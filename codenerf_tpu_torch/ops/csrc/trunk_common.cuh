// Shared pieces of the fused CodeNeRF trunk kernels: K1 (trunk_fwd.cu) and
// K2 / K3 (trunk_bwd.cu).
//
// K2 recomputes K1's forward and takes its relu masks from the recomputed
// bf16 activations, so both kernels must produce the same activations bit
// for bit.  They do so by running the same code: the encode and the five
// hidden layers live here, with the TPU kernel's cast points (every product
// an f32 sum of bf16 products rounded to bf16; per-ray rows and biases
// added in bf16).  The build hashes this header into both libraries' names.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace trunk {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TM = 64;             // sample rows per tile
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WN = 32;             // output columns per warp per pass
constexpr int KX = 16;             // K of the x block: 3 coordinates, zero-padded
constexpr int PAD = 8;             // shared-memory row padding, bf16 elements
constexpr int LDX = KX + PAD;

__host__ __device__ inline int kp_of(int F) { return (3 * F + 15) / 16 * 16; }
__host__ __device__ inline int ld_of(int H, int SC) { return (H > SC ? H : SC) + PAD; }

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 tob(float x) { return __float2bfloat16_rn(x); }
// round an f32 to the nearest bf16 and back
__device__ __forceinline__ float rb(float x) { return f32(tob(x)); }

// The trunk's weights and per-ray rows (all bf16 but the bands).
struct TrunkW {
  const bf16* zs1p;    // [R, H]
  const bf16* featp;   // [R, SC]
  const bf16* sigp;    // [R, 1]
  const bf16* dirp;    // [R, H]
  const bf16* zt1p;    // [R, 3]
  const bf16* b1;      // [H]
  const bf16* w1x;     // [KX, H], rows >= 3 zero; null without the input term
  const bf16* w1s;     // [KP, H], rows >= 3F zero
  const bf16* w1c;     // [KP, H], rows >= 3F zero
  const float* bands;  // [F]
  const bf16* w2;      // [H, H]
  const bf16* wof;     // [H, SC]
  const bf16* wos;     // [H]
  const bf16* wd;      // [SC, H]
  const bf16* wd2;     // [H, H]
  const bf16* bd2;     // [H]
  const bf16* wr;      // [H, 3]
  int S, H, SC, F, KP;
  int ld;              // row stride of the activation buffers
  int ldk;             // row stride of the sin / cos blocks
};

// out[TM, N] = A[TM, K] @ W[K, N], A bf16 in shared memory (row stride lda),
// W bf16 row-major in global memory.  K % 16 == 0, N % WN == 0.  Warp w owns
// columns [w*WN, w*WN + WN) (then + NWARPS*WN, ...) for all TM rows, and
// epi(r, c, v) receives each f32 sum once, on a lane of the owning warp.
template <class Epi>
__device__ __forceinline__ void tile_gemm(const bf16* A, int lda, const bf16* W,
                                          int K, int N, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
  for (int n0 = warp * WN; n0 < N; n0 += NWARPS * WN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16][WN / 16];
#pragma unroll
    for (int i = 0; i < TM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[WN / 16];
#pragma unroll
      for (int j = 0; j < WN / 16; ++j)
        wmma::load_matrix_sync(b[j], W + (size_t)k0 * N + n0 + j * 16, N);
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + i * 16 * lda + k0, lda);
#pragma unroll
        for (int j = 0; j < WN / 16; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WN / 16; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          epi(i * 16 + (e >> 4), n0 + j * 16 + (e & 15), st[e]);
        __syncwarp();
      }
  }
}

// Positional encode of the tile's points (pts: [TM, 3] f32 in shared
// memory), column j = 3k + c <-> band k, coordinate c.  The argument is one
// f32 multiply and sincosf is the full-range version.
__device__ __forceinline__ void encode_tile(const TrunkW& w, const float* pts, bf16* encS,
                                            bf16* encC, bf16* encX) {
  const int tid = threadIdx.x, KP = w.KP, ldk = w.ldk, F3 = 3 * w.F;
  for (int i = tid; i < TM * KP; i += NTHREADS) {
    const int r = i / KP, j = i - r * KP;
    float s = 0.0f, c = 0.0f;
    if (j < F3) sincosf(__fmul_rn(pts[r * 3 + j % 3], w.bands[j / 3]), &s, &c);
    encS[r * ldk + j] = tob(s);
    encC[r * ldk + j] = tob(c);
  }
  for (int i = tid; i < TM * KX; i += NTHREADS) {
    const int r = i / KX, j = i - r * KX;
    encX[r * LDX + j] = tob(j < 3 ? pts[r * 3 + j] : 0.0f);
  }
  __syncthreads();
}

// h1 = relu(layer_xyz1 as three products summed in bf16 in the TPU kernel's
// order, + b1)
__device__ __forceinline__ void fwd_h1(const TrunkW& w, const bf16* encS, const bf16* encC,
                                       const bf16* encX, bf16* h1, float* stage) {
  const int ld = w.ld, ldk = w.ldk, KP = w.KP, H = w.H;
  const bf16* const b1 = w.b1;
  auto l1_last = [=](int r, int c, float v) {
    bf16* d = h1 + r * ld + c;
    const float t = rb(f32(*d) + rb(v));
    *d = tob(fmaxf(rb(t + f32(b1[c])), 0.0f));
  };
  tile_gemm(encS, ldk, w.w1s, KP, H, stage,
            [=](int r, int c, float v) { h1[r * ld + c] = tob(v); });
  if (w.w1x != nullptr) {
    tile_gemm(encC, ldk, w.w1c, KP, H, stage, [=](int r, int c, float v) {
      bf16* d = h1 + r * ld + c;
      *d = tob(f32(*d) + rb(v));
    });
    tile_gemm(encX, LDX, w.w1x, KX, H, stage, l1_last);
  } else {
    tile_gemm(encC, ldk, w.w1c, KP, H, stage, l1_last);
  }
  __syncthreads();
}

// h2 = relu(h1 @ layer_xyz2 top half + per-ray zs1p row)
__device__ __forceinline__ void fwd_h2(const TrunkW& w, const bf16* h1, bf16* h2,
                                       const int* ray, float* stage) {
  const int ld = w.ld, H = w.H;
  const bf16* const zs1p = w.zs1p;
  tile_gemm(h1, ld, w.w2, H, H, stage, [=](int r, int c, float v) {
    const float t = rb(rb(v) + f32(zs1p[(size_t)ray[r] * H + c]));
    h2[r * ld + c] = tob(fmaxf(t, 0.0f));
  });
  __syncthreads();
}

// feat = h2 @ fc_out's feature columns + per-ray featp row (no relu)
__device__ __forceinline__ void fwd_feat(const TrunkW& w, const bf16* h2, bf16* feat,
                                         const int* ray, float* stage) {
  const int ld = w.ld, SC = w.SC;
  const bf16* const featp = w.featp;
  tile_gemm(h2, ld, w.wof, w.H, SC, stage, [=](int r, int c, float v) {
    feat[r * ld + c] = tob(rb(v) + f32(featp[(size_t)ray[r] * SC + c]));
  });
  __syncthreads();
}

// v1 = relu(feat @ layer_dir1 top half + per-ray dirp row)
__device__ __forceinline__ void fwd_v1(const TrunkW& w, const bf16* feat, bf16* v1,
                                       const int* ray, float* stage) {
  const int ld = w.ld, H = w.H;
  const bf16* const dirp = w.dirp;
  tile_gemm(feat, ld, w.wd, w.SC, H, stage, [=](int r, int c, float v) {
    const float t = rb(rb(v) + f32(dirp[(size_t)ray[r] * H + c]));
    v1[r * ld + c] = tob(fmaxf(t, 0.0f));
  });
  __syncthreads();
}

// v2 = relu(v1 @ layer_dir2 + bd2)
__device__ __forceinline__ void fwd_v2(const TrunkW& w, const bf16* v1, bf16* v2, float* stage) {
  const int ld = w.ld, H = w.H;
  const bf16* const bd2 = w.bd2;
  tile_gemm(v1, ld, w.wd2, H, H, stage, [=](int r, int c, float v) {
    const float t = rb(rb(v) + f32(bd2[c]));
    v2[r * ld + c] = tob(fmaxf(t, 0.0f));
  });
  __syncthreads();
}

}  // namespace trunk
