// K1: the fused CodeNeRF trunk forward for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused.py::_trunk_kernel (launched
// by _trunk_pallas).  For every sample row of pts [R*S, 3] it computes
//
//   enc  = sin / cos(x_c * f_k)                       exact f32, then bf16
//   h1   = relu(bf16(bf16(bf16(sin@w1s) + bf16(cos@w1c)) + bf16(x@w1x)) + b1)
//   h2   = relu(bf16(h1@w2) + zs1p[ray])
//   feat = bf16(h2@wof) + featp[ray]                  sigma = f32(bf16(h2.wos)) + sigp[ray]
//   v1   = relu(bf16(feat@wd) + dirp[ray])
//   v2   = relu(bf16(v1@wd2) + bd2)
//   rgb  = f32(bf16(v2@wr)) + zt1p[ray]               raw = [rgb | sigma] f32
//
// with the TPU kernel's cast points: every product is an f32 sum of bf16
// products rounded to bf16, and bias / per-ray rows are added in bf16.
//
// The encode argument x_c * f_k is one f32 multiply and sinf / cosf are
// the full-range versions: this file must not be built with
// --use_fast_math, and must not call __sinf / __cosf.  The arguments reach
// 2^9 * |x| ~ 1e3 rad, where the fast intrinsics lose the phase (the TPU
// kernel hit the same failure with a bf16 encode matmul: 2.8 absolute error
// against 7e-5).
//
// Bound on the H100: at the flagship (h = s = 256, F = 10) a sample costs
// ~0.56 MFLOP of bf16 products and moves 12 B in and 16 B out, plus ~3 KB
// of per-ray rows per ray: ~2e4 FLOP per byte, far above the card's ~295,
// so it is compute-bound.  3.15 M samples per 128x128 image -> ~1.8 ms at
// 989 TFLOP/s bf16 dense.
//
// Design: one block of 8 warps owns 64 consecutive sample rows (a row's
// ray is row / S).  The tile's activations stay in shared memory as bf16,
// in two [64, max(h, s)] buffers that the layers ping-pong between; no
// intermediate touches device memory.  Products run on the tensor cores
// through wmma bf16 16x16x16 fragments with f32 accumulators; warp w owns
// 32 output columns for all 64 rows, reading its weight fragments straight
// from global memory (the ~0.6 MB of weights stay in L2).  Each 16x16
// accumulator goes through a per-warp f32 staging tile for the epilogue
// (rounding, per-ray row, relu).  The two narrow heads (sigma: N = 1,
// rgb: N = 3) are per-thread f32 dot products.  A faster kernel (wgmma,
// TMA, weights staged in shared memory) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 64;             // sample rows per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WN = 32;             // output columns per warp per pass
constexpr int KX = 16;             // K of the x block: 3 coordinates, zero-padded
constexpr int PAD = 8;             // shared-memory row padding, bf16 elements
constexpr int LDX = KX + PAD;

struct Args {
  const float* pts;    // [R*S, 3]
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
  float* out;          // [R*S, 4]
  long long nrows;     // R*S
  int S, H, SC, F, KP;
  int ld;              // row stride of the activation buffers
  int ldk;             // row stride of the sin / cos blocks
};

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 tob(float x) { return __float2bfloat16_rn(x); }
// round an f32 to the nearest bf16 and back
__device__ __forceinline__ float rb(float x) { return f32(tob(x)); }

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

__global__ void __launch_bounds__(NTHREADS, 2) trunk_fwd_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.H, SC = p.SC, ld = p.ld, ldk = p.ldk, KP = p.KP;
  bf16* const bufA = reinterpret_cast<bf16*>(smem);
  bf16* const bufB = bufA + TM * ld;
  bf16* const encS = bufB + TM * ld;
  bf16* const encC = encS + TM * ldk;
  bf16* const encX = encC + TM * ldk;
  float* const stage = reinterpret_cast<float*>(encX + TM * LDX);
  float* const pts = stage + NWARPS * 256;
  float* const sig = pts + TM * 3;
  int* const ray = reinterpret_cast<int*>(sig + TM);

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * TM;
  const long long nrows = p.nrows;
  const bf16* const zs1p = p.zs1p;
  const bf16* const featp = p.featp;
  const bf16* const dirp = p.dirp;
  const bf16* const b1 = p.b1;
  const bf16* const bd2 = p.bd2;

  // rows past the end compute on zeros and are not written
  for (int i = tid; i < TM * 3; i += NTHREADS)
    pts[i] = (row0 + i / 3 < nrows) ? p.pts[row0 * 3 + i] : 0.0f;
  for (int r = tid; r < TM; r += NTHREADS) {
    const long long g = row0 + r < nrows ? row0 + r : nrows - 1;
    ray[r] = (int)(g / p.S);
  }
  __syncthreads();

  // positional encode, column j = 3k + c <-> band k, coordinate c
  const int F3 = 3 * p.F;
  for (int i = tid; i < TM * KP; i += NTHREADS) {
    const int r = i / KP, j = i - r * KP;
    float s = 0.0f, c = 0.0f;
    if (j < F3) sincosf(__fmul_rn(pts[r * 3 + j % 3], p.bands[j / 3]), &s, &c);
    encS[r * ldk + j] = tob(s);
    encC[r * ldk + j] = tob(c);
  }
  for (int i = tid; i < TM * KX; i += NTHREADS) {
    const int r = i / KX, j = i - r * KX;
    encX[r * LDX + j] = tob(j < 3 ? pts[r * 3 + j] : 0.0f);
  }
  __syncthreads();

  // layer_xyz1 as three products, summed in bf16 in the TPU kernel's order
  auto l1_last = [=](int r, int c, float v) {
    bf16* d = bufA + r * ld + c;
    const float t = rb(f32(*d) + rb(v));
    *d = tob(fmaxf(rb(t + f32(b1[c])), 0.0f));
  };
  tile_gemm(encS, ldk, p.w1s, KP, H, stage,
            [=](int r, int c, float v) { bufA[r * ld + c] = tob(v); });
  if (p.w1x != nullptr) {
    tile_gemm(encC, ldk, p.w1c, KP, H, stage, [=](int r, int c, float v) {
      bf16* d = bufA + r * ld + c;
      *d = tob(f32(*d) + rb(v));
    });
    tile_gemm(encX, LDX, p.w1x, KX, H, stage, l1_last);
  } else {
    tile_gemm(encC, ldk, p.w1c, KP, H, stage, l1_last);
  }
  __syncthreads();

  // layer_xyz2 top half + per-ray zs1p row: A -> B
  tile_gemm(bufA, ld, p.w2, H, H, stage, [=](int r, int c, float v) {
    const float t = rb(rb(v) + f32(zs1p[(size_t)ray[r] * H + c]));
    bufB[r * ld + c] = tob(fmaxf(t, 0.0f));
  });
  __syncthreads();

  // fc_out: sigma column (threads 0..TM-1) and feat columns (B -> A)
  if (tid < TM) {
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(f32(bufB[tid * ld + k]), f32(p.wos[k]), acc);
    sig[tid] = rb(acc) + f32(p.sigp[ray[tid]]);
  }
  tile_gemm(bufB, ld, p.wof, H, SC, stage, [=](int r, int c, float v) {
    bufA[r * ld + c] = tob(rb(v) + f32(featp[(size_t)ray[r] * SC + c]));
  });
  __syncthreads();

  // layer_dir1 top half + per-ray dirp row: A -> B
  tile_gemm(bufA, ld, p.wd, SC, H, stage, [=](int r, int c, float v) {
    const float t = rb(rb(v) + f32(dirp[(size_t)ray[r] * H + c]));
    bufB[r * ld + c] = tob(fmaxf(t, 0.0f));
  });
  __syncthreads();

  // layer_dir2 + bias: B -> A
  tile_gemm(bufB, ld, p.wd2, H, H, stage, [=](int r, int c, float v) {
    const float t = rb(rb(v) + f32(bd2[c]));
    bufA[r * ld + c] = tob(fmaxf(t, 0.0f));
  });
  __syncthreads();

  // fc_rgb top half + per-ray zt1p row, and the sigma column
  for (int i = tid; i < TM * 3; i += NTHREADS) {
    const int r = i / 3, j = i - r * 3;
    const long long g = row0 + r;
    if (g < nrows) {
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(f32(bufA[r * ld + k]), f32(p.wr[k * 3 + j]), acc);
      p.out[g * 4 + j] = rb(acc) + f32(p.zt1p[(size_t)ray[r] * 3 + j]);
    }
  }
  for (int r = tid; r < TM; r += NTHREADS)
    if (row0 + r < nrows) p.out[(row0 + r) * 4 + 3] = sig[r];
}

int kp_of(int F) { return (3 * F + 15) / 16 * 16; }
int ld_of(int H, int SC) { return (H > SC ? H : SC) + PAD; }

}  // namespace

extern "C" {

// Rows of the zero-padded w1s / w1c blocks the kernel reads.
int trunk_fwd_kp(int F) { return kp_of(F); }

// Dynamic shared memory of one block.
int trunk_fwd_smem_bytes(int H, int SC, int F) {
  const int ld = ld_of(H, SC), ldk = kp_of(F) + PAD;
  return 2 * TM * ld * 2 + 2 * TM * ldk * 2 + TM * LDX * 2 +
         NWARPS * 256 * 4 + TM * 3 * 4 + TM * 4 + TM * 4;
}

const char* trunk_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K1 on `stream`; returns cudaGetLastError() after the launch.
// Requires H % 32 == 0 and SC % 32 == 0 (the wrapper checks).
int trunk_fwd(const void* pts, const void* zs1p, const void* featp, const void* sigp,
              const void* dirp, const void* zt1p, const void* b1, const void* w1x,
              const void* w1s, const void* w1c, const void* bands, const void* w2,
              const void* wof, const void* wos, const void* wd, const void* wd2,
              const void* bd2, const void* wr, void* out, int R, int S, int H, int SC,
              int F, void* stream) {
  Args p;
  p.pts = static_cast<const float*>(pts);
  p.zs1p = static_cast<const bf16*>(zs1p);
  p.featp = static_cast<const bf16*>(featp);
  p.sigp = static_cast<const bf16*>(sigp);
  p.dirp = static_cast<const bf16*>(dirp);
  p.zt1p = static_cast<const bf16*>(zt1p);
  p.b1 = static_cast<const bf16*>(b1);
  p.w1x = static_cast<const bf16*>(w1x);
  p.w1s = static_cast<const bf16*>(w1s);
  p.w1c = static_cast<const bf16*>(w1c);
  p.bands = static_cast<const float*>(bands);
  p.w2 = static_cast<const bf16*>(w2);
  p.wof = static_cast<const bf16*>(wof);
  p.wos = static_cast<const bf16*>(wos);
  p.wd = static_cast<const bf16*>(wd);
  p.wd2 = static_cast<const bf16*>(wd2);
  p.bd2 = static_cast<const bf16*>(bd2);
  p.wr = static_cast<const bf16*>(wr);
  p.out = static_cast<float*>(out);
  p.nrows = (long long)R * S;
  p.S = S;
  p.H = H;
  p.SC = SC;
  p.F = F;
  p.KP = kp_of(F);
  p.ld = ld_of(H, SC);
  p.ldk = p.KP + PAD;
  const int smem = trunk_fwd_smem_bytes(H, SC, F);
  cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.nrows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((p.nrows + TM - 1) / TM);
  trunk_fwd_kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
