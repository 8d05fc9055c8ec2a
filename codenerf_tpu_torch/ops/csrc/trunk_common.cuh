// Shared pieces of the fused CodeNeRF trunk kernels: K1 (trunk_fwd.cu) and
// K2 / K3 (trunk_bwd.cu).
//
// K2 recomputes K1's forward and takes its relu masks from the recomputed
// activations.  In f32 both kernels run the same code, the encode and the
// five hidden layers here (fwd_front, fwd_back), so they produce the same
// activations bit for bit.  bf16 K1 is a kernel of its own (trunk_fwd.cu,
// wgmma with streamed weights) that sums its products in another order,
// so a bf16 rounding, and with it a relu mask, can rarely differ from K2's
// recompute; the fused step's gradient gate covers that.  Both keep the
// TPU kernel's cast points for the compute type T (every product an f32
// sum of T products rounded to T; per-ray rows and biases added in T).
//
// T is bf16 (K2 / K3; products on the tensor cores through wmma 16x16x16
// with f32 accumulators) or float (K1 and K2 / K3 in compute_dtype
// float32; products on the CUDA cores in f32 fma, no TF32, so every
// rounding to T is exact and nothing is rounded between products, as in
// JAX with cd = f32).  A tile is 64 rows in bf16 and 32 in f32: the same
// bytes of shared memory.  The build hashes this header into both
// libraries' names.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace trunk {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int WN = 32;             // output columns per warp per pass
constexpr int KX = 16;             // K of the x block: 3 coordinates, zero-padded
constexpr int PAD = 8;             // shared-memory row padding, elements
constexpr int LDX = KX + PAD;

// sample rows per tile
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}

__host__ __device__ inline int kp_of(int F) { return (3 * F + 15) / 16 * 16; }
__host__ __device__ inline int ld_of(int H, int SC) { return (H > SC ? H : SC) + PAD; }

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float f32(float x) { return x; }
// round an f32 to T
template <typename T>
__device__ __forceinline__ T cvt(float x);
template <>
__device__ __forceinline__ bf16 cvt<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float cvt<float>(float x) {
  return x;
}
// round an f32 to T and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return f32(cvt<T>(x));
}

// The trunk's weights and per-ray rows (all T but the bands).
template <typename T>
struct TrunkW {
  const T* zs1p;       // [R, H]
  const T* featp;      // [R, SC]
  const T* sigp;       // [R, 1]
  const T* dirp;       // [R, H]
  const T* zt1p;       // [R, 3]
  const T* b1;         // [H]
  const T* w1x;        // [KX, H], rows >= 3 zero; null without the input term
  const T* w1s;        // [KP, H], rows >= 3F zero
  const T* w1c;        // [KP, H], rows >= 3F zero
  // the forward's weights transposed ([out, in]): w1x w1s w1c w2 wof wd wd2
  const T* w1xT;       // [H, KX]; null without the input term
  const T* w1sT;       // [H, KP]
  const T* w1cT;       // [H, KP]
  const T* w2T;        // [H, H]
  const T* wofT;       // [SC, H]
  const T* wdT;        // [H, SC]
  const T* wd2T;       // [H, H]
  // the backward's encode products in one: [w1s; w1c; w1x] ([2 KP + KX, H],
  // without w1x when there is no input term)
  const T* w1b;
  const float* bands;  // [F]
  const T* w2;         // [H, H]
  const T* wof;        // [H, SC]
  const T* wos;        // [H]
  const T* wd;         // [SC, H]
  const T* wd2;        // [H, H]
  const T* bd2;        // [H]
  const T* wr;         // [H, 3]
  int S, H, SC, F, KP;
  int ld;              // row stride of the activation buffers
  int ldk;             // row stride of the sin / cos blocks
};

// epi(r, c, v) for each element of a 16x16 f32 wmma accumulator whose
// top-left element is (r0, c0), straight from the registers.  On sm_80 and
// later the accumulator holds the mma.sync m16n8k16 layout for each 8-column
// half: element e of lane l is row l / 4 + 8 ((e >> 1) & 1), column
// 2 (l % 4) + (e & 1) + 8 (e >> 2).
template <class Frag, class Epi>
__device__ __forceinline__ void frag_epi(const Frag& f, int r0, int c0, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    epi(r0 + g + 8 * ((e >> 1) & 1), c0 + 2 * t + (e & 1) + 8 * (e >> 2), f.x[e]);
}

// out[TM, N] = A[TM, K] @ W^T: A in shared memory (row stride lda), W [N, K]
// row-major in global memory (read as the column-major B operand, two
// adjacent elements a load).  The forward passes its weights transposed
// ([out, in]); the backward's cotangent products g @ w^T pass them as they
// are.  K % 16 == 0, N % WNB == 0.  A warp task is WNB columns of RF 16-row
// groups; the tasks (column-major over the row groups) go round the warps,
// so a narrow product (small N) still keeps every warp busy with RF = 1.
// epi(r, c, v) receives each f32 sum once, on a lane of the owning warp.
// The next k-step's W fragments are loaded while this step's products run.
template <int WNB, int RF, class Epi>
__device__ __forceinline__ void tile_gemm_t(const bf16* A, int lda, const bf16* W, int K, int N,
                                            Epi epi) {
  constexpr int TM = tile_rows<bf16>(), RG = TM / 16 / RF;
  const int warp = threadIdx.x >> 5, ncol = N / WNB;
  for (int task = warp; task < ncol * RG; task += NWARPS) {
    const int n0 = (task % ncol) * WNB, m0 = (task / ncol) * RF * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RF][WNB / 16];
#pragma unroll
    for (int i = 0; i < RF; ++i)
#pragma unroll
      for (int j = 0; j < WNB / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragB;
    FragB b0[WNB / 16], b1[WNB / 16];
    auto load_b = [&](FragB* b, int k0) {
#pragma unroll
      for (int j = 0; j < WNB / 16; ++j)
        wmma::load_matrix_sync(b[j], W + (size_t)(n0 + j * 16) * K + k0, K);
    };
    auto step = [&](const FragB* b, int k0) {
#pragma unroll
      for (int i = 0; i < RF; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (m0 + i * 16) * lda + k0, lda);
#pragma unroll
        for (int j = 0; j < WNB / 16; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    };
    load_b(b0, 0);
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool two = k0 + 16 < K;
      if (two) load_b(b1, k0 + 16);
      step(b0, k0);
      if (two) {
        if (k0 + 32 < K) load_b(b0, k0 + 32);
        step(b1, k0 + 16);
      }
    }
#pragma unroll
    for (int i = 0; i < RF; ++i)
#pragma unroll
      for (int j = 0; j < WNB / 16; ++j) frag_epi(acc[i][j], m0 + i * 16, n0 + j * 16, epi);
  }
}

// The same product in f32 on the CUDA cores: thread c owns output column c
// of all TM rows and sums k in order.
template <int WNB, int RF, class Epi>
__device__ __forceinline__ void tile_gemm_t(const float* A, int lda, const float* W, int K, int N,
                                            Epi epi) {
  constexpr int TM = tile_rows<float>();
  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    float acc[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r] = 0.0f;
    const float* wc = W + (size_t)c * K;
    for (int k = 0; k < K; ++k) {
      const float wv = __ldg(wc + k);
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = fmaf(A[r * lda + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) epi(r, c, acc[r]);
  }
}

// Positional encode of the tile's points (pts: [TM, 3] f32 in shared
// memory), column j = 3k + c <-> band k, coordinate c.  The argument is one
// f32 multiply and sincosf is the full-range version.
template <typename T>
__device__ __forceinline__ void encode_tile(const TrunkW<T>& w, const float* pts, T* encS, T* encC,
                                            T* encX) {
  constexpr int TM = tile_rows<T>();
  const int tid = threadIdx.x, KP = w.KP, ldk = w.ldk, F3 = 3 * w.F;
  for (int i = tid; i < TM * KP; i += NTHREADS) {
    const int r = i / KP, j = i - r * KP;
    float s = 0.0f, c = 0.0f;
    if (j < F3) sincosf(__fmul_rn(pts[r * 3 + j % 3], w.bands[j / 3]), &s, &c);
    encS[r * ldk + j] = cvt<T>(s);
    encC[r * ldk + j] = cvt<T>(c);
  }
  for (int i = tid; i < TM * KX; i += NTHREADS) {
    const int r = i / KX, j = i - r * KX;
    encX[r * LDX + j] = cvt<T>(j < 3 ? pts[r * 3 + j] : 0.0f);
  }
  __syncthreads();
}

// h1 = relu(layer_xyz1 as three products summed in T in the TPU kernel's
// order, + b1)
template <typename T>
__device__ __forceinline__ void fwd_h1(const TrunkW<T>& w, const T* encS, const T* encC,
                                       const T* encX, T* h1) {
  const int ld = w.ld, ldk = w.ldk, KP = w.KP, H = w.H;
  const T* const b1 = w.b1;
  auto l1_last = [=](int r, int c, float v) {
    T* d = h1 + r * ld + c;
    const float t = rnd<T>(f32(*d) + rnd<T>(v));
    *d = cvt<T>(fmaxf(rnd<T>(t + f32(b1[c])), 0.0f));
  };
  tile_gemm_t<WN, 4>(encS, ldk, w.w1sT, KP, H,
            [=](int r, int c, float v) { h1[r * ld + c] = cvt<T>(v); });
  if (w.w1xT != nullptr) {
    tile_gemm_t<WN, 4>(encC, ldk, w.w1cT, KP, H, [=](int r, int c, float v) {
      T* d = h1 + r * ld + c;
      *d = cvt<T>(f32(*d) + rnd<T>(v));
    });
    tile_gemm_t<WN, 4>(encX, LDX, w.w1xT, KX, H, l1_last);
  } else {
    tile_gemm_t<WN, 4>(encC, ldk, w.w1cT, KP, H, l1_last);
  }
  __syncthreads();
}

// h2 = relu(h1 @ layer_xyz2 top half + per-ray zs1p row)
template <typename T>
__device__ __forceinline__ void fwd_h2(const TrunkW<T>& w, const T* h1, T* h2, const int* ray) {
  const int ld = w.ld, H = w.H;
  const T* const zs1p = w.zs1p;
  tile_gemm_t<WN, 4>(h1, ld, w.w2T, H, H, [=](int r, int c, float v) {
    const float t = rnd<T>(rnd<T>(v) + f32(zs1p[(size_t)ray[r] * H + c]));
    h2[r * ld + c] = cvt<T>(fmaxf(t, 0.0f));
  });
  __syncthreads();
}

// feat = h2 @ fc_out's feature columns + per-ray featp row (no relu)
template <typename T>
__device__ __forceinline__ void fwd_feat(const TrunkW<T>& w, const T* h2, T* feat, const int* ray) {
  const int ld = w.ld, SC = w.SC;
  const T* const featp = w.featp;
  tile_gemm_t<WN, 4>(h2, ld, w.wofT, w.H, SC, [=](int r, int c, float v) {
    feat[r * ld + c] = cvt<T>(rnd<T>(v) + f32(featp[(size_t)ray[r] * SC + c]));
  });
  __syncthreads();
}

// v1 = relu(feat @ layer_dir1 top half + per-ray dirp row)
template <typename T>
__device__ __forceinline__ void fwd_v1(const TrunkW<T>& w, const T* feat, T* v1, const int* ray) {
  const int ld = w.ld, H = w.H;
  const T* const dirp = w.dirp;
  tile_gemm_t<WN, 4>(feat, ld, w.wdT, w.SC, H, [=](int r, int c, float v) {
    const float t = rnd<T>(rnd<T>(v) + f32(dirp[(size_t)ray[r] * H + c]));
    v1[r * ld + c] = cvt<T>(fmaxf(t, 0.0f));
  });
  __syncthreads();
}

// v2 = relu(v1 @ layer_dir2 + bd2)
template <typename T>
__device__ __forceinline__ void fwd_v2(const TrunkW<T>& w, const T* v1, T* v2) {
  const int ld = w.ld, H = w.H;
  const T* const bd2 = w.bd2;
  tile_gemm_t<WN, 4>(v1, ld, w.wd2T, H, H, [=](int r, int c, float v) {
    const float t = rnd<T>(rnd<T>(v) + f32(bd2[c]));
    v2[r * ld + c] = cvt<T>(fmaxf(t, 0.0f));
  });
  __syncthreads();
}

// dst rows [row0, row0 + nvalid) of a row-major [*, N] global array from the
// tile buffer src (row stride ld), 16-byte stores
template <typename T>
__device__ __forceinline__ void store_rows(const T* src, int ld, T* dst, int N, long long row0,
                                           int nvalid) {
  const int nv = N * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < nvalid * nv; i += NTHREADS) {
    const int r = i / nv, v = i - r * nv;
    reinterpret_cast<uint4*>(dst + (row0 + r) * N)[v] =
        reinterpret_cast<const uint4*>(src + r * ld)[v];
  }
}

// the tile buffer dst (row stride ld) from rows row0.. of src [*, N]; rows
// past nvalid are zero
template <typename T>
__device__ __forceinline__ void load_rows(const T* src, int N, T* dst, int ld, long long row0,
                                          int nvalid) {
  constexpr int TM = tile_rows<T>();
  const int nv = N * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < TM * nv; i += NTHREADS) {
    const int r = i / nv, v = i - r * nv;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) x = reinterpret_cast<const uint4*>(src + (row0 + r) * N)[v];
    reinterpret_cast<uint4*>(dst + r * ld)[v] = x;
  }
}

// The activations a forward chain stores: [M, H] but feat [M, SC].
template <typename T>
struct Acts {
  T* h1;
  T* h2;
  T* feat;
  T* v1;
  T* v2;
};

// The first half of a tile's forward: the encode of pts [TM, 3], then h1 in
// A and h2 in B (both also to `acts` for the tile's nvalid rows if acts is
// not null).
template <typename T>
__device__ __forceinline__ void fwd_front(const TrunkW<T>& w, const float* pts, const int* ray,
                                          T* A, T* B, T* encS, T* encC, T* encX,
                                          const Acts<T>* acts, long long row0, int nvalid) {
  encode_tile(w, pts, encS, encC, encX);
  fwd_h1(w, encS, encC, encX, A);
  if (acts) store_rows(A, w.ld, acts->h1, w.H, row0, nvalid);
  fwd_h2(w, A, B, ray);
  if (acts) store_rows(B, w.ld, acts->h2, w.H, row0, nvalid);
}

// The second half: feat in A, v1 in B, v2 in A (feat and v1 also to acts).
template <typename T>
__device__ __forceinline__ void fwd_back(const TrunkW<T>& w, const int* ray, T* A, T* B,
                                         const Acts<T>* acts, long long row0, int nvalid) {
  fwd_feat(w, B, A, ray);
  if (acts) store_rows(A, w.ld, acts->feat, w.SC, row0, nvalid);
  fwd_v1(w, A, B, ray);
  if (acts) store_rows(B, w.ld, acts->v1, w.H, row0, nvalid);
  fwd_v2(w, B, A);
}

// Shared memory of fwd_tile.
template <typename T>
__host__ __device__ inline int fwd_smem_bytes(int H, int SC, int F) {
  constexpr int TM = tile_rows<T>();
  const int ld = ld_of(H, SC), ldk = kp_of(F) + PAD;
  return (2 * TM * ld + 2 * TM * ldk + TM * LDX) * (int)sizeof(T) + TM * 3 * 4 + TM * 4 +
         TM * 4;
}

// f32 K1's tile of rows [row0, row0 + TM): raw = [rgb | sigma] f32 to
// out [nrows, 4].
template <typename T>
__device__ __forceinline__ void fwd_tile(const TrunkW<T>& w, const float* gpts, long long nrows,
                                         long long row0, float* out, unsigned char* smem) {
  constexpr int TM = tile_rows<T>();
  const int H = w.H, ld = w.ld, ldk = w.ldk;
  T* const bufA = reinterpret_cast<T*>(smem);
  T* const bufB = bufA + TM * ld;
  T* const encS = bufB + TM * ld;
  T* const encC = encS + TM * ldk;
  T* const encX = encC + TM * ldk;
  float* const pts = reinterpret_cast<float*>(encX + TM * LDX);
  float* const sig = pts + TM * 3;
  int* const ray = reinterpret_cast<int*>(sig + TM);
  const int tid = threadIdx.x;
  const int nvalid = (int)(nrows - row0 < TM ? nrows - row0 : TM);

  // rows past the end compute on zeros and are not written
  for (int i = tid; i < TM * 3; i += NTHREADS)
    pts[i] = (row0 + i / 3 < nrows) ? gpts[row0 * 3 + i] : 0.0f;
  for (int r = tid; r < TM; r += NTHREADS) {
    const long long g = row0 + r < nrows ? row0 + r : nrows - 1;
    ray[r] = (int)(g / w.S);
  }
  __syncthreads();

  fwd_front<T>(w, pts, ray, bufA, bufB, encS, encC, encX, nullptr, row0, nvalid);
  // fc_out's sigma column (threads 0..TM-1) from h2 in B, before v1 takes B
  if (tid < TM) {
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(f32(bufB[tid * ld + k]), f32(w.wos[k]), acc);
    sig[tid] = rnd<T>(acc) + f32(w.sigp[ray[tid]]);
  }
  fwd_back<T>(w, ray, bufA, bufB, nullptr, row0, nvalid);

  // fc_rgb top half + per-ray zt1p row, and the sigma column
  for (int i = tid; i < TM * 3; i += NTHREADS) {
    const int r = i / 3, j = i - r * 3;
    const long long g = row0 + r;
    if (g < nrows) {
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(f32(bufA[r * ld + k]), f32(w.wr[k * 3 + j]), acc);
      out[g * 4 + j] = rnd<T>(acc) + f32(w.zt1p[(size_t)ray[r] * 3 + j]);
    }
  }
  for (int r = tid; r < TM; r += NTHREADS)
    if (row0 + r < nrows) out[(row0 + r) * 4 + 3] = sig[r];
}

}  // namespace trunk
