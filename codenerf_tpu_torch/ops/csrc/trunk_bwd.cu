// K2 and K3: the fused CodeNeRF trunk backward for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused.py::_trunk_bwd_impl,
// launched by _trunk_bwd_pallas: K2 is its recompute form (stored=False,
// the VJP of make_fused_codenerf(pallas_backward=True)), K3 its
// stored-activation form (stored=True, the VJP of make_hybrid_codenerf).
// One template, trunk_bwd_kernel<STORED>, holds both.
//
// For every sample row it takes g = d loss / d raw [R*S, 4] f32 back through
// the trunk K1 computes (trunk_fwd.cu) and emits
//
//   g_pts [R*S, 3]                         f32
//   gzs1p gfeatp gsigp gdirp gzt1p [R, .]  f32 sums over each ray's S rows
//   dw1s dw1c dw1x dw2 dwof dwos dwd dwd2 dwr, db1, dbd2   f32
//
// with the TPU kernel's cast points:
//   * K2 recomputes h1, h2, feat, v1, v2 with K1's own code
//     (trunk_common.cuh), so the relu masks, float(act) > 0 on the bf16
//     activation, are K1's bit for bit.  K3 reads them from the forward.
//     Both rederive the encode: sincosf(__fmul_rn(x_c, f_k)), no fast math.
//   * every cotangent product g @ w^T takes bf16 in, sums in f32 and rounds
//     to bf16; g_rgb and g_sig stay f32 for the per-ray sums and the
//     g_pts chain and are rounded to bf16 where they enter a product;
//   * weight grads x^T @ g take bf16 x and g and sum in f32; db1 and dbd2
//     are f32 column sums of g_h1 and g_v2;
//   * g_scaled = g_sn cos - g_cs sin in f32 with the unrounded sin / cos,
//     and g_pts[c] = sum_k f_k g_scaled[3k + c] in f32 multiplies and adds
//     in band order (no tensor cores: the bands reach 2^(F-1)), then
//     + bf16(g_h1 @ w1x^T) with the input term.
//
// Bound on the H100: at the flagship (h = s = 256, F = 10) a sample row
// costs ~1.12 MFLOP of bf16 products in the backward (dx and dW products)
// plus ~0.56 MFLOP for K2's recompute; K3 reads 2.5 KB of stored bf16
// activations per row.  Both are far above the card's ~295 FLOP per byte,
// so they are bound by operations: ~5.3 ms (K2) and ~3.6 ms (K3) per
// flagship train step (3.15 M rows) at 989 TFLOP/s.
//
// Design.  The TPU accumulated the weight grads in output blocks that its
// sequential grid revisits; CUDA blocks run concurrently and in no order.
// So the grid is persistent (one block per SM: the five activations of a
// 64-row tile take 165 KB of shared memory at the flagship), and each block
// walks the rows of a contiguous range of whole rays in 64-row tiles:
//   * weight grads accumulate into the block's own f32 slab in global
//     memory (279,808 floats at the flagship): each warp owns fixed 32x32
//     blocks of every dW and adds each tile's product to them with wmma
//     (the accumulator fragments are loaded from and stored to the slab),
//     so every element is summed in tile order by one warp;
//   * per-ray sums accumulate into the ray's output row, one thread per
//     column walking the tile's rows in order; the block owns the ray, so
//     no other block touches the row;
//   * a second kernel, trunk_bwd_reduce, sums the slabs in block order.
// No atomics: two calls on the same card give the same bits.  Activations
// and cotangents stay in shared memory as bf16 (a cotangent overwrites the
// activation whose mask it consumed), products use wmma bf16 16x16x16 with
// f32 accumulators, weights are read from global memory (L2).  The slab
// read-modify-write moves ~2.2 MB per tile, which at this size costs about
// as much as the products; wgmma, TMA and dW accumulation that stays on
// chip longer are later work.

#include "trunk_common.cuh"

using namespace trunk;

namespace {

// Offsets (floats) of each weight grad in a block's slab.
struct Layout {
  long long dw1s, dw1c, dw1x, dw2, dwof, dwd, dwd2, dwos, dwr, db1, dbd2, total;
};

Layout layout_of(int H, int SC, int F) {
  Layout L;
  const long long KP = kp_of(F);
  long long o = 0;
  L.dw1s = o; o += KP * H;
  L.dw1c = o; o += KP * H;
  L.dw1x = o; o += (long long)KX * H;
  L.dw2 = o; o += (long long)H * H;
  L.dwof = o; o += (long long)H * SC;
  L.dwd = o; o += (long long)SC * H;
  L.dwd2 = o; o += (long long)H * H;
  L.dwos = o; o += H;
  L.dwr = o; o += 3LL * H;
  L.db1 = o; o += H;
  L.dbd2 = o; o += H;
  L.total = (o + 63) / 64 * 64;
  return L;
}

struct BwdArgs {
  TrunkW w;
  const float* pts;    // [R*S, 3]
  const float* g;      // [R*S, 4]
  const bf16* h1;      // [R*S, H]   stored activations (K3 only)
  const bf16* h2;      // [R*S, H]
  const bf16* feat;    // [R*S, SC]
  const bf16* v1;      // [R*S, H]
  const bf16* v2;      // [R*S, H]
  float* g_pts;        // [R*S, 3]
  float* gzs1p;        // [R, H]
  float* gfeatp;       // [R, SC]
  float* gsigp;        // [R, 1]
  float* gdirp;        // [R, H]
  float* gzt1p;        // [R, 3]
  float* slabs;        // [G, L.total]
  Layout L;
  int R;
};

// out[TM, N] = A[TM, K] @ W^T with W [N, K] row-major in global memory (a
// forward weight in [in, out] layout, read as a column-major W^T).
// K % 16 == 0, N % WNB == 0; warp w owns columns [w*WNB, w*WNB + WNB), ...
template <int WNB, class Epi>
__device__ __forceinline__ void tile_gemm_t(const bf16* A, int lda, const bf16* W, int K,
                                            int N, float* stage, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = stage + warp * 256;
  for (int n0 = warp * WNB; n0 < N; n0 += NWARPS * WNB) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16][WNB / 16];
#pragma unroll
    for (int i = 0; i < TM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WNB / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[WNB / 16];
#pragma unroll
      for (int j = 0; j < WNB / 16; ++j)
        wmma::load_matrix_sync(b[j], W + (size_t)(n0 + j * 16) * K + k0, K);
#pragma unroll
      for (int i = 0; i < TM / 16; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + i * 16 * lda + k0, lda);
#pragma unroll
        for (int j = 0; j < WNB / 16; ++j) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TM / 16; ++i)
#pragma unroll
      for (int j = 0; j < WNB / 16; ++j) {
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          epi(i * 16 + (e >> 4), n0 + j * 16 + (e & 15), st[e]);
        __syncwarp();
      }
  }
}

// slab[M, N] += X^T @ G over the tile's TM rows: X [TM, M] and G [TM, N]
// bf16 in shared memory (row strides ldx, ldg), slab f32 row-major in
// global memory; M % 16 == 0, N % 16 == 0.  Warp w owns the 32x32 blocks
// w, w + NWARPS, ... in every tile, so each element's sum runs in tile order.
__device__ __forceinline__ void dw_gemm(const bf16* X, int ldx, int M, const bf16* G, int ldg,
                                        int N, float* slab) {
  const int warp = threadIdx.x >> 5;
  const int mb = (M + 31) / 32, nb = (N + 31) / 32;
  for (int blk = warp; blk < mb * nb; blk += NWARPS) {
    const int m0 = (blk / nb) * 32, n0 = (blk % nb) * 32;
    const int mi = m0 + 16 < M ? 2 : 1, nj = n0 + 16 < N ? 2 : 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (i < mi && j < nj)
          wmma::load_matrix_sync(acc[i][j], slab + (size_t)(m0 + 16 * i) * N + n0 + 16 * j, N,
                                 wmma::mem_row_major);
    for (int k0 = 0; k0 < TM; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (i < mi) wmma::load_matrix_sync(a[i], X + k0 * ldx + m0 + 16 * i, ldx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nj) wmma::load_matrix_sync(b[j], G + k0 * ldg + n0 + 16 * j, ldg);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (i < mi && j < nj) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (i < mi && j < nj)
          wmma::store_matrix_sync(slab + (size_t)(m0 + 16 * i) * N + n0 + 16 * j, acc[i][j], N,
                                  wmma::mem_row_major);
  }
}

// slab[c] += sum over the tile's valid rows of X[r, c], one thread a column
__device__ __forceinline__ void col_sum(const bf16* X, int ldx, int N, int nvalid, float* slab) {
  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    float acc = 0.0f;
    for (int r = 0; r < nvalid; ++r) acc += f32(X[r * ldx + c]);
    slab[c] += acc;
  }
}

// out[ray, c] += the tile's rows of that ray, one thread a column walking
// the rows in order; out is [R, N] in global memory.
template <class Get>
__device__ __forceinline__ void ray_sums(const int* ray, int nvalid, int N, Get get, float* out) {
  for (int c = threadIdx.x; c < N; c += NTHREADS) {
    int cur = ray[0];
    float run = 0.0f;
    for (int r = 0; r < nvalid; ++r) {
      if (ray[r] != cur) {
        out[(size_t)cur * N + c] += run;
        run = 0.0f;
        cur = ray[r];
      }
      run += get(r, c);
    }
    if (nvalid > 0) out[(size_t)cur * N + c] += run;
  }
}

// dst[TM, N] (row stride ld) = rows row0.. of src [*, N]; rows >= nvalid zero
__device__ __forceinline__ void load_act(const bf16* src, int N, bf16* dst, int ld,
                                         long long row0, int nvalid) {
  const int nv = N / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < TM * nv; i += NTHREADS) {
    const int r = i / nv, v = i - r * nv;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) x = reinterpret_cast<const uint4*>(src + (row0 + r) * N)[v];
    reinterpret_cast<uint4*>(dst + r * ld)[v] = x;
  }
}

int smem_bytes(int H, int SC, int F) {
  const int ld = ld_of(H, SC), ldk = kp_of(F) + PAD;
  return 5 * TM * ld * 2 + 2 * TM * ldk * 2 + TM * LDX * 2 + NWARPS * 256 * 4 + TM * 3 * 4 +
         TM * 4 * 4 + TM * 4;
}

template <bool STORED>
__global__ void __launch_bounds__(NTHREADS, 1) trunk_bwd_kernel(const BwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TrunkW& w = p.w;
  const int H = w.H, SC = w.SC, S = w.S, ld = w.ld, ldk = w.ldk, KP = w.KP, F = w.F;
  bf16* const h1 = reinterpret_cast<bf16*>(smem);
  bf16* const h2 = h1 + TM * ld;
  bf16* const feat = h2 + TM * ld;
  bf16* const v1 = feat + TM * ld;
  bf16* const v2 = v1 + TM * ld;
  bf16* const encS = v2 + TM * ld;
  bf16* const encC = encS + TM * ldk;
  bf16* const encX = encC + TM * ldk;
  float* const stage = reinterpret_cast<float*>(encX + TM * LDX);
  float* const pts = stage + NWARPS * 256;
  float* const g = pts + TM * 3;
  int* const ray = reinterpret_cast<int*>(g + TM * 4);

  const int tid = threadIdx.x;
  const Layout L = p.L;
  float* const slab = p.slabs + (size_t)blockIdx.x * L.total;
  const bf16* const wr = w.wr;
  const bf16* const wos = w.wos;
  const float* const bands = w.bands;
  const bool has_x = w.w1x != nullptr;

  // this block's rays [ray0, ray1) and their rows [rowA, rowB)
  const int ray0 = (int)((long long)blockIdx.x * p.R / gridDim.x);
  const int ray1 = (int)((long long)(blockIdx.x + 1) * p.R / gridDim.x);
  const long long rowA = (long long)ray0 * S, rowB = (long long)ray1 * S;

  for (long long i = tid; i < L.total; i += NTHREADS) slab[i] = 0.0f;
  for (long long i = (long long)ray0 * H + tid; i < (long long)ray1 * H; i += NTHREADS) {
    p.gzs1p[i] = 0.0f;
    p.gdirp[i] = 0.0f;
  }
  for (long long i = (long long)ray0 * SC + tid; i < (long long)ray1 * SC; i += NTHREADS)
    p.gfeatp[i] = 0.0f;
  for (long long i = (long long)ray0 * 3 + tid; i < (long long)ray1 * 3; i += NTHREADS)
    p.gzt1p[i] = 0.0f;
  for (int i = ray0 + tid; i < ray1; i += NTHREADS) p.gsigp[i] = 0.0f;
  __syncthreads();

  for (long long row0 = rowA; row0 < rowB; row0 += TM) {
    const int nvalid = (int)(rowB - row0 < TM ? rowB - row0 : TM);
    // rows past the block's last ray carry g = 0 and write nothing
    for (int i = tid; i < TM * 3; i += NTHREADS)
      pts[i] = i / 3 < nvalid ? p.pts[row0 * 3 + i] : 0.0f;
    for (int i = tid; i < TM * 4; i += NTHREADS)
      g[i] = i / 4 < nvalid ? p.g[row0 * 4 + i] : 0.0f;
    for (int r = tid; r < TM; r += NTHREADS)
      ray[r] = (int)((row0 + (r < nvalid ? r : nvalid - 1)) / S);
    if (STORED) {
      load_act(p.h1, H, h1, ld, row0, nvalid);
      load_act(p.h2, H, h2, ld, row0, nvalid);
      load_act(p.feat, SC, feat, ld, row0, nvalid);
      load_act(p.v1, H, v1, ld, row0, nvalid);
      load_act(p.v2, H, v2, ld, row0, nvalid);
    }
    __syncthreads();

    encode_tile(w, pts, encS, encC, encX);
    if (!STORED) {
      fwd_h1(w, encS, encC, encX, h1, stage);
      fwd_h2(w, h1, h2, ray, stage);
      fwd_feat(w, h2, feat, ray, stage);
      fwd_v1(w, feat, v1, ray, stage);
      fwd_v2(w, v1, v2, stage);
    }

    // ---- heads: per-ray sums of g_rgb / g_sig, dwr = v2^T g_rgb, dwos = h2^T g_sig
    ray_sums(ray, nvalid, 3, [=](int r, int c) { return g[r * 4 + c]; }, p.gzt1p);
    ray_sums(ray, nvalid, 1, [=](int r, int c) { return g[r * 4 + 3]; }, p.gsigp);
    for (int i = tid; i < 4 * H; i += NTHREADS) {
      const int k = i >> 2, j = i & 3;
      const bf16* X = j < 3 ? v2 : h2;
      float acc = 0.0f;
      for (int r = 0; r < nvalid; ++r) acc = fmaf(f32(X[r * ld + k]), rb(g[r * 4 + j]), acc);
      if (j < 3)
        slab[L.dwr + k * 3 + j] += acc;
      else
        slab[L.dwos + k] += acc;
    }
    __syncthreads();

    // g_v2 = live(v2) * bf16(g_rgb @ wr^T), in place of v2
    for (int i = tid; i < TM * H; i += NTHREADS) {
      const int r = i / H, c = i - r * H;
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = fmaf(rb(g[r * 4 + j]), f32(wr[c * 3 + j]), acc);
      bf16* d = v2 + r * ld + c;
      *d = f32(*d) > 0.0f ? tob(acc) : tob(0.0f);
    }
    __syncthreads();
    col_sum(v2, ld, H, nvalid, slab + L.dbd2);
    dw_gemm(v1, ld, H, v2, ld, H, slab + L.dwd2);
    __syncthreads();

    // g_v1 = live(v1) * bf16(g_v2 @ wd2^T), in place of v1
    tile_gemm_t<WN>(v2, ld, w.wd2, H, H, stage, [=](int r, int c, float v) {
      bf16* d = v1 + r * ld + c;
      *d = f32(*d) > 0.0f ? tob(v) : tob(0.0f);
    });
    __syncthreads();
    ray_sums(ray, nvalid, H, [=](int r, int c) { return f32(v1[r * ld + c]); }, p.gdirp);
    dw_gemm(feat, ld, SC, v1, ld, H, slab + L.dwd);
    // g_feat = bf16(g_v1 @ wd^T), into v2's buffer (g_v2 is dead)
    tile_gemm_t<WN>(v1, ld, w.wd, H, SC, stage,
                    [=](int r, int c, float v) { v2[r * ld + c] = tob(v); });
    __syncthreads();
    ray_sums(ray, nvalid, SC, [=](int r, int c) { return f32(v2[r * ld + c]); }, p.gfeatp);
    dw_gemm(h2, ld, H, v2, ld, SC, slab + L.dwof);
    __syncthreads();

    // g_h2 = live(h2) * bf16(bf16(g_feat @ wof^T) + bf16(g_sig * wos)), in place of h2
    tile_gemm_t<WN>(v2, ld, w.wof, SC, H, stage, [=](int r, int c, float v) {
      bf16* d = h2 + r * ld + c;
      const float t = rb(rb(v) + rb(rb(g[r * 4 + 3]) * f32(wos[c])));
      *d = f32(*d) > 0.0f ? tob(t) : tob(0.0f);
    });
    __syncthreads();
    ray_sums(ray, nvalid, H, [=](int r, int c) { return f32(h2[r * ld + c]); }, p.gzs1p);
    dw_gemm(h1, ld, H, h2, ld, H, slab + L.dw2);
    __syncthreads();

    // g_h1 = live(h1) * bf16(g_h2 @ w2^T), in place of h1
    tile_gemm_t<WN>(h2, ld, w.w2, H, H, stage, [=](int r, int c, float v) {
      bf16* d = h1 + r * ld + c;
      *d = f32(*d) > 0.0f ? tob(v) : tob(0.0f);
    });
    __syncthreads();
    col_sum(h1, ld, H, nvalid, slab + L.db1);
    dw_gemm(encS, ldk, KP, h1, ld, H, slab + L.dw1s);
    dw_gemm(encC, ldk, KP, h1, ld, H, slab + L.dw1c);
    if (has_x) dw_gemm(encX, LDX, KX, h1, ld, H, slab + L.dw1x);
    __syncthreads();

    // g_sn, g_cs, g_x = bf16(g_h1 @ w1s^T, w1c^T, w1x^T), into the encode blocks
    tile_gemm_t<16>(h1, ld, w.w1s, H, KP, stage,
                    [=](int r, int c, float v) { encS[r * ldk + c] = tob(v); });
    tile_gemm_t<16>(h1, ld, w.w1c, H, KP, stage,
                    [=](int r, int c, float v) { encC[r * ldk + c] = tob(v); });
    if (has_x)
      tile_gemm_t<16>(h1, ld, w.w1x, H, KX, stage,
                      [=](int r, int c, float v) { encX[r * LDX + c] = tob(v); });
    __syncthreads();

    // g_pts[c] = sum_k f_k (g_sn cos - g_cs sin)[3k + c] (+ g_x[c])
    for (int i = tid; i < nvalid * 3; i += NTHREADS) {
      const int r = i / 3, c = i - r * 3;
      const float x = pts[r * 3 + c];
      float acc = 0.0f;
      for (int k = 0; k < F; ++k) {
        const float f = bands[k];
        float s, co;
        sincosf(__fmul_rn(x, f), &s, &co);
        const int j = 3 * k + c;
        const float gs = __fsub_rn(__fmul_rn(f32(encS[r * ldk + j]), co),
                                   __fmul_rn(f32(encC[r * ldk + j]), s));
        acc = __fadd_rn(acc, __fmul_rn(f, gs));
      }
      if (has_x) acc = __fadd_rn(acc, f32(encX[r * LDX + c]));
      p.g_pts[(row0 + r) * 3 + c] = acc;
    }
    __syncthreads();
  }
}

// out[i] = sum over the slabs in block order
__global__ void trunk_bwd_reduce(const float* slabs, int nslab, long long stride, float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float acc = 0.0f;
  for (int b = 0; b < nslab; ++b) acc += slabs[(size_t)b * stride + i];
  out[i] = acc;
}

template <bool STORED>
int set_smem(int H, int SC, int F) {
  return static_cast<int>(cudaFuncSetAttribute(
      trunk_bwd_kernel<STORED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(H, SC, F)));
}

template <bool STORED>
int grid_of(int R, int H, int SC, int F, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int se = set_smem<STORED>(H, SC, F);
  if (se != 0) return se;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trunk_bwd_kernel<STORED>, NTHREADS,
                                                    smem_bytes(H, SC, F));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long g = (long long)sms * per_sm;
  *grid = (int)(g < R ? g : R);
  return 0;
}

// in:  pts zs1p featp sigp dirp zt1p b1 w1x w1s w1c bands w2 wof wos wd wd2
//      bd2 wr g h1 h2 feat v1 v2   (w1x null without the input term; the
//      five activations null for K2)
// out: g_pts gzs1p gfeatp gsigp gdirp gzt1p slabs dflat
// dims: R S H SC F G
template <bool STORED>
int launch(const void* const* in, void* const* out, const int* dims, void* stream) {
  const int R = dims[0], S = dims[1], H = dims[2], SC = dims[3], F = dims[4], G = dims[5];
  BwdArgs p;
  TrunkW& w = p.w;
  p.pts = static_cast<const float*>(in[0]);
  w.zs1p = static_cast<const bf16*>(in[1]);
  w.featp = static_cast<const bf16*>(in[2]);
  w.sigp = static_cast<const bf16*>(in[3]);
  w.dirp = static_cast<const bf16*>(in[4]);
  w.zt1p = static_cast<const bf16*>(in[5]);
  w.b1 = static_cast<const bf16*>(in[6]);
  w.w1x = static_cast<const bf16*>(in[7]);
  w.w1s = static_cast<const bf16*>(in[8]);
  w.w1c = static_cast<const bf16*>(in[9]);
  w.bands = static_cast<const float*>(in[10]);
  w.w2 = static_cast<const bf16*>(in[11]);
  w.wof = static_cast<const bf16*>(in[12]);
  w.wos = static_cast<const bf16*>(in[13]);
  w.wd = static_cast<const bf16*>(in[14]);
  w.wd2 = static_cast<const bf16*>(in[15]);
  w.bd2 = static_cast<const bf16*>(in[16]);
  w.wr = static_cast<const bf16*>(in[17]);
  p.g = static_cast<const float*>(in[18]);
  p.h1 = static_cast<const bf16*>(in[19]);
  p.h2 = static_cast<const bf16*>(in[20]);
  p.feat = static_cast<const bf16*>(in[21]);
  p.v1 = static_cast<const bf16*>(in[22]);
  p.v2 = static_cast<const bf16*>(in[23]);
  p.g_pts = static_cast<float*>(out[0]);
  p.gzs1p = static_cast<float*>(out[1]);
  p.gfeatp = static_cast<float*>(out[2]);
  p.gsigp = static_cast<float*>(out[3]);
  p.gdirp = static_cast<float*>(out[4]);
  p.gzt1p = static_cast<float*>(out[5]);
  p.slabs = static_cast<float*>(out[6]);
  float* const dflat = static_cast<float*>(out[7]);
  w.S = S;
  w.H = H;
  w.SC = SC;
  w.F = F;
  w.KP = kp_of(F);
  w.ld = ld_of(H, SC);
  w.ldk = w.KP + PAD;
  p.L = layout_of(H, SC, F);
  p.R = R;
  const int se = set_smem<STORED>(H, SC, F);
  if (se != 0) return se;
  if (R <= 0 || G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  trunk_bwd_kernel<STORED><<<G, NTHREADS, smem_bytes(H, SC, F), st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned rblocks = static_cast<unsigned>((p.L.total + 255) / 256);
  trunk_bwd_reduce<<<rblocks, 256, 0, st>>>(p.slabs, G, p.L.total, dflat);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int trunk_bwd_kp(int F) { return kp_of(F); }

int trunk_bwd_smem_bytes(int H, int SC, int F) { return smem_bytes(H, SC, F); }

// The names of the slab's weight grads, in trunk_bwd_layout's order.
const char* trunk_bwd_layout_keys() { return "w1s w1c w1x w2 wof wd wd2 wos wr b1 bd2"; }

// The slab layout: for each grad of trunk_bwd_layout_keys, its offset, rows
// and columns (a row-major block, rows padded as the kernel reads the
// weight), then the slab's length, all in floats: 34 values.
void trunk_bwd_layout(int H, int SC, int F, long long* out) {
  const Layout L = layout_of(H, SC, F);
  const long long KP = kp_of(F);
  const long long v[34] = {L.dw1s, KP, H,  L.dw1c, KP, H,  L.dw1x, KX, H,
                           L.dw2,  H,  H,  L.dwof, H,  SC, L.dwd,  SC, H,
                           L.dwd2, H,  H,  L.dwos, H,  1,  L.dwr,  H,  3,
                           L.db1,  1,  H,  L.dbd2, 1,  H,  L.total};
  for (int i = 0; i < 34; ++i) out[i] = v[i];
}

// Blocks of the persistent grid (one slab each) for R rays on the current
// device; returns a CUDA error code.
int trunk_bwd_grid(int stored, int R, int H, int SC, int F, int* grid) {
  return stored ? grid_of<true>(R, H, SC, F, grid) : grid_of<false>(R, H, SC, F, grid);
}

const char* trunk_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2: recompute the forward, then backpropagate.  Launches the kernel and
// the slab reduction on `stream`; returns cudaGetLastError().
int trunk_bwd_recompute(const void* const* in, void* const* out, const int* dims, void* stream) {
  return launch<false>(in, out, dims, stream);
}

// K3: backpropagate through the stored activations.
int trunk_bwd_stored(const void* const* in, void* const* out, const int* dims, void* stream) {
  return launch<true>(in, out, dims, stream);
}

}  // extern "C"
