// K2 and K3: the fused CodeNeRF trunk backward for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused.py::_trunk_bwd_impl,
// launched by _trunk_bwd_pallas: K2 is its recompute form (stored=False,
// the VJP of make_fused_codenerf(pallas_backward=True)), K3 its
// stored-activation form (stored=True, the VJP of make_hybrid_codenerf).
// Both are a row pass (two of them, below, chosen by shape in
// plan.py::k2_plan) and then, when the weights want gradients (need_dw),
// the same weight-gradient products (xtg.cuh).
//
// For every sample row it takes g = d loss / d raw [R*S, 4] f32 back through
// the trunk K1 computes (trunk_fwd.cu) and emits
//
//   g_pts [R*S, 3]                         f32
//   gzs1p gfeatp gsigp gdirp gzt1p [R, .]  f32 sums over each ray's S rows
//   dw1s dw1c dw1x dw2 dwof dwos dwd dwd2 dwr, db1, dbd2   f32 (need_dw)
//
// with the TPU kernel's cast points for the compute type cd (bf16, or f32
// where every rounding to cd is exact and the products run on the CUDA
// cores, no TF32):
//   * K2's relu masks, float(act) > 0, come from activations recomputed by
//     K1's own code (bf16: trunk_chain.cuh, f32: trunk_common.cuh), bit for
//     bit; K3 reads them from the forward.  Both rederive the encode:
//     sincosf(__fmul_rn(x_c, f_k)), no fast math.
//   * every cotangent product g @ w^T takes cd in, sums in f32 and rounds
//     to cd; g_rgb and g_sig stay f32 for the per-ray sums and the g_pts
//     chain and are rounded to cd where they enter a product;
//   * weight grads x^T @ g take cd x and g and sum in f32; db1 and dbd2 are
//     f32 column sums of g_h1 and g_v2;
//   * g_scaled = g_sn cos - g_cs sin in f32 with the unrounded sin / cos,
//     and g_pts[c] = sum_k f_k g_scaled[3k + c] in f32 multiplies and adds
//     in band order (no tensor cores: the bands reach 2^(F-1)), then
//     + cd(g_h1 @ w1x^T) with the input term.
//
// Bound on the H100: at the flagship (h = s = 256, F = 10) a sample row
// costs ~0.56 MFLOP of bf16 cotangent products, ~0.56 MFLOP of dW products
// and ~0.56 MFLOP for K2's recompute; K3 reads ~2.5 KB of stored bf16
// activations a row.  All far above the card's ~295 FLOP per byte, so both
// are bound by operations: ~5.3 ms (K2) and ~3.6 ms (K3) per flagship
// train step (3.15 M rows) at 989 TFLOP/s, of which the row pass is ~3.5
// and ~1.8 ms.
//
// bf16 at K1's widths: trunk_bwd_rows_wgmma<NH, NS, RECOMPUTE>.  The first
// port's row pass (kept below for f32 and wider shapes) was bounded by
// what bounded K1's first port: wmma 16x16x16 on the legacy tensor-core
// path with every weight fragment read from L2 for every 64-row tile, a
// block-wide barrier after every layer, h2 and h1 read back from device
// memory for their relu masks, and dwr, dwos and the per-ray sums in
// serial loops of one thread a column over the tile's rows between the
// layers; it ran K2 at ~10% of its bound.  This design takes K1's:
//   * A persistent grid of at most one block per SM.  The block's whole-ray
//     range (as before) is split into two whole-ray halves, one per
//     consumer warpgroup (plan.py::trunk_bwd_wgmma_plan: even_ranges(R, 2
//     G)), each walked in 64-row tiles; both warpgroups take every weight
//     chunk, so one chunk serves 128 rows, and the one with fewer tiles
//     runs empty ones at its end.  A ray's rows stay in one warpgroup, so
//     its per-ray sums need no atomics and no cross-warpgroup order: two
//     calls give the same bits.
//   * K2 runs K1's chain itself (trunk_chain.cuh::forward, K1's layer-1
//     order, epilogues and staged per-ray rows), with hooks: each
//     activation's relu mask is kept as bits in the accumulator's layout
//     (4 words a thread at NH = 256), which is the same for every product
//     of width NH, so the backward's epilogues read them where they apply
//     them.  K3 loads v2 h2 v1 h1 through the buffer (cp.async) for the
//     same masks.  The heads (raw) are not computed.
//   * Every cotangent product is wgmma m64nNk16 from shared memory with f32
//     accumulators, B = w as stored [N, K] (g @ w^T reads w K-major), the
//     images packed once per call by ops/fused.py::k2_images and streamed
//     by the producer thread through the ring with cp.async.bulk after
//     K2's 18 forward chunks: wd2, wd, wof, w2 and the stacked [w1s; w1c;
//     w1x] at N = 80 (K1's encode columns).  Each epilogue runs in
//     registers (g_v2's three FMAs a column from g_rgb, the mask, g_h2's
//     wos term, the round to bf16) and writes the warpgroup's swizzled A
//     buffer as the next product's operand; the warpgroups synchronise
//     only on their own named barriers.
//   * While each product's first chunk is in the tensor cores, the
//     threads read its input back from the buffer, one column pair a
//     thread and rows in order: the per-ray sums (a ray's first rows
//     store, its later rows add), the narrow grads dwos, dwr, dbd2, and,
//     with need_dw, the dW operand as 16-byte stores (K2 also h1 h2 feat
//     v1 and the encode [sin | cos | x 1 0 ...], 80 columns, the ones at
//     67 giving db1).  Without need_dw (a frozen trunk: TTO, validation)
//     nothing of that is written and the wrapper launches no dW product;
//     g_pts and the per-ray sums run the same code.
//   * g_pts reads [g_sn | g_cs | g_x] from the buffer, one (row,
//     coordinate) a thread, the bands unrolled so their sincosf overlap.
// Registers bound this design: a consumer has 240 (setmaxnreg; a block of
// 9 warps would put 3 on one SM sub-partition and cap every thread at
// 168), and an N = 256 product's accumulator takes 128 of them.  So the
// long-lived state leaves registers: h1's, h2's and v1's masks live in
// shared memory (v2's, used at once, stays), the narrow grads run on in
// the warpgroup's slab row (each tile reads, adds and writes back its own
// columns), and what ptxas still spills goes to L1, which the 3-stage
// ring (one stage fewer than K1's) doubles by keeping the block under the
// 196 KB carve-out: 198,192 B at 256 / 256 for K2, 184,880 for K3
// (plan.py::k2_smem).
//
// f32, and bf16 wider than 256 or with more than 10 bands:
// trunk_bwd_rows_kernel<T, RECOMPUTE, TM>, the earlier row pass
// (unchanged), which stores the dW operands whether or not
// they are read; with need_dw off the wrapper skips only the products.
//   1. trunk_bwd_rows_kernel: a persistent grid of whole-ray ranges, two
//      blocks per SM (two tile buffers, 91 KB).  Per 64-row tile (32 in
//      f32) K2 first runs K1's chain again (fwd_front / fwd_back), storing
//      h1 h2 feat v1 for the products and leaving v2 and v1 in the two
//      buffers; K3 loads v2 and v1.  Then the cotangent chain, each
//      cotangent overwriting the activation whose mask it consumed (h2 and
//      h1 are read back when their turn comes), and the encode chain to
//      g_pts.  The per-ray sums go to the ray's output row (the block owns
//      the ray), in row order; dwos, dwr and dbd2 (5h floats) to a
//      per-block slab.  The operands of the weight grads are written in
//      cd, 16 bytes a store: the encode [sin | cos | x 1 0 ...] (the ones
//      give db1) and g_h1 g_h2 g_feat g_v1 g_v2, ~2.7 KB a row.
//   2. xtg.cuh: the five dW products (enc^T g_h1 -> dw1s dw1c dw1x db1,
//      h1^T g_h2, h2^T g_feat, feat^T g_v1, v1^T g_v2) as tall split-K
//      wgmma GEMMs over all rows, each block's f32 sums in registers over
//      its row range, partials summed in split order; the per-block (per
//      warpgroup in the wgmma row pass) slabs summed in order.
// The dW products replaced a first design that summed the weight grads
// per block in a 148 MB f32 slab (~110 GB of traffic a flagship step);
// no atomics anywhere: two calls on the same card give the same bits.

#include "hopper.cuh"
#include "trunk_chain.cuh"
#include "trunk_common.cuh"
#include "xtg.cuh"

using namespace trunk;

namespace {

// the narrow grads in a block's slab, in floats: dwos [H], dwr [H, 3],
// dbd2 [H]
constexpr int SMALL_DWOS = 0, SMALL_DWR = 1, SMALL_DBD2 = 4, SMALL_WIDTH = 5;

template <typename T>
struct RowArgs {
  TrunkW<T> w;
  const float* pts;    // [R*S, 3]
  const float* g;      // [R*S, 4]
  Acts<T> act;         // [R*S, .] activations: K3 reads the forward's; K2's
                       // forward writes h1 h2 feat v1 here, read back later
  T* enc;              // [R*S, EW] sin (KP) | cos (KP) | x (3) 1 0 ... (16)
  Acts<T> cot;         // [R*S, .] g_h1 g_h2 g_feat g_v1 g_v2 (written)
  float* g_pts;        // [R*S, 3]
  float* gzs1p;        // [R, H]
  float* gfeatp;       // [R, SC]
  float* gsigp;        // [R, 1]
  float* gdirp;        // [R, H]
  float* gzt1p;        // [R, 3]
  float* small;        // [G, 5H]
  int R, EW;
};

template <typename T>
__host__ __device__ inline int rows_smem_bytes(int H, int SC, int F, int TM) {
  const int ld = ld_of(H, SC), ldk = kp_of(F) + PAD;
  return (2 * TM * ld + 2 * TM * ldk + TM * LDX) * (int)sizeof(T) + TM * 3 * 4 + TM * 4 * 4 +
         TM * 4;
}

__device__ __forceinline__ void load2(const bf16* p, float& a, float& b) {
  const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}

// slab[c] += sum over the tile's valid rows of X[r, c] in row order, two
// columns a thread
template <typename T>
__device__ __forceinline__ void col_sum(const T* X, int ldx, int N, int nvalid, float* slab) {
  for (int c = 2 * threadIdx.x; c < N; c += 2 * NTHREADS) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = 0; r < nvalid; ++r) {
      float a, b;
      load2(X + r * ldx + c, a, b);
      s0 += a;
      s1 += b;
    }
    slab[c] += s0;
    slab[c + 1] += s1;
  }
}

// out[ray, c] += the tile's rows of that ray of X (row stride ldx), summed
// in row order, two columns a thread; out is [R, N] in global memory and the
// tile's rows start at row0 (rays of S rows)
template <typename T>
__device__ __forceinline__ void ray_sums(const T* X, int ldx, int N, long long row0, int nvalid,
                                         int S, float* out) {
  for (int c = 2 * threadIdx.x; c < N; c += 2 * NTHREADS) {
    int r = 0;
    while (r < nvalid) {
      const long long row = row0 + r;
      const int end = min(nvalid, r + S - (int)(row % S));
      float s0 = 0.0f, s1 = 0.0f;
      for (; r < end; ++r) {
        float a, b;
        load2(X + r * ldx + c, a, b);
        s0 += a;
        s1 += b;
      }
      float* o = out + (size_t)(row / S) * N + c;
      o[0] += s0;
      o[1] += s1;
    }
  }
}

// the same for the cotangent's columns j of g [TM, 4] (f32), one thread a
// column
__device__ __forceinline__ void ray_sums_g(const float* g, int j0, int n, long long row0,
                                           int nvalid, int S, float* out) {
  for (int c = threadIdx.x; c < n; c += NTHREADS) {
    int r = 0;
    while (r < nvalid) {
      const long long row = row0 + r;
      const int end = min(nvalid, r + S - (int)(row % S));
      float s = 0.0f;
      for (; r < end; ++r) s += g[r * 4 + j0 + c];
      out[(size_t)(row / S) * n + c] += s;
    }
  }
}

template <typename T, bool RECOMPUTE, int TM>
__global__ void __launch_bounds__(NTHREADS, 2) trunk_bwd_rows_kernel(const RowArgs<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TrunkW<T>& w = p.w;
  const int H = w.H, SC = w.SC, S = w.S, ld = w.ld, ldk = w.ldk, KP = w.KP, F = w.F;
  T* const X = reinterpret_cast<T*>(smem);
  T* const Y = X + TM * ld;
  T* const encS = Y + TM * ld;
  T* const encC = encS + TM * ldk;
  T* const encX = encC + TM * ldk;
  float* const pts = reinterpret_cast<float*>(encX + TM * LDX);
  float* const g = pts + TM * 3;
  int* const ray = reinterpret_cast<int*>(g + TM * 4);

  const int tid = threadIdx.x;
  float* const small = p.small + (size_t)blockIdx.x * SMALL_WIDTH * H;
  const T* const wr = w.wr;
  const T* const wos = w.wos;
  const float* const bands = w.bands;
  const bool has_x = w.w1x != nullptr;
  const int EW = p.EW;

  // this block's rays [ray0, ray1) and their rows [rowA, rowB)
  const int ray0 = (int)((long long)blockIdx.x * p.R / gridDim.x);
  const int ray1 = (int)((long long)(blockIdx.x + 1) * p.R / gridDim.x);
  const long long rowA = (long long)ray0 * S, rowB = (long long)ray1 * S;

  for (int i = tid; i < SMALL_WIDTH * H; i += NTHREADS) small[i] = 0.0f;
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

  auto live = [](T a) { return f32(a) > 0.0f; };
  for (long long row0 = rowA; row0 < rowB; row0 += TM) {
    const int nvalid = (int)(rowB - row0 < TM ? rowB - row0 : TM);
    // rows past the block's last ray carry g = 0 and write nothing
    for (int i = tid; i < TM * 3; i += NTHREADS)
      pts[i] = i / 3 < nvalid ? p.pts[row0 * 3 + i] : 0.0f;
    for (int i = tid; i < TM * 4; i += NTHREADS)
      g[i] = i / 4 < nvalid ? p.g[row0 * 4 + i] : 0.0f;
    if (RECOMPUTE) {
      // K2: K1's chain again, h1 h2 feat v1 stored for the dW products; it
      // leaves v2 in X and v1 in Y
      for (int r = tid; r < TM; r += NTHREADS)
        ray[r] = (int)((row0 + (r < nvalid ? r : nvalid - 1)) / S);
      __syncthreads();
      fwd_front<T, TM>(w, pts, ray, X, Y, encS, encC, encX, &p.act, row0, nvalid);
      fwd_back<T, TM>(w, ray, X, Y, &p.act, row0, nvalid);
    } else {
      load_rows<T, TM>(p.act.v2, H, X, ld, row0, nvalid);
      load_rows<T, TM>(p.act.v1, H, Y, ld, row0, nvalid);
      __syncthreads();
      encode_tile<T, TM>(w, pts, encS, encC, encX);
    }
    // the encode rows for dw1s, dw1c, dw1x and db1: [sin | cos | x 1 0 ...],
    // 16 bytes a store
    {
      constexpr int V = 16 / (int)sizeof(T);
      const int nv = EW / V, ks = KP / V;
      for (int i = tid; i < nvalid * nv; i += NTHREADS) {
        const int r = i / nv, q = i - r * nv;
        uint4 v;
        if (q < ks) {
          v = *reinterpret_cast<const uint4*>(encS + r * ldk + q * V);
        } else if (q < 2 * ks) {
          v = *reinterpret_cast<const uint4*>(encC + r * ldk + (q - ks) * V);
        } else {
          T* e = reinterpret_cast<T*>(&v);
          const int j0 = (q - 2 * ks) * V;
#pragma unroll
          for (int j = 0; j < V; ++j)
            e[j] = j0 + j < 3 && has_x ? encX[r * LDX + j0 + j] : cvt<T>(j0 + j == 3 ? 1.0f : 0.0f);
        }
        reinterpret_cast<uint4*>(p.enc + (row0 + r) * EW)[q] = v;
      }
    }

    // ---- heads: per-ray sums of g_rgb / g_sig, dwr = v2^T g_rgb
    ray_sums_g(g, 0, 3, row0, nvalid, S, p.gzt1p);
    ray_sums_g(g, 3, 1, row0, nvalid, S, p.gsigp);
    for (int k = tid; k < H; k += NTHREADS) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < nvalid; ++r) {
        const float x = f32(X[r * ld + k]);
        const float4 gr = *reinterpret_cast<const float4*>(g + r * 4);
        a0 = fmaf(x, rnd<T>(gr.x), a0);
        a1 = fmaf(x, rnd<T>(gr.y), a1);
        a2 = fmaf(x, rnd<T>(gr.z), a2);
      }
      float* d = small + SMALL_DWR * H + k * 3;
      d[0] += a0;
      d[1] += a1;
      d[2] += a2;
    }
    __syncthreads();

    // g_v2 = live(v2) * cd(g_rgb @ wr^T), in place of v2
    for (int i = tid; i < TM * H; i += NTHREADS) {
      const int r = i / H, c = i - r * H;
      float acc = 0.0f;
      for (int j = 0; j < 3; ++j) acc = fmaf(rnd<T>(g[r * 4 + j]), f32(wr[c * 3 + j]), acc);
      T* d = X + r * ld + c;
      *d = live(*d) ? cvt<T>(acc) : cvt<T>(0.0f);
    }
    __syncthreads();
    col_sum(X, ld, H, nvalid, small + SMALL_DBD2 * H);
    store_rows(X, ld, p.cot.v2, H, row0, nvalid);

    // g_v1 = live(v1) * cd(g_v2 @ wd2^T), in place of v1
    tile_gemm_t<TM, WN, 4>(X, ld, w.wd2, H, H, [=](int r, int c, float v) {
      T* d = Y + r * ld + c;
      *d = live(*d) ? cvt<T>(v) : cvt<T>(0.0f);
    });
    __syncthreads();
    ray_sums(Y, ld, H, row0, nvalid, S, p.gdirp);
    store_rows(Y, ld, p.cot.v1, H, row0, nvalid);
    // g_feat = cd(g_v1 @ wd^T), into X (g_v2 is stored)
    tile_gemm_t<TM, WN, 4>(Y, ld, w.wd, H, SC,
                    [=](int r, int c, float v) { X[r * ld + c] = cvt<T>(v); });
    __syncthreads();
    ray_sums(X, ld, SC, row0, nvalid, S, p.gfeatp);
    store_rows(X, ld, p.cot.feat, SC, row0, nvalid);
    load_rows<T, TM>(p.act.h2, H, Y, ld, row0, nvalid);  // g_v1 is stored
    __syncthreads();

    // dwos = h2^T g_sig
    for (int k = tid; k < H; k += NTHREADS) {
      float acc = 0.0f;
      for (int r = 0; r < nvalid; ++r) acc = fmaf(f32(Y[r * ld + k]), rnd<T>(g[r * 4 + 3]), acc);
      small[SMALL_DWOS * H + k] += acc;
    }
    __syncthreads();
    // g_h2 = live(h2) * cd(cd(g_feat @ wof^T) + cd(cd(g_sig) * wos)), in place of h2
    tile_gemm_t<TM, WN, 4>(X, ld, w.wof, SC, H, [=](int r, int c, float v) {
      T* d = Y + r * ld + c;
      const float t = rnd<T>(rnd<T>(v) + rnd<T>(rnd<T>(g[r * 4 + 3]) * f32(wos[c])));
      *d = live(*d) ? cvt<T>(t) : cvt<T>(0.0f);
    });
    __syncthreads();
    ray_sums(Y, ld, H, row0, nvalid, S, p.gzs1p);
    store_rows(Y, ld, p.cot.h2, H, row0, nvalid);
    load_rows<T, TM>(p.act.h1, H, X, ld, row0, nvalid);  // g_feat is stored
    __syncthreads();

    // g_h1 = live(h1) * cd(g_h2 @ w2^T), in place of h1
    tile_gemm_t<TM, WN, 4>(Y, ld, w.w2, H, H, [=](int r, int c, float v) {
      T* d = X + r * ld + c;
      *d = live(*d) ? cvt<T>(v) : cvt<T>(0.0f);
    });
    __syncthreads();
    store_rows(X, ld, p.cot.h1, H, row0, nvalid);

    // g_sn, g_cs, g_x = cd(g_h1 @ w1s^T, w1c^T, w1x^T), into the encode
    // blocks: one product against the stacked [w1s; w1c; w1x], 16 columns
    // by 16 rows a warp task
    const int n1 = 2 * KP + (has_x ? KX : 0);
    tile_gemm_t<TM, 16, 1>(X, ld, w.w1b, H, n1, [=](int r, int c, float v) {
      T* d = c < KP       ? encS + r * ldk + c
             : c < 2 * KP ? encC + r * ldk + c - KP
                          : encX + r * LDX + c - 2 * KP;
      *d = cvt<T>(v);
    });
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

template <typename T>
void fill_weights(TrunkW<T>& w, const void* const* in, const int* dims) {
  w.zs1p = static_cast<const T*>(in[1]);
  w.featp = static_cast<const T*>(in[2]);
  w.sigp = static_cast<const T*>(in[3]);
  w.dirp = static_cast<const T*>(in[4]);
  w.zt1p = static_cast<const T*>(in[5]);
  w.b1 = static_cast<const T*>(in[6]);
  w.w1x = static_cast<const T*>(in[7]);
  w.w1s = static_cast<const T*>(in[8]);
  w.w1c = static_cast<const T*>(in[9]);
  w.bands = static_cast<const float*>(in[10]);
  w.w2 = static_cast<const T*>(in[11]);
  w.wof = static_cast<const T*>(in[12]);
  w.wos = static_cast<const T*>(in[13]);
  w.wd = static_cast<const T*>(in[14]);
  w.wd2 = static_cast<const T*>(in[15]);
  w.bd2 = static_cast<const T*>(in[16]);
  w.wr = static_cast<const T*>(in[17]);
  w.w1xT = static_cast<const T*>(in[18]);
  w.w1sT = static_cast<const T*>(in[19]);
  w.w1cT = static_cast<const T*>(in[20]);
  w.w2T = static_cast<const T*>(in[21]);
  w.wofT = static_cast<const T*>(in[22]);
  w.wdT = static_cast<const T*>(in[23]);
  w.wd2T = static_cast<const T*>(in[24]);
  w.w1b = static_cast<const T*>(in[25]);
  w.S = dims[1];
  w.H = dims[2];
  w.SC = dims[3];
  w.F = dims[4];
  w.KP = kp_of(w.F);
  w.ld = ld_of(w.H, w.SC);
  w.ldk = w.KP + PAD;
}

template <typename T>
Acts<T> acts_of(void* const* a) {
  return Acts<T>{static_cast<T*>(a[0]), static_cast<T*>(a[1]), static_cast<T*>(a[2]),
                 static_cast<T*>(a[3]), static_cast<T*>(a[4])};
}

// The row pass.  in: as trunk_fwd's, then [w1s; w1c; w1x], g, h1 h2 feat
// v1 v2 (K2: the
// buffers its forward fills; v2 unused); out: g_pts
// gzs1p gfeatp gsigp gdirp gzt1p enc g_h1 g_h2 g_feat g_v1 g_v2 small;
// dims: R S H SC F smem tile_rows G EW
template <typename T, bool RECOMPUTE, int TM>
int launch_tile(const RowArgs<T>& p, int G, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_rows_kernel<T, RECOMPUTE, TM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  trunk_bwd_rows_kernel<T, RECOMPUTE, TM>
      <<<G, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool RECOMPUTE>
int launch_rows(const void* const* in, void* const* out, const int* dims, void* stream) {
  RowArgs<T> p;
  fill_weights(p.w, in, dims);
  p.pts = static_cast<const float*>(in[0]);
  p.g = static_cast<const float*>(in[26]);
  p.act = acts_of<T>(const_cast<void* const*>(in + 27));
  p.g_pts = static_cast<float*>(out[0]);
  p.gzs1p = static_cast<float*>(out[1]);
  p.gfeatp = static_cast<float*>(out[2]);
  p.gsigp = static_cast<float*>(out[3]);
  p.gdirp = static_cast<float*>(out[4]);
  p.gzt1p = static_cast<float*>(out[5]);
  p.enc = static_cast<T*>(out[6]);
  p.cot = acts_of<T>(out + 7);
  p.small = static_cast<float*>(out[12]);
  p.R = dims[0];
  const int G = dims[7];
  p.EW = dims[8];
  const int tm = dims[6];
  const int smem = rows_smem_bytes<T>(p.w.H, p.w.SC, p.w.F, tm);
  const int ew = 2 * p.w.KP + KX;
  if (!tile_ok<T>(tm) || dims[5] != smem || p.EW != ew || p.R <= 0 || G <= 0 || G > p.R)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int TM = tile_rows<T>();
  if (tm == TM) return launch_tile<T, RECOMPUTE, TM>(p, G, smem, stream);
  if (tm == TM / 2) return launch_tile<T, RECOMPUTE, TM / 2>(p, G, smem, stream);
  return launch_tile<T, RECOMPUTE, TM / 4>(p, G, smem, stream);
}

}  // namespace

// ---- bf16: the persistent, warp-specialised wgmma row pass ----

namespace rows_wgmma {

using namespace chain;

constexpr int THREADS = 3 * WG;   // two consumer warpgroups, one producer
// weight chunks in flight: one fewer than K1's ring, which keeps the
// block's shared memory under 196 KB (plan.py::k2_smem) and so leaves the
// SM twice K1's L1 for the consumers' register spills
constexpr int RING = 3;
// registers a thread after setmaxnreg, as K1's
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
// the backward's encode product [g_sn | g_cs | g_x]: N = 80, the encode's
// columns (sin at 0, cos at 32, x at 64)
constexpr int G1 = 2 * KPB + XW;

// byte offsets from the block's 1024-aligned base (plan.py::k2_smem)
struct Layout {
  int stage;   // one ring stage
  int act_wg;  // one warpgroup's buffer
  int act;     // the two buffers
  int pts;     // each warpgroup's 64 points, f32
  int g;       // each warpgroup's 64 rows of g, f32 [64, 4]
  int wrs;     // wr's three columns and wos, f32 [4, NH], zero past H
  int masks;   // each warpgroup's relu masks of h1 h2 v1, u32 [3, NH / 64, WG]
  int bias;    // K2: b1 and bd2, bf16 [NH] each
  int rows;    // K2: each warpgroup's staged per-ray rows, as K1's
  int bars;    // full[RING], empty[RING]
  int total;   // + alignment slack
};
__host__ __device__ inline Layout layout(int NH, int NS, bool recompute) {
  const int nm = NH > NS ? NH : NS;
  Layout L;
  L.stage = nm * 128;
  L.act_wg = nm / 64 * BLOCK;
  L.act = RING * L.stage;
  L.pts = L.act + 2 * L.act_wg;
  L.g = L.pts + 2 * 64 * 3 * 4;
  L.wrs = L.g + 2 * 64 * 16;
  L.masks = L.wrs + 4 * NH * 4;
  L.bias = L.masks + 2 * 3 * NH / 64 * WG * 4;
  L.rows = L.bias + (recompute ? 2 * NH * 2 : 0);
  L.bars = L.rows + (recompute ? 2 * RMAX * (2 * NH + NS) * 2 : 0);
  L.total = L.bars + 2 * RING * 8 + 1024;
  return L;
}

// bytes of the packed weight images (plan.py::k2_chunks): K2 first
// streams K1's (trunk_fwd.cu's image_bytes), then both the cotangent
// products' B = w as stored [N, K]: wd2, wd, wof, w2, [w1s; w1c; w1x]
__host__ __device__ inline long long image_bytes(int NH, int NS, bool recompute) {
  const long long fwd = 128LL * (NH * (2 + 2 * NH / 64 + NS / 64) + NS * (NH / 64));
  const long long bwd = 128LL * (NH / 64 * (2 * NH + NS + G1) + NS / 64 * NH);
  return (recompute ? fwd : 0) + bwd;
}

struct BArgs {
  FwdArgs f;           // pts, zs1p featp dirp (K2), bands; R S H SC F
  const bf16* b1;      // [H] (K2)
  const bf16* bd2;     // [H] (K2)
  const bf16* wos;     // [H]
  const bf16* wr;      // [H, 3]
  const float* g;      // [R*S, 4]
  const bf16* act[4];  // K3: the forward's h1 h2 v1 v2 [R*S, H]
  const unsigned char* img;  // the chunks of plan.py::k2_chunks
  float* g_pts;        // [R*S, 3]
  float* gzs1p;        // [R, H]
  float* gfeatp;       // [R, SC]
  float* gsigp;        // [R, 1]
  float* gdirp;        // [R, H]
  float* gzt1p;        // [R, 3]
  // the dW operands, written with need_dw only
  bf16* enc;           // [R*S, G1] sin | cos | x 1 0 ...
  bf16* fwd[4];        // K2: h1 h2 feat v1 [R*S, H or SC]
  bf16* cot[5];        // g_h1 g_h2 g_feat g_v1 g_v2 [R*S, H or SC]
  float* small;        // [2 G, 5 H]: each warpgroup's dwos | dwr | dbd2
  int has_x, need_dw;
};

// The relu masks of h1 h2 v1 v2 in the accumulator layout of an N = NH
// product: bit i of a thread's mask is accumulator element i (pair j,
// half h, column e at i = 4 j + 2 h + e), so word k holds pair groups 8 k
// .. 8 k + 7, NH / 64 words a thread.  h1's, h2's and v1's live across
// products in shared memory (word k of thread t at k * WG + t): registers
// are what the products' accumulators need.  v2's, used right after it is
// made, stays in registers.  A mask is built a word at a time, pairs in
// order (j, then h), as the epilogues store them.
constexpr int MH1 = 0, MH2 = 1, MV1 = 2;
template <int NH>
struct Masks {
  static constexpr int W = NH / 64;
  uint32_t* sm;  // this warpgroup's [3][W][WG]
  int t;         // its thread
  uint32_t v2[W];
  uint32_t cur;  // the word being built
  __device__ __forceinline__ uint32_t* words(int a) const { return sm + a * W * WG; }
  __device__ __forceinline__ static uint32_t bits(bf2 v) {
    return (__low2float(v) > 0.0f ? 1u : 0u) | (__high2float(v) > 0.0f ? 2u : 0u);
  }
  // pair (j, h) of activation a (MH1, MH2, MV1)
  __device__ __forceinline__ void set(int a, int j, int h, bf2 v) {
    cur |= bits(v) << ((4 * j + 2 * h) & 31);
    if ((j & 7) == 7 && h == 1) {
      words(a)[(j >> 3) * WG + t] = cur;
      cur = 0u;
    }
  }
  __device__ __forceinline__ void set_v2(int j, int h, bf2 v) {
    cur |= bits(v) << ((4 * j + 2 * h) & 31);
    if ((j & 7) == 7 && h == 1) {
      v2[j >> 3] = cur;
      cur = 0u;
    }
  }
  __device__ __forceinline__ bool live(int a, int i) const {
    return (words(a)[(i >> 5) * WG + t] >> (i & 31)) & 1u;
  }
  __device__ __forceinline__ bool live_v2(int i) const { return (v2[i >> 5] >> (i & 31)) & 1u; }
};

// rows [row0, row0 + nvalid) of dst [*, width] from the buffer, whose
// logical 64-column block b sits at block (b + rot) % 4; 16 bytes a store
__device__ __forceinline__ void store_act(const unsigned char* abuf, int rot, bf16* dst,
                                          int width, long long row0, int nvalid, int t128) {
  const int nq = width / 8;
  for (int i = t128; i < nvalid * nq; i += WG) {
    const int r = i / nq, q = i - r * nq;
    const uint4 v = *reinterpret_cast<const uint4*>(abuf + (((q >> 3) + rot) & 3) * BLOCK +
                                                    hopper::swz(r, q & 7));
    reinterpret_cast<uint4*>(dst + (row0 + r) * width)[q] = v;
  }
}

// the encode rows [sin | cos | x 1 0 ...] (G1 columns) of the dW product
// enc^T g_h1 from the encode in the buffer: its column 67 (zero there)
// becomes the ones that give db1
__device__ __forceinline__ void store_enc(const unsigned char* abuf, bf16* dst, long long row0,
                                          int nvalid, int t128) {
  constexpr int nq = G1 / 8;
  for (int i = t128; i < nvalid * nq; i += WG) {
    const int r = i / nq, q = i - r * nq;
    uint4 v = *reinterpret_cast<const uint4*>(abuf + (q >> 3) * BLOCK + hopper::swz(r, q & 7));
    if (q == (2 * KPB + 3) / 8) reinterpret_cast<bf16*>(&v)[3] = __float2bfloat16_rn(1.0f);
    reinterpret_cast<uint4*>(dst + (row0 + r) * G1)[q] = v;
  }
}

// K3: rows [row0, row0 + nvalid) of src [*, width] into the buffer as an
// A operand (swizzled), zero past nvalid rows and past width up to NH
// columns; committed, not waited for
template <int NH>
__device__ __forceinline__ void load_act(unsigned char* abuf, const bf16* src, int width,
                                         long long row0, int nvalid, int t128) {
  constexpr int NQ = NH / 8;
  for (int i = t128; i < 64 * NQ; i += WG) {
    const int r = i / NQ, q = i - r * NQ;
    const bool ok = r < nvalid && q * 8 < width;
    hopper::cp_async16(hopper::smem_u32(abuf + (q >> 3) * BLOCK + hopper::swz(r, q & 7)),
                       ok ? src + (row0 + r) * width + q * 8 : src, ok ? 16 : 0);
  }
  hopper::cp_async_commit();
}

// the mask of an activation in the buffer (activation a of m, or v2 with a
// < 0), read in the accumulator layout
template <int NH>
__device__ __forceinline__ void mask_of(const unsigned char* abuf, int rl, Masks<NH>& m, int a) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < NH / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bf2 v = get2(abuf, rl + 8 * h, 8 * j + c2);
      if (a < 0)
        m.set_v2(j, h, v);
      else
        m.set(a, j, h, v);
    }
}

// f(ray, r0, r1, fresh) for each ray's rows [r0, r1) among the tile's
// first nvalid rows (global rows row0 ..), in order; fresh if r0 is the
// ray's first row (its earlier rows are the previous tile's otherwise)
template <class Fn>
__device__ __forceinline__ void for_segments(long long row0, int nvalid, int S, Fn f) {
  long long ray = row0 / S;
  int first = (int)(row0 - ray * S);
  for (int r0 = 0; r0 < nvalid; ++ray) {
    const int r1 = min(nvalid, r0 + S - first);
    f(ray, r0, r1, first == 0);
    r0 = r1;
    first = 0;
  }
}

// The per-ray sums of the tile's first nvalid rows (global rows row0 ..)
// of this thread's column pair c0, c0 + 1 of the buffer (width columns):
// each ray's f32 sum over its rows in this tile, in row order, to out
// [R, width]; a ray's first rows store, its later rows (the next tile's)
// add.  The warpgroup owns its rays, so no other thread writes them.
__device__ __forceinline__ void ray_sums(const unsigned char* abuf, int c0, int width,
                                         long long row0, int nvalid, int S, float* out) {
  if (c0 >= width) return;
  for_segments(row0, nvalid, S, [&](long long ray, int r0, int r1, bool fresh) {
    float2* const o = reinterpret_cast<float2*>(out + ray * width + c0);
    const float2 before = fresh ? make_float2(0.0f, 0.0f) : *o;
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) {
      const float2 v = __bfloat1622float2(get2(abuf, r, c0));
      s0 += v.x;
      s1 += v.y;
    }
    *o = fresh ? make_float2(s0, s1) : make_float2(before.x + s0, before.y + s1);
  });
}

// the same for column j of the tile's g [64, 4] (f32), into out [R, n]
// at column jo
__device__ __forceinline__ void ray_sums_g(const float* gS, int j, int n, int jo,
                                           long long row0, int nvalid, int S, float* out) {
  for_segments(row0, nvalid, S, [&](long long ray, int r0, int r1, bool fresh) {
    float* const o = out + ray * n + jo;
    const float before = fresh ? 0.0f : *o;
    float s = 0.0f;
#pragma unroll 8
    for (int r = r0; r < r1; ++r) s += gS[r * 4 + j];
    *o = fresh ? s : before + s;
  });
}

// The weight-gradient sums that stay in the row pass, over the
// warpgroup's rows, one column pair a thread: dwos = h2^T cd(g_sig), dwr
// = v2^T cd(g_rgb), dbd2 = the column sums of g_v2.  Each runs on in the
// warpgroup's row of the slab, [dwos H | dwr H x 3 | dbd2 H], which only
// this thread touches at these columns: each tile reads its sums (from 0
// on the first tile), adds the tile's rows in order and writes them back,
// so no register holds them across the products.
struct Narrow {
  float* row;  // the warpgroup's slab row
  int c0, H;
  bool first;  // the warpgroup's first tile
  __device__ __forceinline__ bool idle() const { return c0 >= H; }
  __device__ __forceinline__ float2 get(int off) const {
    return first ? make_float2(0.0f, 0.0f) : *reinterpret_cast<const float2*>(row + off);
  }
  __device__ __forceinline__ void put(int off, float2 v) const {
    *reinterpret_cast<float2*>(row + off) = v;
  }
  // h2 (in the buffer) against cd(g_sig)
  __device__ __forceinline__ void add_dwos(const unsigned char* abuf, const float4* gS,
                                           int nvalid) const {
    if (idle()) return;
    float2 d = get(c0);
    for (int r = 0; r < nvalid; ++r) {
      const float2 a = __bfloat1622float2(get2(abuf, r, c0));
      const float gs = rbf(gS[r].w);
      d.x = fmaf(a.x, gs, d.x);
      d.y = fmaf(a.y, gs, d.y);
    }
    put(c0, d);
  }
  // v2 (in the buffer) against cd(g_rgb)
  __device__ __forceinline__ void add_dwr(const unsigned char* abuf, const float4* gS,
                                          int nvalid) const {
    if (idle()) return;
    const float2 d0 = get(H + 3 * c0), d1 = get(H + 3 * c0 + 2), d2 = get(H + 3 * c0 + 4);
    // [column c0: j 0 1 2 | column c0 + 1: j 0 1 2]
    float d[2][3] = {{d0.x, d0.y, d1.x}, {d1.y, d2.x, d2.y}};
    for (int r = 0; r < nvalid; ++r) {
      const float2 a = __bfloat1622float2(get2(abuf, r, c0));
      const float4 gv = gS[r];
      const float g3[3] = {rbf(gv.x), rbf(gv.y), rbf(gv.z)};
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        d[0][j] = fmaf(a.x, g3[j], d[0][j]);
        d[1][j] = fmaf(a.y, g3[j], d[1][j]);
      }
    }
    put(H + 3 * c0, make_float2(d[0][0], d[0][1]));
    put(H + 3 * c0 + 2, make_float2(d[0][2], d[1][0]));
    put(H + 3 * c0 + 4, make_float2(d[1][1], d[1][2]));
  }
  // g_v2 (in the buffer)
  __device__ __forceinline__ void add_dbd2(const unsigned char* abuf, int nvalid) const {
    if (idle()) return;
    float2 d = get(4 * H + c0);
    for (int r = 0; r < nvalid; ++r) {
      const float2 a = __bfloat1622float2(get2(abuf, r, c0));
      d.x += a.x;
      d.y += a.y;
    }
    put(4 * H + c0, d);
  }
};

// What a warpgroup knows of its current tile.
struct Tile {
  long long row0;
  int nvalid;
  int c0;  // the thread's column pair of the buffer's sums
};

// K2's hooks on K1's chain: the relu masks, the dW operands (encode, h1
// h2 feat v1) stored from the buffer while the next product runs, dwos,
// and the next tile's rows staged once v1 has read this tile's.
template <int NH, int NS>
struct K2Hooks : NoHooks {
  const BArgs& p;
  const Warpgroup& w;
  const Tile& t;
  Masks<NH>& m;
  Narrow& nw;
  const float4* gS;
  long long lim;
  bool has_next;
  __device__ K2Hooks(const BArgs& p_, const Warpgroup& w_, const Tile& t_, Masks<NH>& m_,
                     Narrow& nw_, const float4* gS_, long long lim_, bool has_next_)
      : p(p_), w(w_), t(t_), m(m_), nw(nw_), gS(gS_), lim(lim_), has_next(has_next_) {}
  __device__ __forceinline__ bool reads_across() const { return p.need_dw; }
  __device__ __forceinline__ void encoded() {
    if (!p.need_dw) return;
    store_enc(w.abuf, p.enc, t.row0, t.nvalid, w.t128);
    hopper::named_bar_sync(w.bar, WG);  // before layer 1 writes the buffer
  }
  __device__ __forceinline__ void h1(int j, int h, bf2 v) { m.set(MH1, j, h, v); }
  __device__ __forceinline__ void h2(int j, int h, bf2 v) { m.set(MH2, j, h, v); }
  __device__ __forceinline__ void v1(int j, int h, bf2 v) { m.set(MV1, j, h, v); }
  __device__ __forceinline__ void v2(int j, int h, bf2 v) { m.set_v2(j, h, v); }
  __device__ __forceinline__ void during_h2() {
    if (p.need_dw)
      store_act(w.abuf, h1_rot<NH>(), p.fwd[0], p.f.H, t.row0, t.nvalid, w.t128);
  }
  __device__ __forceinline__ void during_feat() {
    if (!p.need_dw) return;
    nw.add_dwos(w.abuf, gS, t.nvalid);
    store_act(w.abuf, 0, p.fwd[1], p.f.H, t.row0, t.nvalid, w.t128);
  }
  __device__ __forceinline__ void during_v1() {
    if (p.need_dw) store_act(w.abuf, 0, p.fwd[2], p.f.SC, t.row0, t.nvalid, w.t128);
  }
  __device__ __forceinline__ void after_v1() {
    if (has_next) stage_rows<NH, NS>(p.f, w, t.row0 + ROWS, lim);
  }
  __device__ __forceinline__ void during_v2() {
    if (p.need_dw) store_act(w.abuf, 0, p.fwd[3], p.f.H, t.row0, t.nvalid, w.t128);
  }
};

// The backward of one tile from g in gS and the masks: the cotangent
// chain, each product a wgmma over its streamed chunks with the next
// operand written from its registers into the buffer, then g_pts.  While
// each product's first chunk runs, the threads sum the product's input
// (in the buffer) over the tile's rays and store it as a dW operand.
template <int NH, int NS>
__device__ __forceinline__ void backward(const BArgs& p, Warpgroup& w, const Tile& t,
                                         const Masks<NH>& m, Narrow& nw, const float4* gS,
                                         const float* wrs, float* acc) {
  const int H = p.f.H, SC = p.f.SC, S = p.f.S, rl = w.rl;
  const int c2 = 2 * (threadIdx.x & 3);
  const bool need_dw = p.need_dw;
  auto after_product = [&](bool across) {
    if (across) hopper::named_bar_sync(w.bar, WG);
  };

  // g_v2 = live(v2) * cd(cd(g_rgb) @ wr^T): three f32 FMAs a column
  {
    float gr[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 gv = gS[rl + 8 * h];
      gr[h][0] = rbf(gv.x);
      gr[h][1] = rbf(gv.y);
      gr[h][2] = rbf(gv.z);
    }
#pragma unroll
    for (int j = 0; j < NH / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c2 + e;
          float a = fmaf(gr[h][0], wrs[c], 0.0f);
          a = fmaf(gr[h][1], wrs[NH + c], a);
          a = fmaf(gr[h][2], wrs[2 * NH + c], a);
          v[e] = m.live_v2(4 * j + 2 * h + e) ? a : 0.0f;
        }
        put2(w.abuf, rl + 8 * h, 8 * j + c2, pack(v[0], v[1]));
      }
  }
  publish(w);

  // g_v1 = live(v1) * cd(g_v2 @ wd2^T); meanwhile dbd2, g_v2 stored, and
  // the per-ray sums of g_rgb and g_sig
  product<NH, NH, 0, RING>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() {
    // g's columns on lane 0 of each warp
    const float* g4 = reinterpret_cast<const float*>(gS);
    const int j = w.t128 >> 5;
    if ((w.t128 & 31) == 0) {
      if (j < 3)
        ray_sums_g(g4, j, 3, j, t.row0, t.nvalid, S, p.gzt1p);
      else
        ray_sums_g(g4, 3, 1, 0, t.row0, t.nvalid, S, p.gsigp);
    }
    if (!need_dw) return;
    nw.add_dbd2(w.abuf, t.nvalid);
    store_act(w.abuf, 0, p.cot[4], H, t.row0, t.nvalid, w.t128);
  });
  after_product(need_dw);
  store_pairs<NH>(acc, w.abuf, rl, [&](int j, int, int h, float v0, float v1) {
    const int i = 4 * j + 2 * h;
    return pack(m.live(MV1, i) ? v0 : 0.0f, m.live(MV1, i + 1) ? v1 : 0.0f);
  });
  publish(w);

  // g_feat = cd(g_v1 @ wd^T); meanwhile g_v1's ray sums (gdirp)
  product<NS, NH, 0, RING>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() {
    ray_sums(w.abuf, t.c0, H, t.row0, t.nvalid, S, p.gdirp);
    if (need_dw) store_act(w.abuf, 0, p.cot[3], H, t.row0, t.nvalid, w.t128);
  });
  after_product(true);
  store_pairs<NS>(acc, w.abuf, rl,
                  [&](int, int, int, float v0, float v1) { return pack(v0, v1); });
  publish(w);

  // g_h2 = live(h2) * cd(cd(g_feat @ wof^T) + cd(cd(g_sig) * wos));
  // meanwhile g_feat's ray sums (gfeatp)
  product<NH, NS, 0, RING>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() {
    ray_sums(w.abuf, t.c0, SC, t.row0, t.nvalid, S, p.gfeatp);
    if (need_dw) store_act(w.abuf, 0, p.cot[2], SC, t.row0, t.nvalid, w.t128);
  });
  after_product(true);
  {
    const float gs[2] = {rbf(gS[rl].w), rbf(gS[rl + 8].w)};
    const float* const wos = wrs + 3 * NH;
    store_pairs<NH>(acc, w.abuf, rl, [&](int j, int c, int h, float v0, float v1) {
      const int i = 4 * j + 2 * h;
      const float t0 = rbf(rbf(v0) + rbf(gs[h] * wos[c]));
      const float t1 = rbf(rbf(v1) + rbf(gs[h] * wos[c + 1]));
      return pack(m.live(MH2, i) ? t0 : 0.0f, m.live(MH2, i + 1) ? t1 : 0.0f);
    });
  }
  publish(w);

  // g_h1 = live(h1) * cd(g_h2 @ w2^T); meanwhile g_h2's ray sums (gzs1p)
  product<NH, NH, 0, RING>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() {
    ray_sums(w.abuf, t.c0, H, t.row0, t.nvalid, S, p.gzs1p);
    if (need_dw) store_act(w.abuf, 0, p.cot[1], H, t.row0, t.nvalid, w.t128);
  });
  after_product(true);
  store_pairs<NH>(acc, w.abuf, rl, [&](int j, int, int h, float v0, float v1) {
    const int i = 4 * j + 2 * h;
    return pack(m.live(MH1, i) ? v0 : 0.0f, m.live(MH1, i + 1) ? v1 : 0.0f);
  });
  publish(w);

  // [g_sn | g_cs | g_x] = cd(g_h1 @ [w1s; w1c; w1x]^T) into the buffer's
  // first 80 columns (sin at 0, cos at 32, x at 64)
  product<G1, NH, 0, RING>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() {
    if (need_dw) store_act(w.abuf, 0, p.cot[0], H, t.row0, t.nvalid, w.t128);
  });
  after_product(need_dw);
  store_pairs<G1>(acc, w.abuf, rl,
                  [&](int, int, int, float v0, float v1) { return pack(v0, v1); });
  hopper::named_bar_sync(w.bar, WG);

  // g_pts[c] = sum_k f_k (g_sn cos - g_cs sin)[3k + c] (+ g_x[c]): f32
  // multiplies and adds in band order with the unrounded sin and cos
  for (int i = w.t128; i < t.nvalid * 3; i += WG) {
    const int r = i / 3, c = i - r * 3;
    const float x = w.ptsS[r * 3 + c];
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < KPB / 3; ++k) {
      if (k < p.f.F) {
        const float f = __ldg(p.f.bands + k);
        float s, co;
        sincosf(__fmul_rn(x, f), &s, &co);
        const int j = 3 * k + c;
        const float gsn = __bfloat162float(*reinterpret_cast<const bf16*>(w.abuf + at(r, j)));
        const float gcs =
            __bfloat162float(*reinterpret_cast<const bf16*>(w.abuf + at(r, KPB + j)));
        a = __fadd_rn(a, __fmul_rn(f, __fsub_rn(__fmul_rn(gsn, co), __fmul_rn(gcs, s))));
      }
    }
    if (p.has_x)
      a = __fadd_rn(a, __bfloat162float(*reinterpret_cast<const bf16*>(w.abuf + at(r, 2 * KPB + c))));
    p.g_pts[(t.row0 + r) * 3 + c] = a;
  }
  // every thread is past its reads of the tile's points and buffer
  hopper::named_bar_sync(w.bar, WG);
}

// A consumer warpgroup: the rows of its own whole rays,
// even_ranges(R, 2 G)[2 block + wg], in 64-row tiles; both warpgroups of
// a block walk `tiles` tiles (the larger count of the two), so they take
// the ring's chunks together, the shorter one on empty tiles at its end.
template <int NH, int NS, bool RECOMPUTE>
__device__ __forceinline__ void consume(const BArgs& p, unsigned char* base, const Layout& L,
                                        long long tiles) {
  const int wg = threadIdx.x / WG, t128 = threadIdx.x % WG;
  Warpgroup w;
  w.t128 = t128;
  w.bar = 1 + wg;
  w.rl = (t128 >> 5) * 16 + ((t128 & 31) >> 2);
  w.abuf = base + L.act + wg * L.act_wg;
  w.ptsS = reinterpret_cast<float*>(base + L.pts) + wg * 192;
  w.a_s = hopper::smem_u32(w.abuf);
  w.ring_s = hopper::smem_u32(base);
  w.stage = L.stage;
  w.bars = hopper::smem_u32(base + L.bars);
  w.b1S = reinterpret_cast<const bf16*>(base + L.bias);
  w.bd2S = w.b1S + NH;
  w.zsS = reinterpret_cast<bf16*>(base + L.rows) + wg * RMAX * (2 * NH + NS);
  w.ftS = w.zsS + RMAX * NH;
  w.drS = w.ftS + RMAX * NS;
  w.seq = 0;
  const FwdArgs& f = p.f;
  float4* const gS = reinterpret_cast<float4*>(base + L.g) + wg * 64;
  const float* const wrs = reinterpret_cast<const float*>(base + L.wrs);
  const long long lane = 2LL * blockIdx.x + wg, lanes = 2LL * gridDim.x;
  const long long rowA = lane * f.R / lanes * f.S, rowB = (lane + 1) * f.R / lanes * f.S;

  float acc[128];
  float pf[2];
  Masks<NH> m;
  m.sm = reinterpret_cast<uint32_t*>(base + L.masks) + wg * 3 * (NH / 64) * WG;
  m.t = t128;
  m.cur = 0u;
  Narrow nw;
  nw.row = p.small + lane * 5 * f.H;
  nw.c0 = 2 * t128;
  nw.H = f.H;
  Tile t;
  t.c0 = 2 * t128;
  fetch_pts(f, rowA, rowB, t128, pf);
  if (RECOMPUTE) stage_rows<NH, NS>(f, w, rowA, rowB);

  for (long long i = 0; i < tiles; ++i) {
    t.row0 = rowA + i * ROWS;
    const long long left = rowB - t.row0;
    t.nvalid = left <= 0 ? 0 : (left < ROWS ? (int)left : ROWS);
    nw.first = i == 0;
    put_pts(w, pf);
    if (t128 < 64)
      gS[t128] = t128 < t.nvalid ? __ldg(reinterpret_cast<const float4*>(p.g) + t.row0 + t128)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    hopper::cp_async_wait<0>();
    hopper::named_bar_sync(w.bar, WG);
    if (i + 1 < tiles) fetch_pts(f, t.row0 + ROWS, rowB, t128, pf);
    if (RECOMPUTE) {
      // K1's chain again, with its masks
      const TileRows tr = tile_rays<NH, NS>(f, w, t.row0, rowB);
      K2Hooks<NH, NS> hk(p, w, t, m, nw, gS, rowB, i + 1 < tiles);
      forward<NH, NS, RING>(f, w, tr, acc, hk);
      if (p.need_dw) {
        nw.add_dwr(w.abuf, gS, t.nvalid);
        hopper::named_bar_sync(w.bar, WG);  // before g_v2 takes the buffer
      }
    } else {
      // the forward's activations, one at a time through the buffer:
      // their masks, and v2 and h2 for dwr and dwos
      const bf16* const srcs[4] = {p.act[3], p.act[1], p.act[2], p.act[0]};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        load_act<NH>(w.abuf, srcs[a], f.H, t.row0, t.nvalid, t128);
        hopper::cp_async_wait<0>();
        hopper::named_bar_sync(w.bar, WG);
        mask_of<NH>(w.abuf, w.rl, m, a == 0 ? -1 : a == 1 ? MH2 : a == 2 ? MV1 : MH1);
        if (p.need_dw && a == 0) nw.add_dwr(w.abuf, gS, t.nvalid);
        if (p.need_dw && a == 1) nw.add_dwos(w.abuf, gS, t.nvalid);
        hopper::named_bar_sync(w.bar, WG);
      }
      if (p.need_dw) {
        // the encode for enc^T g_h1
        encode(f, w.abuf, w.ptsS, t128);
        hopper::named_bar_sync(w.bar, WG);
        store_enc(w.abuf, p.enc, t.row0, t.nvalid, t128);
        hopper::named_bar_sync(w.bar, WG);
      }
    }
    backward<NH, NS>(p, w, t, m, nw, gS, wrs, acc);
  }
}

// The producer thread: every chunk of every tile, in the chain's order
// (plan.py::k2_chunks): K2 first K1's forward chunks, then the cotangent
// products' (N = NH, NS, NH, NH, G1).
template <int NH, int NS, bool RECOMPUTE>
__device__ __forceinline__ void produce(const BArgs& p, uint32_t ring_s, uint32_t bars,
                                        int stage_bytes, long long tiles) {
  constexpr int kc[10] = {2,       NH / 64, NH / 64, NS / 64, NH / 64,
                          NH / 64, NH / 64, NS / 64, NH / 64, NH / 64};
  constexpr int nb[10] = {NH * 128, NH * 128, NS * 128, NH * 128, NH * 128,
                          NH * 128, NS * 128, NH * 128, NH * 128, G1 * 128};
  constexpr int first = RECOMPUTE ? 0 : 5;
  uint32_t seq = 0;
  for (long long t = 0; t < tiles; ++t) {
    const unsigned char* src = p.img;
#pragma unroll
    for (int l = first; l < 10; ++l)
#pragma unroll
      for (int c = 0; c < kc[l]; ++c, ++seq) {
        produce_chunk<RING>(src, nb[l], ring_s, bars, stage_bytes, seq);
        src += nb[l];
      }
  }
}

template <int NH, int NS, bool RECOMPUTE>
__global__ void __launch_bounds__(THREADS, 1) trunk_bwd_rows_wgmma(const BArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout L = layout(NH, NS, RECOMPUTE);
  const uint32_t bars = hopper::smem_u32(base + L.bars);
  const int tid = threadIdx.x, H = p.f.H, S = p.f.S;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      hopper::mbar_init(full_bar(bars, s), 1);
      hopper::mbar_init(empty_bar<RING>(bars, s), 2 * WG);
    }
    hopper::fence_barrier_init();
  }
  // wr's columns and wos in f32, b1 and bd2 (K2), zero past H
  float* const wrs = reinterpret_cast<float*>(base + L.wrs);
  for (int c = tid; c < NH; c += THREADS) {
    const bool in = c < H;
#pragma unroll
    for (int j = 0; j < 3; ++j) wrs[j * NH + c] = in ? __bfloat162float(p.wr[c * 3 + j]) : 0.0f;
    wrs[3 * NH + c] = in ? __bfloat162float(p.wos[c]) : 0.0f;
    if (RECOMPUTE) {
      bf16* const bias = reinterpret_cast<bf16*>(base + L.bias);
      bias[c] = in ? p.b1[c] : __float2bfloat16_rn(0.0f);
      bias[NH + c] = in ? p.bd2[c] : __float2bfloat16_rn(0.0f);
    }
  }
  hopper::fence_async_smem();
  __syncthreads();
  // the block's tiles: the larger of its two warpgroups' counts
  long long tiles = 0;
  for (int wg = 0; wg < 2; ++wg) {
    const long long lane = 2LL * blockIdx.x + wg, lanes = 2LL * gridDim.x;
    const long long rows = ((lane + 1) * p.f.R / lanes - lane * p.f.R / lanes) * S;
    const long long n = (rows + ROWS - 1) / ROWS;
    tiles = n > tiles ? n : tiles;
  }
  if (tid >= 2 * WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 2 * WG) produce<NH, NS, RECOMPUTE>(p, hopper::smem_u32(base), bars, L.stage, tiles);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    consume<NH, NS, RECOMPUTE>(p, base, L, tiles);
  }
}

template <int NH, int NS, bool RECOMPUTE>
int launch(const BArgs& p, int grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_rows_wgmma<NH, NS, RECOMPUTE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the smallest shared-memory carve-out that holds the block (percent of
  // the largest, 228 KB), so the rest of the SM's 256 KB is L1
  e = cudaFuncSetAttribute(trunk_bwd_rows_wgmma<NH, NS, RECOMPUTE>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (smem + 1024) * 100 / (228 * 1024) + 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  trunk_bwd_rows_wgmma<NH, NS, RECOMPUTE><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <bool RECOMPUTE>
int launch_widths(const BArgs& p, int NH, int NS, int grid, int smem, cudaStream_t st) {
  if (NH > 128)
    return NS > 128 ? launch<256, 256, RECOMPUTE>(p, grid, smem, st)
                    : launch<256, 128, RECOMPUTE>(p, grid, smem, st);
  return NS > 128 ? launch<128, 256, RECOMPUTE>(p, grid, smem, st)
                  : launch<128, 128, RECOMPUTE>(p, grid, smem, st);
}

}  // namespace rows_wgmma

extern "C" {

const char* trunk_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The row pass: K2's (the forward again, activations stored in the act
// buffers) if recompute, else K3's (the forward's activations read).
int trunk_bwd_rows(const void* const* in, void* const* out, const int* dims, int f32,
                   int recompute, void* stream) {
  if (f32)
    return recompute ? launch_rows<float, true>(in, out, dims, stream)
                     : launch_rows<float, false>(in, out, dims, stream);
  return recompute ? launch_rows<bf16, true>(in, out, dims, stream)
                   : launch_rows<bf16, false>(in, out, dims, stream);
}

// The bf16 wgmma row pass (plan.py::k2_plan's "wgmma" route): K2's (K1's
// chain again first) if recompute, else K3's (the forward's activations
// read); with need_dw it also writes the dW operands and the narrow slab.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue if
// the plan does not match this file.
// in:   pts zs1p featp dirp bands b1 bd2 wos wr g img h1 h2 v1 v2 (K2: no
//       h1..v2; K3: no zs1p featp dirp b1 bd2)
// out:  g_pts gzs1p gfeatp gsigp gdirp gzt1p enc h1 h2 feat v1 g_h1 g_h2
//       g_feat g_v1 g_v2 small (enc and after: with need_dw; h1..v1: K2)
// dims: R S H SC F has_x, then plan.py::k2_plan's smem grid nh ns
//       image_bytes
int trunk_bwd_wgmma(const void* const* in, void* const* out, const long long* dims,
                    int recompute, int need_dw, void* stream) {
  using namespace rows_wgmma;
  const long long R = dims[0];
  const int S = (int)dims[1], H = (int)dims[2], SC = (int)dims[3], F = (int)dims[4];
  const int smem = (int)dims[6], grid = (int)dims[7];
  const int NH = wgmma_width(H), NS = wgmma_width(SC);
  const bool widths = H % 32 == 0 && SC % 32 == 0 && H >= 32 && SC >= 32 && H <= 256 &&
                      SC <= 256 && F >= 1 && 3 * F <= KPB && S >= 1 && R >= 1;
  if (!widths || smem != layout(NH, NS, recompute != 0).total || grid < 1 || grid > R ||
      dims[8] != NH || dims[9] != NS || dims[10] != image_bytes(NH, NS, recompute != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BArgs p;
  p.f.pts = static_cast<const float*>(in[0]);
  p.f.zs1p = static_cast<const bf16*>(in[1]);
  p.f.featp = static_cast<const bf16*>(in[2]);
  p.f.dirp = static_cast<const bf16*>(in[3]);
  p.f.bands = static_cast<const float*>(in[4]);
  p.f.R = R;
  p.f.S = S;
  p.f.H = H;
  p.f.SC = SC;
  p.f.F = F;
  p.b1 = static_cast<const bf16*>(in[5]);
  p.bd2 = static_cast<const bf16*>(in[6]);
  p.wos = static_cast<const bf16*>(in[7]);
  p.wr = static_cast<const bf16*>(in[8]);
  p.g = static_cast<const float*>(in[9]);
  p.img = static_cast<const unsigned char*>(in[10]);
  for (int k = 0; k < 4; ++k) p.act[k] = static_cast<const bf16*>(in[11 + k]);
  p.g_pts = static_cast<float*>(out[0]);
  p.gzs1p = static_cast<float*>(out[1]);
  p.gfeatp = static_cast<float*>(out[2]);
  p.gsigp = static_cast<float*>(out[3]);
  p.gdirp = static_cast<float*>(out[4]);
  p.gzt1p = static_cast<float*>(out[5]);
  p.enc = static_cast<bf16*>(out[6]);
  for (int k = 0; k < 4; ++k) p.fwd[k] = static_cast<bf16*>(out[7 + k]);
  for (int k = 0; k < 5; ++k) p.cot[k] = static_cast<bf16*>(out[11 + k]);
  p.small = static_cast<float*>(out[16]);
  p.has_x = (int)dims[5];
  p.need_dw = need_dw;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return recompute ? launch_widths<true>(p, NH, NS, grid, smem, st)
                   : launch_widths<false>(p, NH, NS, grid, smem, st);
}

// The dW products (xtg.cuh) and their reduction.
int trunk_bwd_xtg(const long long* plan, int n, int f32, void* stream) {
  return xtg::run(plan, n, f32, stream);
}

// The narrow grads' slabs summed in block order.
int trunk_bwd_sum(const long long* rows, int n, void* stream) {
  return xtg::sum_parts(rows, n, stream);
}

}  // extern "C"
