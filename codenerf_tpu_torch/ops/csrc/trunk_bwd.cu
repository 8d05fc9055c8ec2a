// K2 and K3: the fused CodeNeRF trunk backward for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused.py::_trunk_bwd_impl,
// launched by _trunk_bwd_pallas: K2 is its recompute form (stored=False,
// the VJP of make_fused_codenerf(pallas_backward=True)), K3 its
// stored-activation form (stored=True, the VJP of make_hybrid_codenerf).
// One template, trunk_bwd_rows_kernel<T, RECOMPUTE>, holds both row passes;
// both then run the same weight-gradient products (xtg.cuh).
//
// For every sample row it takes g = d loss / d raw [R*S, 4] f32 back through
// the trunk K1 computes (trunk_fwd.cu) and emits
//
//   g_pts [R*S, 3]                         f32
//   gzs1p gfeatp gsigp gdirp gzt1p [R, .]  f32 sums over each ray's S rows
//   dw1s dw1c dw1x dw2 dwof dwos dwd dwd2 dwr, db1, dbd2   f32
//
// with the TPU kernel's cast points for the compute type cd (bf16, or f32
// where every rounding to cd is exact and the products run on the CUDA
// cores, no TF32):
//   * K2's relu masks, float(act) > 0, come from activations recomputed by
//     K1's own code (trunk_common.cuh), bit for bit; K3 reads them from the
//     forward.  Both rederive the encode: sincosf(__fmul_rn(x_c, f_k)), no
//     fast math.
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
// costs ~1.12 MFLOP of bf16 products in the backward (dx and dW products)
// plus ~0.56 MFLOP for K2's recompute; K3 reads 2.5 KB of stored bf16
// activations per row.  Both are far above the card's ~295 FLOP per byte,
// so they are bound by operations: ~5.3 ms (K2) and ~3.6 ms (K3) per
// flagship train step (3.15 M rows) at 989 TFLOP/s.
//
// What held the first design back.  The TPU summed the weight grads in
// output blocks its sequential grid revisits.  The first port kept that sum
// per block: each of ~132 persistent blocks (one per SM: five 64-row
// activations in 165 KB of shared memory) added every tile's dW products
// (wmma 16x16x16, weights from L2) into its own f32 slab of 279,808
// floats, loading and storing the whole slab per tile: ~2.24 MB per tile,
// ~110 GB per flagship step.  The 148 MB of slabs do not fit the 50 MB L2,
// so that traffic went to HBM (~33 ms alone); K2 reached 45 TFLOP/s, 4.5% of
// the bf16 peak, 117 ms per step.
//
// This design takes the weight grads out of the row pass.
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
//      its row range, partials summed in split order; the per-block slabs
//      summed in block order.
// Bytes per flagship step: ~5 KB a row written and read again, ~16 GB, ~5
// ms at 3.35 TB/s, against ~110 GB of slab traffic before; products: the
// same FLOPs.  No atomics: two calls on the same card give the same bits.
// The row pass's products are wmma with weights from L2, as in K1; each
// accumulator's epilogue runs straight from its registers.

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

// The dW products (xtg.cuh) and their reduction.
int trunk_bwd_xtg(const long long* plan, int n, int f32, void* stream) {
  return xtg::run(plan, n, f32, stream);
}

// The narrow grads' slabs summed in block order.
int trunk_bwd_sum(const long long* rows, int n, void* stream) {
  return xtg::sum_parts(rows, n, stream);
}

}  // extern "C"
