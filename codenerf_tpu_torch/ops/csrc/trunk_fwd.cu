// K1: the fused CodeNeRF trunk forward for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused.py::_trunk_kernel (launched
// by _trunk_pallas).  For every sample row of pts [R*S, 3] it computes
//
//   enc  = sin / cos(x_c * f_k)                       exact f32, then cd
//   h1   = relu(cd(cd(cd(sin@w1s) + cd(cos@w1c)) + cd(x@w1x)) + b1)
//   h2   = relu(cd(h1@w2) + zs1p[ray])
//   feat = cd(h2@wof) + featp[ray]                    sigma = f32(cd(h2.wos)) + sigp[ray]
//   v1   = relu(cd(feat@wd) + dirp[ray])
//   v2   = relu(cd(v1@wd2) + bd2)
//   rgb  = f32(cd(v2@wr)) + zt1p[ray]                 raw = [rgb | sigma] f32
//
// with the TPU kernel's cast points for the compute type cd (bf16, or f32
// where every cd() is exact): every product is an f32 sum of cd products
// rounded to cd, and bias / per-ray rows are added in cd.  A row's ray is
// row / S.
//
// The encode argument x_c * f_k is one f32 multiply and sinf / cosf are
// the full-range versions: this file must not be built with
// --use_fast_math, and must not call the fast sine and cosine intrinsics.
// The arguments reach 2^9 * |x| ~ 1e3 rad, where the fast intrinsics lose
// the phase (the TPU kernel hit the same failure with a bf16 encode
// matmul: 2.8 absolute error against 7e-5).
//
// Bound on the H100: at the flagship (h = s = 256, F = 10) a sample costs
// ~0.56 MFLOP of bf16 products and moves 12 B in and 16 B out, plus ~3 KB
// of per-ray rows per ray: ~2e4 FLOP per byte, far above the card's ~295,
// so it is bound by operations.  3.15 M samples per 128x128 image -> ~1.8
// ms at 989 TFLOP/s bf16 dense.
//
// bf16 (trunk_fwd_kernel_wgmma<NH, NS>): a persistent grid of at most one
// block per SM (plan.py::trunk_fwd_wgmma_plan), each walking a range of
// 128-row tiles.  What bounded the first port (wmma fragments on the
// legacy tensor-core path, every weight fragment read from L2 for every
// 64-row tile, a block-wide barrier after every layer, the two heads as
// serial per-thread loops) and what this design does instead:
//   * Products run as wgmma m64nNk16 with f32 accumulators in registers,
//     N the layer's width rounded up to 128 or 256 (the weight images are
//     zero-padded to it; a padded column stays zero through the chain).
//     Two consumer warpgroups own 64 rows each; setmaxnreg gives them 240
//     registers a thread and the producer warpgroup 24.
//   * The weights are streamed, not fetched by fragments: the wrapper
//     packs them once per call into the K-major 128-byte swizzled images of
//     hopper.cuh (ops/fused.py::k1_images), cut into chunks of 64 reduction
//     columns (32 KB at N = 256), and one producer thread streams a tile's
//     18 chunks, in the order the chain reads them, through a ring of 4
//     stages: one 1-D bulk copy (cp.async.bulk) per chunk, completing on
//     the stage's full mbarrier.  Every consumer thread arrives on the
//     stage's empty mbarrier once its warp's wgmma that read the stage is
//     done (a warp's wait covers only its own share of the warpgroup's
//     wgmma).  One chunk serves 128 rows: ~14 GB from L2 per image
//     instead of ~27.
//   * Each layer's epilogue runs in registers (round to bf16, add the
//     per-ray row or bias in bf16, relu) and writes the next layer's A
//     operand into the warpgroup's own swizzled K-major buffer; the wgmma
//     is waited for first, so one buffer per warpgroup serves the whole
//     chain, the encode included.  The per-ray rows of the tile's first
//     RMAX rays are staged in shared memory by cp.async a tile ahead (a
//     later ray's row, at S < 22, is read from device memory), b1 and bd2
//     stay there.  The warpgroups synchronise only on their own named
//     barrier (bar.sync 1 + wg, 128).
//   * Layer 1 keeps the TPU kernel's order: sin@w1s and cos@w1c run at
//     once into the two halves of the accumulator, their rounded sum is
//     kept as bf16 pairs in registers, then x@w1x (zero weights without
//     the input term).  It runs in halves of 128 output columns.
//   * sigma = h2.wos and rgb = v2.wr are wgmma m64n8k16 on the buffer,
//     with the heads' weights resident in shared memory, zero-padded to 8
//     columns.
//   * The first wgmma of every product takes its accumulator as output
//     only (wgmma_nn0), so no accumulator is live between products; with
//     "+f" on every step ptxas ran out of registers and serialised every
//     wgmma (C7511).  Consecutive products that write the same
//     accumulator while the earlier result lived on only in registers lost
//     the later product in ptxas's output (a wrong h1 in development), so
//     layer 1 gives sin and cos their own halves.
// bf16 K2 recomputes this chain with the same code, kept in
// trunk_chain.cuh for its wgmma row pass (trunk_bwd.cu), so K2's relu masks
// are this forward's bit for bit.  This kernel keeps its own copy: built
// from the header's pieces (hooks, a warpgroup struct), ptxas spilled many
// more of its registers and it ran about a third slower, with the same
// outputs.
//
// f32 (trunk_fwd_kernel<float, TM>): one block of 8 warps per 32 rows (16
// or 8 for layers too wide for that tile's buffers, plan.py::row_tile); the
// tile's activations stay in shared memory, in two buffers that the layers
// ping-pong between, and the products run on the CUDA cores (f32 fma, no
// TF32), from trunk_common.cuh, the chain K2 recomputes
// (plan.py::trunk_fwd_plan).
//
// bf16 wider than the wgmma kernel takes (a padded width above 256, or
// more than 10 xyz bands) runs the same row-tile chain in bf16
// (trunk_fwd_kernel<bf16, TM>: 64-row tiles, or 32 / 16 when wider still;
// wmma products with the weights read from L2), the chain K2's recompute
// runs, with K1's cast points.
// plan.py::k1_plan picks it by shape before any launch.

#include "hopper.cuh"
#include "trunk_common.cuh"

using namespace trunk;

namespace {

// ---- bf16: the persistent, warp-specialised wgmma kernel ----

constexpr int TILE = 128;         // rows per tile, 64 per consumer
constexpr int STAGES = 4;         // weight chunks in flight
constexpr int WG = 128;           // threads of a warpgroup
constexpr int THREADS = 3 * WG;   // two consumer warpgroups, one producer
// registers a thread after setmaxnreg: the consumers take what the
// producer gives up (2 x 128 x 240 + 128 x 24 <= 65,536)
constexpr int CONSUMER_REGS = 240;
constexpr int PRODUCER_REGS = 24;
constexpr int BLOCK = 64 * 128;   // 64 rows x 64 bf16 of a buffer
constexpr int HEAD = 8 * 128;     // 8 rows x 64 bf16 of a head's image
// the encode's columns: sin of the 3 F <= 30 arguments at [0, 32), cos at
// [32, 64), the point at [64, 67); the rest of [0, 128) is zero
constexpr int KPB = 32;
// rays whose per-ray rows (zs1p, featp, dirp) a warpgroup stages in shared
// memory per tile; a row of a later ray reads device memory instead
constexpr int RMAX = 4;

// the wgmma N of a layer of output width n (plan.py::k1_wgmma_width)
__host__ __device__ inline int wgmma_width(int n) { return n <= 128 ? 128 : 256; }

// byte offsets from the block's 1024-aligned base (plan.py::k1_smem)
struct Layout {
  int stage;   // one ring stage
  int act_wg;  // one warpgroup's activation buffer
  int act;     // the two buffers
  int heads;   // the sigma and rgb heads' images, [8, NH] K-major each
  int pts;     // each warpgroup's 64 points, f32
  int bias;    // b1 and bd2, bf16 [NH] each
  int rows;    // each warpgroup's staged rows: zs1p [RMAX, NH], featp [RMAX,
               // NS], dirp [RMAX, NH], bf16
  int bars;    // full[STAGES], empty[STAGES]
  int total;   // + alignment slack
};
__host__ __device__ inline Layout layout(int NH, int NS) {
  const int nm = NH > NS ? NH : NS;
  Layout L;
  L.stage = nm * 128;
  L.act_wg = nm / 64 * BLOCK;
  L.act = STAGES * L.stage;
  L.heads = L.act + 2 * L.act_wg;
  L.pts = L.heads + 2 * (NH / 64) * HEAD;
  L.bias = L.pts + 2 * 64 * 3 * 4;
  L.rows = L.bias + 2 * NH * 2;
  L.bars = L.rows + 2 * RMAX * (2 * NH + NS) * 2;
  L.total = L.bars + 2 * STAGES * 8 + 1024;
  return L;
}

// bytes of the packed weight images (plan.py::k1_chunks): the encode's
// 128 columns, w2, wof, wd and wd2, each [N, K] padded to the wgmma widths
__host__ __device__ inline long long image_bytes(int NH, int NS) {
  return 128LL * (NH * (2 + 2 * NH / 64 + NS / 64) + NS * (NH / 64));
}

struct WArgs {
  const float* pts;  // [R*S, 3]
  const bf16* zs1p;  // [R, H]
  const bf16* featp; // [R, SC]
  const bf16* sigp;  // [R, 1]
  const bf16* dirp;  // [R, H]
  const bf16* zt1p;  // [R, 3]
  const bf16* b1;    // [H]
  const bf16* bd2;   // [H]
  const bf16* wos;   // [H]
  const bf16* wr;    // [H, 3]
  const float* bands;
  const unsigned char* img;  // the chunks of plan.py::k1_chunks
  float* out;                // [R*S, 4]
  long long nrows;
  long long tiles;
  int S, H, SC, F;
};

__device__ __forceinline__ uint32_t full_bar(uint32_t bars, uint32_t s) { return bars + s * 8; }
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, uint32_t s) {
  return bars + (STAGES + s) * 8;
}
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// bf16 pairs: the accumulator's two columns rounded, and the adds and
// relus of the epilogues, each rounded once to bf16
typedef __nv_bfloat162 bf2;
__device__ __forceinline__ bf2 pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
__device__ __forceinline__ bf2 relu2(bf2 a) { return __hmax2(a, __float2bfloat162_rn(0.0f)); }
// two bf16 of shared or device memory
__device__ __forceinline__ bf2 pair(const bf16* p) { return *reinterpret_cast<const bf2*>(p); }

// the pair (r, col), (r, col + 1) of a 64-row buffer (col even): 64-column
// block col / 64, row r of 128 bytes, 16-byte chunk (col % 64) / 8 swizzled
__device__ __forceinline__ void put2(unsigned char* abuf, int r, int col, bf2 v) {
  *reinterpret_cast<bf2*>(abuf + (col >> 6) * BLOCK + hopper::swz(r, (col & 63) >> 3) +
                          (col & 7) * 2) = v;
}

// f(j, c, h, v0, v1) for each accumulator pair of this thread: row half
// h (row rl + 8 h of the warpgroup's 64, rl = 16 warp + lane / 4),
// columns c = 8 j + 2 (lane % 4) and c + 1
template <int N, class Fn>
__device__ __forceinline__ void for_pairs(const float* acc, Fn f) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(j, 8 * j + c2, h, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// The epilogue of a hidden layer: [relu](cd(acc) + row_h) for each pair,
// stored to the buffer as the next layer's A; row_h (rowp[h], shared or
// device memory) is the per-ray row or bias of half h's row, zero from
// column n on.  The rows are read eight column groups at a time, ahead of
// the stores.
template <int N, bool RELU>
__device__ __forceinline__ void store_rows(const float* acc, unsigned char* abuf, int rl,
                                           const bf16* const* rowp, int n) {
  const int c2 = 2 * (threadIdx.x & 3);
#pragma unroll
  for (int j0 = 0; j0 < N / 8; j0 += 8) {
    bf2 z[8][2];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * (j0 + jj) + c2;
        z[jj][h] = c < n ? pair(rowp[h] + c) : __float2bfloat162_rn(0.0f);
      }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = j0 + jj;
        const bf2 v = __hadd2(pack(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), z[jj][h]);
        put2(abuf, rl + 8 * h, 8 * j + c2, RELU ? relu2(v) : v);
      }
  }
}

// the same pairs, f's bf16 pair stored to the buffer as the next layer's A
template <int N, class Fn>
__device__ __forceinline__ void store_pairs(const float* acc, unsigned char* abuf, int rl, Fn f) {
  for_pairs<N>(acc, [&](int j, int c, int h, float v0, float v1) {
    put2(abuf, rl + 8 * h, c, f(j, c, h, v0, v1));
  });
}

// acc = A[64, K] W^T over the layer's K / 64 ring chunks (ring chunk seq +
// j holds columns [64 j, 64 j + 64) of W^T), with A's columns [64 j, 64 j
// + 64) in block (j + ROT) % 4 of the warpgroup's buffer.  Every consumer
// thread releases each stage once its warp's wgmma that read it is done
// (the next chunk's in flight): a warp's wait covers only its own share
// of a warpgroup's wgmma.  Also waits for every earlier wgmma group.
// Advances seq.
template <int N, int K, int ROT = 0>
__device__ __forceinline__ void product(float* acc, uint32_t a_s, uint32_t ring_s,
                                        uint32_t stage_bytes, uint32_t bars, uint32_t& seq) {
  constexpr int NK = K / 64;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const uint32_t s = seq + j, st = s % STAGES;
    hopper::mbar_wait(full_bar(bars, st), (s / STAGES) & 1);
    hopper::wgmma_fence();
    const uint32_t b_s = ring_s + st * stage_bytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc(a_s + ((j + ROT) & 3) * BLOCK + kk * 32, 16, 1024);
      const uint64_t db = hopper::desc(b_s + kk * 32, 16, 1024);
      if (j == 0 && kk == 0)
        hopper::wgmma_nn0<N>(acc, da, db);
      else
        hopper::wgmma_nn<N>(acc, da, db);
    }
    hopper::wgmma_commit();
    if (j > 0) {
      hopper::wgmma_wait<1>();
      hopper::mbar_arrive(empty_bar(bars, (s - 1) % STAGES));
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<N / 2>(acc);
  hopper::mbar_arrive(empty_bar(bars, (seq + NK - 1) % STAGES));
  seq += NK;
}

// acc = enc[:, c0:c0+16 KS] W^T[:, c0:c0+16 KS] for one of layer 1's
// products, with W^T's chunk at b_s, waited for.
template <int N, int KS>
__device__ __forceinline__ void l1_product(float* acc, uint32_t a_s, uint32_t b_s, int c0) {
  hopper::wgmma_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const uint64_t da = hopper::desc(a_s + (c0 + 16 * k) * 2, 16, 1024);
    const uint64_t db = hopper::desc(b_s + (c0 + 16 * k) * 2, 16, 1024);
    if (k == 0)
      hopper::wgmma_nn0<N>(acc, da, db);
    else
      hopper::wgmma_nn<N>(acc, da, db);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs<N / 2>(acc);
}

// A narrow head, d[64, 8] = A[64, K] Bh^T, from the warpgroup's buffer
// and the head's resident image; committed, not waited for.
template <int K>
__device__ __forceinline__ void head_product(float* d, uint32_t a_s, uint32_t head_s) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t da = hopper::desc(a_s + (kk >> 2) * BLOCK + (kk & 3) * 32, 16, 1024);
    const uint64_t db = hopper::desc(head_s + (kk >> 2) * HEAD + (kk & 3) * 32, 16, 1024);
    if (kk == 0)
      hopper::wgmma_nn0<8>(d, da, db);
    else
      hopper::wgmma_nn<8>(d, da, db);
  }
  hopper::wgmma_commit();
}

// The producer thread: every chunk of every tile of [t0, t1), in the
// chain's order (plan.py::k1_chunks), into the ring.
template <int NH, int NS>
__device__ __forceinline__ void produce(const WArgs& p, uint32_t ring_s, uint32_t bars,
                                        int stage_bytes, long long t0, long long t1) {
  constexpr int kc[5] = {2, NH / 64, NH / 64, NS / 64, NH / 64};
  constexpr int nb[5] = {NH * 128, NH * 128, NS * 128, NH * 128, NH * 128};
  uint32_t seq = 0;
  for (long long t = t0; t < t1; ++t) {
    const unsigned char* src = p.img;
#pragma unroll
    for (int l = 0; l < 5; ++l)
#pragma unroll
      for (int c = 0; c < kc[l]; ++c, ++seq) {
        const uint32_t st = seq % STAGES;
        hopper::mbar_wait(empty_bar(bars, st), ((seq / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full_bar(bars, st), nb[l]);
        hopper::bulk_copy_g2s(ring_s + st * stage_bytes, src, nb[l], full_bar(bars, st));
        src += nb[l];
      }
  }
}

// the warpgroup's 64 points of a tile (3 floats a row, zero past the
// end): thread t128 holds floats t128 and t128 + 128 of the 192
__device__ __forceinline__ void fetch_pts(const WArgs& p, long long row0, int t128, float* pf) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int i = t128 + m * WG;
    pf[m] = (i < 192 && row0 + i / 3 < p.nrows) ? __ldg(p.pts + row0 * 3 + i) : 0.0f;
  }
}

// The encode of the warpgroup's 64 points (pts [64, 3] in shared memory)
// into its buffer, a bf16 pair a store: column j < 32 is sin of argument
// j = 3 k + c (band k, coordinate c; zero from 3F on), 32 + j its cos, 64
// + c coordinate c (zero from 3 on).
__device__ __forceinline__ void encode(const WArgs& p, unsigned char* abuf, const float* pts,
                                       int t128) {
  const int F3 = 3 * p.F;
#pragma unroll 2
  for (int i = t128; i < 64 * (KPB / 2); i += WG) {
    const int r = i / (KPB / 2), j = 2 * (i % (KPB / 2));
    float s0 = 0.0f, c0 = 0.0f, s1 = 0.0f, c1 = 0.0f;
    if (j < F3) sincosf(__fmul_rn(pts[r * 3 + j % 3], __ldg(p.bands + j / 3)), &s0, &c0);
    if (j + 1 < F3)
      sincosf(__fmul_rn(pts[r * 3 + (j + 1) % 3], __ldg(p.bands + (j + 1) / 3)), &s1, &c1);
    put2(abuf, r, j, pack(s0, s1));
    put2(abuf, r, KPB + j, pack(c0, c1));
  }
  for (int i = t128; i < 64 * (KX / 2); i += WG) {
    const int r = i / (KX / 2), j = 2 * (i % (KX / 2));
    put2(abuf, r, 2 * KPB + j,
         pack(j < 3 ? pts[r * 3 + j] : 0.0f, j + 1 < 3 ? pts[r * 3 + j + 1] : 0.0f));
  }
}

// A consumer warpgroup: rows [64 wg, 64 wg + 64) of every tile.
template <int NH, int NS>
__device__ __forceinline__ void consume(const WArgs& p, unsigned char* base, const Layout& L,
                                        long long t0, long long t1) {
  constexpr int H1_ROT = NH > 128 ? 2 : 0;  // h1's blocks, see layer 1
  const int wg = threadIdx.x / WG, t128 = threadIdx.x % WG, bar = 1 + wg;
  const int rl = (t128 >> 5) * 16 + ((t128 & 31) >> 2);  // row of half 0
  const int H = p.H, SC = p.SC;
  unsigned char* const abuf = base + L.act + wg * L.act_wg;
  float* const ptsS = reinterpret_cast<float*>(base + L.pts) + wg * 192;
  const uint32_t a_s = hopper::smem_u32(abuf), ring_s = hopper::smem_u32(base);
  const uint32_t bars = hopper::smem_u32(base + L.bars);
  const uint32_t sig_s = hopper::smem_u32(base + L.heads), rgb_s = sig_s + NH / 64 * HEAD;
  const bf16* const b1S = reinterpret_cast<const bf16*>(base + L.bias);  // b1, then bd2
  const bf16* const bd2S = b1S + NH;
  const bf16* const bd2p[2] = {bd2S, bd2S};
  // the staged rows of rays rb .. rb + RMAX - 1 of this warpgroup's tile
  bf16* const zsS = reinterpret_cast<bf16*>(base + L.rows) + wg * RMAX * (2 * NH + NS);
  bf16* const ftS = zsS + RMAX * NH;
  bf16* const drS = ftS + RMAX * NS;
  const long long R = p.nrows / p.S;
  // cp.async the rows of the RMAX rays from the one of row row0 on (zero
  // past the last ray)
  auto stage_rows = [&](long long row0) {
    const long long rb = (row0 < p.nrows ? row0 : p.nrows - 1) / p.S;
    const int vh = H / 8, vs = SC / 8, per = 2 * vh + vs;
    for (int i = t128; i < RMAX * per; i += WG) {
      const int r = i / per, v = i - r * per;
      const long long ray = rb + r;
      const bf16* src;
      bf16* dst;
      if (v < vh) {
        src = p.zs1p + ray * H + v * 8;
        dst = zsS + r * NH + v * 8;
      } else if (v < vh + vs) {
        src = p.featp + ray * SC + (v - vh) * 8;
        dst = ftS + r * NS + (v - vh) * 8;
      } else {
        src = p.dirp + ray * H + (v - vh - vs) * 8;
        dst = drS + r * NH + (v - vh - vs) * 8;
      }
      hopper::cp_async16(hopper::smem_u32(dst), ray < R ? src : p.zs1p, ray < R ? 16 : 0);
    }
    hopper::cp_async_commit();
  };
  float acc[128];          // N / 2 a layer; layer 1 uses both halves
  bf2 part[32];            // layer 1's running sum, bf16 pairs
  float sacc[4], racc[4];  // the heads (column 0 sigma; columns 0-2 rgb)
  uint32_t seq = 0;        // ring chunks consumed
  float pf[2];
  fetch_pts(p, t0 * TILE + wg * 64, t128, pf);
  stage_rows(t0 * TILE + wg * 64);

  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * TILE + wg * 64;
    const long long rb = (row0 < p.nrows ? row0 : p.nrows - 1) / p.S;
    long long ray[2];
    bool valid[2];
    const bf16* zsp[2];
    const bf16* ftp[2];
    const bf16* drp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long g = row0 + rl + 8 * h;
      valid[h] = g < p.nrows;
      ray[h] = (valid[h] ? g : p.nrows - 1) / p.S;
      const int lr = (int)(ray[h] - rb);
      const bool staged = lr < RMAX;
      zsp[h] = staged ? zsS + lr * NH : p.zs1p + ray[h] * H;
      ftp[h] = staged ? ftS + lr * NS : p.featp + ray[h] * SC;
      drp[h] = staged ? drS + lr * NH : p.dirp + ray[h] * H;
    }

    ptsS[t128] = pf[0];
    if (t128 < 64) ptsS[t128 + WG] = pf[1];
    hopper::cp_async_wait<0>();
    hopper::named_bar_sync(bar, WG);
    if (t + 1 < t1) fetch_pts(p, row0 + TILE, t128, pf);
    encode(p, abuf, ptsS, t128);
    hopper::fence_async_smem();
    hopper::named_bar_sync(bar, WG);

    // h1 = relu(cd(cd(cd(sin@w1s) + cd(cos@w1c)) + cd(x@w1x)) + b1): the
    // layer's two chunks hold [sin | cos] and [x | 0] of W1e^T.  It runs
    // in halves of 128 columns: sin@w1s and cos@w1c go to the two halves
    // of the accumulator at once, their rounded sum to 32 words of bf16
    // pairs, then x@w1x to the first half.  At NH = 256 the first half of
    // h1 goes to blocks 2-3 (the encode holds 0-1), the second to blocks
    // 0-1, and w2's product reads them rotated.
    {
      const uint32_t s0 = seq % STAGES, s1 = (seq + 1) % STAGES;
      const uint32_t b0 = ring_s + s0 * L.stage, b1 = ring_s + s1 * L.stage;
      hopper::mbar_wait(full_bar(bars, s0), (seq / STAGES) & 1);
      hopper::mbar_wait(full_bar(bars, s1), ((seq + 1) / STAGES) & 1);
#pragma unroll
      for (int q = 0; q < NH / 128; ++q) {
        const uint32_t bq0 = b0 + q * 128 * 128, bq1 = b1 + q * 128 * 128;
        float* const acc_c = acc + 64;
        hopper::wgmma_fence();
        hopper::wgmma_nn0<128>(acc, hopper::desc(a_s, 16, 1024), hopper::desc(bq0, 16, 1024));
        hopper::wgmma_nn0<128>(acc_c, hopper::desc(a_s + 2 * KPB, 16, 1024),
                               hopper::desc(bq0 + 2 * KPB, 16, 1024));
#pragma unroll
        for (int k = 1; k < KPB / 16; ++k) {
          hopper::wgmma_nn<128>(acc, hopper::desc(a_s + 32 * k, 16, 1024),
                                hopper::desc(bq0 + 32 * k, 16, 1024));
          hopper::wgmma_nn<128>(acc_c, hopper::desc(a_s + 2 * KPB + 32 * k, 16, 1024),
                                hopper::desc(bq0 + 2 * KPB + 32 * k, 16, 1024));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs<128>(acc);
        for_pairs<128>(acc, [&](int j, int, int h, float v0, float v1) {
          part[2 * j + h] =
              __hadd2(pack(v0, v1), pack(acc_c[4 * j + 2 * h], acc_c[4 * j + 2 * h + 1]));
        });
        l1_product<128, KX / 16>(acc, a_s + BLOCK, bq1, 0);
        store_pairs<128>(acc, abuf + (NH > 128 && q == 0 ? 2 : 0) * BLOCK, rl,
                         [&](int j, int c, int h, float v0, float v1) {
          return relu2(__hadd2(__hadd2(part[2 * j + h], pack(v0, v1)), pair(b1S + 128 * q + c)));
        });
      }
      hopper::mbar_arrive(empty_bar(bars, s0));
      hopper::mbar_arrive(empty_bar(bars, s1));
      seq += 2;
    }
    hopper::fence_async_smem();
    hopper::named_bar_sync(bar, WG);

    // h2 = relu(cd(h1@w2) + zs1p[ray])
    product<NH, NH, H1_ROT>(acc, a_s, ring_s, L.stage, bars, seq);
    store_rows<NH, true>(acc, abuf, rl, zsp, H);
    hopper::fence_async_smem();
    hopper::named_bar_sync(bar, WG);

    // sigma = h2.wos, and feat = cd(h2@wof) + featp[ray]
    head_product<NH>(sacc, a_s, sig_s);
    product<NS, NH>(acc, a_s, ring_s, L.stage, bars, seq);
    hopper::fence_regs<4>(sacc);
    store_rows<NS, false>(acc, abuf, rl, ftp, SC);
    hopper::fence_async_smem();
    hopper::named_bar_sync(bar, WG);

    // v1 = relu(cd(feat@wd) + dirp[ray])
    product<NH, NS>(acc, a_s, ring_s, L.stage, bars, seq);
    store_rows<NH, true>(acc, abuf, rl, drp, H);
    hopper::fence_async_smem();
    hopper::named_bar_sync(bar, WG);
    // every thread is past its last read of this tile's rows
    if (t + 1 < t1) stage_rows(row0 + TILE);

    // v2 = relu(cd(v1@wd2) + bd2), then rgb = v2.wr
    product<NH, NH>(acc, a_s, ring_s, L.stage, bars, seq);
    store_rows<NH, true>(acc, abuf, rl, bd2p, NH);
    hopper::fence_async_smem();
    hopper::named_bar_sync(bar, WG);
    head_product<NH>(racc, a_s, rgb_s);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<4>(racc);

    // raw = [rgb | sigma]: lane 4 i + 1 holds rgb's column 2, lane 4 i the
    // rest; one 16-byte store a row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float b = __shfl_down_sync(0xffffffffu, racc[2 * h], 1);
      if ((t128 & 3) == 0 && valid[h]) {
        const bf16* z = p.zt1p + ray[h] * 3;
        reinterpret_cast<float4*>(p.out)[row0 + rl + 8 * h] =
            make_float4(rbf(racc[2 * h]) + __bfloat162float(__ldg(z)),
                        rbf(racc[2 * h + 1]) + __bfloat162float(__ldg(z + 1)),
                        rbf(b) + __bfloat162float(__ldg(z + 2)),
                        rbf(sacc[2 * h]) + __bfloat162float(__ldg(p.sigp + ray[h])));
      }
    }
  }
}

template <int NH, int NS>
__global__ void __launch_bounds__(THREADS, 1) trunk_fwd_kernel_wgmma(const WArgs p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Layout L = layout(NH, NS);
  const uint32_t bars = hopper::smem_u32(base + L.bars);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full_bar(bars, s), 1);
      hopper::mbar_init(empty_bar(bars, s), 2 * WG);
    }
    hopper::fence_barrier_init();
  }
  // b1 and bd2, zero past H
  bf16* const bias = reinterpret_cast<bf16*>(base + L.bias);
  for (int c = tid; c < NH; c += THREADS) {
    bias[c] = c < p.H ? p.b1[c] : __float2bfloat16_rn(0.0f);
    bias[NH + c] = c < p.H ? p.bd2[c] : __float2bfloat16_rn(0.0f);
  }
  // the heads' images, [8, NH] K-major like the ring's: sigma's row 0 is
  // wos, rgb's rows 0-2 are wr's columns; every other element is zero
  for (int i = tid; i < 8 * NH; i += THREADS) {
    const int n = i / NH, k = i % NH;
    const uint32_t off = (k >> 6) * HEAD + hopper::swz(n, (k & 63) >> 3) + (k & 7) * 2;
    const bool in = k < p.H;
    *reinterpret_cast<bf16*>(base + L.heads + off) =
        in && n == 0 ? p.wos[k] : __float2bfloat16_rn(0.0f);
    *reinterpret_cast<bf16*>(base + L.heads + NH / 64 * HEAD + off) =
        in && n < 3 ? p.wr[k * 3 + n] : __float2bfloat16_rn(0.0f);
  }
  hopper::fence_async_smem();
  __syncthreads();
  // this block's tiles: even_ranges(tiles, gridDim.x)[blockIdx.x]
  const long long t0 = blockIdx.x * p.tiles / gridDim.x;
  const long long t1 = (blockIdx.x + 1) * p.tiles / gridDim.x;
  if (tid >= 2 * WG) {
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 2 * WG) produce<NH, NS>(p, hopper::smem_u32(base), bars, L.stage, t0, t1);
  } else {
    hopper::setmaxnreg_inc<CONSUMER_REGS>();
    consume<NH, NS>(p, base, L, t0, t1);
  }
}

template <int NH, int NS>
int launch_wgmma(const WArgs& p, int grid, int smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel_wgmma<NH, NS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  trunk_fwd_kernel_wgmma<NH, NS><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- f32: the CUDA-core chain of trunk_common.cuh ----

template <typename T>
struct Args {
  const float* pts;    // [R*S, 3]
  TrunkW<T> w;
  float* out;          // [R*S, 4]
  long long nrows;     // R*S
};

template <typename T, int TM>
__global__ void __launch_bounds__(NTHREADS, 2) trunk_fwd_kernel(const Args<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_tile<T, TM>(p.w, p.pts, p.nrows, (long long)blockIdx.x * TM, p.out, smem);
}

template <typename T, int TM>
int launch_tile(const Args<T>& p, int smem, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel<T, TM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.nrows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((p.nrows + TM - 1) / TM);
  trunk_fwd_kernel<T, TM><<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* const* in, void* out, const int* dims, void* stream) {
  const int R = dims[0], S = dims[1], H = dims[2], SC = dims[3], F = dims[4];
  Args<T> p;
  p.pts = static_cast<const float*>(in[0]);
  TrunkW<T>& w = p.w;
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
  p.out = static_cast<float*>(out);
  p.nrows = (long long)R * S;
  w.S = S;
  w.H = H;
  w.SC = SC;
  w.F = F;
  w.KP = kp_of(F);
  w.ld = ld_of(H, SC);
  w.ldk = w.KP + PAD;
  const int tm = dims[6];
  const int smem = fwd_smem_bytes<T>(H, SC, F, tm);
  // the plan (plan.py::trunk_fwd_plan) must match this file's layout
  if (!tile_ok<T>(tm) || dims[5] != smem) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int TM = tile_rows<T>();
  if (tm == TM) return launch_tile<T, TM>(p, smem, stream);
  if (tm == TM / 2) return launch_tile<T, TM / 2>(p, smem, stream);
  return launch_tile<T, TM / 4>(p, smem, stream);
}

}  // namespace

extern "C" {

const char* trunk_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches bf16 K1 on `stream`; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue if the plan does not match this file.
// in:  pts zs1p featp sigp dirp zt1p b1 bd2 wos wr (bf16 but pts), bands
//      (f32), the packed weight images (plan.py::k1_chunks)
// dims: R S H SC F, then plan.py::trunk_fwd_wgmma_plan's tile_rows smem
//      grid tiles image_bytes nh ns
int trunk_fwd_bf16(const void* const* in, void* out, const long long* dims, void* stream) {
  const long long R = dims[0], tiles = dims[8];
  const int S = (int)dims[1], H = (int)dims[2], SC = (int)dims[3], F = (int)dims[4];
  const int smem = (int)dims[6], grid = (int)dims[7];
  const int NH = wgmma_width(H), NS = wgmma_width(SC);
  const bool widths = H % 32 == 0 && SC % 32 == 0 && H >= 32 && SC >= 32 && H <= 256 &&
                      SC <= 256 && F >= 1 && 3 * F <= KPB && S >= 1 && R >= 0;
  if (!widths || dims[5] != TILE || smem != layout(NH, NS).total ||
      tiles != (R * S + TILE - 1) / TILE || grid < (tiles > 0 ? 1 : 0) || grid > tiles ||
      dims[9] != image_bytes(NH, NS) || dims[10] != NH || dims[11] != NS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  WArgs p;
  p.pts = static_cast<const float*>(in[0]);
  p.zs1p = static_cast<const bf16*>(in[1]);
  p.featp = static_cast<const bf16*>(in[2]);
  p.sigp = static_cast<const bf16*>(in[3]);
  p.dirp = static_cast<const bf16*>(in[4]);
  p.zt1p = static_cast<const bf16*>(in[5]);
  p.b1 = static_cast<const bf16*>(in[6]);
  p.bd2 = static_cast<const bf16*>(in[7]);
  p.wos = static_cast<const bf16*>(in[8]);
  p.wr = static_cast<const bf16*>(in[9]);
  p.bands = static_cast<const float*>(in[10]);
  p.img = static_cast<const unsigned char*>(in[11]);
  p.out = static_cast<float*>(out);
  p.nrows = R * S;
  p.tiles = tiles;
  p.S = S;
  p.H = H;
  p.SC = SC;
  p.F = F;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H > 128)
    return SC > 128 ? launch_wgmma<256, 256>(p, grid, smem, st)
                    : launch_wgmma<256, 128>(p, grid, smem, st);
  return SC > 128 ? launch_wgmma<128, 256>(p, grid, smem, st)
                  : launch_wgmma<128, 128>(p, grid, smem, st);
}

// Launches the row-tile K1 (f32, or bf16 with `f32` 0) on `stream`;
// returns cudaGetLastError() after the launch.
// in:  pts zs1p featp sigp dirp zt1p b1 w1x w1s w1c bands w2 wof wos wd wd2
//      bd2 wr, then w1x w1s w1c w2 wof wd wd2 transposed (w1x null without
//      the input term; all in the compute type but pts and bands, f32)
// dims: R S H SC F smem tile_rows (a full tile, a half or a quarter, as
// plan.py::row_tile picks).  Requires H % 32 == 0 and SC % 32 == 0 (the
// wrapper pads).
int trunk_fwd_rows(const void* const* in, void* out, const int* dims, int f32, void* stream) {
  return f32 ? launch_rows<float>(in, out, dims, stream)
             : launch_rows<bf16>(in, out, dims, stream);
}

}  // extern "C"
