// bf16 K1's forward chain for one consumer warpgroup of 64 rows, the code
// of trunk_fwd.cu's trunk_fwd_kernel_wgmma, for K2's recompute in the
// wgmma row pass (trunk_bwd.cu), so that K2's relu masks come from K1's own
// arithmetic, as on the TPU, where the recompute in _trunk_bwd_impl runs
// the same matmuls as _trunk_kernel.  K1 keeps its own copy of these
// pieces: assembled from this header, ptxas allocated its registers worse
// (many more spills) for the same outputs.
//
// The pieces (trunk_fwd.cu's header note gives the design): the weight
// ring's producer step, one wgmma product over a layer's streamed chunks,
// layer 1 in its TPU order, the epilogues that write the next layer's
// swizzled A operand from the accumulator's registers, the m64n8k16 heads,
// the encode and the staged per-ray rows.  `forward` runs one tile of the
// chain from the encode to v2 in the warpgroup's buffer; a kernel's Hooks
// see each stored activation pair (K2 keeps relu masks as bits) and may
// run side work while a product's first chunk is in the tensor cores (K2
// stores the dW operands and sums narrow grads from the buffer then).

#pragma once

#include "hopper.cuh"

namespace chain {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf2;

constexpr int ROWS = 64;          // rows of a consumer warpgroup's tile
constexpr int STAGES = 4;         // weight chunks in flight (K1's ring; a
                                  // kernel may take another count, ST)
constexpr int WG = 128;           // threads of a warpgroup
constexpr int BLOCK = 64 * 128;   // 64 rows x 64 bf16 of a buffer
constexpr int HEAD = 8 * 128;     // 8 rows x 64 bf16 of a head's image
// the encode's columns: sin of the 3 F <= 30 arguments at [0, 32), cos at
// [32, 64), the point at [64, 67); the rest of [0, 128) is zero
constexpr int KPB = 32;
constexpr int XW = 16;            // the point's columns, [64, 80)
// rays whose per-ray rows (zs1p, featp, dirp) a warpgroup stages in shared
// memory per tile; a row of a later ray reads device memory instead
constexpr int RMAX = 4;

// the wgmma N of a layer of output width n (plan.py::k1_wgmma_width)
__host__ __device__ inline int wgmma_width(int n) { return n <= 128 ? 128 : 256; }

// the ring's barriers: full[ST], then empty[ST]
__device__ __forceinline__ uint32_t full_bar(uint32_t bars, uint32_t s) { return bars + s * 8; }
template <int ST = STAGES>
__device__ __forceinline__ uint32_t empty_bar(uint32_t bars, uint32_t s) {
  return bars + (ST + s) * 8;
}
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// bf16 pairs: the accumulator's two columns rounded, and the adds and
// relus of the epilogues, each rounded once to bf16
__device__ __forceinline__ bf2 pack(float a, float b) { return __floats2bfloat162_rn(a, b); }
__device__ __forceinline__ bf2 relu2(bf2 a) { return __hmax2(a, __float2bfloat162_rn(0.0f)); }
// two bf16 of shared or device memory
__device__ __forceinline__ bf2 pair(const bf16* p) { return *reinterpret_cast<const bf2*>(p); }

// byte offset of element (r, col) of a 64-row buffer: 64-column block
// col / 64, row r of 128 bytes, 16-byte chunk (col % 64) / 8 swizzled
__device__ __forceinline__ uint32_t at(int r, int col) {
  return (col >> 6) * BLOCK + hopper::swz(r, (col & 63) >> 3) + (col & 7) * 2;
}
// the pair (r, col), (r, col + 1) of a 64-row buffer (col even)
__device__ __forceinline__ void put2(unsigned char* abuf, int r, int col, bf2 v) {
  *reinterpret_cast<bf2*>(abuf + at(r, col)) = v;
}
__device__ __forceinline__ bf2 get2(const unsigned char* abuf, int r, int col) {
  return *reinterpret_cast<const bf2*>(abuf + at(r, col));
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
// the stores.  on(j, h, v) sees each stored pair.
template <int N, bool RELU, class On>
__device__ __forceinline__ void store_rows(const float* acc, unsigned char* abuf, int rl,
                                           const bf16* const* rowp, int n, On on) {
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
        bf2 v = __hadd2(pack(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]), z[jj][h]);
        if (RELU) v = relu2(v);
        on(j, h, v);
        put2(abuf, rl + 8 * h, 8 * j + c2, v);
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

struct NoSide {
  __device__ __forceinline__ void operator()() const {}
};
struct NoPair {
  __device__ __forceinline__ void operator()(int, int, bf2) const {}
};

// acc = A[64, K] W^T over the layer's K / 64 ring chunks (ring chunk seq +
// j holds columns [64 j, 64 j + 64) of W^T), with A's columns [64 j, 64 j
// + 64) in block (j + ROT) % 4 of the warpgroup's buffer.  Every consumer
// thread releases each stage once its warp's wgmma that read it is done
// (the next chunk's in flight): a warp's wait covers only its own share
// of a warpgroup's wgmma.  side() runs once the first chunk's wgmma is
// committed, while it runs; it must not write the buffer.  Also waits for
// every earlier wgmma group.  Advances seq.
template <int N, int K, int ROT = 0, int ST = STAGES, class Side = NoSide>
__device__ __forceinline__ void product(float* acc, uint32_t a_s, uint32_t ring_s,
                                        uint32_t stage_bytes, uint32_t bars, uint32_t& seq,
                                        Side side = Side()) {
  constexpr int NK = K / 64;
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const uint32_t s = seq + j, st = s % ST;
    hopper::mbar_wait(full_bar(bars, st), (s / ST) & 1);
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
    if (j == 0) side();
    if (j > 0) {
      hopper::wgmma_wait<1>();
      hopper::mbar_arrive(empty_bar<ST>(bars, (s - 1) % ST));
    }
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs<N / 2>(acc);
  hopper::mbar_arrive(empty_bar<ST>(bars, (seq + NK - 1) % ST));
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

// The producer thread's step: chunk seq of `bytes` bytes from src into its
// stage once the consumers have released it.  A kernel's producer calls it
// for every chunk of every tile in the chain's order.
template <int ST = STAGES>
__device__ __forceinline__ void produce_chunk(const unsigned char* src, uint32_t bytes,
                                              uint32_t ring_s, uint32_t bars, int stage_bytes,
                                              uint32_t seq) {
  const uint32_t st = seq % ST;
  hopper::mbar_wait(empty_bar<ST>(bars, st), ((seq / ST) & 1) ^ 1);
  hopper::mbar_arrive_expect_tx(full_bar(bars, st), bytes);
  hopper::bulk_copy_g2s(ring_s + st * stage_bytes, src, bytes, full_bar(bars, st));
}

// What the chain reads from device memory.
struct FwdArgs {
  const float* pts;    // [R*S, 3]
  const bf16* zs1p;    // [R, H]
  const bf16* featp;   // [R, SC]
  const bf16* dirp;    // [R, H]
  const float* bands;  // [F]
  long long R;         // rays
  int S, H, SC, F;
};

// One consumer warpgroup's share of the block's shared memory and its
// place in the ring.
struct Warpgroup {
  unsigned char* abuf;  // its activation buffer: 64 rows, K-major, swizzled
  float* ptsS;          // its 64 points, f32
  bf16* zsS;            // its staged per-ray rows: zs1p [RMAX, NH], featp
  bf16* ftS;            //   [RMAX, NS], dirp [RMAX, NH]
  bf16* drS;
  const bf16* b1S;      // b1 and bd2, bf16 [NH], zero past H
  const bf16* bd2S;
  uint32_t a_s, ring_s, bars, stage;
  int t128, bar, rl;    // thread in the warpgroup, its named barrier, the
                        // row of its accumulator's first half
  uint32_t seq;         // ring chunks consumed
};

// The warpgroup's 64 points of a tile (3 floats a row, zero from row lim
// on): thread t128 holds floats t128 and t128 + 128 of the 192
__device__ __forceinline__ void fetch_pts(const FwdArgs& p, long long row0, long long lim,
                                          int t128, float* pf) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int i = t128 + m * WG;
    pf[m] = (i < 192 && row0 + i / 3 < lim) ? __ldg(p.pts + row0 * 3 + i) : 0.0f;
  }
}

// the points fetched for this tile into the warpgroup's shared memory
__device__ __forceinline__ void put_pts(const Warpgroup& w, const float* pf) {
  w.ptsS[w.t128] = pf[0];
  if (w.t128 < 64) w.ptsS[w.t128 + WG] = pf[1];
}

// the last valid row's ray bounds the rays of rows from lim on
__device__ __forceinline__ long long ray_of(long long g, long long lim, int S) {
  const long long last = lim > 0 ? lim - 1 : 0;
  return (g < lim ? g : last) / S;
}

// cp.async the rows of the RMAX rays from the one of row row0 on (zero
// past the last ray) into the warpgroup's staging; committed
template <int NH, int NS>
__device__ __forceinline__ void stage_rows(const FwdArgs& p, const Warpgroup& w,
                                           long long row0, long long lim) {
  const long long rb = ray_of(row0, lim, p.S);
  const int vh = p.H / 8, vs = p.SC / 8, per = 2 * vh + vs;
  for (int i = w.t128; i < RMAX * per; i += WG) {
    const int r = i / per, v = i - r * per;
    const long long ray = rb + r;
    const bf16* src;
    bf16* dst;
    if (v < vh) {
      src = p.zs1p + ray * p.H + v * 8;
      dst = w.zsS + r * NH + v * 8;
    } else if (v < vh + vs) {
      src = p.featp + ray * p.SC + (v - vh) * 8;
      dst = w.ftS + r * NS + (v - vh) * 8;
    } else {
      src = p.dirp + ray * p.H + (v - vh - vs) * 8;
      dst = w.drS + r * NH + (v - vh - vs) * 8;
    }
    hopper::cp_async16(hopper::smem_u32(dst), ray < p.R ? src : p.zs1p, ray < p.R ? 16 : 0);
  }
  hopper::cp_async_commit();
}

// The rows of this thread's two accumulator halves in a tile from row0:
// validity (row < lim), ray, and where each one's per-ray rows are (the
// staging, or device memory for a ray past the staged ones).
struct TileRows {
  long long ray[2];
  bool valid[2];
  const bf16* zsp[2];
  const bf16* ftp[2];
  const bf16* drp[2];
};
template <int NH, int NS>
__device__ __forceinline__ TileRows tile_rays(const FwdArgs& p, const Warpgroup& w,
                                              long long row0, long long lim) {
  TileRows tr;
  const long long rb = ray_of(row0, lim, p.S);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long g = row0 + w.rl + 8 * h;
    tr.valid[h] = g < lim;
    tr.ray[h] = ray_of(g, lim, p.S);
    const int lr = (int)(tr.ray[h] - rb);
    const bool staged = lr < RMAX;
    tr.zsp[h] = staged ? w.zsS + lr * NH : p.zs1p + tr.ray[h] * p.H;
    tr.ftp[h] = staged ? w.ftS + lr * NS : p.featp + tr.ray[h] * p.SC;
    tr.drp[h] = staged ? w.drS + lr * NH : p.dirp + tr.ray[h] * p.H;
  }
  return tr;
}

// The encode of the warpgroup's 64 points (pts [64, 3] in shared memory)
// into its buffer, a bf16 pair a store: column j < 32 is sin of argument
// j = 3 k + c (band k, coordinate c; zero from 3F on), 32 + j its cos, 64
// + c coordinate c (zero from 3 on).
__device__ __forceinline__ void encode(const FwdArgs& p, unsigned char* abuf, const float* pts,
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
  for (int i = t128; i < 64 * (XW / 2); i += WG) {
    const int r = i / (XW / 2), j = 2 * (i % (XW / 2));
    put2(abuf, r, 2 * KPB + j,
         pack(j < 3 ? pts[r * 3 + j] : 0.0f, j + 1 < 3 ? pts[r * 3 + j + 1] : 0.0f));
  }
}

// h1 = relu(cd(cd(cd(sin@w1s) + cd(cos@w1c)) + cd(x@w1x)) + b1): the
// layer's two chunks hold [sin | cos] and [x | 0] of W1e^T.  It runs in
// halves of 128 columns: sin@w1s and cos@w1c go to the two halves of the
// accumulator at once, their rounded sum to 32 words of bf16 pairs, then
// x@w1x to the first half.  At NH = 256 the first half of h1 goes to
// blocks 2-3 (the encode holds 0-1), the second to blocks 0-1, and w2's
// product reads them rotated (H1_ROT).  on(j, h, v) sees each stored pair,
// j its 8-column group of the full width.
template <int NH>
__host__ __device__ constexpr int h1_rot() {
  return NH > 128 ? 2 : 0;
}
template <int NH, int ST = STAGES, class On>
__device__ __forceinline__ void layer1(float* acc, uint32_t a_s, uint32_t ring_s,
                                       uint32_t stage_bytes, uint32_t bars, uint32_t& seq,
                                       unsigned char* abuf, int rl, const bf16* b1S, On on) {
  const uint32_t s0 = seq % ST, s1 = (seq + 1) % ST;
  const uint32_t b0 = ring_s + s0 * stage_bytes, b1 = ring_s + s1 * stage_bytes;
  bf2 part[32];  // the running sum, bf16 pairs
  hopper::mbar_wait(full_bar(bars, s0), (seq / ST) & 1);
  hopper::mbar_wait(full_bar(bars, s1), ((seq + 1) / ST) & 1);
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
    l1_product<128, XW / 16>(acc, a_s + BLOCK, bq1, 0);
    store_pairs<128>(acc, abuf + (NH > 128 && q == 0 ? 2 : 0) * BLOCK, rl,
                     [&](int j, int c, int h, float v0, float v1) {
      const bf2 v = relu2(__hadd2(__hadd2(part[2 * j + h], pack(v0, v1)),
                                  pair(b1S + 128 * q + c)));
      on(16 * q + j, h, v);
      return v;
    });
  }
  hopper::mbar_arrive(empty_bar<ST>(bars, s0));
  hopper::mbar_arrive(empty_bar<ST>(bars, s1));
  seq += 2;
}

// the warpgroup's writes of its buffer made visible to its wgmma
__device__ __forceinline__ void publish(const Warpgroup& w) {
  hopper::fence_async_smem();
  hopper::named_bar_sync(w.bar, WG);
}

// One tile of the chain, from the points in w.ptsS (and the tile's rows
// staged and landed, all behind the warpgroup's barrier) to v2 in the
// buffer, as K1 runs it (trunk_fwd.cu::consume).  Hooks (K1's heads, K2's masks and side work):
//   encoded()             the encode is in the buffer (and published)
//   h1 / h2 / v1 / v2(j, h, v)   each stored pair of that activation
//   during_h2 / during_feat / during_v1 / during_v2()   side work while
//                         the product's first chunk runs (it reads the
//                         product's input in the buffer; reads_across()
//                         says it reads other warps' rows, so a barrier
//                         follows the product)
//   before_feat(), after_feat()   around the feat product (K1's sigma head)
//   after_v1()            every thread is past its last read of the
//                         tile's staged rows (K1 stages the next tile's)
template <int NH, int NS, int ST = STAGES, class Hooks>
__device__ __forceinline__ void forward(const FwdArgs& p, Warpgroup& w, const TileRows& tr,
                                        float* acc, Hooks& hk) {
  constexpr int H1_ROT = h1_rot<NH>();
  const bf16* const bd2p[2] = {w.bd2S, w.bd2S};
  auto after_product = [&]() {
    if (hk.reads_across()) hopper::named_bar_sync(w.bar, WG);
  };
  encode(p, w.abuf, w.ptsS, w.t128);
  publish(w);
  hk.encoded();

  layer1<NH, ST>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, w.abuf, w.rl, w.b1S,
                 [&](int j, int h, bf2 v) { hk.h1(j, h, v); });
  publish(w);

  // h2 = relu(cd(h1@w2) + zs1p[ray])
  product<NH, NH, H1_ROT, ST>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq,
                          [&]() { hk.during_h2(); });
  after_product();
  store_rows<NH, true>(acc, w.abuf, w.rl, tr.zsp, p.H, [&](int j, int h, bf2 v) { hk.h2(j, h, v); });
  publish(w);

  // feat = cd(h2@wof) + featp[ray]
  hk.before_feat();
  product<NS, NH, 0, ST>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() { hk.during_feat(); });
  hk.after_feat();
  after_product();
  store_rows<NS, false>(acc, w.abuf, w.rl, tr.ftp, p.SC, NoPair());
  publish(w);

  // v1 = relu(cd(feat@wd) + dirp[ray])
  product<NH, NS, 0, ST>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() { hk.during_v1(); });
  after_product();
  store_rows<NH, true>(acc, w.abuf, w.rl, tr.drp, p.H, [&](int j, int h, bf2 v) { hk.v1(j, h, v); });
  publish(w);
  hk.after_v1();

  // v2 = relu(cd(v1@wd2) + bd2)
  product<NH, NH, 0, ST>(acc, w.a_s, w.ring_s, w.stage, w.bars, w.seq, [&]() { hk.during_v2(); });
  after_product();
  store_rows<NH, true>(acc, w.abuf, w.rl, bd2p, NH, [&](int j, int h, bf2 v) { hk.v2(j, h, v); });
  publish(w);
}

// Hooks that do nothing; a kernel's hooks derive from it and replace what
// they use.
struct NoHooks {
  __device__ __forceinline__ bool reads_across() const { return false; }
  __device__ __forceinline__ void encoded() {}
  __device__ __forceinline__ void h1(int, int, bf2) {}
  __device__ __forceinline__ void h2(int, int, bf2) {}
  __device__ __forceinline__ void v1(int, int, bf2) {}
  __device__ __forceinline__ void v2(int, int, bf2) {}
  __device__ __forceinline__ void during_h2() {}
  __device__ __forceinline__ void during_feat() {}
  __device__ __forceinline__ void during_v1() {}
  __device__ __forceinline__ void during_v2() {}
  __device__ __forceinline__ void before_feat() {}
  __device__ __forceinline__ void after_feat() {}
  __device__ __forceinline__ void after_v1() {}
};

}  // namespace chain
