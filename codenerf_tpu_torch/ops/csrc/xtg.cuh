// The weight-gradient products of the port's backward kernels: tall
// split-K products C[kd, nd] = A^T B over M rows, A [M, kd] and B [M, nd]
// row-major (row strides lda, ldb), summed in f32.  K2 / K3 (trunk_bwd.cu)
// run their dW products through it and K4 (layer_bwd.cu) its dw.
//
// Work is cut into output tiles of BK x BN and each tile's rows into
// `splits` contiguous ranges of 64-row chunks; one block owns one (tile,
// range) pair and keeps its tile's sums in registers over the whole range,
// then writes them once to its partial [splits, kd, nd].  xtg_reduce sums
// the partials in split order.  No atomics: two calls give the same bits.
//
// bf16 (the flagship): 256 threads, two warpgroups; warpgroup w owns tile
// rows 64w..64w+63 and all 256 tile columns as one m64n256k16 wgmma
// accumulator (128 f32 registers a thread).  Both operands are MN-major in
// shared memory (the reduction runs over rows), loaded with cp.async into a
// four-stage ring of 48 KB stages, 128-byte swizzled, zero-filled past M,
// kd and nd.  Each A and B byte is read from device memory once per tile
// row or column it feeds; the blocks of one row range run together, so the
// repeats come from L2.
//
// f32: the same tiling at 64 x 64 on the CUDA cores (each thread a 4 x 4
// block of the tile, f32 fma, no TF32, 32-row chunk sums joined with
// compensated addition), for the f32 instantiations.
//
// The launch plan (tiles, splits, first block of each product) is computed
// by codenerf_tpu_torch/ops/plan.py::xtg_plan and checked here.

#pragma once

#include "hopper.cuh"

namespace xtg {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int RC = 64;  // rows per chunk
// bf16 tiles
constexpr int BK = 128, BN = 256, STAGES = 4;
constexpr int A_BYTES = RC * BK * 2, B_BYTES = RC * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BF16 = STAGES * STAGE_BYTES + 1024;
// f32 tiles
constexpr int FK = 64, FN = 64, FRC = 32;

struct Job {
  const void* a;
  const void* b;
  float* part;  // [splits, kd, nd]
  float* out;   // [kd, nd]
  long long M;
  int lda, kd, ldb, nd, splits, first_block, tiles_n;
};
constexpr int MAX_JOBS = 8;
struct Jobs {
  Job j[MAX_JOBS];
  int n;
};

__device__ __forceinline__ int job_of(const Jobs& js) {
  int i = 0;
  while (i + 1 < js.n && (int)blockIdx.x >= js.j[i + 1].first_block) ++i;
  return i;
}

// this block's tile origin, split and chunk range
struct Part {
  int k0, n0, split;
  long long c0, c1;
};
__device__ __forceinline__ Part part_of(const Job& jb, int bk, int bn) {
  const int local = (int)blockIdx.x - jb.first_block;
  const int tile = local / jb.splits;
  Part p;
  p.split = local - tile * jb.splits;
  p.k0 = (tile / jb.tiles_n) * bk;
  p.n0 = (tile % jb.tiles_n) * bn;
  const long long nchunk = (jb.M + RC - 1) / RC;
  p.c0 = nchunk * p.split / jb.splits;
  p.c1 = nchunk * (p.split + 1) / jb.splits;
  return p;
}

// rows [r0, r0 + RC) of the tile's A columns [k0, k0 + BK) and B columns
// [n0, n0 + BN) into one stage, MN-major and swizzled, zero past the edges
__device__ __forceinline__ void load_stage(const Job& jb, const Part& pt, long long r0,
                                           uint32_t sa) {
  const bf16* A = static_cast<const bf16*>(jb.a);
  const bf16* B = static_cast<const bf16*>(jb.b);
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < RC * (BK / 8) / NTHREADS; ++i) {
    const int v = tid + i * NTHREADS, r = v / (BK / 8), c = v % (BK / 8);
    const long long row = r0 + r;
    const int col = pt.k0 + c * 8;
    const bool ok = row < jb.M && col < jb.kd;
    hopper::cp_async16(sa + (c >> 3) * (RC * 128) + hopper::swz(r, c & 7),
                       ok ? A + row * jb.lda + col : A, ok ? 16 : 0);
  }
  const uint32_t sb = sa + A_BYTES;
#pragma unroll
  for (int i = 0; i < RC * (BN / 8) / NTHREADS; ++i) {
    const int v = tid + i * NTHREADS, r = v / (BN / 8), c = v % (BN / 8);
    const long long row = r0 + r;
    const int col = pt.n0 + c * 8;
    const bool ok = row < jb.M && col < jb.nd;
    hopper::cp_async16(sb + (c >> 3) * (RC * 128) + hopper::swz(r, c & 7),
                       ok ? B + row * jb.ldb + col : B, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1) xtg_wgmma_kernel(const __grid_constant__ Jobs js) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  const Job& jb = js.j[job_of(js)];
  const Part pt = part_of(jb, BK, BN);
  const int n = (int)(pt.c1 - pt.c0);
  const int tid = threadIdx.x, wg = tid >> 7;

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load_stage(jb, pt, (pt.c0 + s) * RC, base + s * STAGE_BYTES);
    hopper::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    hopper::cp_async_wait<STAGES - 2>();
    hopper::fence_async_smem();
    __syncthreads();  // chunk i landed; every warpgroup is past chunk i - 1
    const int nx = i + STAGES - 1;
    if (nx < n) load_stage(jb, pt, (pt.c0 + nx) * RC, base + (nx % STAGES) * STAGE_BYTES);
    hopper::cp_async_commit();
    const uint32_t sa = base + (i % STAGES) * STAGE_BYTES + wg * (RC * 128);
    const uint32_t sb = base + (i % STAGES) * STAGE_BYTES + A_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < RC / 16; ++ks)
      hopper::wgmma_m64n256k16_tt(acc, hopper::desc(sa + ks * 2048, RC * 128, 1024),
                                  hopper::desc(sb + ks * 2048, RC * 128, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<128>(acc);
  }
  hopper::cp_async_wait<0>();

  const int wl = (tid & 127) >> 5, lane = tid & 31;
  float* const part = jb.part + (size_t)pt.split * jb.kd * jb.nd;
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = pt.k0 + wg * 64 + wl * 16 + (lane >> 2) + 8 * h;
      const int nc = pt.n0 + 8 * j + 2 * (lane & 3);
      if (kr < jb.kd && nc < jb.nd)
        *reinterpret_cast<float2*>(part + (size_t)kr * jb.nd + nc) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

__global__ void __launch_bounds__(NTHREADS) xtg_simt_kernel(const __grid_constant__ Jobs js) {
  __shared__ __align__(16) float As[FRC][FK];
  __shared__ __align__(16) float Bs[FRC][FN];
  const Job& jb = js.j[job_of(js)];
  const Part pt = part_of(jb, FK, FN);
  const float* A = static_cast<const float*>(jb.a);
  const float* B = static_cast<const float*>(jb.b);
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  // each 32-row chunk's sums join the range's sums with Kahan's compensated
  // addition: a range holds up to M / splits rows, and a plain running f32
  // sum over that many would drift from the f32 GEMM it must match
  float acc[4][4] = {}, comp[4][4] = {};
  const long long rb = pt.c0 * RC, re = pt.c1 * RC < jb.M ? pt.c1 * RC : jb.M;
  for (long long r0 = rb; r0 < re; r0 += FRC) {
    for (int v = tid; v < FRC * FK; v += NTHREADS) {
      const int r = v / FK, c = v % FK;
      const long long row = r0 + r;
      As[r][c] = row < re && pt.k0 + c < jb.kd ? A[row * jb.lda + pt.k0 + c] : 0.0f;
      Bs[r][c] = row < re && pt.n0 + c < jb.nd ? B[row * jb.ldb + pt.n0 + c] : 0.0f;
    }
    __syncthreads();
    float sum[4][4] = {};
    for (int r = 0; r < FRC; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&As[r][tr * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tc * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sum[i][j] = fmaf(av[i], bv[j], sum[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float y = __fsub_rn(sum[i][j], comp[i][j]);
        const float t = __fadd_rn(acc[i][j], y);
        comp[i][j] = __fsub_rn(__fsub_rn(t, acc[i][j]), y);
        acc[i][j] = t;
      }
    __syncthreads();
  }
  float* const part = jb.part + (size_t)pt.split * jb.kd * jb.nd;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      const int kr = pt.k0 + tr * 4 + i, nc = pt.n0 + tc * 4 + j;
      if (kr < jb.kd && nc < jb.nd) part[(size_t)kr * jb.nd + nc] = acc[i][j];
    }
}

// out[i] = sum over s in order of part[s, i], for each product
__global__ void xtg_reduce(const __grid_constant__ Jobs js) {
  const Job& jb = js.j[blockIdx.y];
  const long long count = (long long)jb.kd * jb.nd;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < jb.splits; ++s) acc += jb.part[s * count + i];
    jb.out[i] = acc;
  }
}

// One row of the plan per product, as plan.py::xtg_plan writes it:
// a, b, part, out (pointers), M, lda, kd, ldb, nd, splits, first_block,
// tiles_n, then the grid's total blocks at the end.
constexpr int PLAN_COLS = 12;

// Runs the products of `plan` (n rows, f32 operands if f32 else bf16) on
// `stream`, then the reduction; returns a CUDA error code.
inline int run(const long long* plan, int n, int f32, void* stream) {
  if (n < 1 || n > MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  const int bk = f32 ? FK : BK, bn = f32 ? FN : BN;
  Jobs js;
  js.n = n;
  long long blocks = 0, biggest = 0;
  for (int i = 0; i < n; ++i) {
    const long long* r = plan + i * PLAN_COLS;
    Job& jb = js.j[i];
    jb.a = reinterpret_cast<const void*>(r[0]);
    jb.b = reinterpret_cast<const void*>(r[1]);
    jb.part = reinterpret_cast<float*>(r[2]);
    jb.out = reinterpret_cast<float*>(r[3]);
    jb.M = r[4];
    jb.lda = (int)r[5];
    jb.kd = (int)r[6];
    jb.ldb = (int)r[7];
    jb.nd = (int)r[8];
    jb.splits = (int)r[9];
    jb.first_block = (int)r[10];
    jb.tiles_n = (int)r[11];
    const int elem = f32 ? 4 : 2;
    // the plan must match this file's tiling; operands 16-byte aligned
    if (jb.M < 1 || jb.kd < 1 || jb.nd < 1 || jb.splits < 1 || jb.first_block != blocks ||
        jb.tiles_n != (jb.nd + bn - 1) / bn || jb.kd % 8 || jb.nd % 8 || (jb.lda * elem) % 16 ||
        (jb.ldb * elem) % 16 || reinterpret_cast<uintptr_t>(jb.a) % 16 ||
        reinterpret_cast<uintptr_t>(jb.b) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    blocks += (long long)((jb.kd + bk - 1) / bk) * jb.tiles_n * jb.splits;
    const long long count = (long long)jb.kd * jb.nd;
    if (count > biggest) biggest = count;
  }
  if (blocks != plan[n * PLAN_COLS]) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    xtg_simt_kernel<<<(unsigned)blocks, NTHREADS, 0, st>>>(js);
  } else {
    cudaError_t e = cudaFuncSetAttribute(xtg_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (e != cudaSuccess) return static_cast<int>(e);
    xtg_wgmma_kernel<<<(unsigned)blocks, NTHREADS, SMEM_BF16, st>>>(js);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned gx = (unsigned)((biggest + 255) / 256 < 1024 ? (biggest + 255) / 256 : 1024);
  xtg_reduce<<<dim3(gx, (unsigned)n), 256, 0, st>>>(js);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum over s in order of part[s, i] for plain partial sums (the
// backward kernels' per-block bias sums): rows of part, out, splits, count.
inline int sum_parts(const long long* rows, int n, void* stream) {
  if (n < 1 || n > MAX_JOBS) return static_cast<int>(cudaErrorInvalidValue);
  Jobs js;
  js.n = n;
  long long biggest = 0;
  for (int i = 0; i < n; ++i) {
    const long long* r = rows + i * 4;
    Job& jb = js.j[i];
    jb = Job{};
    jb.part = reinterpret_cast<float*>(r[0]);
    jb.out = reinterpret_cast<float*>(r[1]);
    jb.splits = (int)r[2];
    jb.kd = 1;
    jb.nd = (int)r[3];
    if (jb.splits < 1 || jb.nd < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (r[3] > biggest) biggest = r[3];
  }
  const unsigned gx = (unsigned)((biggest + 255) / 256);
  xtg_reduce<<<dim3(gx, (unsigned)n), 256, 0, static_cast<cudaStream_t>(stream)>>>(js);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace xtg
