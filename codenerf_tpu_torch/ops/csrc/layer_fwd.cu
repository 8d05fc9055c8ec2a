// The forward of one linear + relu layer for Hopper (sm_90a): the product
// with its round-bias-relu epilogue in one kernel.
//
// Replaces no TPU kernel: on the TPU, XLA fuses the bias add and the relu
// of models/ray_structured.py::_dot_add_relu into the product's epilogue.
// The port ran the layer as three launches (a cuBLAS product rounded to
// bf16, a broadcast bf16 add, a relu), each a full pass over the [M, N]
// result.  This kernel computes, over M rows, with JAX's cast points
// (codenerf_tpu/models/ray_structured.py::_dot_add_relu):
//
//   y   = bf16(x @ w)                       f32 sums on the tensor cores
//   z   = bf16(float(y) + float(b))         b a bias [N], or per-ray rows
//                                           [M / S, N]: row m reads m / S
//   out = relu(z)                           NaN passes, as in torch.relu
//
// Operands are bf16: x [M, K] (any K up to 256), w^T [N, Kw] (Kw: K rounded
// up to 16, zero past K; the wrapper pads it) and N = 128 or 256.  The plan
// is plan.py::layer_fwd_plan.
//
// Bound on the H100: each row reads K and writes N bf16 values, 1 KB at
// K = N = 256, against 2 K N = 131,072 FLOP: 128 FLOP per byte, under the
// card's ~295, so the kernel is bound by bytes, rows (K + N) 2 B at
// 3.35 TB/s.  Design, for that bound: read x once, write the output once,
// keep w and every intermediate on the SM, and keep enough bytes in flight.
//
//   * A persistent grid of one block per SM; each block keeps w^T in shared
//     memory for its whole range (128 KB at 256 x 256, K-major, 128-byte
//     swizzled) and owns a run of consecutive tiles of rows.
//   * Two warpgroups, each holding a 64 x 128 f32 accumulator (wgmma
//     m64n128k16): at N = 256 they split a 64-row tile's columns, at N = 128
//     a 128-row tile's rows.
//   * x's tiles arrive by TMA (a tensor map, 128-byte swizzle, rows past M
//     and columns past K filled with zeros) into a ring of stages, issued
//     as soon as a stage is free, so up to `stages` tiles are in flight
//     (loads through registers, one tile ahead, held x to ~0.9 TB/s on an
//     H100 and the kernel to ~31% of its bound).  A K whose rows are not
//     16-byte multiples (lego's first layer, K = 63: 126-byte rows) cannot
//     be described to TMA: that route reads the tile, a contiguous run of
//     TM K elements, as 16-byte vectors into registers one tile ahead and
//     scatters them into the swizzled tile (zero past K).
//   * The epilogue rounds (two values an instruction), adds the bias in
//     bf16 and clamps in registers, writes the tile to shared memory in the
//     same swizzle, and one thread stores it by TMA (rows past M dropped)
//     while the next tile's product runs.
// Every output element is computed by one thread in a fixed order: two
// calls on the same card give the same bits.

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder is looked up at run time)

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int KMAX = 256;       // the widest K: w^T's shared-memory image
constexpr int MAX_STAGES = 4;   // x tiles in flight, at most

struct alignas(64) Args {
  CUtensorMap xmap;  // x [M, K], boxes of 64 columns x TM rows (TMA route)
  CUtensorMap ymap;  // y [M, N], the same boxes
  const bf16* x;     // [M, K]
  const bf16* wt;    // [N, Kw]
  const bf16* b;     // [N], or [M / S, N] per-ray rows
  long long M;
  int S, K, Kw, N, per_ray, stages;
};

// rows of a tile: two 64-row accumulators of 128 columns cover it
__host__ __device__ constexpr int tile_rows(int n) { return 64 * 256 / n; }

// shared memory: w^T and `stages` x tiles in 64-column blocks, the output
// tile, the stages' barriers, alignment slack (plan.py::layer_fwd_smem)
__host__ __device__ inline int smem_bytes(int Kw, int N, int stages) {
  const int ncb = (Kw + 63) / 64, tm = tile_rows(N);
  return ncb * N * 128 + stages * ncb * tm * 128 + tm * N * 2 + 8 * MAX_STAGES + 1024;
}

// TMA: a 2-D box global -> shared, completing on an mbarrier; shared ->
// global in a bulk group; the groups' waits
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map, int c0, int c1, uint32_t src) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(c0), "r"(c1), "r"(src)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores' reads of shared memory are done (the tile may be rewritten)
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int N, bool TMA_X>
__global__ void __launch_bounds__(NTHREADS, 1) layer_fwd_wgmma(const __grid_constant__ Args p) {
  constexpr int TM = tile_rows(N);
  constexpr int VPT = TM * KMAX / 8 / NTHREADS;  // x vectors a thread loads per tile, at most
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gen_base = smem_raw + (base - hopper::smem_u32(smem_raw));
  const int K = p.K, ncb = (p.Kw + 63) / 64, ksteps = p.Kw / 16;
  const int a_bytes = ncb * TM * 128;  // one x tile
  const uint32_t wS = base, aS = base + ncb * N * 128;
  const uint32_t oS = aS + p.stages * a_bytes, barS = oS + TM * N * 2;
  unsigned char* const aG = gen_base + ncb * N * 128;
  unsigned char* const oG = aG + p.stages * a_bytes;
  const int tid = threadIdx.x, wg = tid >> 7, wl = (tid & 127) >> 5, lane = tid & 31;
  const int wrow = N == 128 ? wg * 64 : 0, wcol = N == 256 ? wg * 128 : 0;
  const long long tiles = (p.M + TM - 1) / TM;
  const long long t_begin = tiles * blockIdx.x / gridDim.x;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;

  // TMA: x tile t into stage s, ncb boxes of 64 columns
  auto load_tile = [&](long long t, int s) {
    const uint32_t bar = barS + 8 * s;
    hopper::mbar_arrive_expect_tx(bar, a_bytes);
    for (int kb = 0; kb < ncb; ++kb)
      tma_load(aS + s * a_bytes + kb * TM * 128, &p.xmap, kb * 64, (int)(t * TM), bar);
  };
  if constexpr (TMA_X) {
    if (tid == 0) {
      for (int s = 0; s < p.stages; ++s) hopper::mbar_init(barS + 8 * s, 1);
      hopper::fence_barrier_init();
    }
    __syncthreads();
    if (tid == 0)
      for (int s = 0; s < p.stages && t_begin + s < t_end; ++s) load_tile(t_begin + s, s);
  }

  // w^T, K-major and swizzled, zero past Kw
  for (int v = tid; v < N * ncb * 8; v += NTHREADS) {
    const int n = v / (ncb * 8), c = v - n * ncb * 8;
    const bool ok = c * 8 < p.Kw;
    hopper::cp_async16(wS + (c >> 3) * (N * 128) + hopper::swz(n, c & 7),
                       ok ? p.wt + (size_t)n * p.Kw + c * 8 : p.wt, ok ? 16 : 0);
  }
  hopper::cp_async_commit();

  // the register route: tile t's x as 16-byte vectors (tile t starts at
  // element t TM K, a multiple of 8; only the array's last vector can be
  // partial), scattered element by element into the swizzled tile
  uint4 xv[VPT];
  auto elements = [&](long long t) {
    return (int)(p.M - t * TM < TM ? p.M - t * TM : TM) * K;
  };
  auto fetch = [&](long long t) {
    const int nel = elements(t);
    const bf16* src = p.x + (size_t)t * TM * K;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int e0 = (tid + j * NTHREADS) * 8;
      if (e0 + 8 <= nel) {
        xv[j] = __ldcs(reinterpret_cast<const uint4*>(src + e0));
      } else if (e0 < nel) {
        const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src + e0);
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = (e0 + 2 * i < nel ? s16[2 * i] : 0u) |
                 ((e0 + 2 * i + 1 < nel ? (uint32_t)s16[2 * i + 1] : 0u) << 16);
        xv[j] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };
  auto scatter = [&](long long t) {
    const int nel = elements(t);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int e0 = (tid + j * NTHREADS) * 8;
      if (e0 >= nel) continue;
      int r = e0 / K, c = e0 - r * K;
      const uint32_t w[4] = {xv[j].x, xv[j].y, xv[j].z, xv[j].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (e0 + i < nel)
          *reinterpret_cast<unsigned short*>(aG + (c >> 6) * (TM * 128) +
                                             hopper::swz(r, (c & 63) >> 3) + (c & 7) * 2) =
              (unsigned short)(w[i >> 1] >> (16 * (i & 1)));
        if (++c == K) {
          c = 0;
          ++r;
        }
      }
    }
  };
  if constexpr (!TMA_X) {
    for (int v = tid; v < a_bytes / 16; v += NTHREADS)
      reinterpret_cast<uint4*>(aG)[v] = make_uint4(0u, 0u, 0u, 0u);
    if (t_begin < t_end) fetch(t_begin);
  }
  hopper::cp_async_wait<0>();
  hopper::fence_async_smem();
  __syncthreads();  // w (and the zero tile) before any product or scatter

  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);
  float acc[64];
  int i = 0;  // the block's tiles done
  for (long long t = t_begin; t < t_end; ++t, ++i) {
    const int s = TMA_X ? i % p.stages : 0;
    if constexpr (TMA_X) {
      hopper::mbar_wait(barS + 8 * s, (i / p.stages) & 1);
    } else {
      scatter(t);
      hopper::fence_async_smem();
      __syncthreads();
      // the next tile's loads fly while this tile's product runs
      if (t + 1 < t_end) fetch(t + 1);
    }
    const uint32_t a0 = aS + s * a_bytes + wrow * 128, w0 = wS + wcol * 128;
    hopper::wgmma_fence();
    hopper::wgmma_nn0<128>(acc, hopper::desc(a0, 16, 1024), hopper::desc(w0, 16, 1024));
    for (int k = 1; k < ksteps; ++k) {
      const uint32_t off = (k & 3) * 32;
      hopper::wgmma_nn<128>(acc, hopper::desc(a0 + (k >> 2) * (TM * 128) + off, 16, 1024),
                            hopper::desc(w0 + (k >> 2) * (N * 128) + off, 16, 1024));
    }
    hopper::wgmma_commit();
    if (tid == 0) bulk_wait_read();  // the previous tile's store has read the output tile
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(acc);
    __syncthreads();  // every product has read stage s; the output tile is free
    if constexpr (TMA_X)
      if (tid == 0 && t + p.stages < t_end) load_tile(t + p.stages, s);
    // round, add the bias, clamp: two columns an instruction, into the
    // output tile in the tensor map's swizzle
    const long long row0 = t * TM;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + wl * 16 + (lane >> 2) + 8 * h;
      const long long m = row0 + r < p.M ? row0 + r : p.M - 1;
      const bf16* const brow = p.b + (p.per_ray ? (size_t)((unsigned)m / (unsigned)p.S) * N : 0);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = wcol + 8 * j + 2 * (lane & 3);
        const __nv_bfloat162 bb = __ldg(reinterpret_cast<const __nv_bfloat162*>(brow + col));
        const __nv_bfloat162 z =
            __hadd2(__float22bfloat162_rn(make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1])), bb);
        *reinterpret_cast<__nv_bfloat162*>(oG + (col >> 6) * (TM * 128) + hopper::swz(r, (col & 63) >> 3) +
                                           (col & 7) * 2) = __hmax2_nan(z, zero2);
      }
    }
    hopper::fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      for (int ob = 0; ob < N / 64; ++ob) tma_store(&p.ymap, ob * 64, (int)row0, oS + ob * TM * 128);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait();
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a bf16 [rows, cols] row-major array as boxes of 64 columns x box_rows
// rows, 128-byte swizzle, out-of-bounds elements read as zero
cudaError_t tensor_map(CUtensorMap* map, const void* base, long long rows, int cols, int box_rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int N, bool TMA_X>
cudaError_t launch(const Args& p, int grid, int smem, cudaStream_t stream) {
  const auto kernel = layer_fwd_wgmma<N, TMA_X>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* layer_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The layer on `stream`.  ptr: x wt b y; dims: M S K Kw N grid smem per_ray
// stages (plan.py::layer_fwd_plan's layout; S is read only with per_ray;
// stages 1 takes the register route for x, which a K that is not a
// multiple of 8 needs).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan this file's layout does not match.
int layer_fwd(const void* const* ptr, const long long* dims, void* stream) {
  Args p;
  p.x = static_cast<const bf16*>(ptr[0]);
  p.wt = static_cast<const bf16*>(ptr[1]);
  p.b = static_cast<const bf16*>(ptr[2]);
  p.M = dims[0];
  p.S = (int)dims[1];
  p.K = (int)dims[2];
  p.Kw = (int)dims[3];
  p.N = (int)dims[4];
  const int grid = (int)dims[5], smem = (int)dims[6];
  p.per_ray = (int)dims[7];
  p.stages = (int)dims[8];
  const bool tma_x = p.K % 8 == 0;
  if (p.M <= 0 || p.M >= (1ll << 31) || p.S <= 0 || grid <= 0 || p.K < 1 || p.K > KMAX ||
      p.Kw != (p.K + 15) / 16 * 16 || (p.N != 128 && p.N != 256) ||
      (tma_x ? p.stages < 1 || p.stages > MAX_STAGES : p.stages != 1) ||
      smem != smem_bytes(p.Kw, p.N, p.stages) || (p.per_ray && p.M % p.S))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tm = tile_rows(p.N);
  cudaError_t e = tensor_map(&p.ymap, ptr[3], p.M, p.N, tm);
  if (e == cudaSuccess && tma_x) e = tensor_map(&p.xmap, ptr[0], p.M, p.K, tm);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.N == 256)
    e = tma_x ? launch<256, true>(p, grid, smem, st) : launch<256, false>(p, grid, smem, st);
  else
    e = tma_x ? launch<128, true>(p, grid, smem, st) : launch<128, false>(p, grid, smem, st);
  return static_cast<int>(e);
}

}  // extern "C"
