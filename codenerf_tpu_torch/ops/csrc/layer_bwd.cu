// K4: the backward of one linear + relu layer for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/layer_bwd.py::
// linear_relu_bwd_pallas, the backward of _dot_add_relu_pl
// (models/ray_structured.py) under runtime.pallas_layer_bwd.  For
// y = relu(x @ w + b) and the cotangent g of y, over M rows:
//
//   gp = where(float(y) > 0, g, 0)          in the operand type
//   dx = gp @ w^T   [M, K]                   f32 sums, rounded to x's type
//   dw = x^T @ gp   [K, N]                   f32 sums over every row
//   db = sum of float(gp) over the rows      [N] for a bias; per-ray sums
//                                            over each ray's S rows [R, N]
//                                            for per-ray rows
//
// Operands are bf16 (the flagship) or f32 (products on the CUDA cores in
// f32 fma, no TF32).  K and N are multiples of 16 (at most 256 in bf16);
// M is any count and S any ray length.
//
// Bound on the H100: each row reads x, y and g and writes dx, 2 KB a row
// at K = N = 256 in bf16, against 4 K N = 262,144 FLOP of products: 128
// FLOP per byte, under the card's ~295, so K4 is bound by bytes.  A
// flagship train step runs it 6 times (layer_xyz2, layer_dir1 and
// layer_dir2 in the coarse and fine pass, 3.15 M rows each): 19.3 GB,
// 5.77 ms at 3.35 TB/s, against 2.50 ms for the products at 989 TFLOP/s
// (chip_smoke.py's k4_cost counts this run's inputs).
//
// What held the first port back (39.6 ms per step, 14-15% of the byte
// rate): one block per SM (144 KB of shared memory, 207 registers) with no
// pipeline (the loads of x, y and g, the wmma products and the dw update
// ran one after another), w's fragments re-read from L2 for every tile,
// and dw summed per block in an f32 slab read and written for every
// 128-row tile: 4 KB a row through L2 against the 2 KB the row needs.
//
// Two designs were weighed.  (a) One pass on a cluster of four blocks with
// TMA multicast of x, y and g, each block keeping a 64-column slice of w
// and of dw (as a wgmma accumulator over its whole row range), would move
// only the bound's 2 KB a row; it needs cluster launch, multicast barriers
// across four SMs and a dx product split over the cluster.  (b) Two
// kernels, mask + dx + db, then a tall dw product, move ~3 KB a row (gp
// is written once in bf16 and read once) with two simple kernels and the
// weight-gradient product K2 / K3 already use (xtg.cuh).  (b) is taken:
// ~1.5x the bound's bytes, each kernel streaming at the card's rate.
//
//   1. layer_bwd_rows_kernel: a persistent grid whose blocks own whole
//      rays (whole 64-row tiles for a bias).  Each block keeps w in shared
//      memory for its whole range (bf16: 128 KB at K = N = 256, K-major,
//      128-byte swizzled), and per 64-row tile: reads y and g (the next
//      tile's loads are issued before this tile's product, so they are in
//      flight while it runs), writes gp to shared memory and device memory,
//      runs dx = gp w^T as wgmma m64n128k16 (two warpgroups, 64 f32
//      registers each) and rounds dx to bf16 as it stores it; while the
//      wgmma runs, one thread per column sums gp into db in row order
//      (per-ray sums written when the ray's last row passes; a bias's sum
//      to the block's partial).
//   2. xtg.cuh: dw = x^T gp as a tall split-K wgmma product, partials
//      summed in split order; a bias's db partials summed in block order.
// No atomics: two calls on the same card give the same bits.  f32 keeps
// the same two steps with CUDA-core products (32-row tiles).

#include "xtg.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;
constexpr int KR = 256;  // rows of w's shared-memory tile (bf16): K <= 256

template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return sizeof(T) == 2 ? 64 : 32;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
struct Args {
  const T* w;       // [K, N]
  const T* y;       // [M, N]
  const T* g;       // [M, N]
  T* gp;            // [M, N]
  T* dx;            // [M, K]
  float* db_rows;   // [R, N] per-ray sums, or null for a bias
  float* db_part;   // [G, N] per-block sums of a bias
  long long M;
  int S, K, N;
};

// shared memory of the row pass: bf16 w and gp column blocks of 64, the dx
// tile (row stride K + 8), the db sums, alignment slack; f32 a padded gp
// tile and the db sums
__host__ __device__ inline int rows_smem_bytes(int bf, int K, int N) {
  const int ncb = (N + 63) / 64;
  return bf ? ncb * (KR * 128 + 64 * 128) + 64 * (K + 8) * 2 + N * 4 + 1024
            : tile_rows<float>() * (N + 4) * 4 + N * 4;
}

// db: one thread a column walks the tile's rows in order; a per-ray sum is
// written when its ray's last row passes.  get(r, c) reads gp.
template <typename T, class Get>
__device__ __forceinline__ void db_walk(const Args<T>& p, long long row0, int nvalid,
                                        float* dbacc, Get get) {
  const bool per_ray = p.db_rows != nullptr;
  const int pos0 = per_ray ? (int)(row0 % p.S) : 0;
  const long long ray0 = per_ray ? row0 / p.S : 0;
  for (int c = threadIdx.x; c < p.N; c += NTHREADS) {
    float acc = dbacc[c];
    int pos = pos0;
    long long ray = ray0;
    for (int r = 0; r < nvalid; ++r) {
      acc += get(r, c);
      if (per_ray && ++pos == p.S) {
        p.db_rows[ray * p.N + c] = acc;
        acc = 0.0f;
        pos = 0;
        ++ray;
      }
    }
    dbacc[c] = acc;
  }
}

// this block's rows: whole rays, or whole tiles for a bias
__device__ __forceinline__ void block_rows(long long M, int S, bool per_ray, int tm,
                                           long long* r_begin, long long* r_end) {
  const long long unit = per_ray ? S : tm;
  const long long units = per_ray ? M / S : (M + tm - 1) / tm;
  const long long u0 = units * blockIdx.x / gridDim.x, u1 = units * (blockIdx.x + 1) / gridDim.x;
  *r_begin = u0 * unit;
  *r_end = u1 * unit < M ? u1 * unit : M;
}

__global__ void __launch_bounds__(NTHREADS, 1) layer_bwd_rows_bf16(const Args<bf16> p) {
  constexpr int TM = 64, VPT = 8;  // VPT: 16-byte vectors of y (and g) a thread loads per tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* const gen_base = smem_raw + (base - hopper::smem_u32(smem_raw));
  const int K = p.K, N = p.N, ncb = (N + 63) / 64, nv = N / 8;
  const uint32_t wS = base, gS = base + ncb * KR * 128;
  unsigned char* const gpS = gen_base + ncb * KR * 128;
  bf16* const dxS = reinterpret_cast<bf16*>(gen_base + ncb * (KR * 128 + 64 * 128));
  const int ldd = K + 8;
  float* const dbacc = reinterpret_cast<float*>(dxS + 64 * ldd);
  const int tid = threadIdx.x, wg = tid >> 7, wl = (tid & 127) >> 5, lane = tid & 31;
  const bool per_ray = p.db_rows != nullptr;
  long long r_begin, r_end;
  block_rows(p.M, p.S, per_ray, TM, &r_begin, &r_end);

  // w, K-major and swizzled, zero past K and N; gp's tile zero
  for (int v = tid; v < KR * ncb * 8; v += NTHREADS) {
    const int k = v / (ncb * 8), c = v - k * ncb * 8;
    const bool ok = k < K && c * 8 < N;
    hopper::cp_async16(wS + (c >> 3) * (KR * 128) + hopper::swz(k, c & 7),
                       ok ? p.w + (size_t)k * N + c * 8 : p.w, ok ? 16 : 0);
  }
  hopper::cp_async_commit();
  for (int v = tid; v < ncb * 64 * 8; v += NTHREADS)
    reinterpret_cast<uint4*>(gpS)[v] = make_uint4(0u, 0u, 0u, 0u);
  for (int c = tid; c < N; c += NTHREADS) dbacc[c] = 0.0f;

  uint4 yv[VPT], gv[VPT];
  auto fetch = [&](long long row0) {
    const int nvalid = (int)(r_end - row0 < TM ? r_end - row0 : TM);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = tid + j * NTHREADS, r = v / nv, c = v - r * nv;
      if (r < nvalid) {
        const size_t off = (size_t)(row0 + r) * N + c * 8;
        yv[j] = __ldcs(reinterpret_cast<const uint4*>(p.y + off));
        gv[j] = __ldcs(reinterpret_cast<const uint4*>(p.g + off));
      }
    }
  };
  if (r_begin < r_end) fetch(r_begin);
  hopper::cp_async_wait<0>();

  float acc[64];
  for (long long row0 = r_begin; row0 < r_end; row0 += TM) {
    const int nvalid = (int)(r_end - row0 < TM ? r_end - row0 : TM);
    // gp = where(y > 0, g, 0): to shared memory (rows past nvalid zero) and
    // device memory
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int v = tid + j * NTHREADS, r = v / nv, c = v - r * nv;
      if (r < TM) {
        uint4 out = make_uint4(0u, 0u, 0u, 0u);
        if (r < nvalid) {
          const bf16* ye = reinterpret_cast<const bf16*>(&yv[j]);
          const bf16* ge = reinterpret_cast<const bf16*>(&gv[j]);
          bf16* oe = reinterpret_cast<bf16*>(&out);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            oe[e] = to_f(ye[e]) > 0.0f ? ge[e] : __float2bfloat16_rn(0.0f);
          __stcs(reinterpret_cast<uint4*>(p.gp + (size_t)(row0 + r) * N + c * 8), out);
        }
        *reinterpret_cast<uint4*>(gpS + (c >> 3) * (64 * 128) + hopper::swz(r, c & 7)) = out;
      }
    }
    hopper::fence_async_smem();
    __syncthreads();
    // the next tile's loads fly while this tile's product runs
    if (row0 + TM < r_end) fetch(row0 + TM);

    const bool active = wg * 128 < K;  // warpgroup-uniform
    if (active) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      hopper::wgmma_fence();
      for (int s = 0; s < ncb * 4; ++s) {
        const uint32_t off = (s & 3) * 32;
        hopper::wgmma_nn<128>(
            acc, hopper::desc(gS + (s >> 2) * (64 * 128) + off, 16, 1024),
            hopper::desc(wS + (s >> 2) * (KR * 128) + wg * 128 * 128 + off, 16, 1024));
      }
      hopper::wgmma_commit();
    }
    db_walk(p, row0, nvalid, dbacc, [&](int r, int c) {
      const int cc = c & 63;
      return to_f(*reinterpret_cast<const bf16*>(gpS + (c >> 6) * (64 * 128) +
                                                 hopper::swz(r, cc >> 3) + (cc & 7) * 2));
    });
    if (active) {
      hopper::wgmma_wait<0>();
      hopper::fence_regs<64>(acc);
      // dx rounded to bf16 into the dx tile, two columns a store
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wl * 16 + (lane >> 2) + 8 * h;
          const int col = wg * 128 + 8 * j + 2 * (lane & 3);
          if (col < K)
            *reinterpret_cast<__nv_bfloat162*>(dxS + r * ldd + col) =
                __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
    }
    __syncthreads();
    // the tile's dx rows, 16 bytes a store
    for (int v = tid; v < nvalid * (K / 8); v += NTHREADS) {
      const int r = v / (K / 8), c = v - r * (K / 8);
      __stcs(reinterpret_cast<uint4*>(p.dx + (size_t)(row0 + r) * K + c * 8),
             *reinterpret_cast<const uint4*>(dxS + r * ldd + c * 8));
    }
    __syncthreads();
  }
  if (!per_ray)
    for (int c = tid; c < N; c += NTHREADS) p.db_part[(size_t)blockIdx.x * N + c] = dbacc[c];
}

__global__ void __launch_bounds__(NTHREADS) layer_bwd_rows_f32(const Args<float> p) {
  constexpr int TM = 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = p.K, N = p.N, ldg = N + 4;
  float* const gps = reinterpret_cast<float*>(smem_raw);
  float* const dbacc = gps + TM * ldg;
  const bool per_ray = p.db_rows != nullptr;
  long long r_begin, r_end;
  block_rows(p.M, p.S, per_ray, TM, &r_begin, &r_end);
  for (int c = threadIdx.x; c < N; c += NTHREADS) dbacc[c] = 0.0f;
  for (long long row0 = r_begin; row0 < r_end; row0 += TM) {
    const int nvalid = (int)(r_end - row0 < TM ? r_end - row0 : TM);
    for (int i = threadIdx.x; i < TM * N; i += NTHREADS) {
      const int r = i / N, c = i - r * N;
      float v = 0.0f;
      if (r < nvalid) {
        const size_t off = (size_t)(row0 + r) * N + c;
        v = p.y[off] > 0.0f ? p.g[off] : 0.0f;
        p.gp[off] = v;
      }
      gps[r * ldg + c] = v;
    }
    __syncthreads();
    db_walk(p, row0, nvalid, dbacc, [&](int r, int c) { return gps[r * ldg + c]; });
    // dx = gp w^T: thread k owns column k of the tile's rows
    for (int k = threadIdx.x; k < K; k += NTHREADS) {
      float acc[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) acc[r] = 0.0f;
      const float* wk = p.w + (size_t)k * N;
      for (int n = 0; n < N; ++n) {
        const float wv = __ldg(wk + n);
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r] = fmaf(gps[r * ldg + n], wv, acc[r]);
      }
      for (int r = 0; r < nvalid; ++r) p.dx[(row0 + r) * K + k] = acc[r];
    }
    __syncthreads();
  }
  if (!per_ray)
    for (int c = threadIdx.x; c < N; c += NTHREADS)
      p.db_part[(size_t)blockIdx.x * N + c] = dbacc[c];
}

typedef void (*KernelBf16)(const Args<bf16>);
typedef void (*KernelF32)(const Args<float>);
KernelBf16 kernel_of(const Args<bf16>&) { return layer_bwd_rows_bf16; }
KernelF32 kernel_of(const Args<float>&) { return layer_bwd_rows_f32; }

template <typename T>
int launch(const void* const* ptr, const long long* dims, void* stream) {
  Args<T> p;
  p.w = static_cast<const T*>(ptr[0]);
  p.y = static_cast<const T*>(ptr[1]);
  p.g = static_cast<const T*>(ptr[2]);
  p.gp = static_cast<T*>(const_cast<void*>(ptr[3]));
  p.dx = static_cast<T*>(const_cast<void*>(ptr[4]));
  p.db_rows = static_cast<float*>(const_cast<void*>(ptr[5]));
  p.db_part = static_cast<float*>(const_cast<void*>(ptr[6]));
  p.M = dims[0];
  p.S = (int)dims[1];
  p.K = (int)dims[2];
  p.N = (int)dims[3];
  const int G = (int)dims[4], smem = (int)dims[5], tm = (int)dims[6];
  const bool bf = sizeof(T) == 2;
  // the plan (plan.py::layer_bwd_plan) must match this file's layout
  if (p.M <= 0 || p.S <= 0 || G <= 0 || p.K % 16 || p.N % 16 || (bf && (p.K > KR || p.N > 256)) ||
      smem != rows_smem_bytes(bf, p.K, p.N) || tm != tile_rows<T>() ||
      (p.db_rows != nullptr && p.M % p.S))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kernel_of(p);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<G, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* layer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Step 1 of K4 on `stream`: gp, dx and db.  ptr: w y g gp dx db_rows
// db_part (db_rows null for a bias, db_part null for per-ray rows); dims:
// M S K N G smem tile_rows.  Returns cudaGetLastError().
int layer_bwd_rows(const void* const* ptr, const long long* dims, int f32, void* stream) {
  return f32 ? launch<float>(ptr, dims, stream) : launch<bf16>(ptr, dims, stream);
}

// Step 2: dw = x^T gp (xtg.cuh), with its reduction.
int layer_bwd_xtg(const long long* plan, int n, int f32, void* stream) {
  return xtg::run(plan, n, f32, stream);
}

// A bias's db partials summed in block order.
int layer_bwd_sum(const long long* rows, int n, void* stream) {
  return xtg::sum_parts(rows, n, stream);
}

}  // extern "C"
