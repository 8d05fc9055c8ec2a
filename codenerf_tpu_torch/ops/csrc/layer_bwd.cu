// K4: the single-pass backward of one linear + relu layer for Hopper
// (sm_90a).
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
// Operands are bf16 (the flagship; products on the tensor cores through
// wmma 16x16x16 with f32 accumulators) or f32 (products on the CUDA cores
// in f32 fma, no TF32).  K and N are multiples of 16; M is any count and
// S any ray length.
//
// Bound on the H100: each row reads x, y and g and writes dx, 2 KB a row
// at K = N = 256 in bf16, against 4 K N = 262,144 FLOP of products: 128
// FLOP per byte, under the card's ~295, so K4 is bound by bytes.  A
// flagship train step runs it 6 times (layer_xyz2, layer_dir1 and
// layer_dir2 in the coarse and fine pass, 3.15 M rows each): 19.3 GB,
// 5.77 ms at 3.35 TB/s, against 2.50 ms for the products at 989 TFLOP/s
// (chip_smoke.py's k4_cost counts this run's inputs).
//
// Design.  The TPU kernel's sequential grid summed dw and db in output
// blocks it revisited in order; CUDA blocks run concurrently and in no
// order.  So the grid is persistent (about one block per SM), and each
// block owns a contiguous range of whole rays (of rows, for a bias) and
// walks it in row tiles:
//   * per tile, the block stages x and gp (the mask applied to g as y and
//     g arrive) in shared memory, reading x, y and g once with streaming
//     loads; gp never goes to device memory;
//   * dx = gp w^T comes from the staged gp and w (read from L2) and is
//     rounded and stored with streaming stores;
//   * dw: each warp owns fixed 16x16 blocks of dw and adds the tile's
//     x^T gp to them in the block's own f32 slab in global memory (the
//     accumulator fragments are loaded from and stored to it), so every
//     element is summed in row order by one warp; ~132 slabs of 256 x 256
//     f32 are 34.7 MB, inside the 50 MB L2;
//   * db: one thread per column walks the tile's rows in order; per-ray
//     sums are written to the ray's row when its last row passes (the
//     block owns the ray), a bias's sum goes to the slab at the end;
//   * layer_bwd_reduce sums the slabs in block order.
// No atomics: two calls on the same card give the same bits.  The slab
// read-modify-write moves 512 KB per 128-row tile through L2, 4 KB a row
// against the 2 KB the row needs from device memory; wgmma, TMA and a
// dw that stays on chip longer are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;  // shared-memory row padding, elements

// rows per tile: bf16 tiles of x and gp at K = N = 256 take 132 KB
template <typename T>
__host__ __device__ constexpr int tile_rows() { return sizeof(T) == 2 ? 128 : 32; }

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }

struct Args {
  const void* x;   // [M, K]
  const void* w;   // [K, N], the operand type
  const void* y;   // [M, N]
  const void* g;   // [M, N]
  void* dx;        // [M, K]
  float* slabs;    // [G, K N (+ N for a bias)]
  float* db_rows;  // [R, N] per-ray sums, or null for a bias
  long long M;
  int S, K, N, G;
};

size_t smem_bytes(int bf, int K, int N) {
  const size_t tm = bf ? tile_rows<bf16>() : tile_rows<float>();
  const size_t es = bf ? 2 : 4;
  return tm * (K + PAD) * es + tm * (N + PAD) * es + (bf ? NWARPS * 256 * 4 : 0) +
         (size_t)N * 4;
}

// Stage rows [row0, row0 + nvalid) of x and gp = where(y > 0, g, 0) in
// shared memory; rows from nvalid to the tile's end are zero.
template <typename T>
__device__ __forceinline__ void stage_tile(const Args& p, long long row0, int nvalid, T* xs,
                                           T* gps) {
  constexpr int TM = tile_rows<T>();
  constexpr int V = 16 / sizeof(T);
  const int K = p.K, N = p.N, ldx = K + PAD, ldg = N + PAD;
  const T* x = static_cast<const T*>(p.x);
  const T* y = static_cast<const T*>(p.y);
  const T* g = static_cast<const T*>(p.g);
  const int kv = K / V, nv = N / V;
  for (int i = threadIdx.x; i < TM * kv; i += NTHREADS) {
    const int r = i / kv, c = (i - r * kv) * V;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) v = __ldcs(reinterpret_cast<const uint4*>(x + (row0 + r) * K + c));
    *reinterpret_cast<uint4*>(xs + r * ldx + c) = v;
  }
  for (int i = threadIdx.x; i < TM * nv; i += NTHREADS) {
    const int r = i / nv, c = (i - r * nv) * V;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) {
      const size_t off = (size_t)(row0 + r) * N + c;
      const uint4 yv = __ldcs(reinterpret_cast<const uint4*>(y + off));
      const uint4 gv = __ldcs(reinterpret_cast<const uint4*>(g + off));
      const T* ye = reinterpret_cast<const T*>(&yv);
      const T* ge = reinterpret_cast<const T*>(&gv);
      T* oe = reinterpret_cast<T*>(&out);
      uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const T* z = reinterpret_cast<const T*>(&zero);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = to_f(ye[j]) > 0.0f ? ge[j] : z[j];
    }
    *reinterpret_cast<uint4*>(gps + r * ldg + c) = out;
  }
}

// dx rows of the tile (bf16): warp tasks of 64 rows x 32 columns of dx,
// gp from shared memory, w^T fragments from global memory (col-major view
// of the row-major [K, N] w).
__device__ __forceinline__ void dx_tile(const Args& p, const bf16* gps, long long row0,
                                        int nvalid, float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int K = p.K, N = p.N, ldg = N + PAD;
  const bf16* w = static_cast<const bf16*>(p.w);
  bf16* dx = static_cast<bf16*>(p.dx);
  float* st = stage + warp * 256;
  const int ncol = (K + 31) / 32, nrow = (nvalid + 63) / 64;
  for (int task = warp; task < nrow * ncol; task += NWARPS) {
    const int rb = (task / ncol) * 64, k0 = (task % ncol) * 32;
    const bool two = k0 + 16 < K;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
      wmma::load_matrix_sync(b[0], w + (size_t)k0 * N + n0, N);
      if (two) wmma::load_matrix_sync(b[1], w + (size_t)(k0 + 16) * N + n0, N);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (rb + i * 16 >= nvalid) break;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, gps + (rb + i * 16) * ldg + n0, ldg);
        wmma::mma_sync(acc[i][0], a, b[0], acc[i][0]);
        if (two) wmma::mma_sync(acc[i][1], a, b[1], acc[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (rb + i * 16 >= nvalid) break;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !two) break;
        wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        // lane -> row lane / 2, columns (lane % 2) * 8 .. + 8: one 16-byte store
        const int r = rb + i * 16 + (lane >> 1), c = (lane & 1) * 8;
        if (r < nvalid) {
          uint4 out;
          unsigned short* h = reinterpret_cast<unsigned short*>(&out);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            h[e] = __bfloat16_as_ushort(__float2bfloat16_rn(st[(lane >> 1) * 16 + c + e]));
          __stcs(reinterpret_cast<uint4*>(dx + (row0 + r) * K + k0 + j * 16 + c), out);
        }
        __syncwarp();
      }
    }
  }
}

// slab[K, N] (+)= xs^T gps over the tile's rows (bf16): warp tasks of
// 32 x 64 blocks of dw, each element summed by one warp in row order.
__device__ __forceinline__ void dw_tile(const Args& p, const bf16* xs, const bf16* gps,
                                        int nvalid, float* slab, bool first) {
  const int warp = threadIdx.x >> 5;
  const int K = p.K, N = p.N, ldx = K + PAD, ldg = N + PAD;
  const int nk = (K + 31) / 32, nn = (N + 63) / 64;
  const int mend = (nvalid + 15) & ~15;  // rows past nvalid are zero
  for (int task = warp; task < nk * nn; task += NWARPS) {
    const int k0 = (task / nn) * 32, n0 = (task % nn) * 64;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + i * 16 >= K || n0 + j * 16 >= N) continue;
        if (first)
          wmma::fill_fragment(acc[i][j], 0.0f);
        else
          wmma::load_matrix_sync(acc[i][j], slab + (size_t)(k0 + i * 16) * N + n0 + j * 16, N,
                                 wmma::mem_row_major);
      }
    for (int m0 = 0; m0 < mend; m0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (k0 + i * 16 < K) wmma::load_matrix_sync(a[i], xs + m0 * ldx + k0 + i * 16, ldx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n0 + j * 16 >= N) continue;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, gps + m0 * ldg + n0 + j * 16, ldg);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (k0 + i * 16 < K) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + i * 16 >= K || n0 + j * 16 >= N) continue;
        wmma::store_matrix_sync(slab + (size_t)(k0 + i * 16) * N + n0 + j * 16, acc[i][j], N,
                                wmma::mem_row_major);
      }
  }
}

// The same two products in f32 on the CUDA cores: one thread per output
// element, sums in a fixed order.
__device__ __forceinline__ void dx_tile(const Args& p, const float* gps, long long row0,
                                        int nvalid, float*) {
  const int K = p.K, N = p.N, ldg = N + PAD;
  const float* w = static_cast<const float*>(p.w);
  float* dx = static_cast<float*>(p.dx);
  for (int i = threadIdx.x; i < nvalid * K; i += NTHREADS) {
    const int r = i / K, k = i - r * K;
    const float* gr = gps + r * ldg;
    const float* wr = w + (size_t)k * N;
    float acc = 0.0f;
    for (int n = 0; n < N; ++n) acc = fmaf(gr[n], __ldg(wr + n), acc);
    __stcs(dx + (row0 + r) * K + k, acc);
  }
}

__device__ __forceinline__ void dw_tile(const Args& p, const float* xs, const float* gps,
                                        int nvalid, float* slab, bool first) {
  const int K = p.K, N = p.N, ldx = K + PAD, ldg = N + PAD;
  for (int i = threadIdx.x; i < K * N; i += NTHREADS) {
    const int k = i / N, n = i - k * N;
    float acc = first ? 0.0f : slab[i];
    for (int m = 0; m < nvalid; ++m) acc = fmaf(xs[m * ldx + k], gps[m * ldg + n], acc);
    slab[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 1) layer_bwd_kernel(Args p) {
  constexpr int TM = tile_rows<T>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int K = p.K, N = p.N, ldg = N + PAD;
  const bool per_ray = p.db_rows != nullptr;
  T* xs = reinterpret_cast<T*>(smem);
  T* gps = xs + TM * (K + PAD);
  float* stage = reinterpret_cast<float*>(gps + TM * ldg);
  float* dbacc = stage + (sizeof(T) == 2 ? NWARPS * 256 : 0);

  // this block's rows: whole rays, or whole tiles for a bias
  const long long unit = per_ray ? p.S : TM;
  const long long units = per_ray ? p.M / p.S : (p.M + TM - 1) / TM;
  const long long u0 = units * blockIdx.x / p.G, u1 = units * (blockIdx.x + 1) / p.G;
  const long long r_begin = u0 * unit;
  const long long r_end = u1 * unit < p.M ? u1 * unit : p.M;
  const size_t stride = (size_t)K * N + (per_ray ? 0 : N);
  float* slab = p.slabs + (size_t)blockIdx.x * stride;

  for (int c = threadIdx.x; c < N; c += NTHREADS) dbacc[c] = 0.0f;
  bool first = true;
  for (long long row0 = r_begin; row0 < r_end; row0 += TM) {
    const int nvalid = (int)(r_end - row0 < TM ? r_end - row0 : TM);
    stage_tile<T>(p, row0, nvalid, xs, gps);
    __syncthreads();

    // db: each column's rows in order; a per-ray sum is written when its
    // ray's last row passes
    const int pos0 = per_ray ? (int)(row0 % p.S) : 0;
    const long long ray0 = per_ray ? row0 / p.S : 0;
    for (int c = threadIdx.x; c < N; c += NTHREADS) {
      float acc = dbacc[c];
      int pos = pos0;
      long long ray = ray0;
      for (int r = 0; r < nvalid; ++r) {
        acc += to_f(gps[r * ldg + c]);
        if (per_ray && ++pos == p.S) {
          p.db_rows[ray * N + c] = acc;
          acc = 0.0f;
          pos = 0;
          ++ray;
        }
      }
      dbacc[c] = acc;
    }

    dx_tile(p, gps, row0, nvalid, stage);
    dw_tile(p, xs, gps, nvalid, slab, first);
    first = false;
    __syncthreads();
  }
  if (!per_ray)
    for (int c = threadIdx.x; c < N; c += NTHREADS) slab[(size_t)K * N + c] = dbacc[c];
}

// out[i] = sum over the slabs in block order
__global__ void layer_bwd_reduce(const float* slabs, int nslab, long long stride, float* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= stride) return;
  float acc = 0.0f;
  for (int b = 0; b < nslab; ++b) acc += slabs[(size_t)b * stride + i];
  out[i] = acc;
}

template <typename T>
int set_smem(int K, int N) {
  return static_cast<int>(cudaFuncSetAttribute(layer_bwd_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes(sizeof(T) == 2, K, N)));
}

template <typename T>
int grid_of(int per_ray, long long M, int S, int K, int N, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int se = set_smem<T>(K, N);
  if (se != 0) return se;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, layer_bwd_kernel<T>, NTHREADS,
                                                    smem_bytes(sizeof(T) == 2, K, N));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tm = tile_rows<T>();
  const long long units = per_ray ? M / S : (M + tm - 1) / tm;
  const long long g = (long long)sms * per_sm;
  *grid = (int)(g < units ? g : units);
  return 0;
}

}  // namespace

extern "C" {

// Shared memory per block for operand type bf16 (bf = 1) or f32 (bf = 0).
int layer_bwd_smem_bytes(int bf, int K, int N) { return (int)smem_bytes(bf, K, N); }

// Blocks of the persistent grid (one slab each) for M rows on the current
// device; returns a CUDA error code.
int layer_bwd_grid(int bf, int per_ray, int M, int S, int K, int N, int* grid) {
  if (M <= 0 || S <= 0 || K <= 0 || N <= 0 || K % 16 || N % 16 || (per_ray && M % S))
    return static_cast<int>(cudaErrorInvalidValue);
  return bf ? grid_of<bf16>(per_ray, M, S, K, N, grid)
            : grid_of<float>(per_ray, M, S, K, N, grid);
}

const char* layer_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K4 on `stream`: the kernel, then the slab reduction into `flat` (dw, and
// db after it for a bias).  `db_rows` null selects a bias [N]; otherwise
// the per-ray sums go there.  Returns cudaGetLastError().
int layer_bwd(const void* x, const void* w, const void* y, const void* g, void* dx, void* slabs,
              void* flat, void* db_rows, int bf, int M, int S, int K, int N, int G,
              void* stream) {
  if (M <= 0 || G <= 0 || S <= 0 || K % 16 || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.x = x;
  p.w = w;
  p.y = y;
  p.g = g;
  p.dx = dx;
  p.slabs = static_cast<float*>(slabs);
  p.db_rows = static_cast<float*>(db_rows);
  p.M = M;
  p.S = db_rows != nullptr ? S : 1;
  p.K = K;
  p.N = N;
  p.G = G;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes(bf, K, N);
  int se = bf ? set_smem<bf16>(K, N) : set_smem<float>(K, N);
  if (se != 0) return se;
  if (bf)
    layer_bwd_kernel<bf16><<<G, NTHREADS, smem, st>>>(p);
  else
    layer_bwd_kernel<float><<<G, NTHREADS, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long stride = (long long)K * N + (db_rows != nullptr ? 0 : N);
  layer_bwd_reduce<<<(unsigned)((stride + 255) / 256), 256, 0, st>>>(p.slabs, G, stride,
                                                                     static_cast<float*>(flat));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
