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
// rounded to cd, and bias / per-ray rows are added in cd.
//
// The encode argument x_c * f_k is one f32 multiply and sinf / cosf are
// the full-range versions: this file must not be built with
// --use_fast_math, and must not call __sinf / __cosf.  The arguments reach
// 2^9 * |x| ~ 1e3 rad, where the fast intrinsics lose the phase (the TPU
// kernel hit the same failure with a bf16 encode matmul: 2.8 absolute error
// against 7e-5).
//
// Bound on the H100: at the flagship (h = s = 256, F = 10) a sample costs
// ~0.56 MFLOP of bf16 products and moves 12 B in and 16 B out, plus ~3 KB
// of per-ray rows per ray: ~2e4 FLOP per byte, far above the card's ~295,
// so it is compute-bound.  3.15 M samples per 128x128 image -> ~1.8 ms at
// 989 TFLOP/s bf16 dense.
//
// Design: one block of 8 warps owns 64 consecutive sample rows (32 in f32;
// a row's ray is row / S).  The tile's activations stay in shared memory,
// in two [rows, max(h, s)] buffers that the layers ping-pong between; no
// intermediate touches device memory.  bf16 products run on the tensor
// cores through wmma 16x16x16 fragments with f32 accumulators; warp w owns
// 32 output columns for all 64 rows, reading its weight fragments straight
// from global memory (the ~0.6 MB of weights stay in L2), one k-step ahead.
// Each accumulator's epilogue (rounding, per-ray row, relu) runs straight
// from its registers.  f32 products run on the CUDA
// cores (f32 fma, no TF32).  The two narrow heads (sigma: N = 1, rgb:
// N = 3) are per-thread f32 dot products.  The hidden chain is
// trunk_common.cuh's, shared with K2's recompute (trunk_bwd.cu).
// A faster kernel (wgmma, TMA, weights staged in shared memory) is later
// work.

#include "trunk_common.cuh"

using namespace trunk;

namespace {

template <typename T>
struct Args {
  const float* pts;    // [R*S, 3]
  TrunkW<T> w;
  float* out;          // [R*S, 4]
  long long nrows;     // R*S
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS, 2) trunk_fwd_kernel(const Args<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  fwd_tile<T>(p.w, p.pts, p.nrows, (long long)blockIdx.x * tile_rows<T>(), p.out, smem);
}

template <typename T>
int launch(const void* const* in, void* out, const int* dims, void* stream) {
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
  const int smem = fwd_smem_bytes<T>(H, SC, F);
  // the plan (plan.py::trunk_fwd_plan) must match this file's layout
  if (dims[5] != smem || dims[6] != tile_rows<T>())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.nrows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((p.nrows + tile_rows<T>() - 1) / tile_rows<T>());
  trunk_fwd_kernel<T><<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* trunk_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K1 on `stream`; returns cudaGetLastError() after the launch.
// in:  pts zs1p featp sigp dirp zt1p b1 w1x w1s w1c bands w2 wof wos wd wd2
//      bd2 wr, then w1x w1s w1c w2 wof wd wd2 transposed (w1x null without
//      the input term; all cd but pts and bands)
// dims: R S H SC F smem tile_rows.  f32 selects cd = float32, else bf16.
// Requires H % 32 == 0 and SC % 32 == 0 (the wrapper checks).
int trunk_fwd(const void* const* in, void* out, const int* dims, int f32, void* stream) {
  return f32 ? launch<float>(in, out, dims, stream) : launch<bf16>(in, out, dims, stream);
}

}  // extern "C"
