// K1: the fused CodeNeRF trunk forward for Hopper (sm_90a).
//
// Replaces the TPU kernel codenerf_tpu/ops/fused.py::_trunk_kernel (launched
// by _trunk_pallas).  For every sample row of pts [R*S, 3] it computes
//
//   enc  = sin / cos(x_c * f_k)                       exact f32, then bf16
//   h1   = relu(bf16(bf16(bf16(sin@w1s) + bf16(cos@w1c)) + bf16(x@w1x)) + b1)
//   h2   = relu(bf16(h1@w2) + zs1p[ray])
//   feat = bf16(h2@wof) + featp[ray]                  sigma = f32(bf16(h2.wos)) + sigp[ray]
//   v1   = relu(bf16(feat@wd) + dirp[ray])
//   v2   = relu(bf16(v1@wd2) + bd2)
//   rgb  = f32(bf16(v2@wr)) + zt1p[ray]               raw = [rgb | sigma] f32
//
// with the TPU kernel's cast points: every product is an f32 sum of bf16
// products rounded to bf16, and bias / per-ray rows are added in bf16.
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
// Design: one block of 8 warps owns 64 consecutive sample rows (a row's
// ray is row / S).  The tile's activations stay in shared memory as bf16,
// in two [64, max(h, s)] buffers that the layers ping-pong between; no
// intermediate touches device memory.  Products run on the tensor cores
// through wmma bf16 16x16x16 fragments with f32 accumulators; warp w owns
// 32 output columns for all 64 rows, reading its weight fragments straight
// from global memory (the ~0.6 MB of weights stay in L2).  Each 16x16
// accumulator goes through a per-warp f32 staging tile for the epilogue
// (rounding, per-ray row, relu).  The two narrow heads (sigma: N = 1,
// rgb: N = 3) are per-thread f32 dot products.  The encode and the hidden
// layers are in trunk_common.cuh, shared with the backward kernels
// (trunk_bwd.cu).  A faster kernel (wgmma, TMA, weights staged in shared
// memory) is later work.

#include "trunk_common.cuh"

using namespace trunk;

namespace {

struct Args {
  const float* pts;    // [R*S, 3]
  TrunkW w;
  float* out;          // [R*S, 4]
  long long nrows;     // R*S
};

__global__ void __launch_bounds__(NTHREADS, 2) trunk_fwd_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TrunkW& w = p.w;
  const int H = w.H, ld = w.ld, ldk = w.ldk;
  bf16* const bufA = reinterpret_cast<bf16*>(smem);
  bf16* const bufB = bufA + TM * ld;
  bf16* const encS = bufB + TM * ld;
  bf16* const encC = encS + TM * ldk;
  bf16* const encX = encC + TM * ldk;
  float* const stage = reinterpret_cast<float*>(encX + TM * LDX);
  float* const pts = stage + NWARPS * 256;
  float* const sig = pts + TM * 3;
  int* const ray = reinterpret_cast<int*>(sig + TM);

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * TM;
  const long long nrows = p.nrows;

  // rows past the end compute on zeros and are not written
  for (int i = tid; i < TM * 3; i += NTHREADS)
    pts[i] = (row0 + i / 3 < nrows) ? p.pts[row0 * 3 + i] : 0.0f;
  for (int r = tid; r < TM; r += NTHREADS) {
    const long long g = row0 + r < nrows ? row0 + r : nrows - 1;
    ray[r] = (int)(g / w.S);
  }
  __syncthreads();

  encode_tile(w, pts, encS, encC, encX);
  fwd_h1(w, encS, encC, encX, bufA, stage);       // h1: A
  fwd_h2(w, bufA, bufB, ray, stage);              // h2: B

  // fc_out's sigma column (threads 0..TM-1), then its feature columns
  if (tid < TM) {
    float acc = 0.0f;
    for (int k = 0; k < H; ++k) acc = fmaf(f32(bufB[tid * ld + k]), f32(w.wos[k]), acc);
    sig[tid] = rb(acc) + f32(w.sigp[ray[tid]]);
  }
  fwd_feat(w, bufB, bufA, ray, stage);            // feat: A
  fwd_v1(w, bufA, bufB, ray, stage);              // v1: B
  fwd_v2(w, bufB, bufA, stage);                   // v2: A

  // fc_rgb top half + per-ray zt1p row, and the sigma column
  for (int i = tid; i < TM * 3; i += NTHREADS) {
    const int r = i / 3, j = i - r * 3;
    const long long g = row0 + r;
    if (g < nrows) {
      float acc = 0.0f;
      for (int k = 0; k < H; ++k) acc = fmaf(f32(bufA[r * ld + k]), f32(w.wr[k * 3 + j]), acc);
      p.out[g * 4 + j] = rb(acc) + f32(w.zt1p[(size_t)ray[r] * 3 + j]);
    }
  }
  for (int r = tid; r < TM; r += NTHREADS)
    if (row0 + r < nrows) p.out[(row0 + r) * 4 + 3] = sig[r];
}

}  // namespace

extern "C" {

// Rows of the zero-padded w1s / w1c blocks the kernel reads.
int trunk_fwd_kp(int F) { return kp_of(F); }

// Dynamic shared memory of one block.
int trunk_fwd_smem_bytes(int H, int SC, int F) {
  const int ld = ld_of(H, SC), ldk = kp_of(F) + PAD;
  return 2 * TM * ld * 2 + 2 * TM * ldk * 2 + TM * LDX * 2 +
         NWARPS * 256 * 4 + TM * 3 * 4 + TM * 4 + TM * 4;
}

const char* trunk_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches K1 on `stream`; returns cudaGetLastError() after the launch.
// Requires H % 32 == 0 and SC % 32 == 0 (the wrapper checks).
int trunk_fwd(const void* pts, const void* zs1p, const void* featp, const void* sigp,
              const void* dirp, const void* zt1p, const void* b1, const void* w1x,
              const void* w1s, const void* w1c, const void* bands, const void* w2,
              const void* wof, const void* wos, const void* wd, const void* wd2,
              const void* bd2, const void* wr, void* out, int R, int S, int H, int SC,
              int F, void* stream) {
  Args p;
  p.pts = static_cast<const float*>(pts);
  TrunkW& w = p.w;
  w.zs1p = static_cast<const bf16*>(zs1p);
  w.featp = static_cast<const bf16*>(featp);
  w.sigp = static_cast<const bf16*>(sigp);
  w.dirp = static_cast<const bf16*>(dirp);
  w.zt1p = static_cast<const bf16*>(zt1p);
  w.b1 = static_cast<const bf16*>(b1);
  w.w1x = static_cast<const bf16*>(w1x);
  w.w1s = static_cast<const bf16*>(w1s);
  w.w1c = static_cast<const bf16*>(w1c);
  w.bands = static_cast<const float*>(bands);
  w.w2 = static_cast<const bf16*>(w2);
  w.wof = static_cast<const bf16*>(wof);
  w.wos = static_cast<const bf16*>(wos);
  w.wd = static_cast<const bf16*>(wd);
  w.wd2 = static_cast<const bf16*>(wd2);
  w.bd2 = static_cast<const bf16*>(bd2);
  w.wr = static_cast<const bf16*>(wr);
  p.out = static_cast<float*>(out);
  p.nrows = (long long)R * S;
  w.S = S;
  w.H = H;
  w.SC = SC;
  w.F = F;
  w.KP = kp_of(F);
  w.ld = ld_of(H, SC);
  w.ldk = w.KP + PAD;
  const int smem = trunk_fwd_smem_bytes(H, SC, F);
  cudaError_t e = cudaFuncSetAttribute(trunk_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.nrows == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((p.nrows + TM - 1) / TM);
  trunk_fwd_kernel<<<blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
