// Elementwise stage of the fused MLP's backward, fused with the fc1
// recompute, f32 (the parity path):
//
//   h  = x @ w1^T + b1                     (f32, never leaves the chip)
//   a  = round(h * cdf(h))                 cdf(h) = 0.5 * (1 + erf(h / sqrt 2))
//   dh = round(da * (cdf(h) + h * pdf(h))) pdf(h) = exp(-h^2 / 2) / sqrt(2 pi)
//
// Replaces K3's backward kernel, wildlifemapper_tpu/ops/fused_mlp.py::
// _bwd_dh_kernel (:120, called from _mlp_bwd :148). x is (R, D), w1 (F, D) in
// the torch Linear layout, b1 f32, da (R, F) the gradient of the GELU
// output; a and dh are (R, F) in x's type. `a` may be left out (null) when
// nobody needs the fc2 weight gradient. The four gradient GEMMs around it
// (da = g.w2, dx = dh.w1, dw1, dw2) stay library products in the wrapper, as
// the JAX package leaves them to XLA.
//
// This body recomputes h in scalar f32 FMAs (no TF32): a block keeps a tile
// of 32 x rows in shared memory and streams w1 in 64-wide hidden chunks; the
// epilogue of each chunk reads da and writes a and dh. D is one of 64, 128,
// 256, 768, 1024 and 1280 (ViT-H: the x tile and a w1 piece take 172,416
// bytes of shared memory). bf16 inputs take the Hopper GEMM body of
// mlp_gemm_sm90.cuh (epilogue BiasGeluGrad, where the header says what bounds
// the kernel on the H100), and this entry refuses them.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr float kRsqrt2 = 0.70710678118654752f;
constexpr float kRsqrt2Pi = 0.39894228040143268f;

// a = h * cdf and the factor of da in dh, for one hidden value.
__device__ __forceinline__ void gelu_and_grad(float h, float* act, float* dact) {
  const float cdf = 0.5f * (1.f + erff(h * kRsqrt2));
  const float pdf = expf(-0.5f * h * h) * kRsqrt2Pi;
  *act = h * cdf;
  *dact = cdf + h * pdf;
}

// ---- f32 scalar body --------------------------------------------------------

constexpr int MBM = 32;       // rows per block
constexpr int MBF = 64;       // hidden units per streamed chunk
constexpr int MKD = 32;       // depth of one w1 piece
constexpr int MTHREADS = 256;

template <int D>
__global__ void __launch_bounds__(MTHREADS)
mlp_dh_kernel(const float* __restrict__ x, const float* __restrict__ w1,
              const float* __restrict__ b1, const float* __restrict__ da,
              float* __restrict__ act, float* __restrict__ dh, int R, int F) {
  constexpr int LDX = D + 1;
  constexpr int LW1 = MKD + 1;
  extern __shared__ float smem[];
  float* xs = smem;
  float* w1s = xs + MBM * LDX;

  const int row0 = blockIdx.x * MBM;
  const int t = threadIdx.x;
  for (int i = t; i < MBM * D; i += MTHREADS) {
    const int r = i / D, c = i % D;
    xs[r * LDX + c] = (row0 + r < R) ? x[(long long)(row0 + r) * D + c] : 0.f;
  }

  // One row, 8 hidden units (stride 8) per thread.
  const int hr = t >> 3, hc = t & 7;
  const long long row = row0 + hr;
  for (int f0 = 0; f0 < F; f0 += MBF) {
    float hacc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) hacc[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += MKD) {
      __syncthreads();
      for (int i = t; i < MBF * MKD; i += MTHREADS) {
        const int dd = i % MKD, c = i / MKD;
        w1s[c * LW1 + dd] = w1[(long long)(f0 + c) * D + d0 + dd];
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < MKD; ++dd) {
        const float xv = xs[hr * LDX + d0 + dd];
#pragma unroll
        for (int j = 0; j < 8; ++j) hacc[j] = fmaf(xv, w1s[(hc + 8 * j) * LW1 + dd], hacc[j]);
      }
    }
    if (row < R) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = f0 + hc + 8 * j;
        float a_, d_;
        gelu_and_grad(hacc[j] + b1[col], &a_, &d_);
        if (act != nullptr) act[row * F + col] = a_;
        dh[row * F + col] = da[row * F + col] * d_;
      }
    }
  }
}

template <int D>
cudaError_t launch_dh(const void* x, const void* w1, const float* b1, const void* da,
                      void* act, void* dh, int R, int F, cudaStream_t stream) {
  constexpr int smem = sizeof(float) * (MBM * (D + 1) + MBF * (MKD + 1));
  static_assert(smem <= kMaxSmemBytes, "shared memory of the f32 dh kernel");
  cudaError_t err = cudaFuncSetAttribute(mlp_dh_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + MBM - 1) / MBM);
  mlp_dh_kernel<D><<<grid, MTHREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), b1,
      static_cast<const float*>(da), static_cast<float*>(act), static_cast<float*>(dh), R, F);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wm

// Plain C entry: x (R, D), w1 (F, D), b1 (F,) f32, da (R, F); writes act (R, F)
// unless it is null, and dh (R, F). All contiguous, f32 only. Returns the
// cudaError_t of the launch.
extern "C" int wm_fused_mlp_dh(int dtype, const void* x, const void* w1, const void* b1,
                               const void* da, void* act, void* dh, int R, int D, int F,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  if (F % 64 != 0) return (int)cudaErrorInvalidValue;
  if (dtype == wm::kFloat32) {
    switch (D) {
      case 64: return (int)wm::launch_dh<64>(x, w1, b1f, da, act, dh, R, F, s);
      case 128: return (int)wm::launch_dh<128>(x, w1, b1f, da, act, dh, R, F, s);
      case 256: return (int)wm::launch_dh<256>(x, w1, b1f, da, act, dh, R, F, s);
      case 768: return (int)wm::launch_dh<768>(x, w1, b1f, da, act, dh, R, F, s);
      case 1024: return (int)wm::launch_dh<1024>(x, w1, b1f, da, act, dh, R, F, s);
      case 1280: return (int)wm::launch_dh<1280>(x, w1, b1f, da, act, dh, R, F, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
