// Elementwise stage of the fused MLP's backward, fused with the fc1
// recompute, f32 (the parity path):
//
//   h  = x @ w1^T + b1                     (f32, never leaves the chip)
//   a  = h * cdf(h)                        cdf(h) = 0.5 * (1 + erf(h / sqrt 2))
//   dh = da * (cdf(h) + h * pdf(h))        pdf(h) = exp(-h^2 / 2) / sqrt(2 pi)
//
// Replaces K3's backward kernel, wildlifemapper_tpu/ops/fused_mlp.py::
// _bwd_dh_kernel (:120, called from _mlp_bwd :148) for f32 inputs. x is (R,
// D), w1 (F, D) in the torch Linear layout, b1 f32, da (R, F) the gradient of
// the GELU output; a and dh are (R, F). `a` may be left out (null) when
// nobody needs the fc2 weight gradient. The four gradient GEMMs around it
// (da = g.w2, dx = dh.w1, dw1, dw2) stay library products in the wrapper, as
// the JAX package leaves them to XLA. One launch of the f32 GEMM body of
// mlp_gemm_f32.cuh with its BiasGeluGrad epilogue (where its design and what
// bounds it are described). bf16 inputs take the Hopper GEMM body of
// mlp_gemm_sm90.cuh, and this entry refuses them.

#include "mlp_gemm_f32.cuh"

// Plain C entry: x (R, D), w1 (F, D), b1 (F,), da (R, F); writes act (R, F)
// unless it is null, and dh (R, F). All contiguous f32, D and F multiples of
// 4. Returns the cudaError_t of the launch.
extern "C" int wm_fused_mlp_dh(int dtype, const void* x, const void* w1, const void* b1,
                               const void* da, void* act, void* dh, int R, int D, int F,
                               void* stream) {
  using namespace wm;
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  return (int)launch_f32_gemm<kF32BiasGeluGrad>(x, w1, b1, da, dh, act, R, F, D,
                                                static_cast<cudaStream_t>(stream));
}
