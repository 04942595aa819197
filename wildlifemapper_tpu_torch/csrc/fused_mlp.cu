// Fused transformer MLP, forward, f32 (the parity path):
//
//   out = gelu_erf(x @ w1^T + b1) @ w2^T + b2
//
// Replaces K3, wildlifemapper_tpu/ops/fused_mlp.py::fused_mlp (:97,
// pallas_call :103: the MLP of every ViT block) for f32 inputs. x is (R, D),
// w1 (F, D) and w2 (D, F) in the torch Linear layout (out, in), read by
// stride with no transpose copy; b1 and b2 are f32. Two launches of the f32
// GEMM body of mlp_gemm_f32.cuh (where its design and what bounds it are
// described): fc1 with the bias and exact GELU into the f32 hidden (R, F)
// the caller allocates, then fc2 with the bias into out. bf16 inputs take
// the Hopper GEMM body of mlp_gemm_sm90.cuh (mlp_gemm_sm90.cu), and this
// entry refuses them.

#include "mlp_gemm_f32.cuh"

// Plain C entry: x (R, D), w1 (F, D), b1 (F,), w2 (D, F), b2 (D,), hidden
// (R, F) scratch, out (R, D), all contiguous f32, D and F multiples of 4.
// Returns the cudaError_t of the first launch that fails, else of the last.
extern "C" int wm_fused_mlp_fwd(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* hidden, void* out,
                                int R, int D, int F, void* stream) {
  using namespace wm;
  if (dtype != kFloat32) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_f32_gemm<kF32BiasGelu>(x, w1, b1, nullptr, hidden, nullptr, R, F,
                                                  D, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_f32_gemm<kF32Bias>(hidden, w2, b2, nullptr, out, nullptr, R, D, F, s);
}
