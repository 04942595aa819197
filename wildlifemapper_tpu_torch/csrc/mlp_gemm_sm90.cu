// K3 on Hopper in bf16: the forward's two products and the backward's dh
// kernel, instantiated from mlp_gemm_sm90.cuh (see that header for what it
// replaces, what bounds it and the design).

#include "mlp_gemm_sm90.cuh"

// Plain C entry: C = epilogue(a . b^T) with a (rows, k), b (n, k) and bias
// (n,) f32, all contiguous and 16-byte aligned; n and k multiples of 8.
//   epilogue 0 (BiasGelu):     out (rows, n) = bf16(gelu_erf(acc + bias))
//   epilogue 1 (Bias):         out (rows, n) = bf16(acc + bias)
//   epilogue 2 (BiasGeluGrad): with da (rows, n), out (rows, n) = dh and,
//                              unless act is null, act (rows, n) = a
// bf16 only. Returns the cudaError_t of the launch.
extern "C" int wm_mlp_gemm(int epilogue, const void* a, const void* b, const void* bias,
                           const void* da, void* out, void* act, int rows, int n, int k,
                           void* stream) {
  using namespace wm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (rows < 1 || n < 8 || k < 8 || n % 8 != 0 || k % 8 != 0) return (int)cudaErrorInvalidValue;
  switch (epilogue) {
    case kBiasGelu:
      return (int)launch_mlp_gemm<kBiasGelu>(a, b, bf, nullptr, out, nullptr, rows, n, k, s);
    case kBias:
      return (int)launch_mlp_gemm<kBias>(a, b, bf, nullptr, out, nullptr, rows, n, k, s);
    case kBiasGeluGrad:
      if (da == nullptr) return (int)cudaErrorInvalidValue;
      return (int)launch_mlp_gemm<kBiasGeluGrad>(a, b, bf, da, out, act, rows, n, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Plain C entry of K3's forward, both passes from one host call:
//   hidden (rows, f) = bf16(gelu_erf(x . w1^T + b1)), then
//   out (rows, d)    = bf16(hidden . w2^T + b2)
// with x (rows, d), w1 (f, d), w2 (d, f) bf16 and b1 (f,), b2 (d,) f32, all
// contiguous and 16-byte aligned; d and f multiples of 8. Returns the
// cudaError_t of the first launch that failed.
extern "C" int wm_mlp_forward(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, void* hidden, void* out, int rows, int d, int f,
                              void* stream) {
  using namespace wm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 8 || f < 8 || d % 8 != 0 || f % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_mlp_gemm<kBiasGelu>(x, w1, static_cast<const float*>(b1), nullptr,
                                               hidden, nullptr, rows, f, d, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_mlp_gemm<kBias>(hidden, w2, static_cast<const float*>(b2), nullptr, out,
                                     nullptr, rows, d, f, s);
}
