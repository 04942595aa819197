// Shared helpers for the port's CUDA kernels: element-type conversion and
// rounding to the input type at the same points the Pallas kernels round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace wm {

// dtype codes passed from Python (ops/_build.py::DTYPE_CODES).
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an f32 value to T and back: the `.astype(in_dt)` of the Pallas code.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Largest dynamic shared memory a block may use on Hopper (227 KB).
constexpr int kMaxSmemBytes = 232448;

}  // namespace wm
