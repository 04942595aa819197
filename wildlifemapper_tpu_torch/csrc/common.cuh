// Shared helpers for the port's CUDA kernels: element-type conversion and
// rounding to the input type at the same points the Pallas kernels round.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- tensor-core and async-copy primitives of the bf16 bodies ---------------

// D = A (16x16, row) . B (16x8, col) + D on bf16 inputs with f32 accumulators.
__device__ __forceinline__ void mma_16816(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  mma_16816(c, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

}  // namespace wm
