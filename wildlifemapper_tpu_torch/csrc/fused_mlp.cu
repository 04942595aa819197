// Fused transformer MLP, forward only, f32 (the parity path):
//
//   out = gelu_erf(x @ w1^T + b1) @ w2^T + b2
//
// Replaces K3, wildlifemapper_tpu/ops/fused_mlp.py::fused_mlp (the MLP of
// all 12 ViT blocks) for f32 inputs. x is (R, D), w1 (F, D) and w2 (D, F) in
// the torch Linear layout (out, in), read by stride with no transpose copy;
// b1 and b2 are f32. D = 768 and F = 3072 at ViT-B.
//
// This body keeps the hidden activations on chip as the Pallas kernel does:
// each block takes a tile of BM rows and streams F in 64-wide chunks, h =
// x_tile @ w1[chunk]^T + b1 in scalar f32 FMAs (no TF32), exact GELU with
// erff, then y += a @ w2[:, chunk]^T, with y in registers for the whole F
// loop. D is one of 64, 128, 256, 768, 1024 (BM = 32 rows) and 1280 (ViT-H,
// BM = 16: at 32 rows the x tile and a w2 piece would need 267,776 bytes of
// shared memory, over a block's 232,448, and y 160 registers a thread; at
// 16 rows they take 181,632 bytes and 80 registers). Each output's sums run
// in the same order whatever BM. bf16 inputs take the Hopper GEMM body of
// mlp_gemm_sm90.cuh in two launches (ops/fused_mlp.py), and this entry
// refuses them.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr int MBF = 64;       // hidden units per streamed chunk
constexpr int MKD = 32;       // depth of one w1 piece
constexpr int MKF = 16;       // depth of one w2 piece
constexpr int MTHREADS = 256;

template <int D, int BM>
__host__ __device__ constexpr int mlp_smem_floats() {
  return BM * (D + 1)           // x tile
         + MBF * (MKD + 1)      // w1 piece, [hidden][depth]
         + BM * (MBF + 1)       // gelu activations
         + D * (MKF + 1);       // w2 piece, [out][depth]
}

// BM rows a block (32, or 16 at D = 1280).
template <typename T, int COLS, int BM>
__global__ void __launch_bounds__(MTHREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int R, int F) {
  constexpr int D = COLS * 32;
  constexpr int LDX = D + 1;
  constexpr int LW1 = MKD + 1;
  constexpr int LA = MBF + 1;
  constexpr int LW2 = MKF + 1;
  constexpr int HT = MTHREADS / BM;  // fc1: threads of one row
  constexpr int HJ = MBF / HT;       // fc1: hidden units a thread
  constexpr int YR = BM / 8;         // fc2: rows a thread
  extern __shared__ float smem[];
  float* xs = smem;
  float* w1s = xs + BM * LDX;
  float* as = w1s + MBF * LW1;
  float* w2s = as + BM * LA;

  const int row0 = blockIdx.x * BM;
  const int t = threadIdx.x;
  for (int i = t; i < BM * D; i += MTHREADS) {
    const int r = i / D, c = i % D;
    xs[r * LDX + c] = (row0 + r < R) ? to_f<T>(x[(long long)(row0 + r) * D + c]) : 0.f;
  }

  // fc1 mapping: one row, HJ hidden units (stride HT) per thread.
  const int hr = t / HT, hc = t % HT;
  // fc2 mapping: YR rows, COLS outputs (stride 32) per thread.
  const int yr = (t >> 5) * YR, yc = t & 31;
  float y[YR][COLS];
#pragma unroll
  for (int rr = 0; rr < YR; ++rr)
#pragma unroll
    for (int j = 0; j < COLS; ++j) y[rr][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += MBF) {
    float hacc[HJ];
#pragma unroll
    for (int j = 0; j < HJ; ++j) hacc[j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += MKD) {
      __syncthreads();
      for (int i = t; i < MBF * MKD; i += MTHREADS) {
        const int dd = i % MKD, c = i / MKD;
        w1s[c * LW1 + dd] = to_f<T>(w1[(long long)(f0 + c) * D + d0 + dd]);
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < MKD; ++dd) {
        const float xv = xs[hr * LDX + d0 + dd];
#pragma unroll
        for (int j = 0; j < HJ; ++j) hacc[j] = fmaf(xv, w1s[(hc + HT * j) * LW1 + dd], hacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      const int c = hc + HT * j;
      const float hv = hacc[j] + b1[f0 + c];
      const float g = 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
      as[hr * LA + c] = round_to<T>(g);
    }
    for (int k0 = 0; k0 < MBF; k0 += MKF) {
      __syncthreads();  // activations written; previous w2 piece consumed
      for (int i = t; i < MKF * D; i += MTHREADS) {
        const int kk = i % MKF, o = i / MKF;
        w2s[o * LW2 + kk] = to_f<T>(w2[(long long)o * F + f0 + k0 + kk]);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < MKF; ++kk) {
        float av[YR];
#pragma unroll
        for (int rr = 0; rr < YR; ++rr) av[rr] = as[(yr + rr) * LA + k0 + kk];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const float w = w2s[(yc + 32 * j) * LW2 + kk];
#pragma unroll
          for (int rr = 0; rr < YR; ++rr) y[rr][j] = fmaf(av[rr], w, y[rr][j]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < YR; ++rr) {
    const int row = row0 + yr + rr;
    if (row < R) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = yc + 32 * j;
        out[(long long)row * D + c] = from_f<T>(y[rr][j] + b2[c]);
      }
    }
  }
}

// ---- f32 scalar body -------------------------------------------------------

template <typename T, int COLS, int BM = 32>
cudaError_t launch_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                       const float* b2, void* out, int R, int F, cudaStream_t stream) {
  constexpr int smem = sizeof(float) * mlp_smem_floats<COLS * 32, BM>();
  static_assert(smem <= kMaxSmemBytes, "shared memory of the f32 MLP");
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<T, COLS, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + BM - 1) / BM);
  fused_mlp_kernel<T, COLS, BM><<<grid, MTHREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), R, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                         const float* b2, void* out, int R, int D, int F,
                         cudaStream_t stream) {
  if (F % MBF != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_mlp<T, 2>(x, w1, b1, w2, b2, out, R, F, stream);
    case 128: return launch_mlp<T, 4>(x, w1, b1, w2, b2, out, R, F, stream);
    case 256: return launch_mlp<T, 8>(x, w1, b1, w2, b2, out, R, F, stream);
    case 768: return launch_mlp<T, 24>(x, w1, b1, w2, b2, out, R, F, stream);
    case 1024: return launch_mlp<T, 32>(x, w1, b1, w2, b2, out, R, F, stream);
    case 1280: return launch_mlp<T, 40, 16>(x, w1, b1, w2, b2, out, R, F, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace wm

// Plain C entry: x (R, D), w1 (F, D), b1 (F,) f32, w2 (D, F), b2 (D,) f32,
// out (R, D), all contiguous, f32 only. Returns the cudaError_t of the launch.
extern "C" int wm_fused_mlp_fwd(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int R, int D,
                                int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (dtype == wm::kFloat32)
    return (int)wm::dispatch_mlp<float>(x, w1, b1f, w2, b2f, out, R, D, F, s);
  return (int)cudaErrorInvalidValue;
}
