// Elementwise stage of the fused MLP's backward, fused with the fc1
// recompute:
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
// What bounds it on the H100: at R = 16384, D = 768, F = 3072 the recompute
// is 77 GFLOP (0.08 ms at the bf16 peak) against 300 MB of da, a and dh
// (0.09 ms at 3.35 TB/s), so bytes as much as operations; writing h as well
// and reading it back would add 200 MB in f32. The design is the forward's
// fc1 stage: a block keeps a tile of x rows in shared memory and streams w1
// in 64-wide hidden chunks; the epilogue of each chunk reads da and writes a
// and dh straight from the accumulator registers.
//
// Two bodies: bf16 on tensor cores (mma.sync m16n8k16, w1 pieces through a
// 3-slot cp.async ring, as fused_mlp.cu) and f32 in scalar FMAs (parity).

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

// ---- bf16 tensor-core body --------------------------------------------------
//
// 16 warps own RG*16 rows (RG row groups x CG = 16/RG column groups). Per
// 64-wide hidden chunk each warp accumulates its 16 x (64/CG) slice of h over
// D in KD1-deep pieces of w1, which stream through a ring of NSLOT
// shared-memory slots with cp.async, two pieces ahead of the one being
// multiplied; the last piece's epilogue turns the slice into a and dh.

constexpr int MW = 16;        // warps per block
constexpr int KC = 64;        // hidden units per chunk
constexpr int NSLOT = 3;

// Depth of a w1 piece, dividing D (as fused_mlp.cu).
template <int D>
__host__ __device__ constexpr int kd1() {
  return D % 192 == 0 ? 192 : D % 256 == 0 ? 256 : D % 128 == 0 ? 128 : 64;
}

template <int D, int RG>
__host__ __device__ constexpr int dh_smem_bytes() {
  return 2 * (RG * 16 * (D + 8) + NSLOT * KC * (kd1<D>() + 8));
}

template <int D, int RG>
__global__ void __launch_bounds__(MW * 32, 1)
mlp_dh_tc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                 const float* __restrict__ b1, const __nv_bfloat16* __restrict__ da,
                 __nv_bfloat16* __restrict__ act, __nv_bfloat16* __restrict__ dh, int R,
                 int F) {
  using bf16 = __nv_bfloat16;
  constexpr int CG = MW / RG;           // column groups
  constexpr int BM = RG * 16;           // rows per block
  constexpr int LDX = D + 8;
  constexpr int KD1 = kd1<D>();
  constexpr int LW1 = KD1 + 8;          // w1 piece row: KD1 dims + pad
  constexpr int NG1 = KC / CG / 8;      // 8-wide groups per warp
  constexpr int P1 = D / KD1;           // w1 pieces per chunk
  constexpr int SLOT = KC * LW1;
  constexpr int NT = MW * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = xs + BM * LDX;           // NSLOT x SLOT

  const int row0 = blockIdx.x * BM;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp / CG, cg = warp % CG;
  const int ra = rg * 16 + g;           // this thread's rows ra and ra + 8
  const int n_pieces = (F / KC) * P1;

  auto fetch = [&](int i) {
    if (i < n_pieces) {
      const int f0 = (i / P1) * KC, st = i % P1;
      bf16* slot = ring + (i % NSLOT) * SLOT;
      for (int v = t; v < KC * KD1 / 8; v += NT) {
        const int f = v / (KD1 / 8), dv = (v % (KD1 / 8)) * 8;
        cp_async16(slot + f * LW1 + dv, w1 + (long long)(f0 + f) * D + st * KD1 + dv);
      }
    }
    cp_async_commit();  // an empty group keeps the counting uniform
  };

  for (int i = t; i < BM * D / 8; i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (row0 + r < R)
      cp_async16(xs + r * LDX + c, x + (long long)(row0 + r) * D + c);
    else
      *reinterpret_cast<uint4*>(xs + r * LDX + c) = make_uint4(0u, 0u, 0u, 0u);
  }
  fetch(0);   // the x tile rides in the first group
  fetch(1);

  float hacc[NG1][4];
  for (int i = 0; i < n_pieces; ++i) {
    cp_async_wait1();   // this thread's copies of piece i have landed
    __syncthreads();    // everyone's have; piece i - 1 is consumed
    fetch(i + 2);       // into the slot piece i - 1 used
    const int f0 = (i / P1) * KC, st = i % P1;
    const bf16* slot = ring + (i % NSLOT) * SLOT;
    if (st == 0) {
#pragma unroll
      for (int j = 0; j < NG1; ++j) hacc[j][0] = hacc[j][1] = hacc[j][2] = hacc[j][3] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < KD1 / 16; ++kk) {
      const int c = st * KD1 + kk * 16 + 2 * t4;
      const uint32_t a0 = ld32(xs + ra * LDX + c), a1 = ld32(xs + (ra + 8) * LDX + c);
      const uint32_t a2 = ld32(xs + ra * LDX + c + 8), a3 = ld32(xs + (ra + 8) * LDX + c + 8);
#pragma unroll
      for (int j = 0; j < NG1; ++j) {
        const bf16* bp = slot + (cg * (KC / CG) + j * 8 + g) * LW1 + kk * 16 + 2 * t4;
        mma_16816(hacc[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
    if (st == P1 - 1) {
#pragma unroll
      for (int j = 0; j < NG1; ++j) {
        const int col = f0 + cg * (KC / CG) + j * 8 + 2 * t4;
        const float bb0 = b1[col], bb1 = b1[col + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const long long row = row0 + ra + 8 * half;
          if (row < R) {
            float a0_, d0_, a1_, d1_;
            gelu_and_grad(hacc[j][2 * half] + bb0, &a0_, &d0_);
            gelu_and_grad(hacc[j][2 * half + 1] + bb1, &a1_, &d1_);
            const __nv_bfloat162 dav =
                *reinterpret_cast<const __nv_bfloat162*>(da + row * F + col);
            if (act != nullptr)
              *reinterpret_cast<uint32_t*>(act + row * F + col) = pack_bf16x2(a0_, a1_);
            *reinterpret_cast<uint32_t*>(dh + row * F + col) =
                pack_bf16x2(__bfloat162float(dav.x) * d0_, __bfloat162float(dav.y) * d1_);
          }
        }
      }
    }
  }
}

template <int D, int RG>
cudaError_t launch_dh_tc(const void* x, const void* w1, const float* b1, const void* da,
                         void* act, void* dh, int R, int F, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int smem = dh_smem_bytes<D, RG>();
  static_assert(smem <= kMaxSmemBytes, "mlp_dh_tc_kernel: shared memory");
  cudaError_t err = cudaFuncSetAttribute(mlp_dh_tc_kernel<D, RG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + RG * 16 - 1) / (RG * 16));
  mlp_dh_tc_kernel<D, RG><<<grid, MW * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(da), static_cast<bf16*>(act), static_cast<bf16*>(dh), R, F);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dh(const void* x, const void* w1, const float* b1, const void* da,
                      void* act, void* dh, int R, int F, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(MBM * (D + 1) + MBF * (MKD + 1));
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(mlp_dh_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
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
// unless it is null, and dh (R, F). All contiguous. Returns the cudaError_t
// of the launch.
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
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == wm::kBFloat16) {
    switch (D) {
      case 64: return (int)wm::launch_dh_tc<64, 4>(x, w1, b1f, da, act, dh, R, F, s);
      case 128: return (int)wm::launch_dh_tc<128, 4>(x, w1, b1f, da, act, dh, R, F, s);
      case 256: return (int)wm::launch_dh_tc<256, 4>(x, w1, b1f, da, act, dh, R, F, s);
      case 768: return (int)wm::launch_dh_tc<768, 4>(x, w1, b1f, da, act, dh, R, F, s);
      case 1024: return (int)wm::launch_dh_tc<1024, 2>(x, w1, b1f, da, act, dh, R, F, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
