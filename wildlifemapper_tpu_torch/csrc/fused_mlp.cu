// Fused transformer MLP, forward only:
//
//   out = gelu_erf(x @ w1^T + b1) @ w2^T + b2
//
// Replaces K3, wildlifemapper_tpu/ops/fused_mlp.py::fused_mlp (the MLP of
// all 12 ViT blocks). x is (R, D), w1 (F, D) and w2 (D, F) in the torch
// Linear layout (out, in), read by stride with no transpose copy; b1 and b2
// are f32. D = 768 and F = 3072 at ViT-B.
//
// What bounds it on the H100: the unfused pair writes and re-reads the
// (R, F) hidden activations, 4x the size of x (R = 16384 rows at batch 4 on
// the full canvas: 100 MB each way in bf16). This kernel gives each block a
// tile of rows and streams F in 64-wide chunks: h = x_tile @ w1[chunk]^T + b1
// in f32, exact GELU with erff, rounded to x's type (fused_mlp.py:77), then
// y += a @ w2[:, chunk]^T in f32 registers. The hidden activations live only
// in shared memory.
//
// Two bodies, one per input type:
//  * bf16 (serving): tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulators). 16 warps own 64 rows (32 at D = 1024); the fc2 outputs
//    of the tile stay in registers for the whole F loop; weight pieces
//    stream through a 3-slot shared-memory ring with cp.async.
//  * f32 (parity): scalar f32 FMAs, no TF32.
// wgmma with TMA-fed, shared-memory weight tiles is later work.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr int MBM = 32;       // rows per block
constexpr int MBF = 64;       // hidden units per streamed chunk
constexpr int MKD = 32;       // depth of one w1 piece
constexpr int MKF = 16;       // depth of one w2 piece
constexpr int MTHREADS = 256;

template <int D>
__host__ __device__ constexpr int mlp_smem_floats() {
  return MBM * (D + 1)          // x tile
         + MBF * (MKD + 1)      // w1 piece, [hidden][depth]
         + MBM * (MBF + 1)      // gelu activations
         + D * (MKF + 1);       // w2 piece, [out][depth]
}

template <typename T, int COLS>
__global__ void __launch_bounds__(MTHREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const float* __restrict__ b1, const T* __restrict__ w2,
                 const float* __restrict__ b2, T* __restrict__ out, int R, int F) {
  constexpr int D = COLS * 32;
  constexpr int LDX = D + 1;
  constexpr int LW1 = MKD + 1;
  constexpr int LA = MBF + 1;
  constexpr int LW2 = MKF + 1;
  extern __shared__ float smem[];
  float* xs = smem;
  float* w1s = xs + MBM * LDX;
  float* as = w1s + MBF * LW1;
  float* w2s = as + MBM * LA;

  const int row0 = blockIdx.x * MBM;
  const int t = threadIdx.x;
  for (int i = t; i < MBM * D; i += MTHREADS) {
    const int r = i / D, c = i % D;
    xs[r * LDX + c] = (row0 + r < R) ? to_f<T>(x[(long long)(row0 + r) * D + c]) : 0.f;
  }

  // fc1 mapping: one row, 8 hidden units (stride 8) per thread.
  const int hr = t >> 3, hc = t & 7;
  // fc2 mapping: 4 rows, COLS outputs (stride 32) per thread.
  const int yr = (t >> 5) * 4, yc = t & 31;
  float y[4][COLS];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int j = 0; j < COLS; ++j) y[rr][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += MBF) {
    float hacc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) hacc[j] = 0.f;
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
        for (int j = 0; j < 8; ++j) hacc[j] = fmaf(xv, w1s[(hc + 8 * j) * LW1 + dd], hacc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = hc + 8 * j;
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
        const float a0 = as[(yr + 0) * LA + k0 + kk];
        const float a1 = as[(yr + 1) * LA + k0 + kk];
        const float a2 = as[(yr + 2) * LA + k0 + kk];
        const float a3 = as[(yr + 3) * LA + k0 + kk];
#pragma unroll
        for (int j = 0; j < COLS; ++j) {
          const float w = w2s[(yc + 32 * j) * LW2 + kk];
          y[0][j] = fmaf(a0, w, y[0][j]);
          y[1][j] = fmaf(a1, w, y[1][j]);
          y[2][j] = fmaf(a2, w, y[2][j]);
          y[3][j] = fmaf(a3, w, y[3][j]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
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

// ---- bf16 tensor-core body ----------------------------------------------
//
// 16 warps own RG*16 rows (RG row groups x CG = 16/RG column groups). Per
// 64-wide hidden chunk: fc1 accumulates each warp's 16 x (64/CG) slice of h
// over D in KD1-deep pieces of w1; GELU turns it into bf16 activations in
// shared memory; fc2 adds them times 16-deep pieces of w2 into each warp's
// 16 x (D/CG) output slice, which stays in mma.sync m16n8k16 accumulators for
// the whole F loop. Weight pieces stream through a ring of NSLOT shared-memory
// slots with cp.async, two pieces ahead of the one being multiplied.

constexpr int MW = 16;        // warps per block
constexpr int KC = 64;        // hidden units per chunk
constexpr int KF = 16;        // depth of a w2 piece
constexpr int LW2 = KF + 8;   // w2 piece row: 16 hidden + pad
constexpr int LACT = KC + 8;  // activation row
constexpr int NSLOT = 3;

// Depth of a w1 piece: as deep as the slot allows, dividing D.
template <int D>
__host__ __device__ constexpr int kd1() {
  return D % 192 == 0 ? 192 : D % 256 == 0 ? 256 : D % 128 == 0 ? 128 : 64;
}

template <int D>
__host__ __device__ constexpr int slot_elems() {
  return KC * (kd1<D>() + 8) > D * LW2 ? KC * (kd1<D>() + 8) : D * LW2;
}

template <int D, int RG>
__host__ __device__ constexpr int tc_smem_bytes() {
  return 2 * (RG * 16 * (D + 8) + NSLOT * slot_elems<D>() + RG * 16 * LACT);
}

template <int D, int RG>
__global__ void __launch_bounds__(MW * 32, 1)
fused_mlp_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const __nv_bfloat16* __restrict__ w2,
                    const float* __restrict__ b2,
                    __nv_bfloat16* __restrict__ out, int R, int F) {
  using bf16 = __nv_bfloat16;
  constexpr int CG = MW / RG;           // column groups
  constexpr int BM = RG * 16;           // rows per block
  constexpr int LDX = D + 8;
  constexpr int KD1 = kd1<D>();
  constexpr int LW1 = KD1 + 8;          // w1 piece row: KD1 dims + pad
  constexpr int NG1 = KC / CG / 8;      // fc1 8-wide groups per warp
  constexpr int NG2 = D / CG / 8;       // fc2 8-wide groups per warp
  constexpr int P1 = D / KD1;           // w1 pieces per chunk
  constexpr int NS = P1 + KC / KF;      // pieces per chunk
  constexpr int SLOT = slot_elems<D>();
  constexpr int NT = MW * 32;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = xs + BM * LDX;           // NSLOT x SLOT
  bf16* acts = ring + NSLOT * SLOT;     // [BM][LACT]

  const int row0 = blockIdx.x * BM;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = warp / CG, cg = warp % CG;
  const int ra = rg * 16 + g;           // this thread's rows ra and ra + 8
  const int n_pieces = (F / KC) * NS;

  // Piece i: chunk i / NS; within it, w1 pieces then w2 pieces.
  auto issue = [&](int i) {
    if (i < n_pieces) {
      const int f0 = (i / NS) * KC, st = i % NS;
      bf16* slot = ring + (i % NSLOT) * SLOT;
      if (st < P1) {
        for (int v = t; v < KC * KD1 / 8; v += NT) {
          const int f = v / (KD1 / 8), dv = (v % (KD1 / 8)) * 8;
          cp_async16(slot + f * LW1 + dv, w1 + (long long)(f0 + f) * D + st * KD1 + dv);
        }
      } else {
        for (int v = t; v < D * KF / 8; v += NT) {
          const int o = v / (KF / 8), kv = (v % (KF / 8)) * 8;
          cp_async16(slot + o * LW2 + kv, w2 + (long long)o * F + f0 + (st - P1) * KF + kv);
        }
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
  issue(0);   // the x tile rides in the first group
  issue(1);

  float y[NG2][4];
#pragma unroll
  for (int j = 0; j < NG2; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
  float hacc[NG1][4];

  for (int i = 0; i < n_pieces; ++i) {
    cp_async_wait1();   // this thread's copies of piece i have landed
    __syncthreads();    // everyone's have; piece i - 1 is consumed
    issue(i + 2);       // into the slot piece i - 1 used
    const int f0 = (i / NS) * KC, st = i % NS;
    const bf16* slot = ring + (i % NSLOT) * SLOT;
    if (st < P1) {
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
      if (st == P1 - 1) {  // exact GELU, rounded to bf16, into the activations
#pragma unroll
        for (int j = 0; j < NG1; ++j) {
          const int c = cg * (KC / CG) + j * 8 + 2 * t4;
          const float bb0 = b1[f0 + c], bb1 = b1[f0 + c + 1];
          float v[4] = {hacc[j][0] + bb0, hacc[j][1] + bb1, hacc[j][2] + bb0, hacc[j][3] + bb1};
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = 0.5f * v[e] * (1.f + erff(v[e] * 0.70710678118654752f));
          *reinterpret_cast<uint32_t*>(acts + ra * LACT + c) = pack_bf16x2(v[0], v[1]);
          *reinterpret_cast<uint32_t*>(acts + (ra + 8) * LACT + c) = pack_bf16x2(v[2], v[3]);
        }
      }
    } else {
      // the loop-top barrier orders every warp's activations before this read
      const int c = (st - P1) * KF + 2 * t4;
      const uint32_t a0 = ld32(acts + ra * LACT + c), a1 = ld32(acts + (ra + 8) * LACT + c);
      const uint32_t a2 = ld32(acts + ra * LACT + c + 8), a3 = ld32(acts + (ra + 8) * LACT + c + 8);
#pragma unroll
      for (int j = 0; j < NG2; ++j) {
        const bf16* bp = slot + (cg * (D / CG) + j * 8 + g) * LW2 + 2 * t4;
        mma_16816(y[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NG2; ++j) {
    const int c = cg * (D / CG) + j * 8 + 2 * t4;
    const float bb0 = b2[c], bb1 = b2[c + 1];
    if (row0 + ra < R)
      *reinterpret_cast<uint32_t*>(out + (long long)(row0 + ra) * D + c) =
          pack_bf16x2(y[j][0] + bb0, y[j][1] + bb1);
    if (row0 + ra + 8 < R)
      *reinterpret_cast<uint32_t*>(out + (long long)(row0 + ra + 8) * D + c) =
          pack_bf16x2(y[j][2] + bb0, y[j][3] + bb1);
  }
}

template <int D, int RG>
cudaError_t launch_mlp_tc(const void* x, const void* w1, const float* b1, const void* w2,
                          const float* b2, void* out, int R, int F, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<D, RG>();
  static_assert(smem <= kMaxSmemBytes, "fused_mlp_tc_kernel: shared memory");
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_tc_kernel<D, RG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + RG * 16 - 1) / (RG * 16));
  fused_mlp_tc_kernel<D, RG><<<grid, MW * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1), b1,
      static_cast<const __nv_bfloat16*>(w2), b2, static_cast<__nv_bfloat16*>(out), R, F);
  return cudaGetLastError();
}

cudaError_t dispatch_mlp_tc(const void* x, const void* w1, const float* b1, const void* w2,
                            const float* b2, void* out, int R, int D, int F,
                            cudaStream_t stream) {
  if (F % KC != 0) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_mlp_tc<64, 4>(x, w1, b1, w2, b2, out, R, F, stream);
    case 128: return launch_mlp_tc<128, 4>(x, w1, b1, w2, b2, out, R, F, stream);
    case 256: return launch_mlp_tc<256, 4>(x, w1, b1, w2, b2, out, R, F, stream);
    case 768: return launch_mlp_tc<768, 4>(x, w1, b1, w2, b2, out, R, F, stream);
    case 1024: return launch_mlp_tc<1024, 2>(x, w1, b1, w2, b2, out, R, F, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- f32 scalar body -------------------------------------------------------

template <typename T, int COLS>
cudaError_t launch_mlp(const void* x, const void* w1, const float* b1, const void* w2,
                       const float* b2, void* out, int R, int F, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)mlp_smem_floats<COLS * 32>();
  if (smem > (size_t)kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<T, COLS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((R + MBM - 1) / MBM);
  fused_mlp_kernel<T, COLS><<<grid, MTHREADS, smem, stream>>>(
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
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace wm

// Plain C entry: x (R, D), w1 (F, D), b1 (F,) f32, w2 (D, F), b2 (D,) f32,
// out (R, D), all contiguous. Returns the cudaError_t of the launch.
extern "C" int wm_fused_mlp_fwd(int dtype, const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out, int R, int D,
                                int F, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b1f = static_cast<const float*>(b1);
  const float* b2f = static_cast<const float*>(b2);
  if (dtype == wm::kFloat32)
    return (int)wm::dispatch_mlp<float>(x, w1, b1f, w2, b2f, out, R, D, F, s);
  if (dtype == wm::kBFloat16)
    return (int)wm::dispatch_mlp_tc(x, w1, b1f, w2, b2f, out, R, D, F, s);
  return (int)cudaErrorInvalidValue;
}
