// Multi-head attention with an optional decomposed relative-position bias,
// forward: the kernel bodies (the backward ones are in attention_bwd.cuh).
// Two sources instantiate them, one nvcc each:
//
//   attention.cu (SCALE_SCORES = false), for three TPU kernels of the JAX
//   package that take the packed, head-interleaved layout:
//   K1 wildlifemapper_tpu/ops/windowed_attention_v2.py::windowed_attention_packed
//      (windowed ViT blocks: N = 196 or 144 tokens per window, d = 64; f32 here)
//   K2 wildlifemapper_tpu/ops/flash_attention_v2.py::flash_attention_packed
//      (global ViT blocks: N = 4096 or 2304, d = 64)
//   K4 wildlifemapper_tpu/ops/cross_attention.py::cross_attention_packed
//      (HFC adaptor: no bias, d = 128, N != M allowed)
//
//   grouped_attention.cu (SCALE_SCORES = true), for the two kernels of the
//   grouped layout, q, k, v (BH, N, d) per head (see that file's header):
//   K5 wildlifemapper_tpu/ops/flash_attention.py::flash_attention_rel_pos
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::windowed_attention_rel_pos
//
// out[b, q, h*d:(h+1)*d] = softmax_k(s[q, k] + rel_h[b, q, h, k / gw]
//                                            + rel_w[b, q, h, k % gw]) . v
// with s = round(q*scale) . k              (SCALE_SCORES = false), or
//      s = (q . k) * scale on the f32 sum  (SCALE_SCORES = true).
//
// q, k and v are read by stride: for the packed (B, N, 3C) qkv GEMM output
// they are the same buffer at column offsets 0, C and 2C, so no head split
// is ever copied; the grouped (BH, N, d) operands are the same layout with
// one head and BH batches. The rel tables arrive unpadded as (B, N, H, gh)
// and (B, N, H, gw).
//
// What bounds it on the H100: at N = 4096 a head costs 4*N^2*d flops
// against N*d*6 bytes of q/k/v, so the work is compute-bound; the Pallas K2
// kept K and V for a whole head in VMEM (512 KB in bf16 at N = 4096), which
// does not fit the 227 KB of shared memory a block may use. This design
// streams K and V through shared memory in 64-key tiles with an online
// softmax (running max and sum in f32), so the N x N scores never reach
// device memory. Two bodies, one per input type:
//  * bf16 (serving): tensor cores through mma.sync m16n8k16 (bf16 in, f32
//    accumulators), FlashAttention-2 style: 4 warps own 64 query rows, each
//    warp keeps its scores, probabilities and running output in registers.
//  * f32 (parity): scalar f32 FMAs, no TF32; 4 threads per query row.
// Which launches still run here (ops/_attention.py::attention_body): every
// f32 launch (the parity runs of all five kernels, d = 80 included: the
// bodies are written in D / 16 k-steps and D / 8 column groups, and 80 is a
// multiple of 16), d = 32, and the bf16 launches below 512 keys that are no
// window the resident body holds: d = 128 or N != M (K4 at small sizes), no
// rel tables, and a global block of 209 to 511 tokens that lands in K1 or
// K6. The streaming bf16 shapes of K2, K4 and K5 (d = 64, 80 or 128, 2304 or
// 4096 keys) take the Hopper body of attention_fwd_sm90.cuh (wgmma, a
// TMA-fed ring), and the bf16 windows of K1 and K6 (d = 64 or 80, N = M <=
// 208: 196 and 144 on the main paths) the resident body of
// attention_fwd_resident.cuh (one block a window-head, a one-pass softmax);
// the bf16 body here stays the yardstick of both (chip_smoke.py times them
// side by side), and the backward of a bf16 d-80 attention still runs the
// tile bodies of attention_bwd.cuh.
//
// Rounding points follow the Pallas kernels: q*scale is rounded to the input
// type before QK (packed family) or the f32 scores take the scale (grouped
// family); the rel tables are in the input type; p = exp(s - m) is
// rounded to the input type before PV while the row sum l takes it
// unrounded; out = acc / l is rounded once. When the caller passes an lse
// buffer (training), the kernel also writes lse[b, q, h] = m + log(l) in f32
// from the running max and sum, as flash_attention_v2.py:147,
// cross_attention.py:85 and flash_attention.py:252 do; serving passes none.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int THREADS = 256; // 4 threads per query row

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* relh;  // (B, nq, H, gh) or null
  const void* relw;  // (B, nq, H, gw) or null
  float* lse;        // (B, nq, H) f32 or null
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // element strides
  int heads, nq, nk, gh, gw;
  float scale;
};

template <int D>
__host__ __device__ constexpr int smem_floats_base() {
  // q tile, k tile, v tile (rows padded to D + 1), p tile (BK + 1)
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(THREADS) attn_fwd_kernel(AttnArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CPT = D / 4;   // output columns per thread
  constexpr int SPT = BK / 4;  // scores per thread per tile
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* rhs = ps + BQ * LP;      // BQ x gh
  float* rws = rhs + BQ * a.gh;   // BQ x gw

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const bool has_rel = a.relh != nullptr;

  const T* qg = static_cast<const T*>(a.q) + b * a.q_bs + h * D;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_bs + h * D;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_bs + h * D;
  T* og = static_cast<T*>(a.o) + b * a.o_bs + h * D;

  for (int i = t; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < a.nq) {
      val = to_f<T>(qg[(q0 + r) * a.q_rs + c]);
      if (!SCALE_SCORES) val = round_to<T>(val * a.scale);
    }
    qs[r * LD + c] = val;
  }
  if (has_rel) {
    const T* rh = static_cast<const T*>(a.relh);
    const T* rw = static_cast<const T*>(a.relw);
    for (int i = t; i < BQ * a.gh; i += THREADS) {
      const int r = i / a.gh, j = i % a.gh;
      const long long row = (long long)b * a.nq + q0 + r;
      rhs[i] = (q0 + r < a.nq) ? to_f<T>(rh[(row * a.heads + h) * a.gh + j]) : 0.f;
    }
    for (int i = t; i < BQ * a.gw; i += THREADS) {
      const int r = i / a.gw, j = i % a.gw;
      const long long row = (long long)b * a.nq + q0 + r;
      rws[i] = (q0 + r < a.nq) ? to_f<T>(rw[(row * a.heads + h) * a.gw + j]) : 0.f;
    }
  }

  const int r = t >> 2;    // query row within the tile
  const int l4 = t & 3;    // lane within the row's quad
  float m = -INFINITY, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  const int nkt = (a.nk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile fully consumed; q/rel tiles loaded
    for (int i = t; i < BK * D; i += THREADS) {
      const int kr = i / D, c = i % D;
      const bool ok = k0 + kr < a.nk;
      ks[kr * LD + c] = ok ? to_f<T>(kg[(k0 + kr) * a.k_rs + c]) : 0.f;
      vs[kr * LD + c] = ok ? to_f<T>(vg[(k0 + kr) * a.v_rs + c]) : 0.f;
    }
    __syncthreads();

    float s[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = 0.f;
    for (int i = 0; i < D; ++i) {
      const float qv = qs[r * LD + i];
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[j] = fmaf(qv, ks[(l4 + 4 * j) * LD + i], s[j]);
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kidx = k0 + l4 + 4 * j;
      if (kidx < a.nk) {
        if (SCALE_SCORES) s[j] *= a.scale;
        if (has_rel) s[j] += rhs[r * a.gh + kidx / a.gw] + rws[r * a.gw + kidx % a.gw];
      } else {
        s[j] = -INFINITY;
      }
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);  // finite: every tile holds a valid key
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      ps[r * LP + l4 + 4 * j] = round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[c] *= alpha;
    __syncwarp();  // row r's p values were written by its own quad
    for (int kk = 0; kk < BK; ++kk) {
      const float p = ps[r * LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(p, vs[kk * LD + l4 + 4 * c], acc[c]);
    }
  }

  if (q0 + r < a.nq) {
    T* orow = og + (q0 + r) * a.o_rs;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[l4 + 4 * c] = from_f<T>(acc[c] / l);
    if (a.lse != nullptr && l4 == 0)
      a.lse[((long long)b * a.nq + q0 + r) * a.heads + h] = m + logf(l);
  }
}

// The batch rides blockIdx.z and the heads blockIdx.y.
constexpr int kMaxGridYZ = 65535;

template <typename T, int D, bool SCALE_SCORES>
cudaError_t launch(const AttnArgs& a, int batch, cudaStream_t stream) {
  const int smem_floats = smem_floats_base<D>() + BQ * (a.gh + a.gw);
  const size_t smem = sizeof(float) * (size_t)smem_floats;
  if (smem > (size_t)kMaxSmemBytes || batch > kMaxGridYZ) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T, D, SCALE_SCORES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + BQ - 1) / BQ, a.heads, batch);
  attn_fwd_kernel<T, D, SCALE_SCORES><<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// ---- bf16 tensor-core body ----------------------------------------------
//
// FlashAttention-2 style: each warp owns 16 query rows and keeps its scores,
// probabilities and output in mma.sync m16n8k16 fragments in registers. The
// score accumulators of two adjacent 8-key groups are exactly the A operand
// of the P.V product, so P never goes through shared memory. V is stored
// transposed in shared memory so its B fragments are 32-bit loads.

constexpr int TQ = 64;   // query rows per block (16 per warp)
constexpr int TK = 64;   // keys per streamed tile
constexpr int TW = 4;    // warps per block
constexpr int LVT = TK + 8;  // row length of the transposed V tile

template <int D>
__host__ __device__ constexpr int tc_smem_bytes_base() {
  return 2 * TQ * (D + 8) * 2   // q and k tiles, bf16
         + D * LVT * 2          // transposed v tile, bf16
         + 2 * TK * 4;          // rel-grid row / column of each key in the tile
}

template <int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(TW * 32) attn_tc_kernel(AttnArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;   // k-steps of Q.K^T
  constexpr int NS = TK / 8;   // 8-key groups per tile
  constexpr int ND = D / 8;    // 8-column groups of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + TQ * LD;
  bf16* vt = ks + TK * LD;                                 // [D][LVT]
  int* kdh = reinterpret_cast<int*>(vt + D * LVT);         // key -> rel row
  int* kdw = kdh + TK;                                     // key -> rel column
  float* rhs = reinterpret_cast<float*>(kdw + TK);         // TQ x gh
  float* rws = rhs + TQ * a.gh;                            // TQ x gw

  const int q0 = blockIdx.x * TQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_rel = a.relh != nullptr;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_bs + h * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_bs + h * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_bs + h * D;
  bf16* og = static_cast<bf16*>(a.o) + b * a.o_bs + h * D;

  for (int i = t; i < TQ * D; i += TW * 32) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (q0 + r < a.nq) {
      val = to_f<bf16>(qg[(q0 + r) * a.q_rs + c]);
      if (!SCALE_SCORES) val *= a.scale;
    }
    qs[r * LD + c] = __float2bfloat16_rn(val);
  }
  if (has_rel) {
    const bf16* rh = static_cast<const bf16*>(a.relh);
    const bf16* rw = static_cast<const bf16*>(a.relw);
    for (int i = t; i < TQ * a.gh; i += TW * 32) {
      const int r = i / a.gh, j = i % a.gh;
      const long long row = (long long)b * a.nq + q0 + r;
      rhs[i] = (q0 + r < a.nq) ? to_f<bf16>(rh[(row * a.heads + h) * a.gh + j]) : 0.f;
    }
    for (int i = t; i < TQ * a.gw; i += TW * 32) {
      const int r = i / a.gw, j = i % a.gw;
      const long long row = (long long)b * a.nq + q0 + r;
      rws[i] = (q0 + r < a.nq) ? to_f<bf16>(rw[(row * a.heads + h) * a.gw + j]) : 0.f;
    }
  }
  __syncthreads();

  // This thread's rows: rA = g and rB = g + 8 of the warp's 16.
  const int rA = warp * 16 + g, rB = rA + 8;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int c = kd * 16 + 2 * t4;
    qa[kd][0] = ld32(qs + rA * LD + c);
    qa[kd][1] = ld32(qs + rB * LD + c);
    qa[kd][2] = ld32(qs + rA * LD + c + 8);
    qa[kd][3] = ld32(qs + rB * LD + c + 8);
  }
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  const int nkt = (a.nk + TK - 1) / TK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();  // previous k/v tiles consumed
    constexpr int VPR = D / 8;  // 16-byte vectors per row (wrapper: aligned rows)
    // Consecutive lanes take consecutive keys, so the transposed stores of a
    // warp fall in consecutive shared-memory words.
    for (int i = t; i < TK * VPR; i += TW * 32) {
      const int kr = i % TK, c = (i / TK) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + kr < a.nk) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + kr) * a.k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + kr) * a.v_rs + c);
      }
      *reinterpret_cast<uint4*>(ks + kr * LD + c) = kv;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * LVT + kr] = ve[j];
    }
    if (has_rel && t < TK) {
      const int kidx = k0 + t;
      kdh[t] = kidx / a.gw;
      kdw[t] = kidx - kdh[t] * a.gw;
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp.
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kp = ks + (n * 8 + g) * LD + kd * 16 + 2 * t4;
        mma_16816(s[n], qa[kd], ld32(kp), ld32(kp + 8));
      }
    }

    // Bias, mask and the online softmax of rows rA and rB.
    float tA = -INFINITY, tB = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = n * 8 + 2 * t4 + j;
        if (k0 + kc < a.nk) {
          if (SCALE_SCORES) {
            s[n][j] *= a.scale;
            s[n][j + 2] *= a.scale;
          }
          if (has_rel) {
            const int kh = kdh[kc], kw = kdw[kc];
            s[n][j] += rhs[rA * a.gh + kh] + rws[rA * a.gw + kw];
            s[n][j + 2] += rhs[rB * a.gh + kh] + rws[rB * a.gw + kw];
          }
        } else {
          s[n][j] = s[n][j + 2] = -INFINITY;
        }
        tA = fmaxf(tA, s[n][j]);
        tB = fmaxf(tB, s[n][j + 2]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      tA = fmaxf(tA, __shfl_xor_sync(0xffffffffu, tA, off));
      tB = fmaxf(tB, __shfl_xor_sync(0xffffffffu, tB, off));
    }
    const float nA = fmaxf(mA, tA), nB = fmaxf(mB, tB);  // finite: a valid key per tile
    const float alA = __expf(mA - nA), alB = __expf(mB - nB);
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = __expf(s[n][0] - nA);
      s[n][1] = __expf(s[n][1] - nA);
      s[n][2] = __expf(s[n][2] - nB);
      s[n][3] = __expf(s[n][3] - nB);
      sA += s[n][0] + s[n][1];
      sB += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sA += __shfl_xor_sync(0xffffffffu, sA, off);
      sB += __shfl_xor_sync(0xffffffffu, sB, off);
    }
    lA = lA * alA + sA;
    lB = lB * alB + sB;
    mA = nA;
    mB = nB;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alA;
      o[nd][1] *= alA;
      o[nd][2] *= alB;
      o[nd][3] *= alB;
    }

    // O += P V, P rounded to bf16 straight from the score registers.
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const bf16* vp = vt + (nd * 8 + g) * LVT + kk * 16 + 2 * t4;
        mma_16816(o[nd], pa, ld32(vp), ld32(vp + 8));
      }
    }
  }

  const float iA = 1.f / lA, iB = 1.f / lB;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t4;
    if (q0 + rA < a.nq)
      *reinterpret_cast<uint32_t*>(og + (q0 + rA) * a.o_rs + c) =
          pack_bf16x2(o[nd][0] * iA, o[nd][1] * iA);
    if (q0 + rB < a.nq)
      *reinterpret_cast<uint32_t*>(og + (q0 + rB) * a.o_rs + c) =
          pack_bf16x2(o[nd][2] * iB, o[nd][3] * iB);
  }
  if (a.lse != nullptr && t4 == 0) {
    if (q0 + rA < a.nq) a.lse[((long long)b * a.nq + q0 + rA) * a.heads + h] = mA + logf(lA);
    if (q0 + rB < a.nq) a.lse[((long long)b * a.nq + q0 + rB) * a.heads + h] = mB + logf(lB);
  }
}

template <int D, bool SCALE_SCORES>
cudaError_t launch_tc(const AttnArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = (size_t)tc_smem_bytes_base<D>() + sizeof(float) * TQ * (a.gh + a.gw);
  if (smem > (size_t)kMaxSmemBytes || batch > kMaxGridYZ) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_tc_kernel<D, SCALE_SCORES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + TQ - 1) / TQ, a.heads, batch);
  attn_tc_kernel<D, SCALE_SCORES><<<grid, TW * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool SCALE_SCORES>
cudaError_t dispatch_tc(const AttnArgs& a, int d, int batch, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_tc<32, SCALE_SCORES>(a, batch, stream);
    case 64: return launch_tc<64, SCALE_SCORES>(a, batch, stream);
    case 80: return launch_tc<80, SCALE_SCORES>(a, batch, stream);
    case 128: return launch_tc<128, SCALE_SCORES>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool SCALE_SCORES>
cudaError_t dispatch_d(const AttnArgs& a, int d, int batch, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32, SCALE_SCORES>(a, batch, stream);
    case 64: return launch<T, 64, SCALE_SCORES>(a, batch, stream);
    case 80: return launch<T, 80, SCALE_SCORES>(a, batch, stream);
    case 128: return launch<T, 128, SCALE_SCORES>(a, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The body of a plain C entry. Pointers and element strides as described in
// AttnArgs; relh/relw may be null (no bias), lse may be null (not written).
// Returns the cudaError_t of the launch.
template <bool SCALE_SCORES>
int attention_fwd_entry(int dtype, const void* q, const void* k, const void* v, void* o,
                        const void* relh, const void* relw, void* lse, int batch, int heads,
                        int nq, int nk, int d, long long q_bs, long long q_rs, long long k_bs,
                        long long k_rs, long long v_bs, long long v_rs, long long o_bs,
                        long long o_rs, int gh, int gw, float scale, void* stream) {
  AttnArgs a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.relh = relh; a.relw = relw;
  a.lse = static_cast<float*>(lse);
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = relh ? gh : 0; a.gw = relh ? gw : 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return (int)dispatch_d<float, SCALE_SCORES>(a, d, batch, s);
  if (dtype == kBFloat16) return (int)dispatch_tc<SCALE_SCORES>(a, d, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_FWD(name, scale_scores)                                          \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, void* o,      \
                      const void* relh, const void* relw, void* lse, int batch, int heads,  \
                      int nq, int nk, int d, long long q_bs, long long q_rs,                \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,       \
                      long long o_bs, long long o_rs, int gh, int gw, float scale,          \
                      void* stream) {                                                        \
    return wm::attention_fwd_entry<scale_scores>(dtype, q, k, v, o, relh, relw, lse, batch, \
                                                 heads, nq, nk, d, q_bs, q_rs, k_bs, k_rs,  \
                                                 v_bs, v_rs, o_bs, o_rs, gh, gw, scale,     \
                                                 stream);                                    \
  }
