// Streaming multi-head attention with an optional decomposed
// relative-position bias, forward, bf16: the body made for Hopper (wgmma, a
// shared-memory ring filled by TMA). It computes the function of
// attention_fwd.cuh (see that header for the layouts and rounding points)
// and takes over its streaming shapes, for the TPU kernels
//
//   K2 wildlifemapper_tpu/ops/flash_attention_v2.py::flash_attention_packed
//   K4 wildlifemapper_tpu/ops/cross_attention.py::cross_attention_packed
//      (instantiated by attention_sm90.cu, SCALE_SCORES = false)
//   K5 wildlifemapper_tpu/ops/flash_attention.py::flash_attention_rel_pos
//      (instantiated by grouped_attention_sm90.cu, SCALE_SCORES = true)
//
// at d = 64 or 128 in bf16 with many keys (ops/_attention.py::attention_body
// says which launch comes here). The windowed shapes (K1, K6), d = 32 and
// f32 stay with attention_fwd.cuh.
//
// What bounds it on the H100: operations (4*N^2*d flops a head against
// 6*N*d bytes: 275 GFLOP for K4 at B 4, H 8, N 4096, d 128, 0.278 ms at
// 989 TFLOP/s). The mma.sync body reached a tenth of that: every 64-key tile
// was fetched through registers between two block barriers, V was stored a
// second time transposed by 2-byte stores, every mma took two 32-bit
// shared-memory loads, and a tile served only 64 query rows. What this
// design does about each:
//  * a block owns 128 query rows: two consumer warpgroups of 64 rows and a
//    producer warp; setmaxnreg moves the producer's registers to the
//    consumers;
//  * K and V tiles of TK keys go through a ring of STAGES stages in shared
//    memory, filled by TMA (one thread asks for a box of a 3-D tensor map
//    over column, row and batch; the strides of the packed (B, N, 3C) qkv or
//    of the grouped (BH, N, d) operands are the map's, rows past the end
//    arrive as zeros and another batch's rows are never read) and handed
//    over by mbarriers, full and empty, so loads run ahead of the products.
//    TMA and not cp.async: one thread issues a tile, the 128-byte swizzle
//    wgmma wants is applied by the copy engine, and the ragged edge needs no
//    code. The maps are built on the host for every launch (a few hundred
//    nanoseconds each, no device work) and passed as kernel arguments;
//  * S = Q.K^T is wgmma m64nTKk16 with Q as the A operand from registers
//    (round(q*scale) is taken once, in registers) and K as the B operand,
//    K-major, straight from the ring;
//  * bias, mask and the online softmax stay in the accumulator registers;
//    without rel tables none of the bias code is compiled in (HAS_REL);
//  * O += P.V takes P rounded to bf16 from the same registers as A and V as
//    the B operand in MN-major form (the instruction's transpose bit), so V
//    is never copied transposed.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_sm90_common.cuh"

namespace wm {
namespace {

struct FwdSm90Args {
  const void* q;
  void* o;
  const void* relh;  // (B, nq, H, gh) or null
  const void* relw;  // (B, nq, H, gw) or null
  float* lse;        // (B, nq, H) f32 or null
  long long q_bs, q_rs, o_bs, o_rs;  // element strides
  int heads, nq, nk, gh, gw;
  unsigned gw_magic;  // 2^32 / gw + 1: key / gw by one multiply
  float scale;
};

template <int D, int TK, int STAGES>
__host__ __device__ constexpr int fwd_sm90_ring_bytes() {
  return STAGES * 2 * TK * D * 2;
}

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL>
__global__ void __launch_bounds__(kSm90Threads, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v, FwdSm90Args a) {
  using namespace sm90;
  using bf16 = __nv_bfloat16;
  constexpr int KD = D / 16;            // k-steps of Q.K^T
  constexpr int NS = TK / 8;            // 8-key groups of a tile
  constexpr int ND = D / 8;             // 8-column groups of the output
  constexpr int NR = D / 64;            // 64-column regions of a tile
  constexpr int REGION = TK * kRegionRowBytes;
  constexpr int TILE = NR * REGION;     // K or V of one stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + STAGES * 2 * TILE;
  const uint32_t empty0 = full0 + 8 * STAGES;
  bf16* rhs = reinterpret_cast<bf16*>(gen + STAGES * 2 * TILE + 16 * STAGES);
  const int sh = rel_row_len(a.gh), sw = rel_row_len(a.gw);
  bf16* rws = rhs + kSm90Rows * sh;

  const int q0 = blockIdx.x * kSm90Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int nkt = (a.nk + TK - 1) / TK;

  if (t == 0) init_ring_barriers<STAGES>(full0, empty0, 1);
  __syncthreads();

  if (t >= kConsumerThreads) {
    // ---- producer ----
    reg_dealloc<kProducerRegs>();
    if (t == kConsumerThreads)
      produce_kv_tiles<D, TK, STAGES>(base, full0, empty0, &map_k, &map_v, h, b, nkt);
  } else {
    // ---- consumers ----
    reg_alloc<kConsumerRegs>();
    const int lane = t & 31, warp = t >> 5;  // 8 warps of 16 rows
    const int g = lane >> 2, t4 = lane & 3;
    const int rA = warp * 16 + g, rB = rA + 8;
    const bool okA = q0 + rA < a.nq, okB = q0 + rB < a.nq;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_bs + h * D;
    bf16* og = static_cast<bf16*>(a.o) + b * a.o_bs + h * D;

    uint32_t qa[KD][4];
    {
      const bf16* rowA = qg + (long long)(q0 + rA) * a.q_rs;
      const bf16* rowB = qg + (long long)(q0 + rB) * a.q_rs;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int c = kd * 16 + 2 * t4;
        qa[kd][0] = load_a_pair<!SCALE_SCORES>(rowA, c, okA, a.scale);
        qa[kd][1] = load_a_pair<!SCALE_SCORES>(rowB, c, okB, a.scale);
        qa[kd][2] = load_a_pair<!SCALE_SCORES>(rowA, c + 8, okA, a.scale);
        qa[kd][3] = load_a_pair<!SCALE_SCORES>(rowB, c + 8, okB, a.scale);
      }
    }
    if (HAS_REL) {
      stage_rel_tables(rhs, rws, sh, sw, a.relh, a.relw, b, h, q0, a.nq, a.heads, a.gh, a.gw, t);
      named_barrier(1, kConsumerThreads);
    }
    // with a grid width that is a multiple of 8, an 8-key group lies in one
    // grid row at 8 adjacent columns: one 32-bit read of rel_w a row
    const bool rel_fast = HAS_REL && (a.gw % 8 == 0);

    float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;
    float o[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * TK;
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t ks = base + stage * 2 * TILE, vs = ks + TILE;

      // S = Q K^T: 64 rows x TK keys a warpgroup.
      float s[NS][4];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint64_t kdesc = desc_kmajor(ks + (kd / 4) * REGION + (kd % 4) * 32);
        wgmma_rs<0, TK>(s, qa[kd], kdesc, kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);

      if (SCALE_SCORES) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] *= a.scale;
        }
      }
      if (HAS_REL)
        add_rel_bias<NS>(s, rhs, rws, sh, sw, rA, rB, t4, k0, a.nk, a.gh, a.gw, a.gw_magic,
                         rel_fast);
      if (k0 + TK > a.nk) {  // the last tile: keys past the end count for nothing
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (k0 + n * 8 + 2 * t4 + j >= a.nk) s[n][j] = s[n][j + 2] = -INFINITY;
          }
        }
      }

      // The online softmax of rows rA and rB.
      float tA = -INFINITY, tB = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        tA = fmaxf(tA, fmaxf(s[n][0], s[n][1]));
        tB = fmaxf(tB, fmaxf(s[n][2], s[n][3]));
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

      // O += P V: P rounded to bf16 from the score registers, V MN-major.
      uint32_t pa[TK / 16][4];
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint64_t vdesc = desc_mnmajor(vs + kk * 16 * kRegionRowBytes, REGION);
        wgmma_rs<1, D>(o, pa[kk], vdesc, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    const float iA = 1.f / lA, iB = 1.f / lB;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + 2 * t4;
      if (okA)
        *reinterpret_cast<uint32_t*>(og + (long long)(q0 + rA) * a.o_rs + c) =
            pack_bf16x2(o[nd][0] * iA, o[nd][1] * iA);
      if (okB)
        *reinterpret_cast<uint32_t*>(og + (long long)(q0 + rB) * a.o_rs + c) =
            pack_bf16x2(o[nd][2] * iB, o[nd][3] * iB);
    }
    if (a.lse != nullptr && t4 == 0) {
      if (okA) a.lse[((long long)b * a.nq + q0 + rA) * a.heads + h] = mA + logf(lA);
      if (okB) a.lse[((long long)b * a.nq + q0 + rB) * a.heads + h] = mB + logf(lB);
    }
  }
}

struct FwdSm90Operands {
  const void* k;
  const void* v;
  long long k_bs, k_rs, v_bs, v_rs;
  int batch;
};

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL>
cudaError_t launch_fwd_sm90(const FwdSm90Args& a, const FwdSm90Operands& p,
                            cudaStream_t stream) {
  const size_t smem = 1024 + fwd_sm90_ring_bytes<D, TK, STAGES>() + 16 * STAGES +
                      (HAS_REL ? 2 * kSm90Rows * (rel_row_len(a.gh) + rel_row_len(a.gw)) : 0);
  if (smem > (size_t)kMaxSmemBytes || p.batch > 65535 || a.heads > 65535 || a.nk > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  cudaError_t err = sm90::make_map(&map_k, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, TK);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_v, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, TK);
  if (err != cudaSuccess) return err;
  auto kernel = attn_fwd_sm90_kernel<D, TK, STAGES, SCALE_SCORES, HAS_REL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + kSm90Rows - 1) / kSm90Rows, a.heads, p.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(map_k, map_v, a);
  return cudaGetLastError();
}

// The body of a plain C entry, with the arguments of attention_fwd.cuh's.
// bf16 only, d = 64 or 128; anything else is refused (cudaErrorInvalidValue).
template <bool SCALE_SCORES>
int attention_fwd_sm90_entry(int dtype, const void* q, const void* k, const void* v, void* o,
                             const void* relh, const void* relw, void* lse, int batch,
                             int heads, int nq, int nk, int d, long long q_bs, long long q_rs,
                             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                             long long o_bs, long long o_rs, int gh, int gw, float scale,
                             void* stream) {
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const bool rel = relh != nullptr && relw != nullptr;
  FwdSm90Args a;
  a.q = q; a.o = o; a.relh = rel ? relh : nullptr; a.relw = rel ? relw : nullptr;
  a.lse = static_cast<float*>(lse);
  a.q_bs = q_bs; a.q_rs = q_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = rel ? gh : 0; a.gw = rel ? gw : 0;
  a.gw_magic = gw_magic_of(a.gw);
  a.scale = scale;
  if (rel && (gw < 1 || gh < 1)) return (int)cudaErrorInvalidValue;
  FwdSm90Operands p{k, v, k_bs, k_rs, v_bs, v_rs, batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return (int)(rel ? launch_fwd_sm90<64, 128, 3, SCALE_SCORES, true>(a, p, s)
                     : launch_fwd_sm90<64, 128, 3, SCALE_SCORES, false>(a, p, s));
  if (d == 128)
    return (int)(rel ? launch_fwd_sm90<128, 64, 3, SCALE_SCORES, true>(a, p, s)
                     : launch_fwd_sm90<128, 64, 3, SCALE_SCORES, false>(a, p, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_FWD_SM90(name, scale_scores)                                     \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, void* o,      \
                      const void* relh, const void* relw, void* lse, int batch, int heads,  \
                      int nq, int nk, int d, long long q_bs, long long q_rs,                \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,       \
                      long long o_bs, long long o_rs, int gh, int gw, float scale,          \
                      void* stream) {                                                        \
    return wm::attention_fwd_sm90_entry<scale_scores>(                                       \
        dtype, q, k, v, o, relh, relw, lse, batch, heads, nq, nk, d, q_bs, q_rs, k_bs,      \
        k_rs, v_bs, v_rs, o_bs, o_rs, gh, gw, scale, stream);                                \
  }
