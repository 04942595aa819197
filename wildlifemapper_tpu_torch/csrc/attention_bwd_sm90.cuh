// Backward of the streaming multi-head attention, bf16: the two kernel
// bodies made for Hopper (wgmma, a shared-memory ring filled by TMA). They
// compute the function of attention_bwd.cuh (see that header for the
// formulas and rounding points) and take over its streaming shapes, for the
// TPU kernels
//
//   K2 wildlifemapper_tpu/ops/flash_attention_v2.py::_bwd_dq_kernel and
//      ::_bwd_dkv_kernel
//   K4 wildlifemapper_tpu/ops/cross_attention.py::_bwd_dq_kernel and
//      ::_bwd_dkv_kernel
//      (instantiated by attention_bwd_dq_sm90.cu / attention_bwd_dkv_sm90.cu,
//      SCALE_SCORES = false)
//   K5 wildlifemapper_tpu/ops/flash_attention.py::_bwd_kernel
//      (grouped_attention_bwd_dq_sm90.cu / grouped_attention_bwd_dkv_sm90.cu,
//      SCALE_SCORES = true)
//
// at d = 64 or 128 in bf16 with many keys (ops/_attention.py::attention_body
// says which launch comes here). The windowed shapes (K1, K6), d = 32 and
// f32 stay with attention_bwd.cuh.
//
// What bounds them on the H100: operations, 6*N^2*d flops a head in the dq
// kernel and 8*N^2*d in the dk/dv kernel against O(N*d) bytes (K4 at B 4,
// H 8, N 4096, d 128: 0.417 + 0.556 ms at 989 TFLOP/s). The mma.sync bodies
// fetched every tile through registers between two block barriers, wrote K
// (dq kernel) and the q / do tiles (dk/dv kernel) a second time transposed
// by 2-byte stores, re-read their A fragments from shared memory in every
// tile, and at d = 128 took the q tile in two passes at 255 registers. The
// two-kernel split and what it guarantees stay: one owner for every element
// of dq, dk and dv, the rel-table gradients summed in a fixed order, no
// atomics, bit-identical from run to run. What the design changes:
//  * a block owns 128 rows: two consumer warpgroups of 64 and a producer
//    warp, registers moved to the consumers by setmaxnreg; the streamed
//    tiles go through a ring of STAGES stages filled by TMA and handed over
//    by full / empty mbarriers (see attention_fwd_sm90.cuh on TMA);
//  * dq kernel: q and do of the block's rows are A operands in registers
//    (round(q*scale) taken once), K and V stream; S = Q.K^T and dP = dO.V^T
//    read the K and V tiles K-major, dQ += dS.K reads the same K tile
//    MN-major (the instruction's transpose bit) with dS rounded to bf16 in
//    registers as A. The rel-table sums are register sums as before (column
//    sums added lane by lane into shared accumulators in steps that a warp
//    barrier orders, or kept in registers for the whole walk where a tile is
//    one grid row; row sums by quad shuffles) and run while the dQ product
//    is in flight; without wanted table gradients none of it is compiled in;
//  * dk/dv kernel: the block's K and V tiles are resident in shared memory
//    as A operands, q and do tiles stream. The scores are computed
//    transposed, S^T = K.Q^T and dP^T = V.dO^T (keys are the 64 rows of a
//    warpgroup), so P^T and dS^T sit in registers as the A operands of
//    dV += P^T.dO and dK += dS^T.Q, which read the same streamed tiles
//    MN-major. lse and delta of a tile's rows come with the tile (the
//    producer warp stores them beside it before it signals full); with rel
//    tables, TMA brings the tile's table rows too and the consumers spread
//    them into padded f32 tables (double-buffered, one named barrier a
//    tile). Where the packed family's scale is no power of two (d = 128)
//    round(q*scale) is not (q.k)*scale, so the consumers first round the
//    streamed q tile into a second buffer of the same swizzled layout; a
//    power-of-two scale (d = 64) goes on the f32 scores, which is the same
//    number bit for bit.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_sm90_common.cuh"

namespace wm {
namespace {

struct BwdSm90Args {
  const void* q;       // dq kernel: the block's rows, read by stride
  const void* dout;
  const float* lse;    // (B, nq, H)
  const float* delta;  // (B, nq, H)
  const void* relh;    // (B, nq, H, gh) or null
  const void* relw;
  void* dq;
  void* dk;
  void* dv;
  void* drelh;         // (B, nq, H, gh) or null: not wanted
  void* drelw;
  long long q_bs, q_rs, do_bs, do_rs, dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int heads, nq, nk, gh, gw;
  unsigned gw_magic;
  float scale;
  int prescale;  // dk/dv kernel: round q*scale into a second buffer
  int rel_tma;   // dk/dv kernel: the rel rows of a tile come by TMA
};

// Smallest length >= x that is 4 mod 16 (in f32 words): rows 2*t4 apart
// fall 8 banks apart and the 8 columns of a warp's keys beside them.
__host__ __device__ inline int pitch4(int x) { return ((x + 11) / 16) * 16 + 4; }

// ---- dq (+ drel) kernel -------------------------------------------------------

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL, bool WANT_DREL>
__global__ void __launch_bounds__(kSm90Threads, 1)
    attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, BwdSm90Args a) {
  using namespace sm90;
  using bf16 = __nv_bfloat16;
  static_assert(!WANT_DREL || HAS_REL, "table gradients need tables");
  constexpr int KD = D / 16;
  constexpr int NS = TK / 8;
  constexpr int ND = D / 8;
  constexpr int NR = D / 64;
  constexpr int REGION = TK * kRegionRowBytes;
  constexpr int TILE = NR * REGION;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t full0 = base + STAGES * 2 * TILE;
  const uint32_t empty0 = full0 + 8 * STAGES;
  bf16* rhs = reinterpret_cast<bf16*>(gen + STAGES * 2 * TILE + 16 * STAGES);
  const int sh = rel_row_len(a.gh), sw = rel_row_len(a.gw);
  bf16* rws = rhs + kSm90Rows * sh;
  // the accumulators of the table gradients, rows padded by one float
  const int dh = a.gh + 1, dw = a.gw + 1;
  float* drh = reinterpret_cast<float*>(rws + kSm90Rows * sw);
  float* drw = drh + kSm90Rows * dh;

  const int q0 = blockIdx.x * kSm90Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int nkt = (a.nk + TK - 1) / TK;

  if (t == 0) init_ring_barriers<STAGES>(full0, empty0, 1);
  __syncthreads();

  if (t >= kConsumerThreads) {
    reg_dealloc<kProducerRegs>();
    if (t == kConsumerThreads)
      produce_kv_tiles<D, TK, STAGES>(base, full0, empty0, &map_k, &map_v, h, b, nkt);
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int rA = warp * 16 + g, rB = rA + 8;
    const bool okA = q0 + rA < a.nq, okB = q0 + rB < a.nq;
    const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_bs + h * D;
    const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * D;
    bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dq_bs + h * D;

    uint32_t qa[KD][4], da[KD][4];
    {
      const bf16* qA = qg + (long long)(q0 + rA) * a.q_rs;
      const bf16* qB = qg + (long long)(q0 + rB) * a.q_rs;
      const bf16* dA = dog + (long long)(q0 + rA) * a.do_rs;
      const bf16* dB = dog + (long long)(q0 + rB) * a.do_rs;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int c = kd * 16 + 2 * t4;
        qa[kd][0] = load_a_pair<!SCALE_SCORES>(qA, c, okA, a.scale);
        qa[kd][1] = load_a_pair<!SCALE_SCORES>(qB, c, okB, a.scale);
        qa[kd][2] = load_a_pair<!SCALE_SCORES>(qA, c + 8, okA, a.scale);
        qa[kd][3] = load_a_pair<!SCALE_SCORES>(qB, c + 8, okB, a.scale);
        da[kd][0] = load_a_pair<false>(dA, c, okA, 1.f);
        da[kd][1] = load_a_pair<false>(dB, c, okB, 1.f);
        da[kd][2] = load_a_pair<false>(dA, c + 8, okA, 1.f);
        da[kd][3] = load_a_pair<false>(dB, c + 8, okB, 1.f);
      }
    }
    const long long statA = ((long long)b * a.nq + q0 + rA) * a.heads + h;
    const long long statB = ((long long)b * a.nq + q0 + rB) * a.heads + h;
    const float lseA = okA ? a.lse[statA] : 0.f, lseB = okB ? a.lse[statB] : 0.f;
    const float delA = okA ? a.delta[statA] : 0.f, delB = okB ? a.delta[statB] : 0.f;
    if (HAS_REL) {
      stage_rel_tables(rhs, rws, sh, sw, a.relh, a.relw, b, h, q0, a.nq, a.heads, a.gh, a.gw, t);
      if (WANT_DREL)
        for (int i = t; i < kSm90Rows * (dh + dw); i += kConsumerThreads) drh[i] = 0.f;
      named_barrier(1, kConsumerThreads);
    }
    const bool rel_fast = HAS_REL && (a.gw % 8 == 0);

    float dq[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
    const bool tile_is_row = WANT_DREL && a.gw == TK;
    float cw[NS][4];  // drel_w of this thread's columns, see below
#pragma unroll
    for (int n = 0; n < NS; ++n) cw[n][0] = cw[n][1] = cw[n][2] = cw[n][3] = 0.f;

    int stage = 0;
    uint32_t phase = 0;
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * TK;
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t ks = base + stage * 2 * TILE, vs = ks + TILE;

      // S = Q K^T and dP = dO V^T: 64 rows x TK keys a warpgroup.
      float s[NS][4], dp[NS][4];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        wgmma_rs<0, TK>(s, qa[kd], desc_kmajor(ks + (kd / 4) * REGION + (kd % 4) * 32), kd > 0);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        wgmma_rs<0, TK>(dp, da[kd], desc_kmajor(vs + (kd / 4) * REGION + (kd % 4) * 32), kd > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);

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
      // ds = p * (dp - delta), left in s; masked keys and rows give 0.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const bool valid = k0 + n * 8 + 2 * t4 + j < a.nk;
          float dsA = (valid && okA) ? __expf(s[n][j] - lseA) * (dp[n][j] - delA) : 0.f;
          float dsB = (valid && okB) ? __expf(s[n][j + 2] - lseB) * (dp[n][j + 2] - delB) : 0.f;
          if (WANT_DREL) {  // the sums take ds as the products do: rounded
            dsA = round_to<bf16>(dsA);
            dsB = round_to<bf16>(dsB);
          }
          s[n][j] = dsA;
          s[n][j + 2] = dsB;
        }
      }

      // dQ += dS K: dS rounded to bf16 from the registers, K MN-major.
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
      for (int kk = 0; kk < TK / 16; ++kk)
        wgmma_rs<1, D>(dq, pa[kk], desc_mnmajor(ks + kk * 16 * kRegionRowBytes, REGION), 1);
      wgmma_commit();

      if (WANT_DREL) {
        // While the product runs: the sums of ds over the grid. drel_w: in
        // each step the warp's lanes hold 8 rows x 4 different columns (for
        // a grid at least 8 wide; a narrower one goes one quad lane at a
        // time), so their adds never collide; a warp barrier orders the
        // steps. Each warp owns its 16 rows of the accumulators.
        // Where a tile is exactly one grid row (gw == TK, the 64-grid of the
        // full canvas) a register keeps meeting the same column: the column
        // sums stay in registers until the walk ends.
        if (tile_is_row) {
#pragma unroll
          for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int j = 0; j < 4; ++j) cw[n][j] += s[n][j];
          }
        } else {
          const bool wide = a.gw >= 8;
          const int nq4 = wide ? 1 : 4;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int key = k0 + n * 8 + 2 * t4 + j;
              const int kw = key - div_gw(key, a.gw, a.gw_magic) * a.gw;
              for (int q4 = 0; q4 < nq4; ++q4) {
                if (key < a.nk && (wide || t4 == q4)) {
                  drw[rA * dw + kw] += s[n][j];
                  drw[rB * dw + kw] += s[n][j + 2];
                }
                __syncwarp();
              }
            }
          }
        }
        // drel_h: a grid row is a run of keys; each thread sums its share of
        // the run, the quad adds up, one lane a row accumulates.
        const int rfirst = div_gw(k0, a.gw, a.gw_magic);
        const int rlast = div_gw(min(k0 + TK - 1, a.nk - 1), a.gw, a.gw_magic);
        for (int rr = rfirst; rr <= rlast; ++rr) {
          const int lo = rr * a.gw - k0, hi = lo + a.gw;  // the run, tile-relative
          float pA = 0.f, pB = 0.f;
#pragma unroll
          for (int n = 0; n < NS; ++n) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int kc = n * 8 + 2 * t4 + j;
              if (kc >= lo && kc < hi) {  // masked keys hold 0
                pA += s[n][j];
                pB += s[n][j + 2];
              }
            }
          }
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            pA += __shfl_xor_sync(0xffffffffu, pA, off);
            pB += __shfl_xor_sync(0xffffffffu, pB, off);
          }
          if (t4 == 0) {
            drh[rA * dh + rr] += pA;
            drh[rB * dh + rr] += pB;
          }
        }
      }

      wgmma_wait<0>();
      fence_acc(dq);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + 2 * t4;
      if (okA)
        *reinterpret_cast<uint32_t*>(dqg + (long long)(q0 + rA) * a.dq_rs + c) =
            pack_bf16x2(dq[nd][0] * a.scale, dq[nd][1] * a.scale);
      if (okB)
        *reinterpret_cast<uint32_t*>(dqg + (long long)(q0 + rB) * a.dq_rs + c) =
            pack_bf16x2(dq[nd][2] * a.scale, dq[nd][3] * a.scale);
    }
    if (WANT_DREL) {
      if (tile_is_row) {
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            drw[rA * dw + n * 8 + 2 * t4 + j] = cw[n][j];
            drw[rB * dw + n * 8 + 2 * t4 + j] = cw[n][j + 2];
          }
        }
      }
      __syncwarp();
      bf16* gh_out = static_cast<bf16*>(a.drelh);
      bf16* gw_out = static_cast<bf16*>(a.drelw);
      for (int e = lane; e < 16 * a.gh; e += 32) {
        const int row = warp * 16 + e / a.gh, j = e % a.gh;
        if (q0 + row < a.nq)
          gh_out[(((long long)b * a.nq + q0 + row) * a.heads + h) * a.gh + j] =
              __float2bfloat16_rn(drh[row * dh + j]);
      }
      for (int e = lane; e < 16 * a.gw; e += 32) {
        const int row = warp * 16 + e / a.gw, j = e % a.gw;
        if (q0 + row < a.nq)
          gw_out[(((long long)b * a.nq + q0 + row) * a.heads + h) * a.gw + j] =
              __float2bfloat16_rn(drw[row * dw + j]);
      }
    }
  }
}

// ---- dk/dv kernel ---------------------------------------------------------------

// Shared-memory plan of the dk/dv kernel, in bytes from the 1024-aligned
// base; the same function sizes the launch.
template <int D, int TQ, int STAGES>
struct DkvPlan {
  static constexpr int KV = 2 * kSm90Rows * D * 2;   // resident K and V
  static constexpr int TILE = TQ * D * 2;            // q or do of one stage
  int ring, qs, stats, bars, raw, raw_stage, tabs, tab_w, tab_h, pw, ph, total;
  __host__ __device__ DkvPlan(int gh, int gw, bool has_rel, bool prescale, bool rel_tma) {
    ring = KV;
    qs = ring + STAGES * 2 * TILE;
    stats = qs + (prescale ? STAGES * TILE : 0);
    bars = stats + STAGES * 2 * TQ * 4;
    raw = (bars + 8 * (2 * STAGES + 1) + 127) & ~127;
    raw_stage = (has_rel && rel_tma) ? ((TQ * (gh + gw) * 2 + 127) & ~127) : 0;
    tabs = raw + STAGES * raw_stage;
    pw = has_rel ? pitch4(gw) : 0;
    ph = has_rel ? pitch4((kSm90Rows - 1) / gw + 2) : 0;
    tab_w = TQ * pw * 4;
    tab_h = TQ * ph * 4;
    total = tabs + 2 * (tab_w + tab_h);
  }
};

template <int D, int TQ, int STAGES, bool SCALE_SCORES, bool HAS_REL>
__global__ void __launch_bounds__(kSm90Threads, 1)
    attn_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_rh,
                             const __grid_constant__ CUtensorMap map_rw, BwdSm90Args a) {
  using namespace sm90;
  using bf16 = __nv_bfloat16;
  constexpr int KD = D / 16;
  constexpr int NS = TQ / 8;     // 8-query groups of a tile
  constexpr int ND = D / 8;
  constexpr int NR = D / 64;
  constexpr int KREGION = kSm90Rows * kRegionRowBytes;  // a region of resident K or V
  constexpr int QREGION = TQ * kRegionRowBytes;         // a region of a streamed tile
  constexpr int TILE = NR * QREGION;
  const bool prescale = !SCALE_SCORES && a.prescale != 0;
  const bool rel_tma = HAS_REL && a.rel_tma != 0;
  const DkvPlan<D, TQ, STAGES> plan(a.gh, a.gw, HAS_REL, prescale, rel_tma);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + plan.bars;
  const uint32_t full0 = kv_full + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int k0 = blockIdx.x * kSm90Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int nqt = (a.nq + TQ - 1) / TQ;

  if (t == 0) {
    mbar_init(kv_full, 1);
    // two arrivals fill a stage: the TMA request, then the tile's lse and delta
    init_ring_barriers<STAGES>(full0, empty0, 2);
  }
  __syncthreads();

  if (t >= kConsumerThreads) {
    reg_dealloc<kProducerRegs>();
    if (t < kConsumerThreads + 32) {
      const int lane = t - kConsumerThreads;
      if (lane == 0) {
        mbar_expect_tx(kv_full, plan.KV);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          tma_load_3d(base + r * KREGION, &map_k, h * D + r * 64, k0, b, kv_full);
          tma_load_3d(base + NR * KREGION + r * KREGION, &map_v, h * D + r * 64, k0, b, kv_full);
        }
      }
      int stage = 0;
      uint32_t phase = 1;
      for (int qt = 0; qt < nqt; ++qt) {
        const int q0 = qt * TQ;
        float st_l[TQ / 32], st_d[TQ / 32];
#pragma unroll
        for (int i = 0; i < TQ / 32; ++i) {
          const int row = q0 + lane + 32 * i;
          const long long stat = ((long long)b * a.nq + row) * a.heads + h;
          st_l[i] = row < a.nq ? a.lse[stat] : 0.f;
          st_d[i] = row < a.nq ? a.delta[stat] : 0.f;
        }
        mbar_wait(empty0 + 8 * stage, phase);
        const uint32_t full = full0 + 8 * stage;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * TILE + (rel_tma ? TQ * (a.gh + a.gw) * 2 : 0));
          const uint32_t dst = base + plan.ring + stage * 2 * TILE;
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            tma_load_3d(dst + r * QREGION, &map_q, h * D + r * 64, q0, b, full);
            tma_load_3d(dst + TILE + r * QREGION, &map_do, h * D + r * 64, q0, b, full);
          }
          if (rel_tma) {
            const uint32_t raw = base + plan.raw + stage * plan.raw_stage;
            tma_load_4d(raw, &map_rh, 0, h, q0, b, full);
            tma_load_4d(raw + TQ * a.gh * 2, &map_rw, 0, h, q0, b, full);
          }
        }
        float* stats = reinterpret_cast<float*>(gen + plan.stats) + stage * 2 * TQ;
#pragma unroll
        for (int i = 0; i < TQ / 32; ++i) {
          stats[lane + 32 * i] = st_l[i];
          stats[TQ + lane + 32 * i] = st_d[i];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(full);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = t & 31, warp = t >> 5, wg = t >> 7;
    const int g = lane >> 2, t4 = lane & 3;
    const int rA = warp * 16 + g, rB = rA + 8;  // keys, block-relative
    const bool okA = k0 + rA < a.nk, okB = k0 + rB < a.nk;
    // this block's keys in the rel grid: rows relative to the block's first
    int rfirst = 0, nrh = 0, khA = 0, khB = 0, kwA = 0, kwB = 0;
    if (HAS_REL) {
      rfirst = div_gw(k0, a.gw, a.gw_magic);
      nrh = div_gw(min(k0 + kSm90Rows - 1, a.nk - 1), a.gw, a.gw_magic) - rfirst + 1;
      if (okA) {
        khA = div_gw(k0 + rA, a.gw, a.gw_magic);
        kwA = k0 + rA - khA * a.gw;
        khA -= rfirst;
      }
      if (okB) {
        khB = div_gw(k0 + rB, a.gw, a.gw_magic);
        kwB = k0 + rB - khB * a.gw;
        khB -= rfirst;
      }
    }
    const float mult = (SCALE_SCORES || !prescale) ? a.scale : 1.f;
    const uint32_t k_res = base + wg * 64 * kRegionRowBytes;   // this warpgroup's 64 keys
    const uint32_t v_res = k_res + NR * KREGION;

    float dk[ND][4], dv[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
      dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
    }
    mbar_wait(kv_full, 0);

    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < nqt; ++qt) {
      const int q0 = qt * TQ;
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t q_tile = base + plan.ring + stage * 2 * TILE, do_tile = q_tile + TILE;
      uint32_t qs_tile = q_tile;
      const float* stats = reinterpret_cast<const float*>(gen + plan.stats) + stage * 2 * TQ;
      const float* tab_w = reinterpret_cast<const float*>(gen + plan.tabs) +
                           (qt & 1) * ((plan.tab_w + plan.tab_h) / 4);
      const float* tab_h = tab_w + plan.tab_w / 4;

      if (prescale || HAS_REL) {
        if (prescale) {
          // round(q * scale) of the tile into its own buffer, chunk for chunk
          // at the same swizzled place
          qs_tile = base + plan.qs + stage * TILE;
          const uint4* src = reinterpret_cast<const uint4*>(gen + plan.ring + stage * 2 * TILE);
          uint4* dst = reinterpret_cast<uint4*>(gen + plan.qs + stage * TILE);
          for (int i = t; i < TILE / 16; i += kConsumerThreads) {
            uint4 v = src[i];
            v.x = pack_bf16x2(bf16_lo(v.x) * a.scale, bf16_hi(v.x) * a.scale);
            v.y = pack_bf16x2(bf16_lo(v.y) * a.scale, bf16_hi(v.y) * a.scale);
            v.z = pack_bf16x2(bf16_lo(v.z) * a.scale, bf16_hi(v.z) * a.scale);
            v.w = pack_bf16x2(bf16_lo(v.w) * a.scale, bf16_hi(v.w) * a.scale);
            dst[i] = v;
          }
          fence_proxy_async();
        }
        if (HAS_REL) {
          float* tw = const_cast<float*>(tab_w);
          float* th = const_cast<float*>(tab_h);
          if (rel_tma) {
            const bf16* raw_h =
                reinterpret_cast<const bf16*>(gen + plan.raw + stage * plan.raw_stage);
            const bf16* raw_w = raw_h + TQ * a.gh;
            const int vpr = a.gw / 8;
            for (int i = t; i < TQ * vpr; i += kConsumerThreads) {
              const int qq = i / vpr, c = (i - qq * vpr) * 8;
              const uint4 v = *reinterpret_cast<const uint4*>(raw_w + qq * a.gw + c);
              float4* out = reinterpret_cast<float4*>(tw + qq * plan.pw + c);
              out[0] = make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
              out[1] = make_float4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w));
            }
            for (int i = t; i < TQ * nrh; i += kConsumerThreads) {
              const int qq = i / nrh, j = i - qq * nrh;
              th[qq * plan.ph + j] = bf16_at(raw_h + qq * a.gh + rfirst + j);
            }
          } else {
            const bf16* rh = static_cast<const bf16*>(a.relh);
            const bf16* rw = static_cast<const bf16*>(a.relw);
            for (int i = t; i < TQ * a.gw; i += kConsumerThreads) {
              const int qq = i / a.gw, c = i - qq * a.gw;
              const long long row = ((long long)b * a.nq + q0 + qq) * a.heads + h;
              tw[qq * plan.pw + c] = (q0 + qq < a.nq) ? bf16_at(rw + row * a.gw + c) : 0.f;
            }
            for (int i = t; i < TQ * nrh; i += kConsumerThreads) {
              const int qq = i / nrh, j = i - qq * nrh;
              const long long row = ((long long)b * a.nq + q0 + qq) * a.heads + h;
              th[qq * plan.ph + j] =
                  (q0 + qq < a.nq) ? bf16_at(rh + row * a.gh + rfirst + j) : 0.f;
            }
          }
        }
        named_barrier(1, kConsumerThreads);
      }

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x TQ queries a warpgroup.
      float s[NS][4], dp[NS][4];
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t off_a = (kd / 4) * KREGION + (kd % 4) * 32;
        const uint32_t off_b = (kd / 4) * QREGION + (kd % 4) * 32;
        wgmma_ss<0, TQ>(s, desc_kmajor(k_res + off_a), desc_kmajor(qs_tile + off_b), kd > 0);
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const uint32_t off_a = (kd / 4) * KREGION + (kd % 4) * 32;
        const uint32_t off_b = (kd / 4) * QREGION + (kd % 4) * 32;
        wgmma_ss<0, TQ>(dp, desc_kmajor(v_res + off_a), desc_kmajor(do_tile + off_b), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);

      // p^T into dp and ds^T into s; masked keys and queries give 0.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int qc = n * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(stats + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(stats + TQ + qc);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float l = j ? l2.y : l2.x, del = j ? d2.y : d2.x;
          float sA = s[n][j] * mult, sB = s[n][j + 2] * mult;
          if (HAS_REL) {
            sA += tab_h[(qc + j) * plan.ph + khA] + tab_w[(qc + j) * plan.pw + kwA];
            sB += tab_h[(qc + j) * plan.ph + khB] + tab_w[(qc + j) * plan.pw + kwB];
          }
          const bool valid = q0 + qc + j < a.nq;
          const float pA = (valid && okA) ? __expf(sA - l) : 0.f;
          const float pB = (valid && okB) ? __expf(sB - l) : 0.f;
          s[n][j] = pA * (dp[n][j] - del);
          s[n][j + 2] = pB * (dp[n][j + 2] - del);
          dp[n][j] = pA;
          dp[n][j + 2] = pB;
        }
      }

      // dK += dS^T Q and dV += P^T dO: the streamed tiles MN-major.
      uint32_t sa[TQ / 16][4], pa[TQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        sa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        sa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        sa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        sa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        pa[kk][0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        pa[kk][1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        pa[kk][2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        pa[kk][3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        wgmma_rs<1, D>(dk, sa[kk], desc_mnmajor(q_tile + kk * 16 * kRegionRowBytes, QREGION), 1);
        wgmma_rs<1, D>(dv, pa[kk], desc_mnmajor(do_tile + kk * 16 * kRegionRowBytes, QREGION), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk);
      fence_acc(dv);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dk_bs + h * D;
    bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dv_bs + h * D;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int c = nd * 8 + 2 * t4;
      if (okA) {
        *reinterpret_cast<uint32_t*>(dkg + (long long)(k0 + rA) * a.dk_rs + c) =
            pack_bf16x2(dk[nd][0] * a.scale, dk[nd][1] * a.scale);
        *reinterpret_cast<uint32_t*>(dvg + (long long)(k0 + rA) * a.dv_rs + c) =
            pack_bf16x2(dv[nd][0], dv[nd][1]);
      }
      if (okB) {
        *reinterpret_cast<uint32_t*>(dkg + (long long)(k0 + rB) * a.dk_rs + c) =
            pack_bf16x2(dk[nd][2] * a.scale, dk[nd][3] * a.scale);
        *reinterpret_cast<uint32_t*>(dvg + (long long)(k0 + rB) * a.dv_rs + c) =
            pack_bf16x2(dv[nd][2], dv[nd][3]);
      }
    }
  }
}

// ---- launchers --------------------------------------------------------------------

struct BwdSm90Operands {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  int batch;
};

inline bool grid_ok(const BwdSm90Args& a, int batch) {
  return batch <= 65535 && a.heads <= 65535 && a.nk <= 65535;
}

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL, bool WANT_DREL>
cudaError_t launch_dq_sm90(const BwdSm90Args& a, const BwdSm90Operands& p, cudaStream_t stream) {
  size_t smem = 1024 + STAGES * 2 * TK * D * 2 + 16 * STAGES;
  if (HAS_REL) smem += 2 * kSm90Rows * (rel_row_len(a.gh) + rel_row_len(a.gw));
  if (WANT_DREL) smem += 4 * kSm90Rows * (a.gh + a.gw + 2);
  if (smem > (size_t)kMaxSmemBytes || !grid_ok(a, p.batch)) return cudaErrorInvalidValue;
  CUtensorMap map_k, map_v;
  cudaError_t err = sm90::make_map(&map_k, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, TK);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_v, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, TK);
  if (err != cudaSuccess) return err;
  auto kernel = attn_bwd_dq_sm90_kernel<D, TK, STAGES, SCALE_SCORES, HAS_REL, WANT_DREL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + kSm90Rows - 1) / kSm90Rows, a.heads, p.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(map_k, map_v, a);
  return cudaGetLastError();
}

template <int D, int TQ, int STAGES, bool SCALE_SCORES, bool HAS_REL>
cudaError_t launch_dkv_sm90(BwdSm90Args a, const BwdSm90Operands& p, cudaStream_t stream) {
  // a power-of-two scale on the f32 scores is round(q*scale).k bit for bit
  int exponent;
  a.prescale = !SCALE_SCORES && frexpf(a.scale, &exponent) != 0.5f;
  a.rel_tma = HAS_REL && a.gh % 8 == 0 && a.gw % 8 == 0 && a.gh <= 256 && a.gw <= 256;
  const DkvPlan<D, TQ, STAGES> plan(a.gh, a.gw, HAS_REL, a.prescale != 0, a.rel_tma != 0);
  const size_t smem = 1024 + (size_t)plan.total;
  if (smem > (size_t)kMaxSmemBytes || !grid_ok(a, p.batch)) return cudaErrorInvalidValue;
  CUtensorMap map_k, map_v, map_q, map_do, map_rh, map_rw;
  cudaError_t err =
      sm90::make_map(&map_k, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, kSm90Rows);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_v, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, kSm90Rows);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_q, p.q, a.heads * D, a.nq, p.batch, p.q_rs, p.q_bs, TQ);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_do, p.dout, a.heads * D, a.nq, p.batch, p.do_rs, p.do_bs, TQ);
  if (err != cudaSuccess) return err;
  map_rh = map_q;  // placeholders where no table comes by TMA
  map_rw = map_q;
  if (a.rel_tma) {
    err = sm90::make_rel_map(&map_rh, a.relh, a.gh, a.heads, a.nq, p.batch, TQ);
    if (err != cudaSuccess) return err;
    err = sm90::make_rel_map(&map_rw, a.relw, a.gw, a.heads, a.nq, p.batch, TQ);
    if (err != cudaSuccess) return err;
  }
  auto kernel = attn_bwd_dkv_sm90_kernel<D, TQ, STAGES, SCALE_SCORES, HAS_REL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nk + kSm90Rows - 1) / kSm90Rows, a.heads, p.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(map_k, map_v, map_q, map_do, map_rh, map_rw, a);
  return cudaGetLastError();
}

// The body of a plain C entry, with the arguments of attention_bwd.cuh's;
// WHICH is the one kernel the including source instantiates (0 dq + drel,
// 1 dk/dv), so that each kernel's instantiations compile in an nvcc of their
// own. bf16 only, d = 64 or 128; anything else is refused.
template <bool SCALE_SCORES, int WHICH>
int attention_bwd_sm90_entry(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             const void* relh, const void* relw, void* dq, void* dk, void* dv,
                             void* drelh, void* drelw, int batch, int heads, int nq, int nk,
                             int d, long long q_bs, long long q_rs, long long k_bs,
                             long long k_rs, long long v_bs, long long v_rs, long long do_bs,
                             long long do_rs, long long dq_bs, long long dq_rs, long long dk_bs,
                             long long dk_rs, long long dv_bs, long long dv_rs, int gh, int gw,
                             float scale, void* stream) {
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const bool rel = relh != nullptr && relw != nullptr;
  if (rel && (gh < 1 || gw < 1)) return (int)cudaErrorInvalidValue;
  const bool drel = rel && drelh != nullptr && drelw != nullptr;
  BwdSm90Args a;
  a.q = q; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.relh = rel ? relh : nullptr; a.relw = rel ? relw : nullptr;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.drelh = drel ? drelh : nullptr; a.drelw = drel ? drelw : nullptr;
  a.q_bs = q_bs; a.q_rs = q_rs; a.do_bs = do_bs; a.do_rs = do_rs;
  a.dq_bs = dq_bs; a.dq_rs = dq_rs; a.dk_bs = dk_bs; a.dk_rs = dk_rs;
  a.dv_bs = dv_bs; a.dv_rs = dv_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = rel ? gh : 0; a.gw = rel ? gw : 0;
  a.gw_magic = gw_magic_of(a.gw);
  a.scale = scale;
  a.prescale = 0; a.rel_tma = 0;
  BwdSm90Operands p{q, k, v, dout, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (WHICH == 0) {
    if (d == 64) {
      if (drel) return (int)launch_dq_sm90<64, 64, 4, SCALE_SCORES, true, true>(a, p, s);
      if (rel) return (int)launch_dq_sm90<64, 64, 4, SCALE_SCORES, true, false>(a, p, s);
      return (int)launch_dq_sm90<64, 64, 4, SCALE_SCORES, false, false>(a, p, s);
    }
    if (d == 128) {
      if (drel) return (int)launch_dq_sm90<128, 64, 3, SCALE_SCORES, true, true>(a, p, s);
      if (rel) return (int)launch_dq_sm90<128, 64, 3, SCALE_SCORES, true, false>(a, p, s);
      return (int)launch_dq_sm90<128, 64, 3, SCALE_SCORES, false, false>(a, p, s);
    }
  } else {
    if (d == 64)
      return (int)(rel ? launch_dkv_sm90<64, 64, 3, SCALE_SCORES, true>(a, p, s)
                       : launch_dkv_sm90<64, 64, 3, SCALE_SCORES, false>(a, p, s));
    if (d == 128)
      return (int)(rel ? launch_dkv_sm90<128, 32, 3, SCALE_SCORES, true>(a, p, s)
                       : launch_dkv_sm90<128, 32, 3, SCALE_SCORES, false>(a, p, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header,
// for one of the two kernels (`which`: 0 dq + drel, 1 dk/dv). The arguments
// are attention_bwd.cuh's without its leading `which`.
#define WM_DEFINE_ATTENTION_BWD_SM90(name, scale_scores, which)                              \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v,               \
                      const void* dout, const void* lse, const void* delta,                 \
                      const void* relh, const void* relw, void* dq, void* dk, void* dv,     \
                      void* drelh, void* drelw, int batch, int heads, int nq, int nk,       \
                      int d, long long q_bs, long long q_rs, long long k_bs,                \
                      long long k_rs, long long v_bs, long long v_rs, long long do_bs,      \
                      long long do_rs, long long dq_bs, long long dq_rs, long long dk_bs,   \
                      long long dk_rs, long long dv_bs, long long dv_rs, int gh, int gw,    \
                      float scale, void* stream) {                                           \
    return wm::attention_bwd_sm90_entry<scale_scores, which>(                                \
        dtype, q, k, v, dout, lse, delta, relh, relw, dq, dk, dv, drelh, drelw, batch,      \
        heads, nq, nk, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, dq_bs, dq_rs,   \
        dk_bs, dk_rs, dv_bs, dv_rs, gh, gw, scale, stream);                                  \
  }
