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
// kernel and 8*N^2*d in the dk/dv kernel against O(N*d) bytes (K2 at B 4,
// H 12, N 4096, d 64: 0.313 + 0.417 ms at 989 TFLOP/s). What held the first
// Hopper body at 4-8x that bound was everything beside the products: a plain
// delta pass before the kernels, the rel-table gradients summed lane by lane
// into shared memory in warp-barrier steps, the bias read from tables for
// every score, a barrier of both warpgroups every tile in the dk/dv kernel,
// a rounded copy of every streamed q tile at d = 128, and two waits a tile
// with nothing overlapping the exponentials. The two-kernel split and what
// it guarantees stay: one owner for every element of dq, dk, dv, delta and
// the table gradients, sums in a fixed order, no atomics, bit-identical from
// run to run. The design:
//  * a block owns 128 rows: two consumer warpgroups of 64 and a producer
//    warp, registers moved to the consumers by setmaxnreg; the streamed
//    tiles go through a ring of STAGES stages filled by TMA and handed over
//    by full / empty mbarriers (see attention_fwd_sm90.cuh on TMA);
//  * delta inside: the dq kernel sums delta = rowsum(do*o) of its rows in
//    f32 from do and the forward's out before its walk and writes it for the
//    dk/dv kernel, which runs after it on the same stream; no pass runs
//    before the kernels;
//  * the rel tables on the tensor cores, by the one-hot expansion E of
//    (key / gw, key % gw) over kRelCols columns (rel_h in [0, gh), rel_w in
//    [gh, gh + gw)) and T, the rows' (rel_h | rel_w): the bias is one more
//    product in the scores' group (dq kernel: S = Q.K^T + T.E^T, T of the
//    block's rows staged once, E of the tile's keys written into the ring
//    stage by the producer warp, which clears only the last tile's ones;
//    dk/dv kernel: S^T = K.Q^T + E.T^T, E of the block's keys built once, T
//    of the tile's rows by TMA from the copy the dq kernel wrote), and
//    (drel_h | drel_w) += dS.E is one more product from the dS registers
//    that feed dQ += dS.K, into a whole-walk f32 accumulator. One code path
//    for every grid; keys past nk have zero rows of E; the 16-column steps
//    of E that a tile's keys do not meet are skipped (a block-wide mask in
//    the dk/dv kernel, where a warpgroup's own would make the products'
//    path divergent and the compiler serialize them);
//  * the products overlap the exponentials: each tile issues dQ (and the
//    table product) and then the next tile's S and dP before it waits, so a
//    warpgroup waits once a tile, and the two warpgroups issue in turns
//    (named barriers), so one's exponentials run under the other's
//    products. No accumulator is set by other instructions while products
//    are in flight (the first tile's product overwrites): the compiler
//    would serialize every wgmma of the kernel. p = 2^(s*log2e -
//    lse*log2e) is one FFMA and one MUFU;
//  * dq kernel: q and do of the block's rows arrive once by TMA and are the
//    A operands from shared memory, K and V stream, dQ += dS.K reads the K
//    tile MN-major with dS rounded to bf16 in registers. Keys are masked
//    only in a tile that holds keys past nk (rows past nq are never stored);
//  * dk/dv kernel: the block's K and V are resident as A operands, q and do
//    tiles stream; S^T and dP^T put keys on the warpgroup's 64 rows, so P^T
//    and dS^T are the A operands of dV += P^T.dO and dK += dS^T.Q from
//    registers. lse and delta come with the tile (the producer warp stores
//    them beside it). Nothing is masked: a query past nq has zero rows, a
//    key past nk only its own unstored row. d = 128 streams 48-query tiles;
//  * the scale: the packed family's round(q*scale) is q in shared memory
//    rounded once by the dq kernel, which also writes it for the dk/dv
//    kernel where the scale is no power of two; a power-of-two scale is
//    exact on K in the dk/dv kernel; the grouped family's scale where it is
//    no power of two goes on the f32 scores, and the bias then follows as a
//    product of its own.
#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_sm90_common.cuh"

namespace wm {
namespace {

// Columns of the one-hot rel products: rel_h in [0, gh), rel_w in
// [gh, gh + gw), zeros up to kRelCols (two swizzled regions).
constexpr int kRelCols = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdSm90Args {
  const void* dout;    // dq kernel: the block's rows for delta, read by stride
  const void* out;
  const float* lse;    // (B, nq, H)
  float* delta;        // (B, nq, H): written by the dq kernel, read by dk/dv
  void* qs;            // round(q*scale), (B, nq, H*D) contiguous, or null
  void* tab;           // (rel_h | rel_w | 0) of each row, (B, nq, H, kRelCols), or null
  const void* relh;    // (B, nq, H, gh) or null
  const void* relw;
  void* dq;
  void* dk;
  void* dv;
  void* drelh;         // (B, nq, H, gh) or null: not wanted
  void* drelw;
  long long do_bs, do_rs, o_bs, o_rs, dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int heads, nq, nk, gh, gw;
  unsigned gw_magic;
  float scale;
  int pow2;      // the scale is a power of two
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (row, col) in a tile of 64-column swizzled regions
// of `region` bytes each (see sm90.cuh).
__device__ __forceinline__ int swz(int row, int col, int region) {
  return (col >> 6) * region + row * sm90::kRegionRowBytes +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// 16 bytes of a one-hot row: columns c8*8 .. c8*8 + 7 of the row of key
// `key` (ones at key / gw and gh + key % gw; a key past nk is a zero row).
__device__ __forceinline__ uint4 one_hot_chunk(int key, int c8, int nk, int gh, int gw,
                                               unsigned gw_magic) {
  uint32_t w0 = 0u, w1 = 0u, w2 = 0u, w3 = 0u;
  if (key < nk) {
    const int kh = div_gw(key, gw, gw_magic);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = (i ? gh + key - kh * gw : kh) - c8 * 8;
      const uint32_t one = (c >= 0 && c < 8) ? 0x3F80u << ((c & 1) * 16) : 0u;
      w0 |= (c >> 1) == 0 ? one : 0u;
      w1 |= (c >> 1) == 1 ? one : 0u;
      w2 |= (c >> 1) == 2 ? one : 0u;
      w3 |= (c >> 1) == 3 ? one : 0u;
    }
  }
  return make_uint4(w0, w1, w2, w3);
}

// Sets (v = 0x3F80, bf16 1.0) or clears (v = 0) the two ones of key `key`
// in row `row` of a one-hot tile of swizzled regions of `region` bytes.
__device__ __forceinline__ void put_ones(unsigned char* e, int row, int key, int gh, int gw,
                                         unsigned gw_magic, int region, unsigned short v) {
  const int kh = div_gw(key, gw, gw_magic);
  *reinterpret_cast<unsigned short*>(e + swz(row, kh, region)) = v;
  *reinterpret_cast<unsigned short*>(e + swz(row, gh + key - kh * gw, region)) = v;
}

// 16 bytes of a query row's tables side by side: columns c8*8 .. c8*8 + 7
// of (rel_h | rel_w | 0) of `row` (zeros past nq).
__device__ __forceinline__ uint4 table_chunk(const BwdSm90Args& a, int b, int h, int row,
                                             int c8) {
  using bf16 = __nv_bfloat16;
  const int c = c8 * 8;
  if (row >= a.nq || c >= a.gh + a.gw) return make_uint4(0u, 0u, 0u, 0u);
  const long long r = ((long long)b * a.nq + row) * a.heads + h;
  const bf16* rh = static_cast<const bf16*>(a.relh) + r * a.gh;
  const bf16* rw = static_cast<const bf16*>(a.relw) + r * a.gw;
  if (a.gh % 8 == 0 && a.gw % 8 == 0)  // a chunk lies in one table
    return c < a.gh ? *reinterpret_cast<const uint4*>(rh + c)
                    : *reinterpret_cast<const uint4*>(rw + c - a.gh);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ci = c + i;
    const bf16* src = ci < a.gh ? rh + ci : ci < a.gh + a.gw ? rw + ci - a.gh : nullptr;
    if (src != nullptr)
      w[i >> 1] |= (uint32_t)(*reinterpret_cast<const unsigned short*>(src)) << ((i & 1) * 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 bf16 x to bf16(x * scale).
__device__ __forceinline__ uint4 scale_chunk(uint4 v, float scale) {
  v.x = pack_bf16x2(bf16_lo(v.x) * scale, bf16_hi(v.x) * scale);
  v.y = pack_bf16x2(bf16_lo(v.y) * scale, bf16_hi(v.y) * scale);
  v.z = pack_bf16x2(bf16_lo(v.z) * scale, bf16_hi(v.z) * scale);
  v.w = pack_bf16x2(bf16_lo(v.w) * scale, bf16_hi(v.w) * scale);
  return v;
}

// D (+)= A . B^T over `ksteps` 16-column steps, A and B both K-major in
// swizzled regions (a_region / b_region bytes apart every 64 columns); with
// `mask`, only the steps whose bit is set (the caller accumulates).
template <int N, int M>
__device__ __forceinline__ void wgmma_ss_k(float (&d)[M][4], uint32_t a, int a_region,
                                           uint32_t b, int b_region, int ksteps, bool acc,
                                           unsigned mask = ~0u) {
  using namespace sm90;
#pragma unroll
  for (int k = 0; k < ksteps; ++k) {
    if (!((mask >> k) & 1u)) continue;
    wgmma_ss<0, N>(d, desc_kmajor(a + (k / 4) * a_region + (k % 4) * 32),
                   desc_kmajor(b + (k / 4) * b_region + (k % 4) * 32), acc || k > 0);
  }
}

// The 16-column steps of the one-hot product: those of the rel_w columns
// [gh, gh + gw), whatever keys a tile holds ...
__device__ __forceinline__ unsigned rel_w_steps(int gh, int gw) {
  unsigned m = 0u;
  for (int g = gh >> 4; g <= (gh + gw - 1) >> 4; ++g) m |= 1u << g;
  return m;
}
// ... and those of the rel_h columns of keys [k0, k1] (k1 < nk): at most two
// steps where they span at most 17 grid rows, else all.
__device__ __forceinline__ unsigned rel_h_steps(int k0, int k1, int gw, unsigned gw_magic) {
  if (k1 - k0 >= 15 * gw) return ~0u;
  return (1u << (div_gw(k0, gw, gw_magic) >> 4)) | (1u << (div_gw(k1, gw, gw_magic) >> 4));
}

// D (+)= A . B over TK / 16 steps, A (TK columns) in registers, B
// MN-major: TK rows of a tile of 64-column regions `region` bytes apart.
template <int N, int TK>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 8][4], const uint32_t (&a)[TK / 16][4],
                                           uint32_t b, int region, bool acc) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_rs<1, N>(d, a[kk], desc_mnmajor(b + kk * 16 * kRegionRowBytes, region), acc || kk > 0);
}

// The two consumer warpgroups issue their products in turns: warpgroup w
// waits at barrier 4 + w, which completes when the other one has arrived
// there after issuing its own, so one's exponentials run under the other's
// products. Each warpgroup passes my_turn / your_turn once per issue point,
// warpgroup 1 arrives once first and warpgroup 0 waits once last.
__device__ __forceinline__ void my_turn(int wg) {
  sm90::named_barrier(4 + wg, kConsumerThreads);
}
__device__ __forceinline__ void your_turn(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + (wg ^ 1)), "r"(kConsumerThreads) : "memory");
}

// ---- dq (+ delta, + drel) kernel ------------------------------------------------

// Shared-memory plan of the dq kernel, in bytes from the 1024-aligned base:
// Q and dO of the block (NR regions of 128 rows each) and, with rel tables,
// T (the block's rows of (rel_h | rel_w), two regions); the ring (K, V and,
// with tables, the one-hot E of the tile's keys); the barriers.
template <int D, int TK, int STAGES, bool HAS_REL>
struct DqPlan {
  static constexpr int NR = D / 64;
  static constexpr int QREGION = kSm90Rows * sm90::kRegionRowBytes;
  static constexpr int REGION = TK * sm90::kRegionRowBytes;
  static constexpr int TILE = NR * REGION;  // K or V of one stage
  static constexpr int ETILE = HAS_REL ? (kRelCols / 64) * REGION : 0;
  static constexpr int STAGE = 2 * TILE + ETILE;
  static constexpr int T = 2 * NR * QREGION;
  static constexpr int RING = T + (HAS_REL ? (kRelCols / 64) * QREGION : 0);
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr int TOTAL = BARS + 16 * STAGES + 16;
};

// S = Q K^T (+ T E^T) and dP = dO V^T of one ring stage for a warpgroup's
// 64 rows, A from shared memory, as one wgmma group.
template <int D, int TK, int NS, bool HAS_REL>
__device__ __forceinline__ void issue_s_dp(float (&s)[NS][4], float (&dp)[NS][4], uint32_t qa,
                                           uint32_t da, uint32_t ta, uint32_t ks,
                                           unsigned bias) {
  using P = DqPlan<D, TK, 2, HAS_REL>;
  sm90::wgmma_fence();
  wgmma_ss_k<TK>(s, qa, P::QREGION, ks, P::REGION, D / 16, false);
  if (HAS_REL && bias)
    wgmma_ss_k<TK>(s, ta, P::QREGION, ks + 2 * P::TILE, P::REGION, kRelCols / 16, true, bias);
  wgmma_ss_k<TK>(dp, da, P::QREGION, ks + P::TILE, P::REGION, D / 16, false);
  sm90::wgmma_commit();
}

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL, bool DREL>
__global__ void __launch_bounds__(kSm90Threads, 1)
    attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_do,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, BwdSm90Args a) {
  using namespace sm90;
  using bf16 = __nv_bfloat16;
  using P = DqPlan<D, TK, STAGES, HAS_REL>;
  static_assert(!DREL || HAS_REL, "table gradients need tables");
  constexpr int NS = TK / 8;
  constexpr int ND = D / 8;
  constexpr int NR = D / 64;
  constexpr int NE = kRelCols / 8;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t qd_full = base + P::BARS;
  const uint32_t full0 = qd_full + 16;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int q0 = blockIdx.x * kSm90Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int nkt = (a.nk + TK - 1) / TK;

  if constexpr (HAS_REL) {  // the E tiles start as zeros; the producer sets the ones
    for (int i = t; i < STAGES * (P::ETILE / 16); i += kSm90Threads) {
      const int st = i / (P::ETILE / 16), j = i % (P::ETILE / 16);
      reinterpret_cast<uint4*>(gen + P::RING + st * P::STAGE + 2 * P::TILE)[j] =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
  }
  if (t == 0) {
    mbar_init(qd_full, 1);
    // a stage is full after the TMA bytes and, with E, the producer's writes
    init_ring_barriers<STAGES>(full0, empty0, HAS_REL ? 2 : 1);
  }
  __syncthreads();

  if (t >= kConsumerThreads) {
    reg_dealloc<kProducerRegs>();
    if (t < kConsumerThreads + 32) {
      const int lane = t - kConsumerThreads;
      if (lane == 0) {
        mbar_expect_tx(qd_full, P::T);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          tma_load_3d(base + r * P::QREGION, &map_q, h * D + r * 64, q0, b, qd_full);
          tma_load_3d(base + (NR + r) * P::QREGION, &map_do, h * D + r * 64, q0, b, qd_full);
        }
      }
      int stage = 0;
      uint32_t phase = 1;  // the ring starts empty: the first waits pass
      for (int kt = 0; kt < nkt; ++kt) {
        mbar_wait(empty0 + 8 * stage, phase);
        const uint32_t full = full0 + 8 * stage;
        const uint32_t dst = base + P::RING + stage * P::STAGE;
        if (lane == 0) {
          mbar_expect_tx(full, 2 * P::TILE);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            tma_load_3d(dst + r * P::REGION, &map_k, h * D + r * 64, kt * TK, b, full);
            tma_load_3d(dst + P::TILE + r * P::REGION, &map_v, h * D + r * 64, kt * TK, b, full);
          }
        }
        if (HAS_REL) {  // E of the tile's keys: the last tile's ones out, its in
          unsigned char* e = gen + P::RING + stage * P::STAGE + 2 * P::TILE;
          for (int r = lane; r < TK; r += 32) {
            const int old = (kt - STAGES) * TK + r, key = kt * TK + r;
            if (kt >= STAGES && old < a.nk)
              put_ones(e, r, old, a.gh, a.gw, a.gw_magic, P::REGION, 0);
            if (key < a.nk) put_ones(e, r, key, a.gh, a.gw, a.gw_magic, P::REGION, 0x3F80);
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(full);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int lane = t & 31, warp = t >> 5, wg = t >> 7, tw = t & 127;
    const int g = lane >> 2, t4 = lane & 3;
    const int rA = warp * 16 + g, rB = rA + 8;
    const bool okA = q0 + rA < a.nq, okB = q0 + rB < a.nq;
    const long long statA = ((long long)b * a.nq + q0 + rA) * a.heads + h;
    const long long statB = ((long long)b * a.nq + q0 + rB) * a.heads + h;

    // delta = rowsum(do * o) in f32: a quad holds a row, 8 columns a load
    float del[2] = {0.f, 0.f};
    {
      const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * D;
      const bf16* og = static_cast<const bf16*>(a.out) + b * a.o_bs + h * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + (half ? rB : rA);
        if (!(half ? okB : okA)) continue;
#pragma unroll
        for (int c = t4 * 8; c < D; c += 32) {
          const uint4 x = *reinterpret_cast<const uint4*>(dog + row * a.do_rs + c);
          const uint4 y = *reinterpret_cast<const uint4*>(og + row * a.o_rs + c);
          float sum = del[half];
          sum = fmaf(bf16_lo(x.x), bf16_lo(y.x), sum);
          sum = fmaf(bf16_hi(x.x), bf16_hi(y.x), sum);
          sum = fmaf(bf16_lo(x.y), bf16_lo(y.y), sum);
          sum = fmaf(bf16_hi(x.y), bf16_hi(y.y), sum);
          sum = fmaf(bf16_lo(x.z), bf16_lo(y.z), sum);
          sum = fmaf(bf16_hi(x.z), bf16_hi(y.z), sum);
          sum = fmaf(bf16_lo(x.w), bf16_lo(y.w), sum);
          sum = fmaf(bf16_hi(x.w), bf16_hi(y.w), sum);
          del[half] = sum;
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        del[0] += __shfl_xor_sync(0xffffffffu, del[0], off);
        del[1] += __shfl_xor_sync(0xffffffffu, del[1], off);
      }
      if (t4 == 0) {
        if (okA) a.delta[statA] = del[0];
        if (okB) a.delta[statB] = del[1];
      }
    }
    const float delA = del[0], delB = del[1];
    const float lseA = okA ? a.lse[statA] * kLog2e : 0.f;
    const float lseB = okB ? a.lse[statB] * kLog2e : 0.f;

    // T: this warpgroup's 64 rows of (rel_h | rel_w), swizzled as an A
    // operand, and the same rows out for the dk/dv kernel
    if (HAS_REL) {
      bf16* tabg = static_cast<bf16*>(a.tab);
      for (int i = tw; i < 64 * NE; i += 128) {
        const int row = wg * 64 + i / NE, c8 = i % NE;
        const uint4 v = table_chunk(a, b, h, q0 + row, c8);
        *reinterpret_cast<uint4*>(gen + P::T + swz(row, c8 * 8, P::QREGION)) = v;
        if (q0 + row < a.nq)
          *reinterpret_cast<uint4*>(
              tabg + (((long long)b * a.nq + q0 + row) * a.heads + h) * kRelCols + c8 * 8) = v;
      }
    }
    // The scale: on q in shared memory (round(q*scale), the packed family's
    // rounding point, and exact for a power of two), or on the f32 scores
    // where the grouped family's scale is no power of two.
    const bool scale_s = SCALE_SCORES && !a.pow2;
    mbar_wait(qd_full, 0);
    if (!scale_s) {
      bf16* qsg = static_cast<bf16*>(a.qs);
      for (int i = tw; i < NR * 512; i += 128) {
        const int r = i >> 9, off = wg * 64 * kRegionRowBytes + (i & 511) * 16;
        uint4* p = reinterpret_cast<uint4*>(gen + r * P::QREGION + off);
        const uint4 v = scale_chunk(*p, a.scale);
        *p = v;
        if (qsg != nullptr) {  // for the dk/dv kernel, unswizzled
          const int row = off / kRegionRowBytes;
          const int col = r * 64 + ((((off % kRegionRowBytes) >> 4) ^ (row & 7)) << 3);
          if (q0 + row < a.nq)
            *reinterpret_cast<uint4*>(
                qsg + ((long long)b * a.nq + q0 + row) * a.heads * D + h * D + col) = v;
        }
      }
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    const uint32_t qa = base + wg * 64 * kRegionRowBytes;
    const uint32_t da = qa + NR * P::QREGION;
    const uint32_t ta = base + P::T + wg * 64 * kRegionRowBytes;
    // dQ and the table gradients start with the first tile's product (an
    // accumulator set by other instructions while products are in flight
    // would make the compiler serialize every wgmma)
    float dq[ND][4];
    float dr[DREL ? NE : 1][4];

    // the steps of the bias product that keys [k0, k0 + TK) meet
    const unsigned w_steps = HAS_REL ? rel_w_steps(a.gh, a.gw) : 0u;
    auto steps = [&](int k0) {
      return w_steps | rel_h_steps(k0, min(k0 + TK, a.nk) - 1, a.gw, a.gw_magic);
    };
    float s[NS][4], dp[NS][4];
    uint32_t pa[TK / 16][4];
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(full0, 0);
    if (wg == 1) your_turn(wg);  // warpgroup 0 issues first
    my_turn(wg);
    issue_s_dp<D, TK, NS, HAS_REL>(s, dp, qa, da, ta, base + P::RING,
                                   HAS_REL && !scale_s ? steps(0) : 0u);
    your_turn(wg);
    for (int kt = 0; kt < nkt; ++kt) {
      const int k0 = kt * TK;
      const uint32_t ks = base + P::RING + stage * P::STAGE;
      const unsigned next_steps = HAS_REL && !scale_s ? steps(k0 + TK) : 0u;
      // S and dP of this tile, and the previous tile's dQ and table products
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * (stage == 0 ? STAGES - 1 : stage - 1));

      if (scale_s) {  // the scale on the f32 scores, then the bias T E^T
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] *= a.scale;
        }
        if (HAS_REL) {
          wgmma_fence();
          wgmma_ss_k<TK>(s, ta, P::QREGION, ks + 2 * P::TILE, P::REGION, kRelCols / 16, true,
                         steps(k0));
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(s);
        }
      }
      // ds = p (dp - delta), rounded to bf16 as the A operand of the
      // products; keys past nk give 0 (rows past nq are never stored)
      const bool tail = k0 + TK > a.nk;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        float ds[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float pA = exp2_approx(fmaf(s[n][j], kLog2e, -lseA));
          float pB = exp2_approx(fmaf(s[n][j + 2], kLog2e, -lseB));
          if (tail && k0 + n * 8 + 2 * t4 + j >= a.nk) pA = pB = 0.f;
          ds[j] = pA * (dp[n][j] - delA);
          ds[j + 2] = pB * (dp[n][j + 2] - delB);
        }
        pa[n / 2][(n & 1) * 2] = pack_bf16x2(ds[0], ds[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
      }

      // dQ += dS K (K MN-major) and (drel_h | drel_w) += dS E, then the next
      // tile's S and dP, all before the next wait
      const bool more = kt + 1 < nkt;
      const int next = stage + 1 == STAGES ? 0 : stage + 1;
      if (more) mbar_wait(full0 + 8 * next, next == 0 ? phase ^ 1 : phase);
      my_turn(wg);
      wgmma_fence();
      wgmma_rs_k<D, TK>(dq, pa, ks, P::REGION, kt > 0);
      if constexpr (DREL) wgmma_rs_k<kRelCols, TK>(dr, pa, ks + 2 * P::TILE, P::REGION, kt > 0);
      wgmma_commit();
      stage = next;
      if (next == 0) phase ^= 1;
      if (more)
        issue_s_dp<D, TK, NS, HAS_REL>(s, dp, qa, da, ta, base + P::RING + stage * P::STAGE,
                                       next_steps);
      your_turn(wg);
    }
    if (wg == 0) my_turn(wg);  // the last arrival of warpgroup 1
    wgmma_wait<0>();
    fence_acc(dq);
    if (DREL) fence_acc(dr);

    bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dq_bs + h * D;
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
    if (DREL) {  // columns [0, gh) are drel_h, [gh, gh + gw) drel_w
      bf16* oh = static_cast<bf16*>(a.drelh);
      bf16* ow = static_cast<bf16*>(a.drelw);
#pragma unroll
      for (int n = 0; n < (DREL ? NE : 1); ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = n * 8 + 2 * t4 + j;
          if (c < a.gh) {
            if (okA) oh[statA * a.gh + c] = __float2bfloat16_rn(dr[n][j]);
            if (okB) oh[statB * a.gh + c] = __float2bfloat16_rn(dr[n][j + 2]);
          } else if (c < a.gh + a.gw) {
            if (okA) ow[statA * a.gw + c - a.gh] = __float2bfloat16_rn(dr[n][j]);
            if (okB) ow[statB * a.gw + c - a.gh] = __float2bfloat16_rn(dr[n][j + 2]);
          }
        }
      }
    }
  }
}

// ---- dk/dv kernel ---------------------------------------------------------------

// Shared-memory plan of the dk/dv kernel, in bytes from the 1024-aligned
// base: resident K and V and, with rel tables, the one-hot E of the block's
// keys; the ring (q, do, round(q*scale) where it is needed, T of the tile's
// rows); lse and delta of each stage; the barriers.
template <int D, int TQ, int STAGES, bool HAS_REL>
struct DkvPlan {
  static constexpr int KREGION = kSm90Rows * sm90::kRegionRowBytes;
  static constexpr int QREGION = TQ * sm90::kRegionRowBytes;
  static constexpr int E = 2 * (D / 64) * KREGION;
  static constexpr int RING = E + (HAS_REL ? (kRelCols / 64) * KREGION : 0);
  static constexpr int TILE = (D / 64) * QREGION;  // q, do or round(q*scale)
  int tt, stage, stats, bars, total;
  __host__ __device__ explicit DkvPlan(bool prescale) {
    tt = (prescale ? 3 : 2) * TILE;
    stage = tt + (HAS_REL ? (kRelCols / 64) * QREGION : 0);
    stats = RING + STAGES * stage;
    bars = stats + STAGES * 2 * TQ * 4;
    total = bars + 8 * (2 * STAGES + 1);
  }
};

// S^T = K Q^T (+ E T^T) and dP^T = V dO^T of one ring stage: 64 keys x TQ
// queries a warpgroup, as one wgmma group.
template <int D, int TQ, int NS, bool HAS_REL>
__device__ __forceinline__ void issue_st_dpt(float (&s)[NS][4], float (&dp)[NS][4],
                                             uint32_t k_res, uint32_t v_res, uint32_t e_res,
                                             uint32_t q_tile, uint32_t do_tile, uint32_t t_tile,
                                             unsigned bias) {
  constexpr int KREGION = kSm90Rows * sm90::kRegionRowBytes;
  constexpr int QREGION = TQ * sm90::kRegionRowBytes;
  sm90::wgmma_fence();
  wgmma_ss_k<TQ>(s, k_res, KREGION, q_tile, QREGION, D / 16, false);
  if (HAS_REL && bias)
    wgmma_ss_k<TQ>(s, e_res, KREGION, t_tile, QREGION, kRelCols / 16, true, bias);
  wgmma_ss_k<TQ>(dp, v_res, KREGION, do_tile, QREGION, D / 16, false);
  sm90::wgmma_commit();
}

template <int D, int TQ, int STAGES, bool SCALE_SCORES, bool HAS_REL>
__global__ void __launch_bounds__(kSm90Threads, 1)
    attn_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_qs,
                             const __grid_constant__ CUtensorMap map_tab, BwdSm90Args a) {
  using namespace sm90;
  using bf16 = __nv_bfloat16;
  using P = DkvPlan<D, TQ, STAGES, HAS_REL>;
  constexpr int NS = TQ / 8;     // 8-query groups of a tile
  constexpr int ND = D / 8;
  constexpr int NR = D / 64;
  constexpr int NE = kRelCols / 8;
  // Where the scale goes: on round(q*scale), which the dq kernel wrote, in
  // the packed family where it is no power of two; on the f32 scores in the
  // grouped family where it is none; else on K in shared memory (exact).
  const bool prescale = !SCALE_SCORES && !a.pow2;
  const bool scale_s = SCALE_SCORES && !a.pow2;
  const P plan(prescale);
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
        mbar_expect_tx(kv_full, P::E);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          tma_load_3d(base + r * P::KREGION, &map_k, h * D + r * 64, k0, b, kv_full);
          tma_load_3d(base + (NR + r) * P::KREGION, &map_v, h * D + r * 64, k0, b, kv_full);
        }
      }
      int stage = 0;
      uint32_t phase = 1;
      for (int qt = 0; qt < nqt; ++qt) {
        const int q0 = qt * TQ;
        constexpr int NST = (TQ + 31) / 32;
        float st_l[NST], st_d[NST];
#pragma unroll
        for (int i = 0; i < NST; ++i) {
          const int row = q0 + lane + 32 * i;
          const long long stat = ((long long)b * a.nq + row) * a.heads + h;
          st_l[i] = row < a.nq ? a.lse[stat] * kLog2e : 0.f;
          st_d[i] = row < a.nq ? a.delta[stat] : 0.f;
        }
        mbar_wait(empty0 + 8 * stage, phase);
        const uint32_t full = full0 + 8 * stage;
        if (lane == 0) {
          mbar_expect_tx(full, plan.stage);
          const uint32_t dst = base + P::RING + stage * plan.stage;
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            tma_load_3d(dst + r * P::QREGION, &map_q, h * D + r * 64, q0, b, full);
            tma_load_3d(dst + P::TILE + r * P::QREGION, &map_do, h * D + r * 64, q0, b, full);
            if (prescale)
              tma_load_3d(dst + 2 * P::TILE + r * P::QREGION, &map_qs, h * D + r * 64, q0, b,
                          full);
          }
          if (HAS_REL) {
#pragma unroll
            for (int r = 0; r < kRelCols / 64; ++r)
              tma_load_3d(dst + plan.tt + r * P::QREGION, &map_tab, h * kRelCols + r * 64, q0,
                          b, full);
          }
        }
        float* stats = reinterpret_cast<float*>(gen + plan.stats) + stage * 2 * TQ;
#pragma unroll
        for (int i = 0; i < NST; ++i) {
          if (lane + 32 * i < TQ) {
            stats[lane + 32 * i] = st_l[i];
            stats[TQ + lane + 32 * i] = st_d[i];
          }
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
    const int lane = t & 31, warp = t >> 5, wg = t >> 7, tw = t & 127;
    const int g = lane >> 2, t4 = lane & 3;
    const int rA = warp * 16 + g, rB = rA + 8;  // keys, block-relative
    const bool okA = k0 + rA < a.nk, okB = k0 + rB < a.nk;
    const uint32_t k_res = base + wg * 64 * kRegionRowBytes;   // this warpgroup's 64 keys
    const uint32_t v_res = k_res + NR * P::KREGION;
    const uint32_t e_res = base + P::E + wg * 64 * kRegionRowBytes;

    // this warpgroup's rows of E, and K * scale in place where that is exact
    if (HAS_REL) {
      for (int i = tw; i < 64 * NE; i += 128) {
        const int row = wg * 64 + i / NE, c8 = i % NE;
        *reinterpret_cast<uint4*>(gen + P::E + swz(row, c8 * 8, P::KREGION)) =
            one_hot_chunk(k0 + row, c8, a.nk, a.gh, a.gw, a.gw_magic);
      }
    }
    mbar_wait(kv_full, 0);
    if (!prescale && !scale_s) {
      for (int i = tw; i < NR * 512; i += 128) {
        uint4* p = reinterpret_cast<uint4*>(gen + (i >> 9) * P::KREGION +
                                            wg * 64 * kRegionRowBytes + (i & 511) * 16);
        *p = scale_chunk(*p, a.scale);
      }
    }
    fence_proxy_async();
    named_barrier(2 + wg, 128);

    float dk[ND][4], dv[ND][4];  // set by the first tile's products
    float s[NS][4], dp[NS][4];
    const int qso = prescale ? 2 * P::TILE : 0;  // the tile S^T reads
    // the steps of the bias product the block's keys meet (one mask for the
    // block: a warpgroup's own would make the products' path divergent)
    const unsigned steps =
        HAS_REL ? rel_w_steps(a.gh, a.gw) |
                      rel_h_steps(k0, min(k0 + kSm90Rows, a.nk) - 1, a.gw, a.gw_magic)
                : 0u;
    const unsigned bias = scale_s ? 0u : steps;
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(full0, 0);
    {
      const uint32_t q_tile = base + P::RING;
      if (wg == 1) your_turn(wg);  // warpgroup 0 issues first
      my_turn(wg);
      issue_st_dpt<D, TQ, NS, HAS_REL>(s, dp, k_res, v_res, e_res, q_tile + qso,
                                       q_tile + P::TILE, q_tile + plan.tt, bias);
      your_turn(wg);
    }
    for (int qt = 0; qt < nqt; ++qt) {
      const uint32_t q_tile = base + P::RING + stage * plan.stage;
      const float* stats = reinterpret_cast<const float*>(gen + plan.stats) + stage * 2 * TQ;
      wgmma_wait<0>();
      fence_acc(s);
      fence_acc(dp);
      fence_acc(dk);
      fence_acc(dv);
      if (qt > 0 && lane == 0) mbar_arrive(empty0 + 8 * (stage == 0 ? STAGES - 1 : stage - 1));

      if (scale_s) {  // the scale on the f32 scores, then the bias E T^T
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] *= a.scale;
        }
        if (HAS_REL) {
          wgmma_fence();
          wgmma_ss_k<TQ>(s, e_res, P::KREGION, q_tile + plan.tt, P::QREGION, kRelCols / 16,
                         true, steps);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(s);
        }
      }
      // p^T and ds^T, rounded to bf16 as the A operands of the products
      uint32_t sa[TQ / 16][4], pa[TQ / 16][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int qc = n * 8 + 2 * t4;
        const float2 l2 = *reinterpret_cast<const float2*>(stats + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(stats + TQ + qc);
        float pv[4], dsv[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float l = j ? l2.y : l2.x, del = j ? d2.y : d2.x;
          pv[j] = exp2_approx(fmaf(s[n][j], kLog2e, -l));
          pv[j + 2] = exp2_approx(fmaf(s[n][j + 2], kLog2e, -l));
          dsv[j] = pv[j] * (dp[n][j] - del);
          dsv[j + 2] = pv[j + 2] * (dp[n][j + 2] - del);
        }
        sa[n / 2][(n & 1) * 2] = pack_bf16x2(dsv[0], dsv[1]);
        sa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(dsv[2], dsv[3]);
        pa[n / 2][(n & 1) * 2] = pack_bf16x2(pv[0], pv[1]);
        pa[n / 2][(n & 1) * 2 + 1] = pack_bf16x2(pv[2], pv[3]);
      }

      // dK += dS^T Q and dV += P^T dO, the streamed tiles MN-major; then the
      // next tile's S^T and dP^T, before this group is waited for
      const bool more = qt + 1 < nqt;
      const int next = stage + 1 == STAGES ? 0 : stage + 1;
      if (more) mbar_wait(full0 + 8 * next, next == 0 ? phase ^ 1 : phase);
      my_turn(wg);
      wgmma_fence();
      wgmma_rs_k<D, TQ>(dk, sa, q_tile, P::QREGION, qt > 0);
      wgmma_rs_k<D, TQ>(dv, pa, q_tile + P::TILE, P::QREGION, qt > 0);
      wgmma_commit();
      stage = next;
      if (next == 0) phase ^= 1;
      if (more) {
        const uint32_t nt = base + P::RING + stage * plan.stage;
        issue_st_dpt<D, TQ, NS, HAS_REL>(s, dp, k_res, v_res, e_res, nt + qso, nt + P::TILE,
                                         nt + plan.tt, bias);
      }
      your_turn(wg);
    }
    if (wg == 0) my_turn(wg);  // the last arrival of warpgroup 1
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);

    // dK = scale * dS^T q: K was scaled, q was not
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

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL, bool DREL>
cudaError_t launch_dq_sm90(const BwdSm90Args& a, const BwdSm90Operands& p, cudaStream_t stream) {
  const size_t smem = 1024 + (size_t)DqPlan<D, TK, STAGES, HAS_REL>::TOTAL;
  if (smem > (size_t)kMaxSmemBytes || !grid_ok(a, p.batch)) return cudaErrorInvalidValue;
  CUtensorMap map_q, map_do, map_k, map_v;
  cudaError_t err =
      sm90::make_map(&map_q, p.q, a.heads * D, a.nq, p.batch, p.q_rs, p.q_bs, kSm90Rows);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_do, p.dout, a.heads * D, a.nq, p.batch, p.do_rs, p.do_bs, kSm90Rows);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_k, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, TK);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_v, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, TK);
  if (err != cudaSuccess) return err;
  auto kernel = attn_bwd_dq_sm90_kernel<D, TK, STAGES, SCALE_SCORES, HAS_REL, DREL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + kSm90Rows - 1) / kSm90Rows, a.heads, p.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(map_q, map_do, map_k, map_v, a);
  return cudaGetLastError();
}

template <int D, int TQ, int STAGES, bool SCALE_SCORES, bool HAS_REL>
cudaError_t launch_dkv_sm90(const BwdSm90Args& a, const BwdSm90Operands& p,
                            cudaStream_t stream) {
  const bool prescale = !SCALE_SCORES && !a.pow2;
  if ((prescale && a.qs == nullptr) || (HAS_REL && a.tab == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)DkvPlan<D, TQ, STAGES, HAS_REL>(prescale).total;
  if (smem > (size_t)kMaxSmemBytes || !grid_ok(a, p.batch)) return cudaErrorInvalidValue;
  CUtensorMap map_k, map_v, map_q, map_do, map_qs, map_tab;
  cudaError_t err =
      sm90::make_map(&map_k, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, kSm90Rows);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_v, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, kSm90Rows);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_q, p.q, a.heads * D, a.nq, p.batch, p.q_rs, p.q_bs, TQ);
  if (err != cudaSuccess) return err;
  err = sm90::make_map(&map_do, p.dout, a.heads * D, a.nq, p.batch, p.do_rs, p.do_bs, TQ);
  if (err != cudaSuccess) return err;
  map_qs = map_tab = map_q;  // placeholders where nothing comes by them
  if (prescale) {
    const long long rs = (long long)a.heads * D;
    err = sm90::make_map(&map_qs, a.qs, a.heads * D, a.nq, p.batch, rs, rs * a.nq, TQ);
    if (err != cudaSuccess) return err;
  }
  if (HAS_REL) {
    const long long rs = (long long)a.heads * kRelCols;
    err = sm90::make_map(&map_tab, a.tab, a.heads * kRelCols, a.nq, p.batch, rs, rs * a.nq, TQ);
    if (err != cudaSuccess) return err;
  }
  auto kernel = attn_bwd_dkv_sm90_kernel<D, TQ, STAGES, SCALE_SCORES, HAS_REL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nk + kSm90Rows - 1) / kSm90Rows, a.heads, p.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(map_k, map_v, map_q, map_do, map_qs, map_tab, a);
  return cudaGetLastError();
}

// The body of a plain C entry. WHICH is the one kernel the including source
// instantiates (0 dq + delta + drel, 1 dk/dv), so that each kernel's
// instantiations compile in an nvcc of their own. The dq kernel writes delta
// and, with rel tables, their rows side by side into `tab` (B, nq, H,
// kRelCols) and, where the packed family's scale is no power of two,
// round(q*scale) into `qs` (B, nq, H*d); the dk/dv kernel reads them. bf16
// only, d = 64 or 128, rel grids with gh + gw <= kRelCols; anything else is
// refused.
template <bool SCALE_SCORES, int WHICH>
int attention_bwd_sm90_entry(int dtype, const void* q, const void* k, const void* v,
                             const void* dout, const void* out, const void* lse, void* delta,
                             void* qs, void* tab, const void* relh, const void* relw, void* dq,
                             void* dk, void* dv, void* drelh, void* drelw, int batch, int heads,
                             int nq, int nk, int d, long long q_bs, long long q_rs,
                             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                             long long do_bs, long long do_rs, long long o_bs, long long o_rs,
                             long long dq_bs, long long dq_rs, long long dk_bs, long long dk_rs,
                             long long dv_bs, long long dv_rs, int gh, int gw, float scale,
                             void* stream) {
  if (dtype != kBFloat16 || delta == nullptr) return (int)cudaErrorInvalidValue;
  const bool rel = relh != nullptr && relw != nullptr;
  if (rel && (gh < 1 || gw < 1 || gh + gw > kRelCols)) return (int)cudaErrorInvalidValue;
  const bool drel = rel && drelh != nullptr && drelw != nullptr;
  BwdSm90Args a;
  a.dout = dout; a.out = out;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.tab = rel ? tab : nullptr;
  a.relh = rel ? relh : nullptr; a.relw = rel ? relw : nullptr;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.drelh = drel ? drelh : nullptr; a.drelw = drel ? drelw : nullptr;
  a.do_bs = do_bs; a.do_rs = do_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.dq_bs = dq_bs; a.dq_rs = dq_rs; a.dk_bs = dk_bs; a.dk_rs = dk_rs;
  a.dv_bs = dv_bs; a.dv_rs = dv_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = rel ? gh : 0; a.gw = rel ? gw : 0;
  a.gw_magic = gw_magic_of(a.gw);
  a.scale = scale;
  int exponent;
  a.pow2 = frexpf(scale, &exponent) == 0.5f;
  a.qs = (!SCALE_SCORES && !a.pow2) ? qs : nullptr;
  BwdSm90Operands p{q, k, v, dout, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (WHICH == 0) {
    if (out == nullptr || (rel && tab == nullptr)) return (int)cudaErrorInvalidValue;
    if (d == 64) {
      if (drel) return (int)launch_dq_sm90<64, 64, 4, SCALE_SCORES, true, true>(a, p, s);
      if (rel) return (int)launch_dq_sm90<64, 64, 4, SCALE_SCORES, true, false>(a, p, s);
      return (int)launch_dq_sm90<64, 64, 4, SCALE_SCORES, false, false>(a, p, s);
    }
    if (d == 128) {
      // 32-key tiles leave registers for the table-gradient accumulator
      if (drel) return (int)launch_dq_sm90<128, 32, 4, SCALE_SCORES, true, true>(a, p, s);
      if (rel) return (int)launch_dq_sm90<128, 32, 4, SCALE_SCORES, true, false>(a, p, s);
      return (int)launch_dq_sm90<128, 64, 3, SCALE_SCORES, false, false>(a, p, s);
    }
  } else {
    if (d == 64)
      return (int)(rel ? launch_dkv_sm90<64, 64, 3, SCALE_SCORES, true>(a, p, s)
                       : launch_dkv_sm90<64, 64, 3, SCALE_SCORES, false>(a, p, s));
    // 48-query tiles measured fastest (at 32 the S^T product's shared-memory
    // reads outrun its arithmetic); two stages leave room for the tables
    if (d == 128)
      return (int)(rel ? launch_dkv_sm90<128, 48, 2, SCALE_SCORES, true>(a, p, s)
                       : launch_dkv_sm90<128, 48, 3, SCALE_SCORES, false>(a, p, s));
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header,
// for one of the two kernels (`which`: 0 dq + delta + drel, 1 dk/dv).
#define WM_DEFINE_ATTENTION_BWD_SM90(name, scale_scores, which)                               \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v,                \
                      const void* dout, const void* out, const void* lse, void* delta,       \
                      void* qs, void* tab, const void* relh, const void* relw, void* dq,     \
                      void* dk, void* dv, void* drelh, void* drelw, int batch, int heads,    \
                      int nq, int nk, int d, long long q_bs, long long q_rs, long long k_bs, \
                      long long k_rs, long long v_bs, long long v_rs, long long do_bs,       \
                      long long do_rs, long long o_bs, long long o_rs, long long dq_bs,      \
                      long long dq_rs, long long dk_bs, long long dk_rs, long long dv_bs,    \
                      long long dv_rs, int gh, int gw, float scale, void* stream) {           \
    return wm::attention_bwd_sm90_entry<scale_scores, which>(                                 \
        dtype, q, k, v, dout, out, lse, delta, qs, tab, relh, relw, dq, dk, dv, drelh, drelw, \
        batch, heads, nq, nk, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs,     \
        o_rs, dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs, gh, gw, scale, stream);               \
  }
