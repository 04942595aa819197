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
// at d = 64, 80 or 128 in bf16 with many keys (ops/_attention.py::attention_body
// says which launch comes here). The windowed shapes (K1, K6), d = 32 and
// f32 stay with attention_fwd.cuh. Head dim 80 (ViT-H's global blocks, K2
// and K5) runs here forward only: its backward stays with the tile bodies of
// attention_bwd.cuh, which read this forward's lse (the same function).
//
// What bounds it on the H100: operations, 4*N*M*d flops a head against
// O((N + M)*d) bytes (K2 at B 4, H 12, N 4096, d 64: 206 GFLOP, 0.208 ms at
// 989 TFLOP/s; K4 at B 4, H 8, N 4096, d 128: 0.278 ms). At d = 64 the
// exponentials weigh as much as the products: a score takes 4*d = 256
// tensor-core flops and one ex2 on the MUFU (16 a clock an SM), the same
// time at either unit's peak, and its max, sum, bias and bf16 rounding take
// as many issue slots again. So the body nears its bound only if the
// exponentials and the rest of the per-score work run under the products.
// The first Hopper body waited for each product before the softmax and for
// each softmax before the next product, paid two adds and a branch a score
// for the bias and multiplied every K5 score by the scale, and staged Q and
// the tables element by element before its first product. The design:
//  * a block owns 128 query rows: two consumer warpgroups of 64 rows and a
//    producer warp; setmaxnreg moves the producer's registers to the
//    consumers;
//  * the prologue is the producer's: it loads the block's Q (one box a
//    64-column region) and the rows' rel tables (a box of each, maps over
//    the (B*nq, H*g) tables) by TMA before the K and V tiles, so the
//    consumers only wait. Tables no map takes (a table wider than kTabCols,
//    rows off a 16-byte boundary: ragged grids) the consumers load, eight
//    loads in flight a thread. K and V tiles of TK keys go through a ring of
//    STAGES stages in shared memory, filled by TMA (one thread asks for a
//    box of a 3-D tensor map over column, row and batch; the strides of the
//    packed (B, N, 3C) qkv or of the grouped (BH, N, d) operands are the
//    map's, rows past the end arrive as zeros and another batch's rows are
//    never read) and handed over by mbarriers, full and empty;
//  * S = Q.K^T is wgmma m64nTKk16 with K K-major straight from the ring and
//    Q from its TMA box: at d = 64 read once into registers as the A
//    fragments, at d = 128 (128-key tiles, whose scores, P and O need the
//    registers) read by the product from shared memory. O += P.V takes P
//    rounded to bf16 from registers as A and V MN-major (the instruction's
//    transpose bit), so V is never copied transposed;
//  * the schedule: the two warpgroups issue their products in turns (named
//    barriers), so one's softmax runs under the other's products. Within a
//    warpgroup tile j's S and tile j - 1's P.V are issued together and S is
//    retired with wgmma_wait<1>, so the row maxima of tile j run under its
//    own P.V. ptxas ends the P fragments' lifetime at the product that
//    reads them and places the wait for it before the first register it
//    takes back, ahead of the exponentials; a wait moved past the next
//    stage's spin loop, where ptxas cannot place it, had the softmax write
//    the fragments of the product in flight. No accumulator is set while
//    its product is in flight (that would make ptxas serialize every
//    wgmma): the bias is written before the issue, O is rescaled and p
//    rounded into the fragments after the wait;
//  * the bias is the scores' initial value: written into the accumulators
//    before the product issues, the product accumulates onto it; keys past
//    the end start at -inf the same way, so there is no mask pass, and
//    without rel tables the product overwrites. Where a tile is two grid
//    rows (TK = 2 * gw: 128 keys on the 64-grid, 96 on the 48-grid) a
//    thread's rel_w entries are the same in every tile and are read once,
//    and a tile reads two rel_h entries a row: one FFMA a score. Other grids
//    read the tables a key group at a time, the grid row advancing by a
//    select, not a branch;
//  * the softmax is exp2 with the scale and log2(e) folded into one FFMA a
//    score: the scores leave the products unscaled where the scale is a
//    power of two (exact on q.k) or is the grouped family's f32 scale, and
//    the bias enters divided by it; the packed family's other scales keep
//    round(q*scale) (in registers at d = 64, in shared memory at d = 128).
//    l is summed per thread and reduced once; lse stays in natural units;
//  * d = 80 is 64 + 16 columns: Q, K and V of a head sit in a 128-byte
//    swizzled region of 64 columns and a narrow region of 16 (32-byte rows,
//    32-byte swizzle, a second TMA box from column h*80 + 64; sm90.cuh), so
//    no byte is brought in that is not read. Q.K^T takes 5 k-steps, the last
//    on the narrow region's B32 descriptor, P.V an n64 and an n16 product;
//    Q stays in registers (20 fragments). K and V tiles of 128 keys (two
//    grid rows of the 64-grid) are 40 KB a stage: four stages, 222,288 bytes
//    of shared memory with Q and the tables. Two full regions (the second
//    loaded from column 64, a quarter of it read, one n80 product) need
//    1.6x the bytes a tile and leave room for two stages only: K2 at B 1,
//    H 16, N 4096 took 0.259 ms that way against 0.206 (H100 at 700 W, in
//    turns; PERF.md).
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "attention_sm90_common.cuh"

namespace wm {
namespace {

// The block's rows of the rel tables in shared memory. By TMA (gh and gw at
// most kTabCols, rows of H * g elements on 16-byte boundaries): rel_h and
// rel_w each a box of kTabCols columns, rows of kTabCols elements one after
// the other. Else written by the consumers: rel_h at column 0 and rel_w at
// column woff of rows of kTabPitch bytes (gh + gw <= 128). Either pitch is 4
// words past a multiple of 32, so the 8 rows a warp reads fall in 8 banks.
constexpr int kTabCols = 72;
constexpr int kTabPitch = 272;
constexpr int kTabBytes = 2 * kSm90Rows * kTabCols * 2;  // >= kSm90Rows * kTabPitch

struct FwdSm90Args {
  void* o;
  const void* relh;  // (B, nq, H, gh) or null
  const void* relw;  // (B, nq, H, gw) or null
  float* lse;        // (B, nq, H) f32 or null
  long long o_bs, o_rs;  // element strides
  int heads, nq, nk, gh, gw;
  int tab_tma;  // the tables arrive by TMA
  int tp;       // bytes a table row in shared memory
  int wbase;    // rel_w[row][0] lies wbase bytes past rel_h[row][0]
  int scale_q;  // round(q*scale) in shared memory; else the scale goes on the exponent
  unsigned gw_magic;  // 2^32 / gw + 1: key / gw by one multiply
  float scale;
};

// Shared-memory plan, in bytes from the 1024-aligned base: Q of the block
// (the regions of HeadRegions<D>, 128 rows each: D / 64 swizzled regions of
// 64 columns and at d = 80 a narrow one of 16), the tables, the ring of K and
// V tiles (the same regions, TK rows each), the barriers (Q, tables, then
// full and empty a stage).
template <int D, int TK, int STAGES, bool HAS_REL>
struct FwdPlan {
  static constexpr int NR = HeadRegions<D>::NR;
  static constexpr int NARROW = HeadRegions<D>::NARROW;  // 0 or 16 columns
  static constexpr int QREGION = kSm90Rows * sm90::kRegionRowBytes;
  static constexpr int REGION = TK * sm90::kRegionRowBytes;
  static constexpr int TILE = NR * REGION + TK * NARROW * 2;  // K or V of one stage
  static constexpr int TAB = NR * QREGION + kSm90Rows * NARROW * 2;  // after Q
  static constexpr int RING = TAB + (HAS_REL ? kTabBytes : 0);
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int TOTAL = BARS + 16 + 16 * STAGES;
};

__device__ __forceinline__ float bf16_at(const unsigned char* p) {
  return __uint_as_float((uint32_t)*reinterpret_cast<const unsigned short*>(p) << 16);
}

// The tables of this warpgroup's 64 rows into shared memory where no TMA
// map takes them (rows past nq hold zeros), eight loads in flight a thread.
// The warpgroup meets at a barrier afterwards.
__device__ __forceinline__ void stage_tables(unsigned char* tab, const FwdSm90Args& a, int b,
                                             int h, int q0, int wg, int tw) {
  const unsigned short* rh = static_cast<const unsigned short*>(a.relh);
  const unsigned short* rw = static_cast<const unsigned short*>(a.relw);
  const int g = a.gh + a.gw, total = 64 * g;
  for (int i0 = tw; i0 < total; i0 += 8 * 128) {
    unsigned short v[8];
    int off[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + u * 128;
      const int row = wg * 64 + i / g, j = i % g;
      const long long r = ((long long)b * a.nq + q0 + row) * a.heads + h;
      v[u] = 0;
      off[u] = i < total ? row * a.tp + (j < a.gh ? 2 * j : a.wbase + 2 * (j - a.gh)) : -1;
      if (i < total && q0 + row < a.nq) v[u] = j < a.gh ? rh[r * a.gh + j] : rw[r * a.gw + j - a.gh];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (off[u] >= 0) *reinterpret_cast<unsigned short*>(tab + off[u]) = v[u];
    }
  }
}

// The rel bias of keys k0 .. k0 + TK - 1 for rows rA and rA + 8 in units of
// the scores (times binv) into s, the scores' initial value. rowA points at
// rel_h[rA][0] in shared memory. Keys past nk read the last grid row's
// entries (the caller masks them). With gw % 8 == 0 an 8-key group lies in
// one grid row at 8 adjacent columns: one 32-bit read of rel_w a row and
// group, and the grid row advances by a select, not a branch.
template <int NS>
__device__ __forceinline__ void rel_bias(float (&s)[NS][4], const unsigned char* rowA, int t4,
                                         int k0, const FwdSm90Args& a, float binv) {
  const unsigned char* rowB = rowA + 8 * a.tp;
  if (a.gw % 8 == 0) {
    int kh = div_gw(k0, a.gw, a.gw_magic);
    int kw = k0 - kh * a.gw;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int khc = min(kh, a.gh - 1);
      const float hA = bf16_at(rowA + 2 * khc) * binv, hB = bf16_at(rowB + 2 * khc) * binv;
      const int w = a.wbase + 2 * kw + 4 * t4;
      const uint32_t wA = *reinterpret_cast<const uint32_t*>(rowA + w);
      const uint32_t wB = *reinterpret_cast<const uint32_t*>(rowB + w);
      s[n][0] = fmaf(bf16_lo(wA), binv, hA);
      s[n][1] = fmaf(bf16_hi(wA), binv, hA);
      s[n][2] = fmaf(bf16_lo(wB), binv, hB);
      s[n][3] = fmaf(bf16_hi(wB), binv, hB);
      kw += 8;
      const bool wrap = kw >= a.gw;  // gw >= 8: one grid row at most
      kw = wrap ? kw - a.gw : kw;
      kh += wrap;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = min(k0 + n * 8 + 2 * t4 + j, a.nk - 1);
        const int kh = div_gw(key, a.gw, a.gw_magic);
        const int w = a.wbase + 2 * (key - kh * a.gw);
        s[n][j] = (bf16_at(rowA + 2 * kh) + bf16_at(rowA + w)) * binv;
        s[n][j + 2] = (bf16_at(rowB + 2 * kh) + bf16_at(rowB + w)) * binv;
      }
    }
  }
}

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL>
__global__ void __launch_bounds__(kSm90Threads, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_rh,
                         const __grid_constant__ CUtensorMap map_rw,
                         const __grid_constant__ CUtensorMap map_qn,
                         const __grid_constant__ CUtensorMap map_kn,
                         const __grid_constant__ CUtensorMap map_vn, FwdSm90Args a) {
  using namespace sm90;
  using P = FwdPlan<D, TK, STAGES, HAS_REL>;
  constexpr int KD = D / 16;  // k-steps of Q.K^T; at d = 80 the last reads the narrow region
  constexpr bool QREG = D != 128;  // Q from registers; at d = 128 from shared memory
  constexpr int NS = TK / 8;  // 8-key groups of a tile
  constexpr int ND = D / 8;   // 8-column groups of the output
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + P::BARS, tab_full = q_full + 8;
  const uint32_t full0 = q_full + 16, empty0 = full0 + 8 * STAGES;

  const int q0 = blockIdx.x * kSm90Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int nkt = (a.nk + TK - 1) / TK;

  if (t == 0) {
    mbar_init(q_full, 1);
    mbar_init(tab_full, 1);
    init_ring_barriers<STAGES>(full0, empty0, 1);
  }
  __syncthreads();

  if (t >= kConsumerThreads) {
    // ---- producer: Q and the tables once, then K and V through the ring ----
    reg_dealloc<kProducerRegs>();
    if (t == kConsumerThreads) {
      mbar_expect_tx(q_full, P::TAB);
#pragma unroll
      for (int r = 0; r < P::NR; ++r)
        tma_load_3d(base + r * P::QREGION, &map_q, h * D + r * 64, q0, b, q_full);
      if constexpr (P::NARROW != 0)
        tma_load_3d(base + P::NR * P::QREGION, &map_qn, h * D + P::NR * 64, q0, b, q_full);
      if (HAS_REL && a.tab_tma) {
        mbar_expect_tx(tab_full, kTabBytes);
        tma_load_3d(base + P::TAB, &map_rh, h * a.gh, q0, b, tab_full);
        tma_load_3d(base + P::TAB + kTabBytes / 2, &map_rw, h * a.gw, q0, b, tab_full);
      }
      produce_kv_tiles<D, TK, STAGES>(base + P::RING, full0, empty0, &map_k, &map_v, &map_kn,
                                      &map_vn, h, b, nkt);
    }
    return;
  }

  // ---- consumers ----
  reg_alloc<kConsumerRegs>();
  const int lane = t & 31, warp = t >> 5, wg = t >> 7;
  const int g = lane >> 2, t4 = lane & 3;
  const int rA = warp * 16 + g, rB = rA + 8;
  const bool okA = q0 + rA < a.nq, okB = q0 + rB < a.nq;
  // The scores s leave the products in units of lscale: with the packed
  // family's round(q*scale) (scale_q) they are the scores,
  // else the scale is a power of two (exact on q.k) or the grouped family's
  // f32 scale, and exp(lscale*s - m) is one FFMA a score before the exp2.
  const float lscale = a.scale_q ? 1.f : a.scale;
  const float c = lscale * kLog2e;
  const float binv = 1.f / lscale;

  // The tables where no map takes them, and at d = 128, where the products
  // read Q from shared memory as it arrived, round(q*scale) of this
  // warpgroup's Q rows in place where the packed family's scale is no power
  // of two.
  if (HAS_REL && !a.tab_tma) stage_tables(gen + P::TAB, a, b, h, q0, wg, t & 127);
  mbar_wait(q_full, 0);
  if (!QREG && a.scale_q) {
    for (int i = t & 127; i < P::NR * 512; i += 128) {
      uint4* q = reinterpret_cast<uint4*>(gen + (i >> 9) * P::QREGION +
                                          wg * 64 * kRegionRowBytes + (i & 511) * 16);
      uint4 v = *q;
      v.x = pack_bf16x2(bf16_lo(v.x) * a.scale, bf16_hi(v.x) * a.scale);
      v.y = pack_bf16x2(bf16_lo(v.y) * a.scale, bf16_hi(v.y) * a.scale);
      v.z = pack_bf16x2(bf16_lo(v.z) * a.scale, bf16_hi(v.z) * a.scale);
      v.w = pack_bf16x2(bf16_lo(v.w) * a.scale, bf16_hi(v.w) * a.scale);
      *q = v;
    }
    fence_proxy_async();
  }
  if ((!QREG && a.scale_q) || (HAS_REL && !a.tab_tma)) named_barrier(2 + wg, 128);
  if (HAS_REL && a.tab_tma) mbar_wait(tab_full, 0);
  const uint32_t qs = base + wg * 64 * kRegionRowBytes;  // this warpgroup's Q rows
  // at d = 64 and 80, rows rA, rB of Q as the A fragments of S from registers
  uint32_t qa[QREG ? KD : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i & 1 ? rB : rA, col = kd * 16 + 2 * t4 + (i >> 1) * 8;
        const int off = col < P::NR * 64 || P::NARROW == 0
                            ? swz(row, col, P::QREGION)
                            : P::NR * P::QREGION + swz32(row, col - P::NR * 64);
        uint32_t w = *reinterpret_cast<const uint32_t*>(gen + off);
        if (a.scale_q) w = pack_bf16x2(bf16_lo(w) * a.scale, bf16_hi(w) * a.scale);
        qa[kd][i] = w;
      }
    }
    fence_acc(qa);
  }
  const unsigned char* tabA = gen + P::TAB + rA * a.tp;

  float s[NS][4];           // the scores of a tile, then its p
  uint32_t pa[TK / 16][4];  // p rounded to bf16: the A operand of P.V
  float o[ND][4];           // set by the first P.V product
  float mA = -INFINITY, mB = -INFINITY, lA = 0.f, lB = 0.f;  // l: this thread's columns

  // Where a tile is two grid rows (TK == 2 * gw: the 64-grid at 128 keys, the
  // 48-grid at 96), the rel_w entries of this thread's columns are the same
  // in every tile: read once, in units of the scores. A tile then reads two
  // rel_h entries a row.
  constexpr int NH = NS / 2;
  const bool periodic = HAS_REL && 2 * a.gw == TK;
  float wA[NH][2], wB[NH][2];
  if (periodic) {
#pragma unroll
    for (int m = 0; m < NH; ++m) {
      const int w = a.wbase + 16 * m + 4 * t4;
      const uint32_t xA = *reinterpret_cast<const uint32_t*>(tabA + w);
      const uint32_t xB = *reinterpret_cast<const uint32_t*>(tabA + 8 * a.tp + w);
      wA[m][0] = bf16_lo(xA) * binv;
      wA[m][1] = bf16_hi(xA) * binv;
      wB[m][0] = bf16_lo(xB) * binv;
      wB[m][1] = bf16_hi(xB) * binv;
    }
  }

  // The scores' initial value for keys [k0, k0 + TK): the bias, -inf past
  // nk. False where they start from zero: the product overwrites.
  auto init_scores = [&](int k0) {
    const bool tail = k0 + TK > a.nk;
    if (!HAS_REL && !tail) return false;
    if (periodic) {
      const int kh0 = min(2 * (k0 / TK), a.gh - 1), kh1 = min(kh0 + 1, a.gh - 1);
      const float hA0 = bf16_at(tabA + 2 * kh0) * binv, hA1 = bf16_at(tabA + 2 * kh1) * binv;
      const float hB0 = bf16_at(tabA + 8 * a.tp + 2 * kh0) * binv;
      const float hB1 = bf16_at(tabA + 8 * a.tp + 2 * kh1) * binv;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float hA = n < NH ? hA0 : hA1, hB = n < NH ? hB0 : hB1;
        s[n][0] = hA + wA[n % NH][0];
        s[n][1] = hA + wA[n % NH][1];
        s[n][2] = hB + wB[n % NH][0];
        s[n][3] = hB + wB[n % NH][1];
      }
    } else if constexpr (HAS_REL) {
      rel_bias(s, tabA, t4, k0, a, binv);
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    }
    if (tail) {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (k0 + n * 8 + 2 * t4 + j >= a.nk) s[n][j] = s[n][j + 2] = -INFINITY;
        }
      }
    }
    fence_acc(s);
    return true;
  };
  // S (+)= Q.K^T of one stage: K K-major straight from the ring (the last
  // k-step at d = 80 from the narrow region), Q from registers (d = 64, 80)
  // or K-major from its TMA box (d = 128)
  auto issue_s = [&](int st, bool acc) {
    const uint32_t ks = base + P::RING + st * 2 * P::TILE;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const uint64_t kdesc = kd < 4 * P::NR
                                 ? desc_kmajor(ks + (kd / 4) * P::REGION + (kd % 4) * 32)
                                 : desc_kmajor32(ks + P::NR * P::REGION);
      if constexpr (QREG)
        wgmma_rs<0, TK>(s, qa[kd], kdesc, acc || kd > 0);
      else
        wgmma_ss<0, TK>(s, desc_kmajor(qs + (kd / 4) * P::QREGION + (kd % 4) * 32), kdesc,
                        acc || kd > 0);
    }
  };
  // O (+)= P.V of one stage: V MN-major straight from the ring; at d = 80
  // an n64 product over the first region and an n16 one over the narrow one
  auto issue_pv = [&](int st, bool acc) {
    const uint32_t vs = base + P::RING + st * 2 * P::TILE + P::TILE;
    if constexpr (P::NARROW == 0) {
      wgmma_rs_k<D, TK>(o, pa, vs, P::REGION, acc);
    } else {
      static_assert(P::NR == 1 && P::NARROW == 16, "d = 80: 64 + 16 columns");
      float(&o64)[8][4] = *reinterpret_cast<float(*)[8][4]>(&o[0][0]);
      float(&o16)[2][4] = *reinterpret_cast<float(*)[2][4]>(&o[8][0]);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wgmma_rs<1, 64>(o64, pa[kk], desc_mnmajor(vs + kk * 16 * kRegionRowBytes, P::REGION),
                        acc || kk > 0);
        wgmma_rs<1, 16>(o16, pa[kk], desc_mnmajor32(vs + P::REGION + kk * 16 * 32),
                        acc || kk > 0);
      }
    }
  };
  // The online softmax of rows rA, rB over the tile's scores (finite
  // maxima: every tile holds a key below nk), p in place of the scores;
  // returns the factors that rescale what O holds.
  auto softmax = [&](float& alA, float& alB) {
    float tA = mA, tB = mB;
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
    alA = exp2_approx((mA - tA) * c);
    alB = exp2_approx((mB - tB) * c);
    mA = tA;
    mB = tB;
    const float cA = tA * c, cB = tB * c;
    float sA = 0.f, sB = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = exp2_approx(fmaf(s[n][0], c, -cA));
      s[n][1] = exp2_approx(fmaf(s[n][1], c, -cA));
      s[n][2] = exp2_approx(fmaf(s[n][2], c, -cB));
      s[n][3] = exp2_approx(fmaf(s[n][3], c, -cB));
      sA += s[n][0] + s[n][1];
      sB += s[n][2] + s[n][3];
    }
    lA = lA * alA + sA;
    lB = lB * alB + sB;
  };
  // p rounded to bf16 into the A fragments of P.V
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      pa[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    fence_acc(pa);
  };

  // The first tile: S, then its softmax.
  float alA, alB;
  int stage = 0;
  uint32_t phase = 0;
  bool acc = init_scores(0);
  mbar_wait(full0, 0);
  if (wg == 1) your_turn(wg);  // warpgroup 0 issues first
  my_turn(wg);
  wgmma_fence();
  issue_s(0, acc);
  wgmma_commit();
  your_turn(wg);
  wgmma_wait<0>();
  fence_acc(s);
  softmax(alA, alB);
  pack_p();
  // Tile kt: its scores' initial value written, then its S and the last
  // tile's P.V issued together in this warpgroup's turn; its softmax runs
  // under the other warpgroup's products. The wait for P.V stays in the
  // softmax's block: ptxas places it before the first register it reuses
  // from the P fragments (after the row maxima), and could not protect
  // them from a wait beyond the next stage's spin loop.
  for (int kt = 1; kt < nkt; ++kt) {
    const int prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    acc = init_scores(kt * TK);
    mbar_wait(full0 + 8 * stage, phase);
    my_turn(wg);
    wgmma_fence();
    issue_s(stage, acc);
    wgmma_commit();
    issue_pv(prev, kt > 1);
    wgmma_commit();
    your_turn(wg);
    wgmma_wait<1>();
    fence_acc(s);
    softmax(alA, alB);
    wgmma_wait<0>();
    fence_acc(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      o[nd][0] *= alA;
      o[nd][1] *= alA;
      o[nd][2] *= alB;
      o[nd][3] *= alB;
    }
    fence_acc(o);
    pack_p();
  }
  // The last tile's P.V.
  my_turn(wg);
  wgmma_fence();
  issue_pv(stage, nkt > 1);
  wgmma_commit();
  your_turn(wg);
  if (wg == 0) my_turn(wg);  // the last arrival of warpgroup 1
  wgmma_wait<0>();
  fence_acc(o);

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    lA += __shfl_xor_sync(0xffffffffu, lA, off);
    lB += __shfl_xor_sync(0xffffffffu, lB, off);
  }
  const float iA = 1.f / lA, iB = 1.f / lB;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.o) + b * a.o_bs + h * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + 2 * t4;
    if (okA)
      *reinterpret_cast<uint32_t*>(og + (long long)(q0 + rA) * a.o_rs + col) =
          pack_bf16x2(o[nd][0] * iA, o[nd][1] * iA);
    if (okB)
      *reinterpret_cast<uint32_t*>(og + (long long)(q0 + rB) * a.o_rs + col) =
          pack_bf16x2(o[nd][2] * iB, o[nd][3] * iB);
  }
  if (a.lse != nullptr && t4 == 0) {
    if (okA) a.lse[((long long)b * a.nq + q0 + rA) * a.heads + h] = mA * lscale + logf(lA);
    if (okB) a.lse[((long long)b * a.nq + q0 + rB) * a.heads + h] = mB * lscale + logf(lB);
  }
}

struct FwdSm90Operands {
  const void* q;
  const void* k;
  const void* v;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs;
  int batch;
};

template <int D, int TK, int STAGES, bool SCALE_SCORES, bool HAS_REL>
cudaError_t launch_fwd_sm90(const FwdSm90Args& a, const FwdSm90Operands& p,
                            cudaStream_t stream) {
  using P = FwdPlan<D, TK, STAGES, HAS_REL>;
  const size_t smem = 1024 + P::TOTAL;
  if (smem > (size_t)kMaxSmemBytes || p.batch > 65535 || a.heads > 65535 || a.nk > 65535)
    return cudaErrorInvalidValue;
  CUtensorMap map_q, map_k, map_v, map_rh, map_rw, map_qn, map_kn, map_vn;
  memset(&map_rh, 0, sizeof(map_rh));
  memset(&map_rw, 0, sizeof(map_rw));
  memset(&map_qn, 0, sizeof(map_qn));
  memset(&map_kn, 0, sizeof(map_kn));
  memset(&map_vn, 0, sizeof(map_vn));
  cudaError_t err =
      sm90::make_map(&map_q, p.q, a.heads * D, a.nq, p.batch, p.q_rs, p.q_bs, kSm90Rows);
  if (err == cudaSuccess)
    err = sm90::make_map(&map_k, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, TK);
  if (err == cudaSuccess)
    err = sm90::make_map(&map_v, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, TK);
  if (P::NARROW != 0) {  // boxes of the 16 columns past the first region, 32-byte swizzled
    if (err == cudaSuccess)
      err = sm90::make_map(&map_qn, p.q, a.heads * D, a.nq, p.batch, p.q_rs, p.q_bs, kSm90Rows,
                           P::NARROW, 32);
    if (err == cudaSuccess)
      err = sm90::make_map(&map_kn, p.k, a.heads * D, a.nk, p.batch, p.k_rs, p.k_bs, TK,
                           P::NARROW, 32);
    if (err == cudaSuccess)
      err = sm90::make_map(&map_vn, p.v, a.heads * D, a.nk, p.batch, p.v_rs, p.v_bs, TK,
                           P::NARROW, 32);
  }
  if (HAS_REL && a.tab_tma) {
    const long long rh = (long long)a.heads * a.gh, rw = (long long)a.heads * a.gw;
    if (err == cudaSuccess)
      err = sm90::make_map(&map_rh, a.relh, (int)rh, a.nq, p.batch, rh, rh * a.nq, kSm90Rows,
                           kTabCols, 0);
    if (err == cudaSuccess)
      err = sm90::make_map(&map_rw, a.relw, (int)rw, a.nq, p.batch, rw, rw * a.nq, kSm90Rows,
                           kTabCols, 0);
  }
  if (err != cudaSuccess) return err;
  auto kernel = attn_fwd_sm90_kernel<D, TK, STAGES, SCALE_SCORES, HAS_REL>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.nq + kSm90Rows - 1) / kSm90Rows, a.heads, p.batch);
  kernel<<<grid, kSm90Threads, smem, stream>>>(map_q, map_k, map_v, map_rh, map_rw, map_qn,
                                               map_kn, map_vn, a);
  return cudaGetLastError();
}

// The body of a plain C entry, with the arguments of attention_fwd.cuh's.
// bf16 only, d = 64, 80 or 128, rel grids with gh + gw <= 128; anything else
// is refused (cudaErrorInvalidValue).
template <bool SCALE_SCORES>
int attention_fwd_sm90_entry(int dtype, const void* q, const void* k, const void* v, void* o,
                             const void* relh, const void* relw, void* lse, int batch,
                             int heads, int nq, int nk, int d, long long q_bs, long long q_rs,
                             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                             long long o_bs, long long o_rs, int gh, int gw, float scale,
                             void* stream) {
  if (dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const bool rel = relh != nullptr && relw != nullptr;
  if (rel && (gw < 1 || gh < 1 || gh + gw > 128)) return (int)cudaErrorInvalidValue;
  FwdSm90Args a;
  a.o = o;
  a.relh = rel ? relh : nullptr;
  a.relw = rel ? relw : nullptr;
  a.lse = static_cast<float*>(lse);
  a.o_bs = o_bs; a.o_rs = o_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = rel ? gh : 0; a.gw = rel ? gw : 0;
  a.gw_magic = gw_magic_of(a.gw);
  a.scale = scale;
  int e;
  a.scale_q = !SCALE_SCORES && frexpf(scale, &e) != 0.5f;
  a.tab_tma = rel && gh <= kTabCols && gw <= kTabCols && (heads * gh) % 8 == 0 &&
              (heads * gw) % 8 == 0 && (uintptr_t)relh % 16 == 0 && (uintptr_t)relw % 16 == 0;
  if (a.tab_tma) {
    a.tp = kTabCols * 2;
    a.wbase = kTabBytes / 2;
  } else {  // rel_w's columns start on an 8-column boundary where its rows are read in pairs
    a.tp = kTabPitch;
    a.wbase = 2 * (gw % 8 == 0 ? (gh + 7) & ~7 : gh);
  }
  FwdSm90Operands p{q, k, v, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64 && rel && gw == 48)  // two grid rows a tile
    return (int)launch_fwd_sm90<64, 96, 4, SCALE_SCORES, true>(a, p, s);
  if (d == 64)
    return (int)(rel ? launch_fwd_sm90<64, 128, 4, SCALE_SCORES, true>(a, p, s)
                     : launch_fwd_sm90<64, 128, 4, SCALE_SCORES, false>(a, p, s));
  if (d == 80)  // 64 + 16 columns: 40 KB a stage
    return (int)(rel ? launch_fwd_sm90<80, 128, 4, SCALE_SCORES, true>(a, p, s)
                     : launch_fwd_sm90<80, 128, 4, SCALE_SCORES, false>(a, p, s));
  if (d == 128)  // 128-key tiles and the tables do not fit in registers
    return (int)(rel ? launch_fwd_sm90<128, 64, 4, SCALE_SCORES, true>(a, p, s)
                     : launch_fwd_sm90<128, 128, 3, SCALE_SCORES, false>(a, p, s));
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
