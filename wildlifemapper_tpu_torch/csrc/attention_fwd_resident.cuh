// Windowed multi-head attention with the decomposed relative-position bias,
// forward, bf16, d = 64 or 80: the resident body. One block owns one (window, head)
// at a time and holds all of its Q, K and V in shared memory. It computes the
// function of attention_fwd.cuh (see that header for the layouts and the
// rounding points) and takes over its windowed launches, for the TPU kernels
//
//   K1 wildlifemapper_tpu/ops/windowed_attention_v2.py::windowed_attention_packed
//      (:200; the Pallas call at :227; instantiated by attention_resident.cu,
//      SCALE_SCORES = false)
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::windowed_attention_rel_pos
//      (:111; the Pallas call at :144; instantiated by
//      grouped_attention_resident.cu, SCALE_SCORES = true)
//
// with N = M <= 208 tokens a window (196 = 14 x 14 and 144 = 12 x 12 on the
// main paths), rel tables at most 16 wide (ops/_attention.py::attention_body
// says which launch comes here). Global blocks that land in K1 / K6 with more
// keys, d = 32, d = 128 and f32 stay with attention_fwd.cuh. Head dim 80
// (ViT-H's windows) runs here forward only: its backward stays with the tile
// bodies of attention_bwd.cuh (attention_bwd_resident.cuh is d = 64 only).
//
// What bounds it on the H100: bytes. A window-head reads 3 x N x 128 B of
// q, k, v and N x 2 x g x 2 B of tables and writes N x 128 B: 111 KB at
// N = 196, 133 MB for 1200 window-heads, 0.040 ms at 3.35 TB/s, against
// 4 N^2 d flops = 11.8 GFLOP, 0.012 ms at 989 TFLOP/s. The tile body of
// attention_fwd.cuh took a window as a short stream: four 64-row blocks a
// window-head, each loading the same K and V between two block barriers (K
// and V read four times, never overlapped), V copied transposed by 2-byte
// stores, 256 x 256 scores computed for 196 x 196, an online softmax whose
// rescale was never needed. What this design does about each:
//  * the instruction is mma.sync m16n8k16 fed by ldmatrix, not wgmma: the
//    unit of work is a 16-row tile, so 196 rows pad to 208 = 13 x 16 (6 %
//    waste) and 144 to 144 (none), where wgmma's 64-row warpgroups would pad
//    to 256 (23 %) and 192 (25 %); the operations bound is a third of the
//    byte bound, so the lower rate of mma.sync is not what bounds the kernel.
//    Only this body was written and timed; a wgmma variant was not tried.
//    Two instantiations: KT = 13 key tiles (up to 208 tokens) and KT = 9 (up
//    to 144). A block is NW = 7 (KT = 13) or 5 (KT = 9) warps and a warp
//    takes the tiles warp, warp + NW, ... one after the other. One warp a
//    tile was tried first (13 warps): warps are allotted registers four at a
//    time, so 13 warps get what 16 would, 128 a thread, and the 104 score
//    registers spilled; 7 warps of 206 registers were faster on the H100 than
//    13 or 12;
//  * Q, K and V of a window-head come to shared memory once, by 16-byte
//    cp.async, rows of 128 bytes with the 16-byte chunk index XORed with
//    row % 8, so ldmatrix reads every operand without bank conflicts and
//    ldmatrix.trans reads V as the B operand of P.V in place: no tile is
//    copied transposed and nothing is loaded by 2-byte loads;
//  * the bias is a product: with E[k] = (onehot(k / gw), onehot(k % gw)) and
//    T[q] = (rel_h[q], rel_w[q]), 32 columns each, S = Q.K^T + T.E^T: two
//    more k-steps of the same mma on the bf16 tables (exact: one-hot entries,
//    f32 sums) in place of two table reads and an index division a score.
//    The tables come by 4-byte cp.async (a row of 14 bf16 is 28 bytes, so no
//    wider copy is aligned); odd table widths take 2-byte loads;
//  * a row's scores stay in registers (16 x 208 f32 a warp, 104 registers a
//    thread): one maximum, one exp2, one sum, then P.V with P rounded to bf16
//    from those registers. No running rescale;
//  * loads overlap the products across window-heads: one persistent block an
//    SM walks its window-heads through a two-stage ring, and the next
//    window-head's cp.async (started by all threads, no producer warp) are in
//    flight while this one is computed. Shared memory at KT = 13: 2 stages x
//    3 tiles x 208 x 128 B = 159,744 B, two table buffers and E of 208 x 64 B
//    = 39,936 B: 199,680 B of 232,448. Two resident blocks an SM instead
//    would need twice the 104 score registers a thread for 13 tiles, which
//    the register file does not hold. On the H100 at BW 100, N 196 the
//    copies alone run near the card's memory rate in about a third of the
//    kernel's time and the ring hides little of them: what bounds the kernel
//    today is the shared-memory traffic of the B operands (a 16-row tile
//    reads all of K, V and E by ldmatrix) and the softmax's ALU work between
//    the two products, not device memory;
//  * out goes back through the warp's own (spent) Q rows as 16-byte stores;
//  * d = 80 (ViT-H: 16 heads, windows of 196) is ten 16-byte chunks a row:
//    chunks 0-7 in 128-byte rows as at d = 64 and chunks 8-9 in a second
//    part of 32-byte rows with the chunk index XORed with (row / 4) % 2
//    (res_tile_off), so ldmatrix stays free of bank conflicts in both. A tile
//    of 208 rows is then 33,280 bytes and the two-stage ring of Q, K and V
//    would need 239,616 bytes with the tables and E. So Q has one tile and
//    K, V two stages (206,336 bytes): a warp reads only its own Q rows (the
//    A operand of its row tiles, then the staging of its out), so as soon
//    as it has written its out it starts the next window-head's Q into those
//    rows by cp.async, and the next round's wait covers them: the Q copies
//    still run under the products. The QK product takes 5 k-steps, P.V 10
//    column groups (40 O registers a thread, 8 more than at d = 64).
//
// Rounding points as in attention_fwd.cuh: the packed family rounds q*scale
// to bf16 (in the A fragment registers), the grouped family scales the f32
// scores; where the scale is a power of two (d = 64: 2^-3) the two are the
// same bit for bit and both scale the Q fragments. p is rounded to bf16
// before P.V, the row sum takes it unrounded, out = acc / l is rounded once,
// and lse = m + log(l) is written when the caller passes the buffer.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr int kResD = 64;          // head dim of the resident bodies (the forward also 80)
constexpr int kResTileRow = 128;   // bytes of a q, k, v row at d = 64
constexpr int kResTabRow = 64;     // bytes of a table row: rel_h in [0, 16), rel_w in [16, 32)
constexpr int kResMaxGrid = 16;    // widest rel table
constexpr float kLog2e = 1.4426950408889634f;

// How the softmax scale enters (see the header note).
enum ResScaleMode : int {
  kResScalePow2 = 0,    // exact in bf16: on the Q (or, transposed, the K) fragments
  kResScaleRoundQ = 1,  // packed family: round(q * scale) wherever q is an operand
  kResScaleScores = 2,  // grouped family: on the f32 scores
};

inline int res_scale_mode(float scale, bool scale_scores) {
  int exponent;
  if (frexpf(scale, &exponent) == 0.5f) return kResScalePow2;
  return scale_scores ? kResScaleScores : kResScaleRoundQ;
}

inline int res_sm_count() {
  static int count = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    return n;
  }();
  return count;
}

__device__ __forceinline__ uint32_t res_smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte chunk `chunk` of row `row`: in a q, k, v tile
// (TAB = false, 8 chunks a row) or in a table tile (TAB = true, 4 chunks).
template <bool TAB> __device__ __forceinline__ uint32_t res_off(int row, int chunk) {
  if (TAB) return (uint32_t)(row * kResTabRow + ((chunk ^ ((row >> 1) & 3)) << 4));
  return (uint32_t)(row * kResTileRow + ((chunk ^ (row & 7)) << 4));
}

// The same in a q, k, v tile of ROWS rows at head dim D. At d = 80 a row is
// ten chunks: chunks 0-7 in 128-byte rows as above, then chunks 8 and 9 in a
// part of 32-byte rows after the ROWS rows of the first, the chunk index
// XORed with (row / 4) % 2, so that 8 rows at one chunk fall in 8 16-byte
// bank groups there too. `hi`: the chunk lies in that part (chunk >= 8).
template <int D, int ROWS>
__device__ __forceinline__ uint32_t res_tile_off(int row, int chunk, bool hi) {
  if (D == 64 || !hi) return res_off<false>(row, chunk);
  return (uint32_t)(ROWS * kResTileRow + row * 32 + (((chunk & 1) ^ ((row >> 2) & 1)) << 4));
}
template <bool TAB, int D, int ROWS>
__device__ __forceinline__ uint32_t res_any_off(int row, int chunk, bool hi) {
  return TAB ? res_off<true>(row, chunk) : res_tile_off<D, ROWS>(row, chunk, hi);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// A operand: rows r0 .. r0 + 15, 16 columns from chunk `chunk` (even), of a
// tile stored [row][column] (a q, k, v tile at head dim D of ROWS rows, or a
// table tile).
template <bool TAB, int D = kResD, int ROWS = 0>
__device__ __forceinline__ void res_lda(uint32_t (&a)[4], uint32_t tile, int r0, int chunk,
                                        int lane) {
  ldsm_x4(a, tile + res_any_off<TAB, D, ROWS>(r0 + (lane & 15), chunk + (lane >> 4), chunk >= 8));
}
// B operands of two adjacent 8-wide column groups n0 .. n0 + 15 over a
// k-step of 16 from chunk `chunk`, of a tile stored [n][k] (K, Q, dO, V as
// the right-hand side of X.Y^T): b[0], b[1] for n0, b[2], b[3] for n0 + 8.
template <bool TAB, int D = kResD, int ROWS = 0>
__device__ __forceinline__ void res_ldb(uint32_t (&b)[4], uint32_t tile, int n0, int chunk,
                                        int lane) {
  ldsm_x4(b, tile + res_any_off<TAB, D, ROWS>(n0 + ((lane >> 4) << 3) + (lane & 7),
                                             chunk + ((lane >> 3) & 1), chunk >= 8));
}
// The same for a tile stored [k][n] (V, K, Q, dO as the right-hand side of
// X.Y): the k-step is rows k0 .. k0 + 15, the column groups are chunks
// `chunk` and `chunk` + 1, read transposed in place.
template <bool TAB, int D = kResD, int ROWS = 0>
__device__ __forceinline__ void res_ldbt(uint32_t (&b)[4], uint32_t tile, int k0, int chunk,
                                         int lane) {
  ldsm_x4_trans(b, tile + res_any_off<TAB, D, ROWS>(k0 + (((lane >> 3) & 1) << 3) + (lane & 7),
                                                   chunk + (lane >> 4), chunk >= 8));
}

__device__ __forceinline__ void res_cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void res_cp4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void res_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void res_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float res_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float res_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float res_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
// Both bf16 of each register times `scale`, rounded to bf16.
template <int N> __device__ __forceinline__ void res_scale_regs(uint32_t (&r)[N], float scale) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = pack_bf16x2(res_lo(r[i]) * scale, res_hi(r[i]) * scale);
}

// Rows [r0, r1) of one [n][D] bf16 tensor of a window-head into a tile of
// ROWS rows, 16 bytes a copy: D / 8 adjacent lanes take one row.
template <int D = kResD, int ROWS = 0>
__device__ __forceinline__ void res_copy_tile(uint32_t tile, const __nv_bfloat16* src,
                                               long long row_stride, int n, int t, int nthr,
                                               int r0 = 0) {
  constexpr int CH = D / 8;
  for (int i = r0 * CH + t; i < n * CH; i += nthr) {
    const int row = (unsigned)i / CH, c = (unsigned)i % CH;
    res_cp16(tile + res_tile_off<D, ROWS>(row, c, c >= 8), src + row * row_stride + c * 8);
  }
}

// The rel tables' rows of window-head (b, h) into a table tile: rel_h into
// columns [0, gh), rel_w into [16, 16 + gw). Even widths go by 4-byte
// cp.async, odd ones by 2-byte loads and stores (visible after the next
// block barrier either way).
__device__ __forceinline__ void res_copy_tables(unsigned char* smem, uint32_t tab_off,
                                                 const __nv_bfloat16* relh,
                                                 const __nv_bfloat16* relw, long long b, int h,
                                                 int heads, int n, int gh, int gw, int t,
                                                 int nthr) {
  const uint32_t tab = res_smem_u32(smem) + tab_off;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const __nv_bfloat16* src = which ? relw : relh;
    const int g = which ? gw : gh, col0 = which ? 16 : 0;
    if ((g & 1) == 0) {
      // eight lanes a row, one pair of columns each: no division
      for (int i = t; i < n * 8; i += nthr) {
        const int row = i >> 3, c = col0 + 2 * (i & 7);
        if (c - col0 < g)
          res_cp4(tab + res_off<true>(row, c >> 3) + (c & 7) * 2,
                  src + ((b * n + row) * heads + h) * g + (c - col0));
      }
    } else {
      for (int i = t; i < n * g; i += nthr) {
        const int row = i / g, c = col0 + (i - row * g);
        *reinterpret_cast<__nv_bfloat16*>(smem + tab_off + res_off<true>(row, c >> 3) +
                                          (c & 7) * 2) =
            src[((b * n + row) * heads + h) * g + (c - col0)];
      }
    }
  }
}

// Once a block: zeros in the rows past n of every tile (so padded keys and
// rows are finite and count for nothing), zeros in both table buffers (the
// copies then fill the live columns), and the one-hot tile E.
template <int KT, int D = kResD>
__device__ __forceinline__ void res_init(unsigned char* smem, int ntiles, uint32_t tabs_off,
                                         uint32_t eye_off, int n, int gw, int t, int nthr) {
  constexpr int ROWS = KT * 16, CH = D / 8;
  constexpr int TILE = ROWS * D * 2, TAB = ROWS * kResTabRow;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int pad = (ROWS - n) * CH;
  for (int i = t; i < ntiles * pad; i += nthr) {
    const int tile = i / pad, j = i - tile * pad;
    const int row = n + j / CH, c = j % CH;
    *reinterpret_cast<uint4*>(smem + tile * TILE + res_tile_off<D, ROWS>(row, c, c >= 8)) = zero;
  }
  for (int i = t; i < 2 * TAB / 16; i += nthr)
    *reinterpret_cast<uint4*>(smem + tabs_off + i * 16) = zero;
  for (int i = t; i < ROWS * 4; i += nthr) {
    const int key = i >> 2, c = i & 3;
    // columns 8c .. 8c + 7: the one-hot of key / gw lives in [0, 16), of
    // key % gw in [16, 32)
    const int kh = key / gw;
    const int hot = key < n ? (c < 2 ? kh : 16 + key - kh * gw) - 8 * c : -1;
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (hot == 2 * j ? 0x3F80u : 0u) | (hot == 2 * j + 1 ? 0x3F800000u : 0u);
    *reinterpret_cast<uint4*>(smem + eye_off + res_off<true>(key, c)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

struct ResFwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const __nv_bfloat16* relh;  // (B, n, H, gh)
  const __nv_bfloat16* relw;  // (B, n, H, gw)
  float* lse;                 // (B, n, H) f32 or null
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // element strides
  int batch, heads, n, gh, gw;
  float scale;
  int mode;  // ResScaleMode
};

// Q tiles of the ring: two at d = 64; one at d = 80, where each warp refills
// its own rows for the next window-head as soon as it has written them out
// (a two-stage Q does not fit beside K, V, the tables and E: 239,616 bytes).
template <int D> __host__ __device__ constexpr int res_q_stages() { return D == 64 ? 2 : 1; }

template <int KT, int D> __host__ __device__ constexpr int res_fwd_smem_bytes() {
  return (res_q_stages<D>() + 4) * KT * 16 * D * 2 + 3 * KT * 16 * kResTabRow;
}

template <int D, int KT, int NW>
__global__ void __launch_bounds__(NW * 32, 1) attn_fwd_resident_kernel(ResFwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int ROWS = KT * 16, CH = D / 8;
  constexpr int TILE = ROWS * D * 2, TAB = ROWS * kResTabRow;
  constexpr int QST = res_q_stages<D>();
  // Q, K and V of stage 0, then of stage 1 (d = 64); or Q, then K and V of
  // each stage (d = 80); then the two table buffers and E
  constexpr uint32_t TABS = (QST + 4) * TILE, EYE = TABS + 2 * TAB;
  auto q_tile = [](int stage) { return (uint32_t)(QST == 2 ? stage * 3 * TILE : 0); };
  auto k_tile = [](int stage) {
    return (uint32_t)(QST == 2 ? stage * 3 * TILE + TILE : TILE + stage * 2 * TILE);
  };
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = res_smem_u32(smem_raw);
  const int t = threadIdx.x, nthr = blockDim.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int total = a.batch * a.heads;

  res_init<KT, D>(smem_raw, QST + 4, TABS, EYE, a.n, a.gw, t, nthr);
  __syncthreads();

  auto copy_in = [&](int wh, int stage, bool with_q) {
    const long long b = wh / a.heads;
    const int h = wh - (int)b * a.heads;
    const uint32_t kt = base + k_tile(stage);
    if (with_q)
      res_copy_tile<D, ROWS>(base + q_tile(stage), a.q + b * a.q_bs + h * D, a.q_rs, a.n, t,
                             nthr);
    res_copy_tile<D, ROWS>(kt, a.k + b * a.k_bs + h * D, a.k_rs, a.n, t, nthr);
    res_copy_tile<D, ROWS>(kt + TILE, a.v + b * a.v_bs + h * D, a.v_rs, a.n, t, nthr);
    res_copy_tables(smem_raw, TABS + stage * TAB, a.relh, a.relw, b, h, a.heads, a.n, a.gh,
                     a.gw, t, nthr);
  };

  int wh = blockIdx.x;
  if (wh < total) copy_in(wh, 0, true);
  res_commit();
  for (int it = 0; wh < total; wh += gridDim.x, ++it) {
    const int stage = it & 1;
    const int next = wh + (int)gridDim.x;
    // the other stage was read last in the previous round, which ended on a
    // block barrier: fill it while this round computes. With one Q tile the
    // warps' own refills of the previous round complete in the same wait.
    if (next < total) copy_in(next, stage ^ 1, QST == 2);
    res_commit();
    res_wait<1>();
    __syncthreads();

    const long long b = wh / a.heads;
    const int h = wh - (int)b * a.heads;
    const uint32_t qs = base + q_tile(stage), ks = base + k_tile(stage), vs = ks + TILE;
    const uint32_t tb = base + TABS + stage * TAB, eye = base + EYE;

    // A warp takes the 16-row tiles warp, warp + NW, ... of the window.
#pragma unroll 1
    for (int r0 = warp * 16; r0 < a.n; r0 += NW * 16) {
      // S = Q K^T + T E^T: 16 rows x 16 KT keys.
      float s[2 * KT][4];
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t qa[4];
        res_lda<false, D, ROWS>(qa, qs, r0, 2 * kd, lane);
        if (a.mode != kResScaleScores) res_scale_regs(qa, a.scale);
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t kb[4];
          res_ldb<false, D, ROWS>(kb, ks, 16 * np, 2 * kd, lane);
          mma_16816(s[2 * np], qa, kb[0], kb[1]);
          mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      if (a.mode == kResScaleScores) {
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[n][j] *= a.scale;
        }
      }
#pragma unroll
      for (int ks2 = 0; ks2 < 2; ++ks2) {
        uint32_t ta[4];
        res_lda<true>(ta, tb, r0, 2 * ks2, lane);
#pragma unroll
        for (int np = 0; np < KT; ++np) {
          uint32_t eb[4];
          res_ldb<true>(eb, eye, 16 * np, 2 * ks2, lane);
          mma_16816(s[2 * np], ta, eb[0], eb[1]);
          mma_16816(s[2 * np + 1], ta, eb[2], eb[3]);
        }
      }

      // One-pass softmax of rows rA = r0 + g and rB = rA + 8; keys past n count
      // for nothing.
      float mA = -INFINITY, mB = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
        if (n * 8 + 8 > a.n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (n * 8 + 2 * t4 + j >= a.n) s[n][j] = s[n][j + 2] = -INFINITY;
          }
        }
        mA = fmaxf(mA, fmaxf(s[n][0], s[n][1]));
        mB = fmaxf(mB, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mA = fmaxf(mA, __shfl_xor_sync(0xffffffffu, mA, off));
        mB = fmaxf(mB, __shfl_xor_sync(0xffffffffu, mB, off));
      }
      const float mA2 = mA * kLog2e, mB2 = mB * kLog2e;  // finite: key 0 is live
      float lA = 0.f, lB = 0.f;
      uint32_t pa[KT][4];
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int n = 2 * kk + half;
          const float p0 = res_ex2(fmaf(s[n][0], kLog2e, -mA2));
          const float p1 = res_ex2(fmaf(s[n][1], kLog2e, -mA2));
          const float p2 = res_ex2(fmaf(s[n][2], kLog2e, -mB2));
          const float p3 = res_ex2(fmaf(s[n][3], kLog2e, -mB2));
          lA += p0 + p1;
          lB += p2 + p3;
          pa[kk][2 * half] = pack_bf16x2(p0, p1);
          pa[kk][2 * half + 1] = pack_bf16x2(p2, p3);
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        lA += __shfl_xor_sync(0xffffffffu, lA, off);
        lB += __shfl_xor_sync(0xffffffffu, lB, off);
      }

      // O = P V, V read transposed in place.
      float o[CH][4];
#pragma unroll
      for (int nd = 0; nd < CH; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int ndp = 0; ndp < D / 16; ++ndp) {
          uint32_t vb[4];
          res_ldbt<false, D, ROWS>(vb, vs, 16 * kk, 2 * ndp, lane);
          mma_16816(o[2 * ndp], pa[kk], vb[0], vb[1]);
          mma_16816(o[2 * ndp + 1], pa[kk], vb[2], vb[3]);
        }
      }

      // out through the warp's own Q rows (only this warp read them), then 16
      // bytes a store; rows past n are left as they are.
      const int rA = r0 + g, rB = rA + 8;
      const float iA = 1.f / lA, iB = 1.f / lB;
      unsigned char* qrows = smem_raw + (qs - base);
      __syncwarp();
#pragma unroll
      for (int nd = 0; nd < CH; ++nd) {
        if (rA < a.n)
          *reinterpret_cast<uint32_t*>(qrows + res_tile_off<D, ROWS>(rA, nd, nd >= 8) + t4 * 4) =
              pack_bf16x2(o[nd][0] * iA, o[nd][1] * iA);
        if (rB < a.n)
          *reinterpret_cast<uint32_t*>(qrows + res_tile_off<D, ROWS>(rB, nd, nd >= 8) + t4 * 4) =
              pack_bf16x2(o[nd][2] * iB, o[nd][3] * iB);
      }
      __syncwarp();
      bf16* og = a.o + b * a.o_bs + h * D;
#pragma unroll
      for (int i = 0; i < CH / 2; ++i) {  // 16 rows of CH chunks, 32 lanes
        const unsigned j = lane + 32 * i;
        const int row = r0 + j / CH, c = j % CH;
        if (row < a.n)
          *reinterpret_cast<uint4*>(og + row * a.o_rs + c * 8) =
              *reinterpret_cast<const uint4*>(qrows + res_tile_off<D, ROWS>(row, c, c >= 8));
      }
      if (a.lse != nullptr && t4 == 0) {
        if (rA < a.n) a.lse[(b * a.n + rA) * a.heads + h] = mA + logf(lA);
        if (rB < a.n) a.lse[(b * a.n + rB) * a.heads + h] = mB + logf(lB);
      }
      if constexpr (QST == 1) {
        // these rows are read out: the next window-head's Q into them (only
        // this warp reads them), waited for at the next round's res_wait
        __syncwarp();
        if (next < total) {
          const long long nb = next / a.heads;
          const int nh = next - (int)nb * a.heads;
          res_copy_tile<D, ROWS>(qs, a.q + nb * a.q_bs + nh * D, a.q_rs, min(r0 + 16, a.n), lane,
                                 32, r0);
        }
        res_commit();
      }
    }
    __syncthreads();  // this stage is free for the round after next's copies
  }
  res_wait<0>();
}

// Largest window the bodies hold resident, and the key tiles of the
// instantiation that takes n tokens.
constexpr int kResMaxTokens = 208;
inline int res_key_tiles(int n) { return n <= 144 ? 9 : 13; }

template <int D, int KT, int NW>
cudaError_t launch_fwd_resident(const ResFwdArgs& a, cudaStream_t stream) {
  constexpr int smem = res_fwd_smem_bytes<KT, D>();
  static_assert(smem <= kMaxSmemBytes, "shared memory of the forward");
  auto kernel = attn_fwd_resident_kernel<D, KT, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int sms = res_sm_count();
  if (sms < 1) return cudaErrorInvalidDevice;
  const long long total = (long long)a.batch * a.heads;
  const int grid = (int)(total < sms ? total : sms);
  const int tiles = (a.n + 15) / 16;
  kernel<<<grid, 32 * (tiles < NW ? tiles : NW), smem, stream>>>(a);
  return cudaGetLastError();
}

// What both resident entries refuse (cudaErrorInvalidValue): anything but
// bf16 with nq == nk <= 208, both rel tables at most 16 wide covering the
// window, 16-byte aligned rows. Each entry checks its head dims (the
// forward d = 64 and 80, the backward d = 64).
inline bool res_shapes_ok(int dtype, int batch, int heads, int nq, int nk,
                          const void* relh, const void* relw, int gh, int gw) {
  return dtype == kBFloat16 && nq == nk && nq >= 1 && nq <= kResMaxTokens &&
         batch >= 1 && heads >= 1 && (long long)batch * heads < (1ll << 31) &&
         relh != nullptr && relw != nullptr && gh >= 1 && gw >= 1 && gh <= kResMaxGrid &&
         gw <= kResMaxGrid && gh * gw == nk;
}

// The body of a plain C entry, with the arguments of attention_fwd.cuh's.
template <bool SCALE_SCORES>
int attention_fwd_resident_entry(int dtype, const void* q, const void* k, const void* v,
                                 void* o, const void* relh, const void* relw, void* lse,
                                 int batch, int heads, int nq, int nk, int d, long long q_bs,
                                 long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                 long long v_rs, long long o_bs, long long o_rs, int gh, int gw,
                                 float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!res_shapes_ok(dtype, batch, heads, nq, nk, relh, relw, gh, gw) || (d != 64 && d != 80))
    return (int)cudaErrorInvalidValue;
  ResFwdArgs a;
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.o = static_cast<bf16*>(o);
  a.relh = static_cast<const bf16*>(relh); a.relw = static_cast<const bf16*>(relw);
  a.lse = static_cast<float*>(lse);
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.batch = batch; a.heads = heads; a.n = nq; a.gh = gh; a.gw = gw;
  a.scale = scale;
  a.mode = res_scale_mode(scale, SCALE_SCORES);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 80)
    return (int)(res_key_tiles(nq) == 9 ? launch_fwd_resident<80, 9, 5>(a, s)
                                        : launch_fwd_resident<80, 13, 7>(a, s));
  return (int)(res_key_tiles(nq) == 9 ? launch_fwd_resident<64, 9, 5>(a, s)
                                      : launch_fwd_resident<64, 13, 7>(a, s));
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_FWD_RESIDENT(name, scale_scores)                                 \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, void* o,      \
                      const void* relh, const void* relw, void* lse, int batch, int heads,  \
                      int nq, int nk, int d, long long q_bs, long long q_rs,                \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,       \
                      long long o_bs, long long o_rs, int gh, int gw, float scale,          \
                      void* stream) {                                                        \
    return wm::attention_fwd_resident_entry<scale_scores>(                                   \
        dtype, q, k, v, o, relh, relw, lse, batch, heads, nq, nk, d, q_bs, q_rs, k_bs,      \
        k_rs, v_bs, v_rs, o_bs, o_rs, gh, gw, scale, stream);                                \
  }
