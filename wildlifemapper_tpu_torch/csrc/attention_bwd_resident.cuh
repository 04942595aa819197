// Backward of the windowed attention of attention_fwd_resident.cuh, bf16,
// d = 64 or 80: one kernel a window-head. It computes the function of the
// two kernels of attention_bwd.cuh and of the delta pass before them (see
// that header for the formulas and the rounding points) and takes over their
// windowed launches, for the TPU kernels
//
//   K1 wildlifemapper_tpu/ops/windowed_attention_v2.py::_bwd_kernel (:125;
//      the Pallas call at :260; instantiated by attention_bwd_resident.cu,
//      SCALE_SCORES = false)
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::_bwd_kernel (:64; the
//      Pallas call at :173; instantiated by grouped_attention_bwd_resident.cu,
//      SCALE_SCORES = true)
//
// with N = M <= 208 tokens a window and rel tables at most 16 wide
// (ops/_attention.py::attention_body). Everything else stays with
// attention_bwd.cuh.
//
// What bounds it on the H100: bytes. A window-head reads q, k, v, do, o
// (5 x N x 2d B), the tables and lse, and writes dq, dk, dv and the table
// gradients: 224 KB at N = 196, d = 64, 0.08 ms for 1200 window-heads at
// 3.35 TB/s, against 10 N^2 d flops (0.03 ms at 989 TFLOP/s). The tile bodies
// spent 1.77 ms: a plain tensor pass for delta that wrote f32 copies of do and
// o, then two kernels that each recomputed S and dP over 64 x 64 tiles padded
// to 256 x 256, with K (or q and do) copied transposed by 2-byte stores and
// the table gradients added into shared memory lane by lane. A window-head
// has one owner, so here one block makes all five gradients with no atomics
// and no second kernel. What the design does:
//  * mma.sync m16n8k16 fed by ldmatrix on 16-row tiles, 7 warps (KT = 13,
//    up to 208 tokens) or 5 (KT = 9, up to 144) that each take two tiles one
//    after the other, as the forward and for the forward's reasons (13 warps
//    get 128 registers a thread and spilled; 7 warps of 247 registers were
//    faster on the H100);
//  * Q, K, dO and V of the window-head are resident in shared memory in the
//    forward's swizzled rows (res_tile_off), brought by 16-byte cp.async;
//    every transposed operand (K in dS.K, Q in dS^T.Q, dO in P^T.dO) is read
//    in place by ldmatrix.trans;
//  * delta = rowsum(do * o) in f32 is taken inside the kernel: each warp
//    reads its 16 rows of o from device memory as 16-byte vectors while the
//    copies are in flight and multiplies them with the do tile;
//  * pass 1, a warp owns 16 query rows at a time and walks the resident
//    keys in chunks of CHA x 16 (registers: S and dP of a 16 x 208 strip
//    would be 208 a thread): S = Q.K^T + T.E^T and dP = dO.V^T, p = exp2((s - lse) log2 e)
//    from the saved lse, ds = round(p (dp - delta)), dq += ds.K, and the
//    table gradients as one more product, (drel_h | drel_w) += ds.E with the
//    one-hot E of the forward: the row's sums over k / gw and k % gw come out
//    of the tensor cores from the ds registers into 16 accumulators a thread
//    and are stored once. No shared-memory read-modify-write;
//  * pass 2, a warp owns 16 keys at a time and walks the resident queries in
//    chunks of CHB x 16: it recomputes S^T = K.Q^T + E.T^T and dP^T = V.dO^T (7
//    products a window-head in all, nothing staged: bf16 P and dS strips of
//    208 x 208 would be 173 KB beside 106 KB of operands), then
//    dv += round(p)^T.dO and dk += ds^T.Q;
//  * one persistent block an SM walks its window-heads through tile slots.
//    At d = 64, KT = 13 (208 rows) a slot is 26,624 B and four are in use,
//    so two full stages (213 KB + tables) do not fit; seven slots (186,368 B)
//    in a ring, two table buffers and E (39,936 B) and lse / delta (1,664 B)
//    make 227,968 B of 232,448: the next window-head's Q, K and dO are in
//    flight while this one is computed, and its V follows when the round
//    starts, under the delta pass. At KT = 9 eight slots fit and all four
//    tensors are prefetched, at d = 64 and at d = 80;
//  * every element of dq, dk, dv and the table gradients is owned by one
//    thread and summed in a fixed order: two runs are bit-identical.
//
// Head dim 80 (ViT-H: 16 heads, windows of 196) takes the forward's row
// layout: ten 16-byte chunks a row, chunks 0-7 in 128-byte rows and chunks
// 8-9 in a part of 32-byte rows swizzled by (row / 4) % 2, so ldmatrix and
// ldmatrix.trans stay free of bank conflicts in both parts; the products
// take a fifth k-step (S, dP, S^T, dP^T) and ten column groups (dq, dk, dv).
// A 208-row slot is 33,280 B, so at KT = 13 five slots fit beside the tables
// and E (208,000 B in all), not a ring of seven. They are fixed: Q, K and V
// in slots 0-2 and dO in slot 3 or 4 by the round's parity. The next
// window-head's dO and tables come in under this one's products; its K and
// V come in row by row in pass 2, where a warp reads only its own 16 rows of
// K and V (the A operands): when a warp has written a key tile's dk and dv
// it starts the next window-head's K and V rows of that tile into them
// (pass 1 reads every key, so a block barrier separates the passes); its Q,
// read by every warp until the round's end, comes in when the next round
// starts, under the delta pass. The chunks are narrower than at d = 64,
// where dq, dk and dv are a quarter larger: CHA = 4 and CHB = 2 at KT = 13
// (40 dq, and 2 x 40 dk / dv accumulators beside a 16 x 32 S / dP chunk),
// CHA = CHB = 3 at KT = 9; d = 64 keeps CHA = 5 and CHB = 3 (KT = 13) or 4
// (KT = 9). chip_smoke.py phase 1 holds every instantiation to 0 bytes
// spilled.
//
// Keys and rows past n are zeros in shared memory and their p is forced to
// zero where a tile straddles n, so they add nothing; they are not written.
#pragma once

#include "attention_fwd_resident.cuh"

namespace wm {
namespace {

struct ResBwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const __nv_bfloat16* out;
  const float* lse;            // (B, n, H)
  const __nv_bfloat16* relh;   // (B, n, H, gh)
  const __nv_bfloat16* relw;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  __nv_bfloat16* drelh;        // (B, n, H, gh) or null: not wanted
  __nv_bfloat16* drelw;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs;  // element strides
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int batch, heads, n, gh, gw;
  float scale;
  int mode;  // ResScaleMode
};

// Tile slots: as many as fit beside the tables and E (see the header).
template <int D, int KT> __host__ __device__ constexpr int res_bwd_slots() {
  return KT > 9 ? (D == 64 ? 7 : 5) : 8;
}
template <int D, int KT> __host__ __device__ constexpr int res_bwd_smem_bytes() {
  return res_bwd_slots<D, KT>() * KT * 16 * D * 2 + 3 * KT * 16 * kResTabRow + 2 * KT * 16 * 4;
}

// One pair of a row's table gradients: columns c and c + 1 of a g-wide row.
__device__ __forceinline__ void res_store_drel(__nv_bfloat16* row, int g, int c, float x0,
                                               float x1) {
  if (c + 1 < g && (g & 1) == 0) {
    *reinterpret_cast<uint32_t*>(row + c) = pack_bf16x2(x0, x1);
  } else {
    if (c < g) row[c] = __float2bfloat16_rn(x0);
    if (c + 1 < g) row[c + 1] = __float2bfloat16_rn(x1);
  }
}

template <int D, int KT, int NW, int CHA, int CHB>
__global__ void __launch_bounds__(NW * 32, 1) attn_bwd_resident_kernel(ResBwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int ROWS = KT * 16, CH = D / 8;
  constexpr int TILE = ROWS * D * 2, TAB = ROWS * kResTabRow;
  constexpr int NSLOT = res_bwd_slots<D, KT>();
  // Fewer than seven slots (d = 80, KT = 13): no ring. Q, K, V in slots 0-2,
  // dO in slot 3 or 4 by the round's parity; K and V of the next window-head
  // come in row by row as pass 2 frees them (see the header).
  constexpr bool REFILL = NSLOT < 7;
  constexpr int EARLY = NSLOT - 4 < 4 ? NSLOT - 4 : 4;  // ring: tensors prefetched a round ahead
  constexpr uint32_t TABS = NSLOT * TILE, EYE = TABS + 2 * TAB, STATS = EYE + TAB;
  constexpr int ND = D / 8, KD = D / 16;
  constexpr int MAXT = (KT + NW - 1) / NW;  // 16-row tiles a warp takes
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t base = res_smem_u32(smem_raw);
  float* lse2_s = reinterpret_cast<float*>(smem_raw + STATS);  // lse * log2(e), 0 past n
  float* delta_s = lse2_s + ROWS;
  const int t = threadIdx.x, nthr = blockDim.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int total = a.batch * a.heads;
  const bool want_drel = a.drelh != nullptr;

  res_init<KT, D>(smem_raw, NSLOT, TABS, EYE, a.n, a.gw, t, nthr);
  for (int i = t; i < 2 * ROWS; i += nthr) lse2_s[i] = 0.f;  // rows past n stay 0
  __syncthreads();

  // Rows [r0, r1) of tensor j (0 Q, 1 K, 2 dO, 3 V) of window-head (b, h)
  // into `tile`, by threads tid of nt.
  auto copy_tensor = [&](int j, long long b, int h, uint32_t tile, int r0, int r1, int tid,
                         int nt) {
    if (j == 0) res_copy_tile<D, ROWS>(tile, a.q + b * a.q_bs + h * D, a.q_rs, r1, tid, nt, r0);
    if (j == 1) res_copy_tile<D, ROWS>(tile, a.k + b * a.k_bs + h * D, a.k_rs, r1, tid, nt, r0);
    if (j == 2)
      res_copy_tile<D, ROWS>(tile, a.dout + b * a.do_bs + h * D, a.do_rs, r1, tid, nt, r0);
    if (j == 3) res_copy_tile<D, ROWS>(tile, a.v + b * a.v_bs + h * D, a.v_rs, r1, tid, nt, r0);
  };
  auto copy_tables = [&](long long b, int h, int tab) {
    res_copy_tables(smem_raw, TABS + tab * TAB, a.relh, a.relw, b, h, a.heads, a.n, a.gh,
                    a.gw, t, nthr);
  };
  // The ring: tensor j of a round whose first slot is s0 sits in slot
  // (s0 + j) % NSLOT (0 Q, 1 K, 2 dO, 3 V); the tables of round `it` in
  // buffer it % 2. Written out, not through copy_tensor: through it ptxas
  // scheduled the d-64 kernels otherwise, up to 1 % slower on the H100.
  auto copy_in = [&](int wh, int s0, int tab, int j0, int j1) {
    const long long b = wh / a.heads;
    const int h = wh - (int)b * a.heads;
    for (int j = j0; j < j1; ++j) {
      const uint32_t tile = base + ((s0 + j) % NSLOT) * TILE;
      if (j == 0) res_copy_tile<D, ROWS>(tile, a.q + b * a.q_bs + h * D, a.q_rs, a.n, t, nthr);
      if (j == 1) res_copy_tile<D, ROWS>(tile, a.k + b * a.k_bs + h * D, a.k_rs, a.n, t, nthr);
      if (j == 2)
        res_copy_tile<D, ROWS>(tile, a.dout + b * a.do_bs + h * D, a.do_rs, a.n, t, nthr);
      if (j == 3) res_copy_tile<D, ROWS>(tile, a.v + b * a.v_bs + h * D, a.v_rs, a.n, t, nthr);
    }
    if (j0 == 0) copy_tables(b, h, tab);
  };

  int wh = blockIdx.x;
  if (wh < total) {
    if constexpr (REFILL) {
      const long long b = wh / a.heads;
      const int h = wh - (int)b * a.heads;
      copy_tensor(2, b, h, base + 3 * TILE, 0, a.n, t, nthr);
      copy_tensor(1, b, h, base + TILE, 0, a.n, t, nthr);
      copy_tensor(3, b, h, base + 2 * TILE, 0, a.n, t, nthr);
      copy_tables(b, h, 0);
    } else {
      copy_in(wh, 0, 0, 0, EARLY);
    }
  }
  res_commit();
  int s0 = 0;
  for (int it = 0; wh < total; wh += gridDim.x, ++it, s0 = (s0 + 4) % NSLOT) {
    const long long b = wh / a.heads;
    const int h = wh - (int)b * a.heads;
    const int next = wh + (int)gridDim.x;
    const long long nb = next / a.heads;  // the next window-head's (b, h)
    const int nh = next - (int)nb * a.heads;
    const uint32_t qs = base + (REFILL ? 0 : s0 * TILE);
    const uint32_t ks = base + (REFILL ? 1 : (s0 + 1) % NSLOT) * TILE;
    const uint32_t dos = base + (REFILL ? 3 + (it & 1) : (s0 + 2) % NSLOT) * TILE;
    const uint32_t vs = base + (REFILL ? 2 : (s0 + 3) % NSLOT) * TILE;
    const uint32_t tb = base + TABS + (it & 1) * TAB, eye = base + EYE;

    // What was not prefetched (its slot was in use until the last barrier):
    // V in the ring, Q with the refills.
    if constexpr (REFILL)
      copy_tensor(0, b, h, qs, 0, a.n, t, nthr);
    else
      copy_in(wh, s0, it & 1, EARLY, 4);
    res_commit();

    // This warp's rows of o and lse (tiles warp, warp + NW, ...), from device
    // memory while the copies land: two lanes a row, D / 2 columns each.
    const int dhalf = lane & 1;
    uint4 ov[MAXT][CH / 2];
    float lse_row[MAXT];
#pragma unroll
    for (int ti = 0; ti < MAXT; ++ti) {
      const int drow = (warp + ti * NW) * 16 + (lane >> 1);
      const bf16* og = a.out + b * a.o_bs + h * D + drow * a.o_rs + dhalf * (D / 2);
#pragma unroll
      for (int i = 0; i < CH / 2; ++i)
        ov[ti][i] =
            drow < a.n ? *reinterpret_cast<const uint4*>(og + i * 8) : make_uint4(0u, 0u, 0u, 0u);
      lse_row[ti] =
          (drow < a.n && dhalf == 0) ? a.lse[(b * a.n + drow) * a.heads + h] * kLog2e : 0.f;
    }
    res_wait<1>();
    __syncthreads();  // all but the copy just issued: dO and the tables are in

    // delta[row] = sum_d do * o in f32.
#pragma unroll
    for (int ti = 0; ti < MAXT; ++ti) {
      const int drow = (warp + ti * NW) * 16 + (lane >> 1);
      float sum = 0.f;
      if (drow < a.n) {
#pragma unroll
        for (int i = 0; i < CH / 2; ++i) {
          const int c = dhalf * (CH / 2) + i;
          const uint4 dv4 = *reinterpret_cast<const uint4*>(
              smem_raw + (dos - base) + res_tile_off<D, ROWS>(drow, c, c >= 8));
          const uint32_t dw[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
          const uint32_t ow[4] = {ov[ti][i].x, ov[ti][i].y, ov[ti][i].z, ov[ti][i].w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum += res_lo(dw[j]) * res_lo(ow[j]) + res_hi(dw[j]) * res_hi(ow[j]);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      if (dhalf == 0 && drow < a.n) {
        delta_s[drow] = sum;
        lse2_s[drow] = lse_row[ti];
      }
    }

    // The next window-head's first tensors into the free slots: in the ring
    // Q, K, dO (or all four) and the tables; with the refills dO and the
    // tables.
    if (next < total) {
      if constexpr (REFILL) {
        copy_tensor(2, nb, nh, base + (3 + ((it + 1) & 1)) * TILE, 0, a.n, t, nthr);
        copy_tables(nb, nh, (it + 1) & 1);
      } else {
        copy_in(next, (s0 + 4) % NSLOT, (it + 1) & 1, 0, EARLY);
      }
    }
    res_commit();
    res_wait<1>();
    __syncthreads();  // every tensor is in; lse and delta of every row are visible

    // ---- pass 1: this warp's 16-row query tiles against every key ----------
#pragma unroll 1
    for (int r0 = warp * 16; r0 < a.n; r0 += NW * 16) {
      const int rA = r0 + g, rB = rA + 8;
      const float lseA = lse2_s[rA], lseB = lse2_s[rB];
      const float delA = delta_s[rA], delB = delta_s[rB];
      float dq[ND][4], dt[4][4];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) dq[nd][0] = dq[nd][1] = dq[nd][2] = dq[nd][3] = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) dt[n][0] = dt[n][1] = dt[n][2] = dt[n][3] = 0.f;

#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += CHA) {
        float s[2 * CHA][4], dp[2 * CHA][4];
#pragma unroll
        for (int n = 0; n < 2 * CHA; ++n) {
          s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
          dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
        }
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t qa[4], da[4];
          res_lda<false, D, ROWS>(qa, qs, r0, 2 * kd, lane);
          res_lda<false, D, ROWS>(da, dos, r0, 2 * kd, lane);
          if (a.mode != kResScaleScores) res_scale_regs(qa, a.scale);
#pragma unroll
          for (int i = 0; i < CHA; ++i) {
            if (c0 + i < KT) {
              uint32_t kb[4], vb[4];
              res_ldb<false, D, ROWS>(kb, ks, 16 * (c0 + i), 2 * kd, lane);
              res_ldb<false, D, ROWS>(vb, vs, 16 * (c0 + i), 2 * kd, lane);
              mma_16816(s[2 * i], qa, kb[0], kb[1]);
              mma_16816(s[2 * i + 1], qa, kb[2], kb[3]);
              mma_16816(dp[2 * i], da, vb[0], vb[1]);
              mma_16816(dp[2 * i + 1], da, vb[2], vb[3]);
            }
          }
        }
        if (a.mode == kResScaleScores) {
#pragma unroll
          for (int n = 0; n < 2 * CHA; ++n) {
#pragma unroll
            for (int j = 0; j < 4; ++j) s[n][j] *= a.scale;
          }
        }
#pragma unroll
        for (int ks2 = 0; ks2 < 2; ++ks2) {
          uint32_t ta[4];
          res_lda<true>(ta, tb, r0, 2 * ks2, lane);
#pragma unroll
          for (int i = 0; i < CHA; ++i) {
            if (c0 + i < KT) {
              uint32_t eb[4];
              res_ldb<true>(eb, eye, 16 * (c0 + i), 2 * ks2, lane);
              mma_16816(s[2 * i], ta, eb[0], eb[1]);
              mma_16816(s[2 * i + 1], ta, eb[2], eb[3]);
            }
          }
        }

        // ds = p (dp - delta), rounded to bf16 as the A operand of the
        // products below.
        uint32_t dsa[CHA][4];
#pragma unroll
        for (int i = 0; i < CHA; ++i) {
          if (c0 + i < KT) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int n = 2 * i + half;
              float pv[4];
              pv[0] = res_ex2(fmaf(s[n][0], kLog2e, -lseA));
              pv[1] = res_ex2(fmaf(s[n][1], kLog2e, -lseA));
              pv[2] = res_ex2(fmaf(s[n][2], kLog2e, -lseB));
              pv[3] = res_ex2(fmaf(s[n][3], kLog2e, -lseB));
              if (16 * (c0 + i) + 8 * half + 8 > a.n) {  // a tile that straddles n
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  if (16 * (c0 + i) + 8 * half + 2 * t4 + j >= a.n) pv[j] = pv[j + 2] = 0.f;
                }
              }
              dsa[i][2 * half] =
                  pack_bf16x2(pv[0] * (dp[n][0] - delA), pv[1] * (dp[n][1] - delA));
              dsa[i][2 * half + 1] =
                  pack_bf16x2(pv[2] * (dp[n][2] - delB), pv[3] * (dp[n][3] - delB));
            }
          }
        }

        // dq += ds K and (drel_h | drel_w) += ds E, K and E read transposed
        // in place.
#pragma unroll
        for (int i = 0; i < CHA; ++i) {
          if (c0 + i < KT) {
#pragma unroll
            for (int ndp = 0; ndp < ND / 2; ++ndp) {
              uint32_t kb[4];
              res_ldbt<false, D, ROWS>(kb, ks, 16 * (c0 + i), 2 * ndp, lane);
              mma_16816(dq[2 * ndp], dsa[i], kb[0], kb[1]);
              mma_16816(dq[2 * ndp + 1], dsa[i], kb[2], kb[3]);
            }
            if (want_drel) {
#pragma unroll
              for (int np = 0; np < 2; ++np) {
                uint32_t eb[4];
                res_ldbt<true>(eb, eye, 16 * (c0 + i), 2 * np, lane);
                mma_16816(dt[2 * np], dsa[i], eb[0], eb[1]);
                mma_16816(dt[2 * np + 1], dsa[i], eb[2], eb[3]);
              }
            }
          }
        }
      }

      bf16* dqg = a.dq + b * a.dq_bs + h * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int c = nd * 8 + 2 * t4;
        if (rA < a.n)
          *reinterpret_cast<uint32_t*>(dqg + rA * a.dq_rs + c) =
              pack_bf16x2(dq[nd][0] * a.scale, dq[nd][1] * a.scale);
        if (rB < a.n)
          *reinterpret_cast<uint32_t*>(dqg + rB * a.dq_rs + c) =
              pack_bf16x2(dq[nd][2] * a.scale, dq[nd][3] * a.scale);
      }
      if (want_drel) {
        // dt[0..1]: columns 0..15 of drel_h; dt[2..3]: of drel_w
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          bf16* tabg = n < 2 ? a.drelh : a.drelw;
          const int gg = n < 2 ? a.gh : a.gw, c = (n & 1) * 8 + 2 * t4;
          if (rA < a.n)
            res_store_drel(tabg + ((b * a.n + rA) * a.heads + h) * gg, gg, c, dt[n][0],
                           dt[n][1]);
          if (rB < a.n)
            res_store_drel(tabg + ((b * a.n + rB) * a.heads + h) * gg, gg, c, dt[n][2],
                           dt[n][3]);
        }
      }
    }
    // Pass 1 read every row of K and V; from here on a warp reads only its
    // own rows of them, which the refills replace.
    if constexpr (REFILL) __syncthreads();

    // ---- pass 2: this warp's 16-key tiles against every query --------------
#pragma unroll 1
    for (int r0 = warp * 16; r0 < a.n; r0 += NW * 16) {
      const int rA = r0 + g, rB = rA + 8;
      float dk[ND][4], dv[ND][4];
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
        dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
      }
#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += CHB) {
        float st[2 * CHB][4], dpt[2 * CHB][4];
#pragma unroll
        for (int n = 0; n < 2 * CHB; ++n) {
          st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
          dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
        }
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t ka[4], va[4];
          res_lda<false, D, ROWS>(ka, ks, r0, 2 * kd, lane);
          res_lda<false, D, ROWS>(va, vs, r0, 2 * kd, lane);
          if (a.mode == kResScalePow2) res_scale_regs(ka, a.scale);
#pragma unroll
          for (int i = 0; i < CHB; ++i) {
            if (c0 + i < KT) {
              uint32_t qb[4], db[4];
              res_ldb<false, D, ROWS>(qb, qs, 16 * (c0 + i), 2 * kd, lane);
              res_ldb<false, D, ROWS>(db, dos, 16 * (c0 + i), 2 * kd, lane);
              if (a.mode == kResScaleRoundQ) res_scale_regs(qb, a.scale);
              mma_16816(st[2 * i], ka, qb[0], qb[1]);
              mma_16816(st[2 * i + 1], ka, qb[2], qb[3]);
              mma_16816(dpt[2 * i], va, db[0], db[1]);
              mma_16816(dpt[2 * i + 1], va, db[2], db[3]);
            }
          }
        }
        if (a.mode == kResScaleScores) {
#pragma unroll
          for (int n = 0; n < 2 * CHB; ++n) {
#pragma unroll
            for (int j = 0; j < 4; ++j) st[n][j] *= a.scale;
          }
        }
#pragma unroll
        for (int ks2 = 0; ks2 < 2; ++ks2) {
          uint32_t ea[4];
          res_lda<true>(ea, eye, r0, 2 * ks2, lane);
#pragma unroll
          for (int i = 0; i < CHB; ++i) {
            if (c0 + i < KT) {
              uint32_t tq[4];
              res_ldb<true>(tq, tb, 16 * (c0 + i), 2 * ks2, lane);
              mma_16816(st[2 * i], ea, tq[0], tq[1]);
              mma_16816(st[2 * i + 1], ea, tq[2], tq[3]);
            }
          }
        }

        // p^T and ds^T of keys rA, rB at queries 16 (c0 + i) + 8 half + 2 t4
        // + {0, 1}; queries past n have do = 0 and q = 0 and add nothing.
        uint32_t pta[CHB][4], dsta[CHB][4];
#pragma unroll
        for (int i = 0; i < CHB; ++i) {
          if (c0 + i < KT) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int n = 2 * i + half;
              const int qc = 16 * (c0 + i) + 8 * half + 2 * t4;
              const float2 l2 = *reinterpret_cast<const float2*>(lse2_s + qc);
              const float2 de = *reinterpret_cast<const float2*>(delta_s + qc);
              const float p0 = res_ex2(fmaf(st[n][0], kLog2e, -l2.x));
              const float p1 = res_ex2(fmaf(st[n][1], kLog2e, -l2.y));
              const float p2 = res_ex2(fmaf(st[n][2], kLog2e, -l2.x));
              const float p3 = res_ex2(fmaf(st[n][3], kLog2e, -l2.y));
              pta[i][2 * half] = pack_bf16x2(p0, p1);
              pta[i][2 * half + 1] = pack_bf16x2(p2, p3);
              dsta[i][2 * half] = pack_bf16x2(p0 * (dpt[n][0] - de.x), p1 * (dpt[n][1] - de.y));
              dsta[i][2 * half + 1] =
                  pack_bf16x2(p2 * (dpt[n][2] - de.x), p3 * (dpt[n][3] - de.y));
            }
          }
        }

        // dv += P^T dO and dk += dS^T Q, dO and Q read transposed in place.
#pragma unroll
        for (int i = 0; i < CHB; ++i) {
          if (c0 + i < KT) {
#pragma unroll
            for (int ndp = 0; ndp < ND / 2; ++ndp) {
              uint32_t db[4], qb[4];
              res_ldbt<false, D, ROWS>(db, dos, 16 * (c0 + i), 2 * ndp, lane);
              res_ldbt<false, D, ROWS>(qb, qs, 16 * (c0 + i), 2 * ndp, lane);
              mma_16816(dv[2 * ndp], pta[i], db[0], db[1]);
              mma_16816(dv[2 * ndp + 1], pta[i], db[2], db[3]);
              mma_16816(dk[2 * ndp], dsta[i], qb[0], qb[1]);
              mma_16816(dk[2 * ndp + 1], dsta[i], qb[2], qb[3]);
            }
          }
        }
      }

      bf16* dkg = a.dk + b * a.dk_bs + h * D;
      bf16* dvg = a.dv + b * a.dv_bs + h * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int c = nd * 8 + 2 * t4;
        if (rA < a.n) {
          *reinterpret_cast<uint32_t*>(dkg + rA * a.dk_rs + c) =
              pack_bf16x2(dk[nd][0] * a.scale, dk[nd][1] * a.scale);
          *reinterpret_cast<uint32_t*>(dvg + rA * a.dv_rs + c) = pack_bf16x2(dv[nd][0], dv[nd][1]);
        }
        if (rB < a.n) {
          *reinterpret_cast<uint32_t*>(dkg + rB * a.dk_rs + c) =
              pack_bf16x2(dk[nd][2] * a.scale, dk[nd][3] * a.scale);
          *reinterpret_cast<uint32_t*>(dvg + rB * a.dv_rs + c) = pack_bf16x2(dv[nd][2], dv[nd][3]);
        }
      }
      if constexpr (REFILL) {
        // these K and V rows are spent (only this warp read them in pass 2):
        // the next window-head's into them, waited for at the next round's
        // first res_wait
        __syncwarp();
        if (next < total) {
          const int r1 = min(r0 + 16, a.n);
          copy_tensor(1, nb, nh, ks, r0, r1, lane, 32);
          copy_tensor(3, nb, nh, vs, r0, r1, lane, 32);
        }
        res_commit();
      }
    }
    __syncthreads();  // every slot of this round is free
  }
  res_wait<0>();
}

template <int D, int KT, int NW, int CHA, int CHB>
cudaError_t launch_bwd_resident(const ResBwdArgs& a, cudaStream_t stream) {
  constexpr int smem = res_bwd_smem_bytes<D, KT>();
  static_assert(smem <= kMaxSmemBytes, "shared memory of the backward");
  auto kernel = attn_bwd_resident_kernel<D, KT, NW, CHA, CHB>;
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

// The body of a plain C entry: the arguments of attention_bwd.cuh's kernels
// with the forward's `out` (and its strides) in place of delta, which this
// kernel takes itself. drelh / drelw may be null (not wanted).
template <bool SCALE_SCORES>
int attention_bwd_resident_entry(int dtype, const void* q, const void* k, const void* v,
                                 const void* dout, const void* out, const void* lse,
                                 const void* relh, const void* relw, void* dq, void* dk,
                                 void* dv, void* drelh, void* drelw, int batch, int heads,
                                 int nq, int nk, int d, long long q_bs, long long q_rs,
                                 long long k_bs, long long k_rs, long long v_bs, long long v_rs,
                                 long long do_bs, long long do_rs, long long o_bs,
                                 long long o_rs, long long dq_bs, long long dq_rs,
                                 long long dk_bs, long long dk_rs, long long dv_bs,
                                 long long dv_rs, int gh, int gw, float scale, void* stream) {
  using bf16 = __nv_bfloat16;
  if (!res_shapes_ok(dtype, batch, heads, nq, nk, relh, relw, gh, gw) || (d != 64 && d != 80) ||
      lse == nullptr)
    return (int)cudaErrorInvalidValue;
  ResBwdArgs a;
  a.q = static_cast<const bf16*>(q); a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v); a.dout = static_cast<const bf16*>(dout);
  a.out = static_cast<const bf16*>(out); a.lse = static_cast<const float*>(lse);
  a.relh = static_cast<const bf16*>(relh); a.relw = static_cast<const bf16*>(relw);
  a.dq = static_cast<bf16*>(dq); a.dk = static_cast<bf16*>(dk); a.dv = static_cast<bf16*>(dv);
  const bool drel = drelh != nullptr && drelw != nullptr;
  a.drelh = drel ? static_cast<bf16*>(drelh) : nullptr;
  a.drelw = drel ? static_cast<bf16*>(drelw) : nullptr;
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.do_bs = do_bs; a.do_rs = do_rs;
  a.o_bs = o_bs; a.o_rs = o_rs;
  a.dq_bs = dq_bs; a.dq_rs = dq_rs; a.dk_bs = dk_bs; a.dk_rs = dk_rs;
  a.dv_bs = dv_bs; a.dv_rs = dv_rs;
  a.batch = batch; a.heads = heads; a.n = nq; a.gh = gh; a.gw = gw;
  a.scale = scale;
  a.mode = res_scale_mode(scale, SCALE_SCORES);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 80)
    return (int)(res_key_tiles(nq) == 9 ? launch_bwd_resident<80, 9, 5, 3, 3>(a, s)
                                        : launch_bwd_resident<80, 13, 7, 4, 2>(a, s));
  return (int)(res_key_tiles(nq) == 9 ? launch_bwd_resident<64, 9, 5, 5, 4>(a, s)
                                      : launch_bwd_resident<64, 13, 7, 5, 3>(a, s));
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_BWD_RESIDENT(name, scale_scores)                                 \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v,               \
                      const void* dout, const void* out, const void* lse, const void* relh, \
                      const void* relw, void* dq, void* dk, void* dv, void* drelh,          \
                      void* drelw, int batch, int heads, int nq, int nk, int d,             \
                      long long q_bs, long long q_rs, long long k_bs, long long k_rs,       \
                      long long v_bs, long long v_rs, long long do_bs, long long do_rs,     \
                      long long o_bs, long long o_rs, long long dq_bs, long long dq_rs,     \
                      long long dk_bs, long long dk_rs, long long dv_bs, long long dv_rs,   \
                      int gh, int gw, float scale, void* stream) {                           \
    return wm::attention_bwd_resident_entry<scale_scores>(                                   \
        dtype, q, k, v, dout, out, lse, relh, relw, dq, dk, dv, drelh, drelw, batch, heads, \
        nq, nk, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs, dq_bs,     \
        dq_rs, dk_bs, dk_rs, dv_bs, dv_rs, gh, gw, scale, stream);                           \
  }
