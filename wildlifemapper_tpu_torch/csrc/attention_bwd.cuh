// Backward of the multi-head attention in attention_fwd.cuh: the bodies of
// two kernels. Two sources instantiate them, one nvcc each, as the forward:
//
//   attention_bwd.cu (SCALE_SCORES = false), the packed family:
//   K1 wildlifemapper_tpu/ops/windowed_attention_v2.py::_bwd_kernel (:125)
//   K2 wildlifemapper_tpu/ops/flash_attention_v2.py::_bwd_dq_kernel (:229)
//      and ::_bwd_dkv_kernel (:276)
//   K4 wildlifemapper_tpu/ops/cross_attention.py::_bwd_dq_kernel (:90)
//      and ::_bwd_dkv_kernel (:116)
//
//   grouped_attention_bwd.cu (SCALE_SCORES = true), the grouped family:
//   K5 wildlifemapper_tpu/ops/flash_attention.py::_bwd_kernel (:133)
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::_bwd_kernel (:64)
//
// With s = round(q*scale).k (packed) or (q.k)*scale on the f32 sum
// (grouped), plus rel_h[q, k / gw] + rel_w[q, k % gw], the forward's
// lse[q] = log sum_k exp(s) and delta[q] = sum_d do[q, d]*o[q, d]
// (a plain f32 pass outside the kernels, flash_attention_v2.py:342):
//
//   p  = exp(s - lse)                      dp = do . v^T
//   ds = round(p * (dp - delta))           (rounded to the input type)
//   dq = round((ds . k) * scale)           dk = round((ds^T . q) * scale)
//   dv = round(round(p)^T . do)
//   drel_h[q, r] = round(sum_{k / gw == r} ds[q, k])
//   drel_w[q, c] = round(sum_{k % gw == c} ds[q, k])
//
// * the dq kernel grids q-blocks of 64 rows, streams K/V in 64-key tiles
//   and also reduces ds into the rel-table gradients;
// * the dk/dv kernel grids k-blocks of 64 keys and streams q/do tiles.
// Every element of dq, dk and dv is owned by one thread, and every drel sum
// is added to in a fixed order (one lane at a time, ordered by warp and
// block barriers), so there are no atomics and the result is deterministic.
//
// What bounds it on the H100: 7 N^2 d MACs a head (3 products in the dq
// kernel, 4 in the dk/dv kernel) against O(N d) bytes, so operations. The
// Pallas kernels kept whole K/V (or q/do) resident in VMEM; at N = 4096 that
// is 512 KB a head in bf16 against 227 KB of shared memory a block, so both
// kernels stream tiles and recompute the scores from the saved lse (no max
// pass). K1's Pallas backward recomputes a full softmax and takes
// delta = sum p*dp in the kernel; with lse and rowsum(do*o) the function is
// the same and only a rounding of the working type differs.
//
// Two bodies per kernel, as the forward: bf16 on tensor cores through
// mma.sync m16n8k16 with f32 accumulators (4 warps, 16 rows each, scores and
// ds in registers), and f32 in scalar FMAs without TF32 (parity). q, k, v,
// do and the outputs are read and written by stride, so dq, dk and dv land
// in the column blocks of one packed (B, N, 3C) dqkv.
// Which launches still run here (ops/_attention.py::attention_body): every
// f32 launch (the parity steps of all five kernels), d = 32, every bf16
// backward at d = 80 (ViT-H's K1, K2, K5, K6, whose bf16 forward runs the
// Hopper and the resident bodies and leaves the same lse; no Hopper body for
// the d-80 backward yet), and the bf16
// launches below 512 keys that are no window the resident body holds: d = 128
// or N != M, no rel tables, and a global block of 209 to 511 tokens that
// lands in K1 or K6. The streaming bf16 shapes of K2, K4 and K5 take the
// Hopper bodies of attention_bwd_sm90.cuh (wgmma, a TMA-fed ring), and the
// bf16 windows of K1 and K6 (d = 64, N = M <= 208) the one-kernel body of
// attention_bwd_resident.cuh, which also takes delta; the bf16 bodies here
// stay the yardstick of both.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 256;  // f32 bodies: 4 threads per row
constexpr int TW = 4;         // bf16 bodies: warps per block, 16 rows each

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;     // (B, nq, H)
  const float* delta;   // (B, nq, H)
  const void* relh;     // (B, nq, H, gh) or null
  const void* relw;     // (B, nq, H, gw) or null
  void* dq;
  void* dk;
  void* dv;
  void* drelh;          // (B, nq, H, gh) or null: not wanted
  void* drelw;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;  // element strides
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int heads, nq, nk, gh, gw;
  float scale;
};

// Row length of the rel_h slice a block of BK keys needs: the grid rows its
// keys can touch, plus one float of padding.
__host__ __device__ inline int rel_h_slice(int gw) { return gw > 0 ? BK / gw + 3 : 0; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Adds this tile's ds (rows of `dss`, BK wide with row stride lds; masked
// keys hold 0) into the rel-table gradient rows (row strides sh and sw). The
// caller's threads `lane` of `nlanes` own the tile rows [row0, row0 + nrows).
__device__ __forceinline__ void drel_accumulate(const float* dss, int lds, float* drh,
                                                float* drw, int sh, int sw, int gh, int gw,
                                                int k0, int row0, int nrows, int lane,
                                                int nlanes) {
  const int kw0 = k0 % gw;
  for (int e = lane; e < nrows * gw; e += nlanes) {
    const int row = row0 + e / gw, c = e % gw;
    int j = c - kw0;
    if (j < 0) j += gw;
    float sum = 0.f;
    for (; j < BK; j += gw) sum += dss[row * lds + j];
    drw[row * sw + c] += sum;
  }
  const int rfirst = k0 / gw;
  const int rlast = min((k0 + BK - 1) / gw, gh - 1);
  const int nr = rlast - rfirst + 1;
  for (int e = lane; e < nrows * nr; e += nlanes) {
    const int row = row0 + e / nr, rr = rfirst + e % nr;
    const int j0 = max(rr * gw - k0, 0), j1 = min((rr + 1) * gw - k0, BK);
    float sum = 0.f;
    for (int j = j0; j < j1; ++j) sum += dss[row * lds + j];
    drh[row * sh + rr] += sum;
  }
}

// ---- f32 scalar bodies ------------------------------------------------------

template <int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(THREADS) attn_bwd_dq_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CPT = D / 4;   // dq columns per thread
  constexpr int SPT = BK / 4;  // scores per thread per tile
  float* qs = smem;               // q*scale, or q as it is with SCALE_SCORES
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;      // BQ x BK ds tile
  float* rhs = dss + BQ * LP;     // BQ x gh
  float* rws = rhs + BQ * a.gh;   // BQ x gw
  float* drh = rws + BQ * a.gw;   // BQ x gh, only when drel is wanted
  float* drw = drh + BQ * a.gh;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const bool has_rel = a.relh != nullptr;
  const bool want_drel = a.drelh != nullptr;

  const float* qg = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* dog = static_cast<const float*>(a.dout) + b * a.do_bs + h * D;
  float* dqg = static_cast<float*>(a.dq) + b * a.dq_bs + h * D;

  for (int i = t; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const bool ok = q0 + r < a.nq;
    qs[r * LD + c] = ok ? qg[(q0 + r) * a.q_rs + c] * (SCALE_SCORES ? 1.f : a.scale) : 0.f;
    dos[r * LD + c] = ok ? dog[(q0 + r) * a.do_rs + c] : 0.f;
  }
  if (has_rel) {
    const float* rh = static_cast<const float*>(a.relh);
    const float* rw = static_cast<const float*>(a.relw);
    for (int i = t; i < BQ * a.gh; i += THREADS) {
      const int r = i / a.gh, j = i % a.gh;
      const long long row = (long long)b * a.nq + q0 + r;
      rhs[i] = (q0 + r < a.nq) ? rh[(row * a.heads + h) * a.gh + j] : 0.f;
      if (want_drel) drh[i] = 0.f;
    }
    for (int i = t; i < BQ * a.gw; i += THREADS) {
      const int r = i / a.gw, j = i % a.gw;
      const long long row = (long long)b * a.nq + q0 + r;
      rws[i] = (q0 + r < a.nq) ? rw[(row * a.heads + h) * a.gw + j] : 0.f;
      if (want_drel) drw[i] = 0.f;
    }
  }

  const int r = t >> 2;    // query row within the tile
  const int l4 = t & 3;    // lane within the row's quad
  const bool row_ok = q0 + r < a.nq;
  const long long stat = ((long long)b * a.nq + q0 + r) * a.heads + h;
  const float lse = row_ok ? a.lse[stat] : 0.f;
  const float delta = row_ok ? a.delta[stat] : 0.f;
  float acc[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc[c] = 0.f;

  const int nkt = (a.nk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile consumed; q/do/rel tiles loaded
    for (int i = t; i < BK * D; i += THREADS) {
      const int kr = i / D, c = i % D;
      const bool ok = k0 + kr < a.nk;
      ks[kr * LD + c] = ok ? kg[(k0 + kr) * a.k_rs + c] : 0.f;
      vs[kr * LD + c] = ok ? vg[(k0 + kr) * a.v_rs + c] : 0.f;
    }
    __syncthreads();

    float s[SPT], dp[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = dp[j] = 0.f;
    for (int i = 0; i < D; ++i) {
      const float qv = qs[r * LD + i];
      const float dv = dos[r * LD + i];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        s[j] = fmaf(qv, ks[(l4 + 4 * j) * LD + i], s[j]);
        dp[j] = fmaf(dv, vs[(l4 + 4 * j) * LD + i], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int kidx = k0 + l4 + 4 * j;
      float ds = 0.f;
      if (kidx < a.nk && row_ok) {
        float sv = SCALE_SCORES ? s[j] * a.scale : s[j];
        if (has_rel) sv += rhs[r * a.gh + kidx / a.gw] + rws[r * a.gw + kidx % a.gw];
        ds = expf(sv - lse) * (dp[j] - delta);
      }
      dss[r * LP + l4 + 4 * j] = ds;
    }
    __syncwarp();  // row r's ds values were written by its own quad
    for (int kk = 0; kk < BK; ++kk) {
      const float d = dss[r * LP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = fmaf(d, ks[kk * LD + l4 + 4 * c], acc[c]);
    }
    if (want_drel)
      drel_accumulate(dss, LP, drh, drw, a.gh, a.gw, a.gh, a.gw, k0, r, 1, l4, 4);
  }

  if (want_drel) __syncwarp();  // the quad's last sums, before its lanes read them
  if (row_ok) {
    float* drow = dqg + (q0 + r) * a.dq_rs;
#pragma unroll
    for (int c = 0; c < CPT; ++c) drow[l4 + 4 * c] = acc[c] * a.scale;
    if (want_drel) {
      float* gh_out = static_cast<float*>(a.drelh) + stat * a.gh;
      float* gw_out = static_cast<float*>(a.drelw) + stat * a.gw;
      for (int j = l4; j < a.gh; j += 4) gh_out[j] = drh[r * a.gh + j];
      for (int j = l4; j < a.gw; j += 4) gw_out[j] = drw[r * a.gw + j];
    }
  }
}

template <int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(THREADS) attn_bwd_dkv_kernel(BwdArgs a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int LP = BQ + 1;
  constexpr int CPT = D / 4;   // dk / dv columns per thread
  constexpr int SPT = BQ / 4;  // transposed scores per thread per tile
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qr = vs + BK * LD;       // q as it is: dk takes the unscaled q
  float* dos = qr + BQ * LD;
  float* pt = dos + BQ * LD;      // BK x BQ p^T tile
  float* dst = pt + BK * LP;      // BK x BQ ds^T tile
  float* lses = dst + BK * LP;
  float* deltas = lses + BQ;
  float* bt = deltas + BQ;        // BK x BQ bias^T tile, only with rel tables

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const bool has_rel = a.relh != nullptr;

  const float* qg = static_cast<const float*>(a.q) + b * a.q_bs + h * D;
  const float* kg = static_cast<const float*>(a.k) + b * a.k_bs + h * D;
  const float* vg = static_cast<const float*>(a.v) + b * a.v_bs + h * D;
  const float* dog = static_cast<const float*>(a.dout) + b * a.do_bs + h * D;
  const float* rh = static_cast<const float*>(a.relh);
  const float* rw = static_cast<const float*>(a.relw);

  for (int i = t; i < BK * D; i += THREADS) {
    const int kr = i / D, c = i % D;
    const bool ok = k0 + kr < a.nk;
    ks[kr * LD + c] = ok ? kg[(k0 + kr) * a.k_rs + c] : 0.f;
    vs[kr * LD + c] = ok ? vg[(k0 + kr) * a.v_rs + c] : 0.f;
  }

  const int r = t >> 2;    // key row within the tile
  const int l4 = t & 3;
  const bool key_ok = k0 + r < a.nk;
  float acc_dk[CPT], acc_dv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) acc_dk[c] = acc_dv[c] = 0.f;

  const int nqt = (a.nq + BQ - 1) / BQ;
  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // previous tile consumed; k/v tiles loaded
    for (int i = t; i < BQ * D; i += THREADS) {
      const int qq = i / D, c = i % D;
      const bool ok = q0 + qq < a.nq;
      qr[qq * LD + c] = ok ? qg[(q0 + qq) * a.q_rs + c] : 0.f;
      dos[qq * LD + c] = ok ? dog[(q0 + qq) * a.do_rs + c] : 0.f;
    }
    if (t < BQ) {
      const bool ok = q0 + t < a.nq;
      const long long stat = ((long long)b * a.nq + q0 + t) * a.heads + h;
      lses[t] = ok ? a.lse[stat] : 0.f;
      deltas[t] = ok ? a.delta[stat] : 0.f;
    }
    if (has_rel) {
      for (int i = t; i < BQ * BK; i += THREADS) {
        const int qq = i / BK, kr = i % BK;
        const int kidx = k0 + kr;
        float val = 0.f;
        if (q0 + qq < a.nq && kidx < a.nk) {
          const long long row = ((long long)b * a.nq + q0 + qq) * a.heads + h;
          val = rh[row * a.gh + kidx / a.gw] + rw[row * a.gw + kidx % a.gw];
        }
        bt[kr * LP + qq] = val;
      }
    }
    __syncthreads();

    float s[SPT], dp[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) s[j] = dp[j] = 0.f;
    for (int i = 0; i < D; ++i) {
      const float kv = ks[r * LD + i];
      const float vv = vs[r * LD + i];
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        s[j] = fmaf(qr[(l4 + 4 * j) * LD + i] * (SCALE_SCORES ? 1.f : a.scale), kv, s[j]);
        dp[j] = fmaf(dos[(l4 + 4 * j) * LD + i], vv, dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int qq = l4 + 4 * j;
      float p = 0.f;
      if (key_ok && q0 + qq < a.nq) {
        float sv = SCALE_SCORES ? s[j] * a.scale : s[j];
        if (has_rel) sv += bt[r * LP + qq];
        p = expf(sv - lses[qq]);
      }
      pt[r * LP + qq] = p;
      dst[r * LP + qq] = p * (dp[j] - deltas[qq]);
    }
    __syncwarp();  // key row r's values were written by its own quad
    for (int qq = 0; qq < BQ; ++qq) {
      const float p = pt[r * LP + qq];
      const float d = dst[r * LP + qq];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        acc_dv[c] = fmaf(p, dos[qq * LD + l4 + 4 * c], acc_dv[c]);
        acc_dk[c] = fmaf(d, qr[qq * LD + l4 + 4 * c], acc_dk[c]);
      }
    }
  }

  if (key_ok) {
    float* dkrow = static_cast<float*>(a.dk) + b * a.dk_bs + h * D + (k0 + r) * a.dk_rs;
    float* dvrow = static_cast<float*>(a.dv) + b * a.dv_bs + h * D + (k0 + r) * a.dv_rs;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkrow[l4 + 4 * c] = acc_dk[c] * a.scale;
      dvrow[l4 + 4 * c] = acc_dv[c];
    }
  }
}

// ---- bf16 tensor-core bodies ------------------------------------------------
//
// mma.sync m16n8k16 fragments: thread (g = lane / 4, t4 = lane % 4) of a warp
// holds rows g and g + 8 of the warp's 16 and, of each 8-wide column group,
// columns 2*t4 and 2*t4 + 1. The f32 accumulators of two adjacent column
// groups are the A operand of the next product once rounded to bf16, so ds
// and p never go through shared memory. Tiles whose contraction runs over
// rows are kept transposed in shared memory so B fragments are 32-bit loads.

template <int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(TW * 32) attn_bwd_dq_tc_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;
  constexpr int LKT = BK + 8;   // row length of the transposed K tile
  constexpr int LDS = BK + 1;   // row length of the f32 ds tile
  constexpr int KD = D / 16;    // k-steps over the head dim
  constexpr int NS = BK / 8;    // 8-key groups per tile
  constexpr int ND = D / 8;     // 8-column groups of dq
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);            // [BQ][LD] round(q*scale)
  bf16* dos = qs + BQ * LD;                                // [BQ][LD]
  bf16* ks = dos + BQ * LD;                                // [BK][LD]
  bf16* vs = ks + BK * LD;                                 // [BK][LD]
  bf16* kt = vs + BK * LD;                                 // [D][LKT]
  int* kdh = reinterpret_cast<int*>(kt + D * LKT);         // key -> rel row
  int* kdw = kdh + BK;                                     // key -> rel column
  float* rhs = reinterpret_cast<float*>(kdw + BK);         // BQ x gh
  float* rws = rhs + BQ * a.gh;                            // BQ x gw
  // Only when drel is wanted: the accumulators, rows padded by one float
  // against bank conflicts, and (for grids narrower than 8) the ds tile.
  const int sh = a.gh + 1, sw = a.gw + 1;
  float* drh = rws + BQ * a.gw;                            // [BQ][sh]
  float* drw = drh + BQ * sh;                              // [BQ][sw]
  float* dss = drw + BQ * sw;                              // [BQ][LDS]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_rel = a.relh != nullptr;
  const bool want_drel = a.drelh != nullptr;
  // With a grid at least 8 wide the 4 keys a quad holds of an 8-key group
  // fall in 4 different columns, so the sums go straight from the registers.
  const bool drel_from_regs = a.gw >= 8;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_bs + h * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_bs + h * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_bs + h * D;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * D;
  bf16* dqg = static_cast<bf16*>(a.dq) + b * a.dq_bs + h * D;

  for (int i = t; i < BQ * D; i += TW * 32) {
    const int r = i / D, c = i % D;
    float qv = 0.f, dv = 0.f;
    if (q0 + r < a.nq) {
      qv = __bfloat162float(qg[(q0 + r) * a.q_rs + c]) * (SCALE_SCORES ? 1.f : a.scale);
      dv = __bfloat162float(dog[(q0 + r) * a.do_rs + c]);
    }
    qs[r * LD + c] = __float2bfloat16_rn(qv);
    dos[r * LD + c] = __float2bfloat16_rn(dv);
  }
  if (has_rel) {
    const bf16* rh = static_cast<const bf16*>(a.relh);
    const bf16* rw = static_cast<const bf16*>(a.relw);
    for (int i = t; i < BQ * a.gh; i += TW * 32) {
      const int r = i / a.gh, j = i % a.gh;
      const long long row = (long long)b * a.nq + q0 + r;
      rhs[i] = (q0 + r < a.nq) ? __bfloat162float(rh[(row * a.heads + h) * a.gh + j]) : 0.f;
    }
    for (int i = t; i < BQ * a.gw; i += TW * 32) {
      const int r = i / a.gw, j = i % a.gw;
      const long long row = (long long)b * a.nq + q0 + r;
      rws[i] = (q0 + r < a.nq) ? __bfloat162float(rw[(row * a.heads + h) * a.gw + j]) : 0.f;
    }
    if (want_drel)
      for (int i = t; i < BQ * (sh + sw); i += TW * 32) drh[i] = 0.f;  // drh and drw
  }

  // This thread's rows: rA = g and rB = g + 8 of the warp's 16.
  const int rA = warp * 16 + g, rB = rA + 8;
  const bool okA = q0 + rA < a.nq, okB = q0 + rB < a.nq;
  const long long statA = ((long long)b * a.nq + q0 + rA) * a.heads + h;
  const long long statB = ((long long)b * a.nq + q0 + rB) * a.heads + h;
  const float lseA = okA ? a.lse[statA] : 0.f, lseB = okB ? a.lse[statB] : 0.f;
  const float delA = okA ? a.delta[statA] : 0.f, delB = okB ? a.delta[statB] : 0.f;
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;

  const int nkt = (a.nk + BK - 1) / BK;
  for (int kt_i = 0; kt_i < nkt; ++kt_i) {
    const int k0 = kt_i * BK;
    __syncthreads();  // previous k/v tiles consumed; q/do/rel tiles loaded
    constexpr int VPR = D / 8;  // 16-byte vectors per row (wrapper: aligned rows)
    // Consecutive lanes take consecutive keys, so the transposed stores of a
    // warp fall in consecutive shared-memory words.
    for (int i = t; i < BK * VPR; i += TW * 32) {
      const int kr = i % BK, c = (i / BK) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + kr < a.nk) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + kr) * a.k_rs + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + kr) * a.v_rs + c);
      }
      *reinterpret_cast<uint4*>(ks + kr * LD + c) = kv;
      *reinterpret_cast<uint4*>(vs + kr * LD + c) = vv;
      const bf16* ke = reinterpret_cast<const bf16*>(&kv);
#pragma unroll
      for (int j = 0; j < 8; ++j) kt[(c + j) * LKT + kr] = ke[j];
    }
    if (has_rel && t < BK) {
      const int kidx = k0 + t;
      kdh[t] = kidx / a.gw;
      kdw[t] = kidx - kdh[t] * a.gw;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int c = kd * 16 + 2 * t4;
      uint32_t qa[4], da[4];
      qa[0] = ld32(qs + rA * LD + c);
      qa[1] = ld32(qs + rB * LD + c);
      qa[2] = ld32(qs + rA * LD + c + 8);
      qa[3] = ld32(qs + rB * LD + c + 8);
      da[0] = ld32(dos + rA * LD + c);
      da[1] = ld32(dos + rB * LD + c);
      da[2] = ld32(dos + rA * LD + c + 8);
      da[3] = ld32(dos + rB * LD + c + 8);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const bf16* kp = ks + (n * 8 + g) * LD + c;
        const bf16* vp = vs + (n * 8 + g) * LD + c;
        mma_16816(s[n], qa, ld32(kp), ld32(kp + 8));
        mma_16816(dp[n], da, ld32(vp), ld32(vp + 8));
      }
    }

    // ds = p * (dp - delta), left in s; masked keys and rows give 0.
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = n * 8 + 2 * t4 + j;
        float dsA = 0.f, dsB = 0.f;
        if (k0 + kc < a.nk) {
          float sA = s[n][j], sB = s[n][j + 2];
          if (SCALE_SCORES) {
            sA *= a.scale;
            sB *= a.scale;
          }
          if (has_rel) {
            const int kh = kdh[kc], kw = kdw[kc];
            sA += rhs[rA * a.gh + kh] + rws[rA * a.gw + kw];
            sB += rhs[rB * a.gh + kh] + rws[rB * a.gw + kw];
          }
          if (okA) dsA = __expf(sA - lseA) * (dp[n][j] - delA);
          if (okB) dsB = __expf(sB - lseB) * (dp[n][j + 2] - delB);
        }
        if (want_drel) {  // the sums take ds as the products do: rounded
          dsA = bf16_round(dsA);
          dsB = bf16_round(dsB);
          if (!drel_from_regs) {
            dss[rA * LDS + kc] = dsA;
            dss[rB * LDS + kc] = dsB;
          }
        }
        s[n][j] = dsA;
        s[n][j + 2] = dsB;
      }
    }

    // dQ += dS K, dS rounded to bf16 straight from the registers.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const bf16* kp = kt + (nd * 8 + g) * LKT + kk * 16 + 2 * t4;
        mma_16816(o[nd], pa, ld32(kp), ld32(kp + 8));
      }
    }

    if (want_drel && drel_from_regs) {
      // drel_w: in each step the warp's lanes hold 8 rows x 4 different
      // columns, so their adds never collide; steps are ordered by the
      // warp barrier.
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kc = n * 8 + 2 * t4 + j;
          if (k0 + kc < a.nk) {
            const int kw = kdw[kc];
            drw[rA * sw + kw] += s[n][j];
            drw[rB * sw + kw] += s[n][j + 2];
          }
          __syncwarp();
        }
      }
      // drel_h: a grid row is a run of keys; each thread sums its share of
      // the run, the quad adds up, one lane a row accumulates.
      const int rfirst = k0 / a.gw;
      const int rlast = min(k0 + BK - 1, a.nk - 1) / a.gw;
      for (int rr = rfirst; rr <= rlast; ++rr) {
        float pA = 0.f, pB = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kc = n * 8 + 2 * t4 + j;
            if (k0 + kc < a.nk && kdh[kc] == rr) {
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
          drh[rA * sh + rr] += pA;
          drh[rB * sh + rr] += pB;
        }
      }
    } else if (want_drel) {
      __syncwarp();  // the warp's 16 rows of ds are its own
      drel_accumulate(dss, LDS, drh, drw, sh, sw, a.gh, a.gw, k0, warp * 16, 16, lane, 32);
    }
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t4;
    if (okA)
      *reinterpret_cast<uint32_t*>(dqg + (q0 + rA) * a.dq_rs + c) =
          pack_bf16x2(o[nd][0] * a.scale, o[nd][1] * a.scale);
    if (okB)
      *reinterpret_cast<uint32_t*>(dqg + (q0 + rB) * a.dq_rs + c) =
          pack_bf16x2(o[nd][2] * a.scale, o[nd][3] * a.scale);
  }
  if (want_drel) {
    __syncwarp();
    bf16* gh_out = static_cast<bf16*>(a.drelh);
    bf16* gw_out = static_cast<bf16*>(a.drelw);
    for (int e = lane; e < 16 * a.gh; e += 32) {
      const int row = warp * 16 + e / a.gh, j = e % a.gh;
      if (q0 + row < a.nq)
        gh_out[(((long long)b * a.nq + q0 + row) * a.heads + h) * a.gh + j] =
            __float2bfloat16_rn(drh[row * sh + j]);
    }
    for (int e = lane; e < 16 * a.gw; e += 32) {
      const int row = warp * 16 + e / a.gw, j = e % a.gw;
      if (q0 + row < a.nq)
        gw_out[(((long long)b * a.nq + q0 + row) * a.heads + h) * a.gw + j] =
            __float2bfloat16_rn(drw[row * sw + j]);
    }
  }
}

template <int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(TW * 32) attn_bwd_dkv_tc_kernel(BwdArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;
  constexpr int LT = BQ + 8;    // row length of the transposed q / do tiles
  constexpr int KD = D / 16;    // k-steps over the head dim
  constexpr int ND = D / 8;     // 8-column groups of dk / dv
  // At d = 128 the dk and dv accumulators take 128 registers, so the q tile
  // goes through in two passes of 32 columns to keep s and dp at 16 each.
  constexpr int QP = D > 64 ? 32 : 64;
  constexpr int NSP = QP / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);            // [BK][LD]
  bf16* vs = ks + BK * LD;                                 // [BK][LD]
  bf16* qs = vs + BK * LD;                                 // [BQ][LD] round(q*scale), or q
  bf16* dos = qs + BQ * LD;                                // [BQ][LD]
  bf16* qt = dos + BQ * LD;                                // [D][LT] q as it is
  bf16* dot = qt + D * LT;                                 // [D][LT]
  float* lses = reinterpret_cast<float*>(dot + D * LT);    // [BQ]
  float* deltas = lses + BQ;                               // [BQ]
  // With rel tables, per q tile: every column of rel_w and the few columns
  // of rel_h that this block's 64 keys touch (rows padded by one float).
  const int sw = a.gw + 1;
  const int sh = rel_h_slice(a.gw);
  float* rws = deltas + BQ;                                // [BQ][sw]
  float* rhs = rws + BQ * sw;                              // [BQ][sh]

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool has_rel = a.relh != nullptr;
  const bf16* qg = static_cast<const bf16*>(a.q) + b * a.q_bs + h * D;
  const bf16* kg = static_cast<const bf16*>(a.k) + b * a.k_bs + h * D;
  const bf16* vg = static_cast<const bf16*>(a.v) + b * a.v_bs + h * D;
  const bf16* dog = static_cast<const bf16*>(a.dout) + b * a.do_bs + h * D;
  const bf16* rh = static_cast<const bf16*>(a.relh);
  const bf16* rw = static_cast<const bf16*>(a.relw);

  constexpr int VPR = D / 8;  // 16-byte vectors per row (wrapper: aligned rows)
  for (int i = t; i < BK * VPR; i += TW * 32) {
    const int kr = i / VPR, c = (i % VPR) * 8;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
    if (k0 + kr < a.nk) {
      kv = *reinterpret_cast<const uint4*>(kg + (k0 + kr) * a.k_rs + c);
      vv = *reinterpret_cast<const uint4*>(vg + (k0 + kr) * a.v_rs + c);
    }
    *reinterpret_cast<uint4*>(ks + kr * LD + c) = kv;
    *reinterpret_cast<uint4*>(vs + kr * LD + c) = vv;
  }

  // This thread's key rows: rA = g and rB = g + 8 of the warp's 16, and
  // their places in the rel grid (row relative to the block's first).
  const int rA = warp * 16 + g, rB = rA + 8;
  const bool okA = k0 + rA < a.nk, okB = k0 + rB < a.nk;
  int rfirst = 0, nrh = 0, khA = 0, khB = 0, kwA = 0, kwB = 0;
  if (has_rel) {
    rfirst = k0 / a.gw;
    nrh = min(k0 + BK - 1, a.nk - 1) / a.gw - rfirst + 1;
    if (okA) {
      khA = (k0 + rA) / a.gw - rfirst;
      kwA = (k0 + rA) % a.gw;
    }
    if (okB) {
      khB = (k0 + rB) / a.gw - rfirst;
      kwB = (k0 + rB) % a.gw;
    }
  }
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    dk[nd][0] = dk[nd][1] = dk[nd][2] = dk[nd][3] = 0.f;
    dv[nd][0] = dv[nd][1] = dv[nd][2] = dv[nd][3] = 0.f;
  }

  const int nqt = (a.nq + BQ - 1) / BQ;
  for (int qt_i = 0; qt_i < nqt; ++qt_i) {
    const int q0 = qt_i * BQ;
    __syncthreads();  // previous q/do tiles consumed; k/v tiles loaded
    // Consecutive lanes take consecutive queries, so the transposed stores
    // of a warp fall in consecutive shared-memory words.
    for (int i = t; i < BQ * VPR; i += TW * 32) {
      const int qq = i % BQ, c = (i / BQ) * 8;
      uint4 qv = make_uint4(0u, 0u, 0u, 0u), dvv = qv;
      if (q0 + qq < a.nq) {
        qv = *reinterpret_cast<const uint4*>(qg + (q0 + qq) * a.q_rs + c);
        dvv = *reinterpret_cast<const uint4*>(dog + (q0 + qq) * a.do_rs + c);
      }
      const bf16* qe = reinterpret_cast<const bf16*>(&qv);
      const bf16* de = reinterpret_cast<const bf16*>(&dvv);
      __align__(16) bf16 sc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j] = SCALE_SCORES ? qe[j] : __float2bfloat16_rn(__bfloat162float(qe[j]) * a.scale);
        qt[(c + j) * LT + qq] = qe[j];
        dot[(c + j) * LT + qq] = de[j];
      }
      *reinterpret_cast<uint4*>(qs + qq * LD + c) = *reinterpret_cast<const uint4*>(sc);
      *reinterpret_cast<uint4*>(dos + qq * LD + c) = dvv;
    }
    if (t < BQ) {
      const bool ok = q0 + t < a.nq;
      const long long stat = ((long long)b * a.nq + q0 + t) * a.heads + h;
      lses[t] = ok ? a.lse[stat] : 0.f;
      deltas[t] = ok ? a.delta[stat] : 0.f;
    }
    if (has_rel) {
      if (a.gw % 8 == 0) {  // rows of rel_w start on 16-byte boundaries
        const int vpr = a.gw / 8;
        for (int i = t; i < BQ * vpr; i += TW * 32) {
          const int qq = i / vpr, c = (i % vpr) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (q0 + qq < a.nq) {
            const long long row = ((long long)b * a.nq + q0 + qq) * a.heads + h;
            v = *reinterpret_cast<const uint4*>(rw + row * a.gw + c);
          }
          const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j) rws[qq * sw + c + j] = __bfloat162float(e[j]);
        }
      } else {
        for (int i = t; i < BQ * a.gw; i += TW * 32) {
          const int qq = i / a.gw, c = i % a.gw;
          const long long row = ((long long)b * a.nq + q0 + qq) * a.heads + h;
          rws[qq * sw + c] = (q0 + qq < a.nq) ? __bfloat162float(rw[row * a.gw + c]) : 0.f;
        }
      }
      for (int i = t; i < BQ * nrh; i += TW * 32) {
        const int qq = i / nrh, j = i % nrh;
        const long long row = ((long long)b * a.nq + q0 + qq) * a.heads + h;
        rhs[qq * sh + j] =
            (q0 + qq < a.nq) ? __bfloat162float(rh[row * a.gh + rfirst + j]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int pass = 0; pass < BQ / QP; ++pass) {
      const int qb = pass * QP;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x QP queries per warp.
      float s[NSP][4], dp[NSP][4];
#pragma unroll
      for (int n = 0; n < NSP; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const int c = kd * 16 + 2 * t4;
        uint32_t ka[4], va[4];
        ka[0] = ld32(ks + rA * LD + c);
        ka[1] = ld32(ks + rB * LD + c);
        ka[2] = ld32(ks + rA * LD + c + 8);
        ka[3] = ld32(ks + rB * LD + c + 8);
        va[0] = ld32(vs + rA * LD + c);
        va[1] = ld32(vs + rB * LD + c);
        va[2] = ld32(vs + rA * LD + c + 8);
        va[3] = ld32(vs + rB * LD + c + 8);
#pragma unroll
        for (int n = 0; n < NSP; ++n) {
          const bf16* qp = qs + (qb + n * 8 + g) * LD + c;
          const bf16* dp_ = dos + (qb + n * 8 + g) * LD + c;
          mma_16816(s[n], ka, ld32(qp), ld32(qp + 8));
          mma_16816(dp[n], va, ld32(dp_), ld32(dp_ + 8));
        }
      }

      // p^T into dp and ds^T into s; masked keys and queries give 0.
#pragma unroll
      for (int n = 0; n < NSP; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qc = qb + n * 8 + 2 * t4 + j;
          float pA = 0.f, pB = 0.f;
          if (q0 + qc < a.nq) {
            float sA = s[n][j], sB = s[n][j + 2];
            if (SCALE_SCORES) {
              sA *= a.scale;
              sB *= a.scale;
            }
            if (has_rel) {
              sA += rhs[qc * sh + khA] + rws[qc * sw + kwA];
              sB += rhs[qc * sh + khB] + rws[qc * sw + kwB];
            }
            const float l = lses[qc];
            if (okA) pA = __expf(sA - l);
            if (okB) pB = __expf(sB - l);
          }
          const float del = deltas[qc];
          s[n][j] = pA * (dp[n][j] - del);
          s[n][j + 2] = pB * (dp[n][j + 2] - del);
          dp[n][j] = pA;
          dp[n][j + 2] = pB;
        }
      }

      // dK += dS^T Q and dV += P^T dO over this pass's queries.
#pragma unroll
      for (int kk = 0; kk < QP / 16; ++kk) {
        uint32_t sa[4], pa[4];
        sa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        sa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        sa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        sa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        pa[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        pa[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        pa[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        pa[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const bf16* qp = qt + (nd * 8 + g) * LT + qb + kk * 16 + 2 * t4;
          const bf16* dp_ = dot + (nd * 8 + g) * LT + qb + kk * 16 + 2 * t4;
          mma_16816(dk[nd], sa, ld32(qp), ld32(qp + 8));
          mma_16816(dv[nd], pa, ld32(dp_), ld32(dp_ + 8));
        }
      }
    }
  }

  bf16* dkg = static_cast<bf16*>(a.dk) + b * a.dk_bs + h * D;
  bf16* dvg = static_cast<bf16*>(a.dv) + b * a.dv_bs + h * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int c = nd * 8 + 2 * t4;
    if (okA) {
      *reinterpret_cast<uint32_t*>(dkg + (k0 + rA) * a.dk_rs + c) =
          pack_bf16x2(dk[nd][0] * a.scale, dk[nd][1] * a.scale);
      *reinterpret_cast<uint32_t*>(dvg + (k0 + rA) * a.dv_rs + c) =
          pack_bf16x2(dv[nd][0], dv[nd][1]);
    }
    if (okB) {
      *reinterpret_cast<uint32_t*>(dkg + (k0 + rB) * a.dk_rs + c) =
          pack_bf16x2(dk[nd][2] * a.scale, dk[nd][3] * a.scale);
      *reinterpret_cast<uint32_t*>(dvg + (k0 + rB) * a.dv_rs + c) =
          pack_bf16x2(dv[nd][2], dv[nd][3]);
    }
  }
}

// ---- launchers ----------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, const BwdArgs& a, dim3 grid, int threads,
                          size_t smem, cudaStream_t stream) {
  // the batch rides blockIdx.z and the heads blockIdx.y
  if (smem > (size_t)kMaxSmemBytes || grid.y > 65535u || grid.z > 65535u)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool SCALE_SCORES>
cudaError_t launch_dq(const BwdArgs& a, bool bf16, int batch, cudaStream_t stream) {
  const dim3 grid((a.nq + BQ - 1) / BQ, a.heads, batch);
  const int rel = BQ * (a.gh + a.gw) * (a.drelh != nullptr ? 2 : 1);
  if (bf16) {
    size_t smem = 2 * (4 * BQ * (D + 8) + D * (BK + 8)) + 4 * (2 * BK + rel);
    if (a.drelh != nullptr) {
      smem += 4 * 2 * BQ;                             // the accumulators' row padding
      if (a.gw < 8) smem += 4 * BQ * (BK + 1);        // the ds tile
    }
    return launch_kernel(attn_bwd_dq_tc_kernel<D, SCALE_SCORES>, a, grid, TW * 32, smem, stream);
  }
  const size_t smem = 4 * (size_t)(4 * BQ * (D + 1) + BQ * (BK + 1) + rel);
  return launch_kernel(attn_bwd_dq_kernel<D, SCALE_SCORES>, a, grid, THREADS, smem, stream);
}

template <int D, bool SCALE_SCORES>
cudaError_t launch_dkv(const BwdArgs& a, bool bf16, int batch, cudaStream_t stream) {
  const dim3 grid((a.nk + BK - 1) / BK, a.heads, batch);
  const int bias = a.relh != nullptr ? BK * (BQ + 1) : 0;
  if (bf16) {
    const int rel = a.relh != nullptr ? BQ * (a.gw + 1 + rel_h_slice(a.gw)) : 0;
    const size_t smem = 2 * (4 * BQ * (D + 8) + 2 * D * (BQ + 8)) + 4 * (2 * BQ + rel);
    return launch_kernel(attn_bwd_dkv_tc_kernel<D, SCALE_SCORES>, a, grid, TW * 32, smem, stream);
  }
  const size_t smem = 4 * (size_t)(4 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ + bias);
  return launch_kernel(attn_bwd_dkv_kernel<D, SCALE_SCORES>, a, grid, THREADS, smem, stream);
}

// The body of a plain C entry. Pointers and element strides as in BwdArgs.
// `which` is 0 for the dq kernel (writes dq and, when drelh/drelw are given,
// the rel-table gradients) and 1 for the dk/dv kernel. relh/relw may be null
// (no bias). Returns the cudaError_t of the launch.
template <bool SCALE_SCORES>
int attention_bwd_entry(int which, int dtype, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        const void* relh, const void* relw, void* dq, void* dk, void* dv,
                        void* drelh, void* drelw, int batch, int heads, int nq, int nk, int d,
                        long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                        long long v_bs, long long v_rs, long long do_bs, long long do_rs,
                        long long dq_bs, long long dq_rs, long long dk_bs, long long dk_rs,
                        long long dv_bs, long long dv_rs, int gh, int gw, float scale,
                        void* stream) {
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.relh = relh; a.relw = relh ? relw : nullptr;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.drelh = relh ? drelh : nullptr; a.drelw = relh ? drelw : nullptr;
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.do_bs = do_bs; a.do_rs = do_rs;
  a.dq_bs = dq_bs; a.dq_rs = dq_rs; a.dk_bs = dk_bs; a.dk_rs = dk_rs;
  a.dv_bs = dv_bs; a.dv_rs = dv_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = relh ? gh : 0; a.gw = relh ? gw : 0;
  a.scale = scale;
  if (dtype != kFloat32 && dtype != kBFloat16) return (int)cudaErrorInvalidValue;
  const bool bf16 = dtype == kBFloat16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    switch (d) {
      case 32: return (int)launch_dq<32, SCALE_SCORES>(a, bf16, batch, s);
      case 64: return (int)launch_dq<64, SCALE_SCORES>(a, bf16, batch, s);
      case 80: return (int)launch_dq<80, SCALE_SCORES>(a, bf16, batch, s);
      case 128: return (int)launch_dq<128, SCALE_SCORES>(a, bf16, batch, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (which == 1) {
    switch (d) {
      case 32: return (int)launch_dkv<32, SCALE_SCORES>(a, bf16, batch, s);
      case 64: return (int)launch_dkv<64, SCALE_SCORES>(a, bf16, batch, s);
      case 80: return (int)launch_dkv<80, SCALE_SCORES>(a, bf16, batch, s);
      case 128: return (int)launch_dkv<128, SCALE_SCORES>(a, bf16, batch, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_BWD(name, scale_scores)                                          \
  extern "C" int name(int which, int dtype, const void* q, const void* k, const void* v,    \
                      const void* dout, const void* lse, const void* delta,                 \
                      const void* relh, const void* relw, void* dq, void* dk, void* dv,     \
                      void* drelh, void* drelw, int batch, int heads, int nq, int nk,       \
                      int d, long long q_bs, long long q_rs, long long k_bs,                \
                      long long k_rs, long long v_bs, long long v_rs, long long do_bs,      \
                      long long do_rs, long long dq_bs, long long dq_rs, long long dk_bs,   \
                      long long dk_rs, long long dv_bs, long long dv_rs, int gh, int gw,    \
                      float scale, void* stream) {                                           \
    return wm::attention_bwd_entry<scale_scores>(                                            \
        which, dtype, q, k, v, dout, lse, delta, relh, relw, dq, dk, dv, drelh, drelw,      \
        batch, heads, nq, nk, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, dq_bs,   \
        dq_rs, dk_bs, dk_rs, dv_bs, dv_rs, gh, gw, scale, stream);                           \
  }
