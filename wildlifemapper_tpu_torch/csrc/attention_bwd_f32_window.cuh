// Backward of the windowed attention in f32 on Hopper's CUDA cores: one
// kernel a window-head, register-tiled, delta inside. Two sources
// instantiate it, one nvcc each:
//
//   attention_bwd_f32_window.cu (SCALE_SCORES = false), the packed family:
//   K1 wildlifemapper_tpu/ops/windowed_attention_v2.py::_bwd_kernel (:125,
//      pallas_call :260)
//
//   grouped_attention_bwd_f32_window.cu (SCALE_SCORES = true), the grouped
//   family:
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::_bwd_kernel (:64,
//      pallas_call :173)
//
// The function is the tile body's (attention_bwd.cuh), with each family's
// rounding points: s = (q*scale).k (packed) or (q.k)*scale (grouped), plus
// bias = rel_h[q, k / gw] + rel_w[q, k % gw]; p = exp(s - lse) from the
// forward's lse; delta = rowsum(do * o); ds = p * (dp - delta) with
// dp = do . v^T; dq = (ds . k) * scale, dk = (ds^T . q) * scale,
// dv = p^T . do; drel_h / drel_w the sums of ds over k / gw and k % gw,
// written only when wanted. No TF32: every product is an f32 FMA.
// ops/_attention.py::attention_body sends here the f32 backward of the
// windows the bf16 resident body takes: d = 64 or 80, N = M <= 208, rel
// tables at most 16 wide (K1 and K6 at 196 and 144 tokens, ViT-H's d-80
// windows). d 32 and everything past those limits stay on the tile body.
//
// What bounds it on the H100: operations. A window-head is 5 N^2 d MACs of
// the function (10 BW H N^2 d f32 operations: 29.5 GFLOP, 0.443 ms at
// 67 TFLOP/s for BW 100, H 12, N 196, d 64) against O(N d) bytes. The tile
// body took 6.98 ms there: a plain delta pass that wrote f32 products of do
// and o, two kernels that each recomputed S and dP over 64 x 64 tiles padded
// to 256 x 256, one row a thread (every FMA one shared-memory load), the
// table gradients added into shared memory one lane at a time. On the CUDA
// cores shared memory bounds a product before the FMA pipes do: an SM
// delivers 128 bytes a clock to its 128 FMA lanes, and registers bound how
// far ahead a thread can load. The design:
//  * one owner a window-head: every dq, dk, dv and table-gradient element
//    is summed by one thread in a fixed order, so there are no atomics and a
//    repeated call is bit-identical. One kernel, two blocks a window-head:
//    the first runs pass 1, the second pass 2, each taking lse and delta
//    itself, so nothing passes between them (11-13 % faster at 196 tokens
//    than one block running both passes);
//  * two passes with the resident side swapped, because the four f32
//    operands of a 208-row window (213 KB at d 64) do not fit beside the
//    tiles. Pass 1 keeps q (scaled in the packed family) and do of the
//    window-head resident, k-major, and walks its keys in slabs of 32 rows
//    (K and V by 16-byte cp.async, double-buffered: the next slab's copy runs
//    under this slab's products): S and dP, p and ds into a tile, then
//    dq += ds . K and the table gradients. Pass 2 keeps K (scaled in the
//    packed family) and V resident and walks the queries in slabs of 32 (q,
//    do and their table rows) twice: S^T and dv += p^T . do, then S^T, dP^T
//    and dk += ds^T . q. Eight products, one more than the bf16 resident
//    body, so that a thread holds one set of gradient accumulators (the
//    seven-product pass 2, dk and dv together, spilled); dq, dk and dv stay
//    in registers over their walk and are written once;
//  * delta inside: two lanes a row take rowsum(do * o) as a block loads do;
//    it stays in shared memory beside lse, and no plain pass runs;
//  * register tiles of 8 x 4 (the f32 streaming body's fb_scores): a warp
//    takes 32 resident rows, a thread 8 of them (two 128-bit loads a step)
//    and 4 streamed rows (one 128-bit load each per 4 columns), 12 shared
//    loads for 128 FMAs, 2.67 FMAs a float; the gradient products are 8 x 8
//    (8 x 10 at d 80) a thread, 4 loads for 64 FMAs. 5 warps (160 threads)
//    hold up to 160 tokens, so a 144-token window pads to 160. A 196-token
//    window takes 7 warps of 28 rows, 7 x 4 tiles (a thread drops the last
//    of its 8 rows, fw_real / fw_index map tokens to the 28 of every 32
//    indices): no padded resident row, 6 % faster than 7 warps of 32 rows
//    whose last warp is mostly padding; 197 to 224 tokens take 7 warps of 32;
//  * the tables by whole grid rows: a key slab of pass 1 is floor(32 / gw)
//    whole grid rows (28 keys at gw 14, 24 at gw 12), so each key slot keeps
//    one grid column over the walk. Thread t owns query row t: it stages its
//    row of rel_w in shared memory once, writes the slab's bias into the
//    tile from it and the slab's rel_h before the score product, and after
//    the product reads its row of the ds tile, writes drel_h for the slab's
//    grid rows and adds into its 16 drel_w sums in registers, written once
//    after the walk. Pass 2 reads each query's rel_h | rel_w row from the
//    slab's stage. Nothing is added into shared memory lane by lane, and no
//    product waits on a table load from device memory;
//  * d 64 and 80 are template instances, as are 5 and 7 warps and 7 or 8
//    rows a thread.
// Shared memory (f32_window_smem_bytes in ops/_attention.py): two resident
// [D][T] tensors, two stages of two [32][D + 4] slabs, the [32][T + 4]
// bias / p / ds tile, lse and delta, and the tables: 194,816 B at d 64 and
// 231,680 B at d 80 for 224 rows, of the 232,448 a block may have: one
// block an SM; registers up to 255 a thread (__launch_bounds__(32 * W, 1)),
// 0 bytes spilled, and chip_smoke.py phase 1 prints ptxas's counts and
// fails on a spill.
//
// Keys and rows past n are zeros in shared memory and their p is forced to
// zero, so they add nothing; they are not written.

#pragma once

#include "attention_bwd_f32.cuh"

namespace wm {
namespace {

constexpr int kFwSlab = 32;        // streamed rows a slab: keys (pass 1), queries (pass 2)
constexpr int kFwMaxTokens = 224;  // 7 warps of 32 resident rows
constexpr int kFwMaxGrid = 16;     // table columns a row: drel_w sums a thread holds
constexpr int kFwTabRow = 2 * kFwMaxGrid + 1;  // a query's rel_h | rel_w in pass 2's stage

// The tables' region: pass 1's rel_w of every resident row [kFwMaxGrid][T],
// or pass 2's two stages of a slab's rel_h | rel_w rows [kFwSlab][kFwTabRow].
__host__ __device__ constexpr int fw_tab_floats(int t) {
  return kFwMaxGrid * t > 2 * kFwSlab * kFwTabRow ? kFwMaxGrid * t : 2 * kFwSlab * kFwTabRow;
}

// Shared-memory bytes of an instantiation: D head columns, W warps.
__host__ __device__ constexpr int fw_smem_bytes(int d, int w) {
  return 4 * (2 * d * 32 * w + 2 * 2 * kFwSlab * (d + 4) + kFwSlab * (32 * w + 4) + 2 * 32 * w +
              fw_tab_floats(32 * w));
}

// A thread's R resident rows (R = 8, or 7 without its row e = 7) are the
// rows fb_row(r0, e) of the block's index space of 32 W rows: a warp's
// 32 rows, or 28 of them at R = 7 (the holes at 19, 23, 27 and 31 of each
// warp's 32 take no FMA). fw_real maps an index to its token (-1: a hole),
// fw_index a token to its index.
template <int R>
__device__ __forceinline__ int fw_real(int idx) {
  if (R == 8) return idx;
  const int w = idx >> 5, i = idx & 31;
  if (i < 16) return 28 * w + i;
  const int k = (i - 16) & 3;
  return k == 3 ? -1 : 28 * w + 16 + 3 * ((i - 16) >> 2) + k;
}
template <int R>
__device__ __forceinline__ int fw_index(int tok) {
  if (R == 8) return tok;
  const int w = tok / 28, i = tok - 28 * w;
  return i < 16 ? 32 * w + i : 32 * w + 16 + 4 * ((i - 16) / 3) + (i - 16) % 3;
}

// acc[e][n] += sum_c at[c * lda + fb_row(r0, e)] * b[(j0 + 8n) * ldb + c],
// e < R, c = 0 .. D-1 in order: fb_scores with R rows and its column loop
// unrolled twice (8 + N shared loads for 4 R N FMAs every 4 c; unrolled
// fully, four instantiations spilled 12-20 B and the body ran 1.5x slower).
template <int D, int N, int R>
__device__ __forceinline__ void fw_scores(float (&acc)[R][N], const float* at, int lda, int r0,
                                          const float* b, int ldb, int j0) {
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 bv[N];
#pragma unroll
    for (int n = 0; n < N; ++n) bv[n] = fb_ld4(b + (j0 + 8 * n) * ldb + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 lo = fb_ld4(at + (c + cc) * lda + r0);
      const float4 hi = fb_ld4(at + (c + cc) * lda + r0 + 16);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float bn = fb_at(bv[n], cc);
        acc[0][n] = fmaf(lo.x, bn, acc[0][n]);
        acc[1][n] = fmaf(lo.y, bn, acc[1][n]);
        acc[2][n] = fmaf(lo.z, bn, acc[2][n]);
        acc[3][n] = fmaf(lo.w, bn, acc[3][n]);
        acc[4][n] = fmaf(hi.x, bn, acc[4][n]);
        acc[5][n] = fmaf(hi.y, bn, acc[5][n]);
        acc[6][n] = fmaf(hi.z, bn, acc[6][n]);
        if constexpr (R == 8) acc[R - 1][n] = fmaf(hi.w, bn, acc[R - 1][n]);
      }
    }
  }
}

// The output columns a thread holds in a gradient product, 8 (10 at d 80):
// 4lk .. 4lk+3, 32+4lk .. 32+4lk+3 and at d 80 64+lk, 72+lk.
// acc[e][x] += sum_j g[j * ldg + fb_row(r0, e)] * b[j * ldb + col_x], j = 0 ..
// J-1 in order: `g` streamed-major (p or ds), `b` row-major (K, q or do).
// 4 shared loads (6 at d 80) for 8 R (10 R) FMAs.
template <int D, int R>
__device__ __forceinline__ void fw_grad(float (&acc)[R][D / 8], const float* g, int ldg, int r0,
                                        const float* b, int ldb, int lk, int J) {
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const float4 lo = fb_ld4(g + j * ldg + r0);
    const float4 hi = fb_ld4(g + j * ldg + r0 + 16);
    const float4 b0 = fb_ld4(b + j * ldb + 4 * lk);
    const float4 b1 = fb_ld4(b + j * ldb + 32 + 4 * lk);
    float bx[D / 8];
    bx[0] = b0.x;
    bx[1] = b0.y;
    bx[2] = b0.z;
    bx[3] = b0.w;
    bx[4] = b1.x;
    bx[5] = b1.y;
    bx[6] = b1.z;
    bx[7] = b1.w;
    if constexpr (D == 80) {
      bx[8] = b[j * ldb + 64 + lk];
      bx[9] = b[j * ldb + 72 + lk];
    }
#pragma unroll
    for (int x = 0; x < D / 8; ++x) {
      acc[0][x] = fmaf(lo.x, bx[x], acc[0][x]);
      acc[1][x] = fmaf(lo.y, bx[x], acc[1][x]);
      acc[2][x] = fmaf(lo.z, bx[x], acc[2][x]);
      acc[3][x] = fmaf(lo.w, bx[x], acc[3][x]);
      acc[4][x] = fmaf(hi.x, bx[x], acc[4][x]);
      acc[5][x] = fmaf(hi.y, bx[x], acc[5][x]);
      acc[6][x] = fmaf(hi.z, bx[x], acc[6][x]);
      if constexpr (R == 8) acc[R - 1][x] = fmaf(hi.w, bx[x], acc[R - 1][x]);
    }
  }
}

// A thread's R x 4 tile into the streamed-major tile (row stride ld):
// element [e][n] at x[(j0 + 8n) * ld + fb_row(r0, e)] (a hole gets 0).
template <int R>
__device__ __forceinline__ void fw_put(float* x, int ld, int r0, int j0, const float (&v)[R][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float* at = x + (j0 + 8 * n) * ld + r0;
    *reinterpret_cast<float4*>(at) = make_float4(v[0][n], v[1][n], v[2][n], v[3][n]);
    *reinterpret_cast<float4*>(at + 16) =
        make_float4(v[4][n], v[5][n], v[6][n], R == 8 ? v[R - 1][n] : 0.f);
  }
}

template <int D>
__device__ __forceinline__ void fw_store_row(float* row, const float (&acc)[D / 8], float mul,
                                             int lk) {
  *reinterpret_cast<float4*>(row + 4 * lk) =
      make_float4(acc[0] * mul, acc[1] * mul, acc[2] * mul, acc[3] * mul);
  *reinterpret_cast<float4*>(row + 32 + 4 * lk) =
      make_float4(acc[4] * mul, acc[5] * mul, acc[6] * mul, acc[7] * mul);
  if constexpr (D == 80) {
    row[64 + lk] = acc[8] * mul;
    row[72 + lk] = acc[9] * mul;
  }
}

template <int R, int N>
__device__ __forceinline__ void fw_zero(float (&acc)[R][N]) {
#pragma unroll
  for (int e = 0; e < R; ++e)
#pragma unroll
    for (int x = 0; x < N; ++x) acc[e][x] = 0.f;
}

// Tokens of a window-head's tensor into a k-major resident tile [D][T] at
// their indices: two lanes a token, each its 16-byte chunks part, part + 2,
// ... (element c at dst[c * T + fw_index(tok)]), times `mul`; zeros past n.
template <int D, int T, int R>
__device__ __forceinline__ void fw_resident(float* dst, const float* src, int rs, int n,
                                            float mul) {
  const int part = threadIdx.x & 1;
  for (int tok = threadIdx.x >> 1; tok < T / 8 * R; tok += T / 2) {
    const bool ok = tok < n;
    const int gr = ok ? tok : 0, idx = fw_index<R>(tok);
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      const int c = 4 * (part + 2 * m);
      const float4 v = fb_ldg4(src + gr * rs + c, ok);
#pragma unroll
      for (int x = 0; x < 4; ++x) dst[(c + x) * T + idx] = fb_at(v, x) * mul;
    }
  }
}

// Two blocks a window-head (blockIdx.x = 2 * (b * heads + h) + part): part 0
// runs pass 1 (dq and the table gradients), part 1 pass 2 (dv, then dk). W warps
// of 32 resident indices, R of every 8 a thread's rows (T / 8 * R tokens).
template <int D, int W, int R, bool SCALE_SCORES>
__global__ void __launch_bounds__(32 * W, 1) attn_bwd_f32_window_kernel(F32BwdArgs a) {
  constexpr int T = 32 * W;       // threads, resident indices, and the resident tiles' row stride
  constexpr int LDX = T + 4;      // row stride of the p / ds tile
  constexpr int S = kFwSlab;
  constexpr int LDT = D + 4;      // row stride of a slab
  constexpr int CH = D / 4;       // 16-byte chunks a row
  constexpr int NC = D / 8;
  constexpr int STAGE = 2 * S * LDT;
  extern __shared__ __align__(16) float smem[];
  float* ra = smem;               // [D][T] q*scale (packed) or q; then K*scale or K
  float* rb = ra + D * T;         // [D][T] do; then V
  float* stages = rb + D * T;     // two stages of two [S][LDT] slabs: K, V; then q, do
  float* xs = stages + 2 * STAGE; // [S][LDX] the slab's bias, p, then ds, streamed-major
  float* lses = xs + S * LDX;     // [T] by token
  float* dels = lses + T;         // [T] by token
  float* tabs = dels + T;         // fw_tab_floats(T): rel_w [16][T]; then two [S][kFwTabRow]

  const bool pass1 = blockIdx.x % 2 == 0;
  const int wh = blockIdx.x / 2;
  const int h = wh % a.heads, b = wh / a.heads;
  const int n = a.nq;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int lk = lane >> 2;
  const int r0 = 32 * warp + 4 * (lane & 3);
  const bool has_rel = a.relh != nullptr;
  const bool want_drel = a.drelh != nullptr;
  const int gh = a.gh, gw = a.gw;
  const float* qg = a.q + b * a.q_bs + h * D;
  const float* kg = a.k + b * a.k_bs + h * D;
  const float* vg = a.v + b * a.v_bs + h * D;
  const float* dog = a.dout + b * a.do_bs + h * D;
  const float* og = a.out + b * a.o_bs + h * D;
  // row strides within a window-head, and the (B, N, H) index of token r,
  // tab0 + r * rel_step (32-bit: the entry refuses larger tensors)
  const int q_rs = (int)a.q_rs, k_rs = (int)a.k_rs, v_rs = (int)a.v_rs;
  const int do_rs = (int)a.do_rs, o_rs = (int)a.o_rs;
  const int tab0 = b * n * a.heads + h;
  const int rel_step = a.heads;
  // the tokens of a thread's R rows (-1 for none), and of its index t
  int tok[R];
#pragma unroll
  for (int e = 0; e < R; ++e) tok[e] = fw_real<R>(fb_row(r0, e));
  const int ttok = fw_real<R>(t);

  // lse and delta = rowsum(do * o) of every token (0 past n): two lanes a
  // token, each its chunks part, part + 2, ... in order, then the pair's
  // sum. Pass 1 also keeps q (scaled in the packed family) and do of the
  // tokens, k-major at their indices.
  {
    const int half = t & 1;
    for (int row = t >> 1; row < T; row += T / 2) {
      const bool ok = row < n;
      const int gr = ok ? row : 0, idx = fw_index<R>(row);
      const bool keep = pass1 && row < T / 8 * R;
      float sum = 0.f;
#pragma unroll
      for (int m = 0; m < D / 8; ++m) {
        const int c = 4 * (half + 2 * m);
        const float4 dv = fb_ldg4(dog + gr * do_rs + c, ok);
        const float4 ov = fb_ldg4(og + gr * o_rs + c, ok);
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (keep) {
          qv = fb_ldg4(qg + gr * q_rs + c, ok);
          if (!SCALE_SCORES) {
            qv.x *= a.scale;
            qv.y *= a.scale;
            qv.z *= a.scale;
            qv.w *= a.scale;
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          if (keep) {
            ra[(c + x) * T + idx] = fb_at(qv, x);
            rb[(c + x) * T + idx] = fb_at(dv, x);
          }
          sum = fmaf(fb_at(dv, x), fb_at(ov, x), sum);
        }
      }
      sum = fb_pair_sum(sum);
      if (half == 0) {
        lses[row] = ok ? a.lse[tab0 + row * rel_step] : 0.f;
        dels[row] = ok ? sum : 0.f;
      }
    }
  }

  // ---- pass 1: q and do resident, key slabs walk -------------------------
  if (pass1) {
    // keys a slab: whole grid rows with tables
    const int rows_per_slab = has_rel ? S / gw : 0;
    const int ks = has_rel ? rows_per_slab * gw : S;
    auto load_kv = [&](int kt) {
      float* s0 = stages + (kt & 1) * STAGE;
      float* s1 = s0 + S * LDT;
      const int k0 = kt * ks;
      for (int e = t; e < S * CH; e += T) {
        const int r = e / CH, c = (e % CH) * 4;
        const bool in = r < ks && k0 + r < n;
        const int row = in ? k0 + r : 0;
        fb_cp16(s0 + r * LDT + c, kg + row * k_rs + c, in);
        fb_cp16(s1 + r * LDT + c, vg + row * v_rs + c, in);
      }
      fb_commit();
    };
    load_kv(0);
    // rel_w of every token, [c][T] at the token's index: thread t's
    const bool tok_ok = ttok >= 0 && ttok < n;
    const int trow = tab0 + (tok_ok ? ttok : 0) * rel_step;
    if (has_rel) {
#pragma unroll
      for (int c = 0; c < kFwMaxGrid; ++c)
        tabs[c * T + t] = (c < gw && tok_ok) ? __ldg(a.relw + trow * gw + c) : 0.f;
    }
    float acc[R][NC];
    fw_zero(acc);
    float drw[kFwMaxGrid];  // thread t's drel_w sums of its token
#pragma unroll
    for (int c = 0; c < kFwMaxGrid; ++c) drw[c] = 0.f;

    const int nkt = has_rel ? (gh + rows_per_slab - 1) / rows_per_slab : (n + S - 1) / S;
    for (int kt = 0; kt < nkt; ++kt) {
      fb_wait_all();
      __syncthreads();  // slab kt landed; the previous slab's products are done
      if (kt + 1 < nkt) load_kv(kt + 1);
      const float* ksl = stages + (kt & 1) * STAGE;
      const float* vsl = ksl + S * LDT;
      const int k0 = kt * ks;
      if (has_rel) {
        // the slab's bias into the tile by row: thread t, its token, the
        // slab grid rows' rel_h and every column's rel_w
        for (int r = 0; r < rows_per_slab; ++r) {
          const int grow = kt * rows_per_slab + r;
          const float rh = (tok_ok && grow < gh) ? __ldg(a.relh + trow * gh + grow) : 0.f;
#pragma unroll
          for (int c = 0; c < kFwMaxGrid; ++c)
            if (c < gw) xs[(r * gw + c) * LDX + t] = rh + tabs[c * T + t];
        }
      }

      // p = exp(s + bias - lse) into the tile; 0 past the keys and tokens
      {
        float s[R][4];
        fw_zero(s);
        fw_scores<D, 4, R>(s, ra, T, r0, ksl, LDT, lk);
        __syncthreads();  // the bias tile
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int slot = lk + 8 * j;
          const bool kok = slot < ks && k0 + slot < n;
#pragma unroll
          for (int e = 0; e < R; ++e) {
            float p = 0.f;
            if (kok && tok[e] >= 0 && tok[e] < n) {
              float sv = SCALE_SCORES ? s[e][j] * a.scale : s[e][j];
              if (has_rel) sv += xs[slot * LDX + fb_row(r0, e)];
              p = __expf(sv - lses[tok[e]]);
            }
            s[e][j] = p;
          }
        }
        fw_put<R>(xs, LDX, r0, lk, s);
      }
      // ds = p * (dp - delta), over p in place (each thread its own elements)
      {
        float dp[R][4];
        fw_zero(dp);
        fw_scores<D, 4, R>(dp, rb, T, r0, vsl, LDT, lk);
#pragma unroll
        for (int e = 0; e < R; ++e) {
          const float del = tok[e] >= 0 ? dels[tok[e]] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dp[e][j] = xs[(lk + 8 * j) * LDX + fb_row(r0, e)] * (dp[e][j] - del);
        }
        fw_put<R>(xs, LDX, r0, lk, dp);
      }
      __syncthreads();  // the ds tile

      fw_grad<D, R>(acc, xs, LDX, r0, ksl, LDT, lk, ks);
      if (want_drel) {
        // thread t, its token: drel_h of the slab's grid rows, written once;
        // drel_w's sums over the walk in registers (columns in order)
        for (int r = 0; r < rows_per_slab; ++r) {
          float hs = 0.f;
#pragma unroll
          for (int c = 0; c < kFwMaxGrid; ++c) {
            if (c < gw) {
              const float v = xs[(r * gw + c) * LDX + t];
              hs += v;
              drw[c] += v;
            }
          }
          const int grow = kt * rows_per_slab + r;
          if (tok_ok && grow < gh) a.drelh[trow * gh + grow] = hs;
        }
      }
    }

    float* dqg = a.dq + b * a.dq_bs + h * D;
#pragma unroll
    for (int e = 0; e < R; ++e)
      if (tok[e] >= 0 && tok[e] < n) fw_store_row<D>(dqg + tok[e] * (int)a.dq_rs, acc[e], a.scale, lk);
    if (want_drel && tok_ok) {
#pragma unroll
      for (int c = 0; c < kFwMaxGrid; ++c)
        if (c < gw) a.drelw[trow * gw + c] = drw[c];
    }
    return;
  }

  // ---- pass 2: K and V resident, query slabs walk twice: dv, then dk -----
  auto load_qdo = [&](int qt) {
    float* s0 = stages + (qt & 1) * STAGE;
    float* s1 = s0 + S * LDT;
    const int q0 = qt * S;
    for (int e = t; e < S * CH; e += T) {
      const int r = e / CH, c = (e % CH) * 4;
      const bool in = q0 + r < n;
      const int row = in ? q0 + r : 0;
      fb_cp16(s0 + r * LDT + c, qg + row * q_rs + c, in);
      fb_cp16(s1 + r * LDT + c, dog + row * do_rs + c, in);
    }
    if (has_rel) {  // the slab's rel_h | rel_w rows
      float* tb = tabs + (qt & 1) * S * kFwTabRow;
      for (int e = t; e < S * 2 * kFwMaxGrid; e += T) {
        const int r = e / (2 * kFwMaxGrid), c = e % (2 * kFwMaxGrid);
        const bool w = c >= kFwMaxGrid;
        const int col = w ? c - kFwMaxGrid : c;
        if (col < (w ? gw : gh)) {
          const bool in = q0 + r < n;
          const int row = tab0 + (in ? q0 + r : 0) * rel_step;
          fb_cp4(tb + r * kFwTabRow + c, w ? a.relw + row * gw + col : a.relh + row * gh + col, in);
        }
      }
    }
    fb_commit();
  };
  load_qdo(0);
  // K (scaled in the packed family: round(q*scale).k becomes (k*scale).q,
  // the same product to a rounding) and V, k-major at the keys' indices
  fw_resident<D, T, R>(ra, kg, k_rs, n, SCALE_SCORES ? 1.f : a.scale);
  fw_resident<D, T, R>(rb, vg, v_rs, n, 1.f);

  // p^T = exp(s^T + bias - lse) of the slab qt, over s^T in place; 0 past n.
  // The bias of a thread's key e and the slab's query j from the slab's
  // table rows.
  auto probs_t = [&](float (&s)[R][4], int qt) {
    const float* tb = tabs + (qt & 1) * S * kFwTabRow;
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int key = tok[e];
      const int krow = has_rel && key >= 0 ? key / gw : 0;
      const int kcol = kFwMaxGrid + key - krow * gw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qj = lk + 8 * j, qi = qt * S + qj;
        float p = 0.f;
        if (qi < n && key >= 0 && key < n) {
          float sv = SCALE_SCORES ? s[e][j] * a.scale : s[e][j];
          if (has_rel) sv += tb[qj * kFwTabRow + krow] + tb[qj * kFwTabRow + kcol];
          p = __expf(sv - lses[qi]);
        }
        s[e][j] = p;
      }
    }
  };
  // a thread's dk or dv rows to its keys
  auto store_keys = [&](float* g, long long rs, const float (&acc)[R][NC], float mul) {
#pragma unroll
    for (int e = 0; e < R; ++e)
      if (tok[e] >= 0 && tok[e] < n) fw_store_row<D>(g + tok[e] * (int)rs, acc[e], mul, lk);
  };
  const int nqt = (n + S - 1) / S;

  // the first walk: dv += p^T . do (S^T and one gradient product a slab)
  {
    float dvacc[R][NC];
    fw_zero(dvacc);
    for (int qt = 0; qt < nqt; ++qt) {
      fb_wait_all();
      __syncthreads();  // slab qt landed; the previous slab's product is done
      if (qt + 1 < nqt) load_qdo(qt + 1);
      const float* qsl = stages + (qt & 1) * STAGE;
      const float* dsl = qsl + S * LDT;
      float s[R][4];
      fw_zero(s);
      fw_scores<D, 4, R>(s, ra, T, r0, qsl, LDT, lk);
      probs_t(s, qt);
      fw_put<R>(xs, LDX, r0, lk, s);
      __syncthreads();  // the p tile
      fw_grad<D, R>(dvacc, xs, LDX, r0, dsl, LDT, lk, S);
    }
    store_keys(a.dv + b * a.dv_bs + h * D, a.dv_rs, dvacc, 1.f);
  }

  // the second walk: dk += ds^T . q (S^T, dP^T and one gradient product a
  // slab): one more product than a single walk, so that a thread holds one
  // set of accumulators and not two
  __syncthreads();  // every read of the first walk's tiles is done
  load_qdo(0);
  {
    float dkacc[R][NC];
    fw_zero(dkacc);
    for (int qt = 0; qt < nqt; ++qt) {
      fb_wait_all();
      __syncthreads();  // slab qt landed; the previous slab's product is done
      if (qt + 1 < nqt) load_qdo(qt + 1);
      const float* qsl = stages + (qt & 1) * STAGE;
      const float* dsl = qsl + S * LDT;
      const int q0 = qt * S;
      float p[R][4], ds[R][4];
      fw_zero(p);
      fw_zero(ds);
      fw_scores<D, 4, R>(p, ra, T, r0, qsl, LDT, lk);
      probs_t(p, qt);
      fw_scores<D, 4, R>(ds, rb, T, r0, dsl, LDT, lk);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float del = dels[q0 + lk + 8 * j];
#pragma unroll
        for (int e = 0; e < R; ++e) ds[e][j] = p[e][j] * (ds[e][j] - del);
      }
      fw_put<R>(xs, LDX, r0, lk, ds);
      __syncthreads();  // the ds tile
      fw_grad<D, R>(dkacc, xs, LDX, r0, qsl, LDT, lk, S);
    }
    store_keys(a.dk + b * a.dk_bs + h * D, a.dk_rs, dkacc, a.scale);
  }
}

template <int D, int W, int R, bool SCALE_SCORES>
cudaError_t launch_f32_window(const F32BwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = fw_smem_bytes(D, W);
  auto kernel = attn_bwd_f32_window_kernel<D, W, R, SCALE_SCORES>;
  const long long blocks = (long long)batch * a.heads * 2;
  if (smem > (size_t)kMaxSmemBytes || blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation a window of n tokens takes: 5 warps of 32 rows up to 160
// tokens, 7 warps of 28 rows up to 196 and 7 of 32 up to kFwMaxTokens.
template <int D, bool SCALE_SCORES>
cudaError_t launch_f32_window_for(const F32BwdArgs& a, int batch, int n, cudaStream_t stream) {
  if (n <= 160) return launch_f32_window<D, 5, 8, SCALE_SCORES>(a, batch, stream);
  if (n <= 196) return launch_f32_window<D, 7, 7, SCALE_SCORES>(a, batch, stream);
  return launch_f32_window<D, 7, 8, SCALE_SCORES>(a, batch, stream);
}

// The body of a plain C entry: dq, dk, dv and, when drelh / drelw are given,
// the table gradients of every window-head, delta taken inside. relh / relw
// may be null (no bias). Returns the cudaError_t of the launch; refuses a
// head dim other than 64 or 80, N != M, more than kFwMaxTokens tokens and
// tables wider than kFwMaxGrid.
template <bool SCALE_SCORES>
int attention_bwd_f32_window_entry(const void* q, const void* k, const void* v, const void* dout,
                                   const void* out, const void* lse, const void* relh,
                                   const void* relw, void* dq, void* dk, void* dv, void* drelh,
                                   void* drelw, int batch, int heads, int nq, int nk, int d,
                                   long long q_bs, long long q_rs, long long k_bs, long long k_rs,
                                   long long v_bs, long long v_rs, long long do_bs,
                                   long long do_rs, long long o_bs, long long o_rs,
                                   long long dq_bs, long long dq_rs, long long dk_bs,
                                   long long dk_rs, long long dv_bs, long long dv_rs, int gh,
                                   int gw, float scale, void* stream) {
  F32BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.out = static_cast<const float*>(out);
  a.lse = static_cast<const float*>(lse);
  a.delta = nullptr;
  a.relh = static_cast<const float*>(relh);
  a.relw = relh ? static_cast<const float*>(relw) : nullptr;
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.drelh = relh ? static_cast<float*>(drelh) : nullptr;
  a.drelw = relh ? static_cast<float*>(drelw) : nullptr;
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.do_bs = do_bs; a.do_rs = do_rs;
  a.o_bs = o_bs; a.o_rs = o_rs;
  a.dq_bs = dq_bs; a.dq_rs = dq_rs; a.dk_bs = dk_bs; a.dk_rs = dk_rs;
  a.dv_bs = dv_bs; a.dv_rs = dv_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = relh ? gh : 0;
  a.gw = relh ? gw : 0;
  a.scale = scale;
  // a window-head's row offsets and the (B, N, H, g) tables' indices are
  // 32-bit in the kernel
  const long long strides[8] = {q_rs, k_rs, v_rs, do_rs, o_rs, dq_rs, dk_rs, dv_rs};
  long long rs_max = 0;
  for (long long rs : strides) rs_max = rs > rs_max ? rs : rs_max;
  const long long tab_elems = (long long)batch * nq * heads * kFwMaxGrid;
  if ((d != 64 && d != 80) || nq != nk || nq < 1 || nq > kFwMaxTokens || batch < 1 ||
      heads < 1 || (relh && (gh < 1 || gw < 1 || gw > kFwMaxGrid || gh * gw != nk)) ||
      rs_max * nq > 2147483647LL || tab_elems > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(d == 64 ? launch_f32_window_for<64, SCALE_SCORES>(a, batch, nq, s)
                       : launch_f32_window_for<80, SCALE_SCORES>(a, batch, nq, s));
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_BWD_F32_WINDOW(name, scale_scores)                                \
  extern "C" int name(const void* q, const void* k, const void* v, const void* dout,         \
                      const void* out, const void* lse, const void* relh, const void* relw,  \
                      void* dq, void* dk, void* dv, void* drelh, void* drelw, int batch,     \
                      int heads, int nq, int nk, int d, long long q_bs, long long q_rs,      \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,        \
                      long long do_bs, long long do_rs, long long o_bs, long long o_rs,      \
                      long long dq_bs, long long dq_rs, long long dk_bs, long long dk_rs,    \
                      long long dv_bs, long long dv_rs, int gh, int gw, float scale,         \
                      void* stream) {                                                         \
    return wm::attention_bwd_f32_window_entry<scale_scores>(                                  \
        q, k, v, dout, out, lse, relh, relw, dq, dk, dv, drelh, drelw, batch, heads, nq, nk, \
        d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs, dq_bs, dq_rs,       \
        dk_bs, dk_rs, dv_bs, dv_rs, gh, gw, scale, stream);                                  \
  }
