// Forward of the multi-head attention in f32 on Hopper's CUDA cores, at the
// streaming shapes: one register-tiled kernel, a template on the head dim,
// the family and the key tile. Two sources instantiate it, one nvcc each:
//
//   attention_fwd_f32.cu (SCALE_SCORES = false), the packed family:
//   K2 wildlifemapper_tpu/ops/flash_attention_v2.py::_fwd_kernel (:95,
//      pallas_call :199), the global ViT blocks: B 4, H 12, N = M 4096 on the
//      64-grid or 2304 on the 48-grid, d 64; ViT-H's d 80 (H 16); a
//      tensor-parallel rank's 6 heads;
//   K4 wildlifemapper_tpu/ops/cross_attention.py::_fwd_kernel (:64,
//      pallas_call :160), the HFC adaptor's cross attention: B 4, H 8,
//      N = M = 4096 (full canvas, compat crop) or 2304 (crop_prologue), a
//      tensor-parallel rank's 4 heads; N != M and ragged N or M allowed.
//
//   grouped_attention_fwd_f32.cu (SCALE_SCORES = true), the grouped family:
//   K5 wildlifemapper_tpu/ops/flash_attention.py::_fwd_kernel (:88,
//      pallas_call :230): BH 48, N 4096 or 2304, d 64; ViT-H's BH 16 at d 80.
//
// The function is the tile body's (attention_fwd.cuh) and the _fwd_kernels':
// s = round(q*scale) . k (packed; q*scale in f32 is the input type) or
// (q . k) * scale on the f32 sum (grouped), plus the decomposed rel bias
// rel_h[q, k / gw] + rel_w[q, k % gw] (added as one sum, as the tile body
// does), an online softmax in f32 (running max m and sum l a row),
// p = exp(s - m) unrounded (f32), out = acc / l, and lse = m + log(l) when an
// lse buffer is given. No TF32: every product is an f32 FMA.
// ops/_attention.py::attention_body sends here the f32 forward launches from
// STREAM_MIN_KEYS (512) keys at d 128 without tables (the body it calls
// "f32"; backward attention_bwd_f32_d128.cuh) and at d 64 or 80 with no
// tables or a rel grid of gh + gw <= 128 (backward attention_bwd_f32.cuh). The
// f32 forward of K1 and K6 (the windows) runs attention_fwd_f32_window.cuh;
// d 32, d 128 with tables and fewer than 512 keys stay on the tile body of
// attention_fwd.cuh; bf16 runs the Hopper and the resident bodies.
//
// What bounds it on the H100: two products of N M d MACs a head against
// O((N + M) d) bytes, so operations, at 67 TFLOP/s without tensor cores. At
// B 4, H 8, N = M 4096, d 128 that is 274.9 GFLOP, 4.10 ms at the peak (N
// 2304: 87.0 GFLOP, 1.30 ms); K2 / K5 at B 4, H 12, N 4096, d 64 206.2 GFLOP
// and the tables' two adds a score, 3.10 ms. The tile body reached 11.9-13.7
// TFLOP/s there: 4 threads a query row, about one shared load per FMA, and
// an SM's shared memory delivers 128 bytes a clock to its 128 FMA lanes, so a
// product runs at the FMA rate only where a thread makes about 4 FMAs of
// every float it loads. The design (the lessons of attention_bwd_f32.cuh):
//  * a block of 256 threads keeps 128 queries resident, q*scale (or q)
//    staged k-major in shared memory (32, 40 or 64 KB at d 64, 80, 128), and
//    walks K and V tiles of BK = 128 keys that arrive by 16-byte cp.async;
//  * a warp owns 16 whole query rows, so a row's max and sum are taken
//    across the 16 lanes that share it by warp shuffles, never through
//    shared memory; a thread holds an 8 x 8 register tile of scores (8 rows,
//    two runs of 4; keys kl + 16 n), 16 shared loads for 256 FMAs, 4 FMAs a
//    float;
//  * the rel tables: the block's 128 rows of rel_h and rel_w are staged in
//    shared memory once a block (row strides 4 past a multiple of 8, so the
//    two runs of rows a warp reads fall in different banks), and each score
//    takes rel_h[r][k / gw] + rel_w[r][k % gw] with the scale, after the QK
//    FMAs: two shared loads a score against its 2 D FMAs, any grid of
//    gh + gw <= 128 (ragged ones too), one key-to-grid division a key slot;
//  * P.V runs on an 8 x 4 register tile of the output (8 rows by columns
//    4 kl .. 4 kl + 3 of each run of 64) and, at d 80, one more column
//    (64 + kl) a thread; the row sum l stays a per-thread partial over the
//    thread's keys, scaled with the output at every new max and summed
//    across the row's lanes once at the end;
//  * p, k-major: at d 128 a K row (132 floats) holds a p row, so p goes
//    into the K tile it was made from once every warp is past the scores,
//    on one stage (V's next tile copied under the next tile's scores, K's
//    after P.V). At d 64 and 80 it does not (68 / 84 floats against 132), so
//    p has a tile of its own, and a small one: P.V reads only the warp's own
//    16 rows of p, so each warp writes its p into a strip of its own, 32
//    keys at a time (16 rows padded to 24 floats, 3 KB a warp, 24 KB a
//    block), __syncwarp between, and no block barrier waits on p; K's next
//    tile is copied under P.V, V's under the next tile's scores;
//  * nothing runs on a plain pass outside the kernel.
// Shared memory: at d 128 64 KB of q*scale and two 128 x 132 f32 tiles (K
// and V), 200,704 B, no tables. At d 64 / 80: q 32,768 / 40,960 B, K and V
// 69,632 / 86,016 B, the p strips 24,576 B and the tables 512 (ldh + ldw)
// B, 69,632 B on the 64-grid: 196,608 / 221,184 B; ops/_attention.py::
// f32_forward_smem_bytes mirrors ff_smem_bytes. One block an SM, registers
// up to 255 a thread (__launch_bounds__(256, 1)), and chip_smoke.py phase 1
// holds ptxas to 0 bytes spilled. On the H100 at d 128 the fuller score
// tile outweighs the copy of K it leaves exposed: two stages of 64-key
// tiles (8 x 4 score tiles, 2.67 FMAs a float, every copy under the
// products) took the same shared memory and were 7 % slower, and 64-, 80-
// and 96-key tiles with p in a tile of its own and K's copy under P.V 3-8 %
// (scripts/sweep_f32_attention.py builds variants from this header by text
// edits and times them beside it; at d 64 and 80 it sweeps the key tile,
// 64, 96 or 128, and one or two stages). Every output element has one owner
// that sums in a fixed order, so a repeated call is bit-identical.
// At N 2304 a K4 launch is 4 * 8 * 18 = 576 blocks on 132 SMs: 4.36 rounds
// of one block an SM, the fifth round 36 % full; K2's is 4 * 12 * 18 = 864,
// 6.5 rounds.

#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_bwd_f32.cuh"  // the f32 bodies' cp.async and load helpers
#include "common.cuh"

namespace wm {
namespace {

constexpr int kFfRows = 128;    // resident queries of a block
constexpr int kFfKeys = 128;    // keys of a streamed K / V tile
constexpr int kFfThreads = 256;
constexpr int kFfPKeys = 32;    // keys of a warp's p strip
constexpr int kFfPLd = 24;      // row stride of a p strip: 16 rows and 8 of pad
constexpr int kFfRelCols = 128; // gh + gw of the largest rel grid staged

struct F32FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const float* relh;  // (B, nq, H, gh) or null
  const float* relw;  // (B, nq, H, gw)
  float* lse;         // (B, nq, H) or null: not written
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // element strides
  int heads, nq, nk, gh, gw;
  float scale;
};

// A thread's 8 rows of its warp's 16: rA .. rA+3 and rA+8 .. rA+11.
__device__ __forceinline__ int ff_row(int rA, int e) { return rA + (e & 3) + 8 * (e >> 2); }

// p takes a strip of its own where a K row cannot hold a p row.
template <int D>
__host__ __device__ constexpr bool ff_p_own() {
  return D + 4 < kFfRows + 4;
}

// Row stride of a staged table g wide: the least >= g that is 4 past a
// multiple of 8 (0 without tables).
__host__ __device__ constexpr int ff_tab_ld(int g) { return g == 0 ? 0 : (g + 3) / 8 * 8 + 4; }

template <int D, int BK>
__host__ __device__ constexpr int ff_smem_bytes(int gh, int gw) {
  return 4 * (D * kFfRows + 2 * BK * (D + 4) +
              (ff_p_own<D>() ? 8 * kFfPKeys * kFfPLd : 0) +
              kFfRows * (ff_tab_ld(gh) + ff_tab_ld(gw)));
}

// s[e][n] = sum_c qt[c][row e] * k[kl + 16 n][c], c = 0 .. D-1 in order.
template <int D, int NJ>
__device__ __forceinline__ void ff_scores(float (&s)[8][NJ], const float* qt, int rA,
                                          const float* ks, int kl) {
  constexpr int BQ = kFfRows;
  constexpr int LDT = D + 4;
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int n = 0; n < NJ; ++n) s[e][n] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float4 kc[NJ];
#pragma unroll
    for (int n = 0; n < NJ; ++n) kc[n] = fb_ld4(ks + (kl + 16 * n) * LDT + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 lo = fb_ld4(qt + (c + cc) * BQ + rA);
      const float4 hi = fb_ld4(qt + (c + cc) * BQ + rA + 8);
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const float kn = fb_at(kc[n], cc);
        s[0][n] = fmaf(lo.x, kn, s[0][n]);
        s[1][n] = fmaf(lo.y, kn, s[1][n]);
        s[2][n] = fmaf(lo.z, kn, s[2][n]);
        s[3][n] = fmaf(lo.w, kn, s[3][n]);
        s[4][n] = fmaf(hi.x, kn, s[4][n]);
        s[5][n] = fmaf(hi.y, kn, s[5][n]);
        s[6][n] = fmaf(hi.z, kn, s[6][n]);
        s[7][n] = fmaf(hi.w, kn, s[7][n]);
      }
    }
  }
}

// The output columns a thread holds: 4 of each run of 64 (4 kl ..) and, at
// d 80, one of the last 16 (64 + kl).
template <int D>
struct FfCols {
  static constexpr int NV = D / 64;
  static constexpr int N = 4 * NV + (D % 64) / 16;
};

// acc[e][x] += sum_j p[j * ldp + r0 + row e] * v[j * LDT + col x], j = 0 ..
// J-1 in order: p k-major (rows r0 + (e & 3) + 8 (e >> 2)), v row-major.
template <int D, int J>
__device__ __forceinline__ void ff_pv(float (&acc)[8][FfCols<D>::N], const float* p, int ldp,
                                      int r0, const float* vs, int kl) {
  constexpr int LDT = D + 4;
  constexpr int NV = FfCols<D>::NV;
  constexpr int NX = FfCols<D>::N;
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const float4 lo = fb_ld4(p + j * ldp + r0);
    const float4 hi = fb_ld4(p + j * ldp + r0 + 8);
    float vx[NX];
#pragma unroll
    for (int g = 0; g < NV; ++g) {
      const float4 vv = fb_ld4(vs + j * LDT + 64 * g + 4 * kl);
      vx[4 * g] = vv.x;
      vx[4 * g + 1] = vv.y;
      vx[4 * g + 2] = vv.z;
      vx[4 * g + 3] = vv.w;
    }
    if constexpr (NX > 4 * NV) vx[4 * NV] = vs[j * LDT + 64 * NV + kl];
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      acc[0][x] = fmaf(lo.x, vx[x], acc[0][x]);
      acc[1][x] = fmaf(lo.y, vx[x], acc[1][x]);
      acc[2][x] = fmaf(lo.z, vx[x], acc[2][x]);
      acc[3][x] = fmaf(lo.w, vx[x], acc[3][x]);
      acc[4][x] = fmaf(hi.x, vx[x], acc[4][x]);
      acc[5][x] = fmaf(hi.y, vx[x], acc[5][x]);
      acc[6][x] = fmaf(hi.z, vx[x], acc[6][x]);
      acc[7][x] = fmaf(hi.w, vx[x], acc[7][x]);
    }
  }
}

// Keys kl + 16 n of the thread's tile columns n0 .. n0 + N - 1 into a
// k-major p tile (row stride ldp), rows r0 .. r0+3 and r0+8 .. r0+11.
template <int NJ>
__device__ __forceinline__ void ff_put_p(float* p, int ldp, int r0, int kl, int n0, int nn,
                                         const float (&s)[8][NJ]) {
  float* at = p + (kl + 16 * nn) * ldp + r0;
  *reinterpret_cast<float4*>(at) = make_float4(s[0][n0], s[1][n0], s[2][n0], s[3][n0]);
  *reinterpret_cast<float4*>(at + 8) = make_float4(s[4][n0], s[5][n0], s[6][n0], s[7][n0]);
}

template <int D, int BK, bool SCALE_SCORES>
__global__ void __launch_bounds__(kFfThreads, 1) attn_fwd_f32_kernel(F32FwdArgs a) {
  constexpr int BQ = kFfRows;
  constexpr int NJ = BK / 16;               // keys of a tile a thread holds
  constexpr int LDT = D + 4;                // row stride of the K and V tiles
  constexpr bool OWN = ff_p_own<D>();       // p in strips of its own
  constexpr int NX = FfCols<D>::N;          // output columns a thread holds
  constexpr int NV = FfCols<D>::NV;
  static_assert(D % 64 == 0 || D % 64 == 16, "64-column runs and a 16-column tail");
  static_assert(BK % 16 == 0 && (OWN ? BK % kFfPKeys == 0 : BQ + 4 <= LDT), "p's tile");
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float* qt = smem;                        // [D][BQ] q*scale (or q), k-major
  float* ks = qt + D * BQ;                 // [BK][LDT] K
  float* vs = ks + BK * LDT;               // [BK][LDT] V
  float* pw = vs + BK * LDT;               // the warps' p strips
  float* rhs = pw + (OWN ? 8 * kFfPKeys * kFfPLd : 0);  // [BQ][ldh] rel_h
  const int ldh = ff_tab_ld(a.gh), ldw = ff_tab_ld(a.gw);
  float* rws = rhs + BQ * ldh;             // [BQ][ldw] rel_w
  pw += warp * kFfPKeys * kFfPLd;
  const bool has_rel = OWN && a.relh != nullptr;  // no tables at d 128

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qg = a.q + b * a.q_bs + h * D;
  const float* kg = a.k + b * a.k_bs + h * D;
  const float* vg = a.v + b * a.v_bs + h * D;
  const int nkt = (a.nk + BK - 1) / BK;

  // K's or V's rows of tile kt, one commit group (an empty group past the
  // last tile, so the waits below count alike)
  auto load = [&](float* dst, const float* src, long long rs, int kt) {
    if (kt < nkt) fb_copy_rows<D>(dst, LDT, src, rs, kt * BK, BK, a.nk, t);
    fb_commit();
  };
  load(ks, kg, a.k_rs, 0);
  load(vs, vg, a.v_rs, 0);

  // q*scale (or q), k-major: two lanes a row, chunks part, part + 2, ...
  {
    const int row = t >> 1, part = t & 1;
    const bool ok = q0 + row < a.nq;
    const long long gr = ok ? q0 + row : 0;
    const float mul = SCALE_SCORES ? 1.f : a.scale;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      const int c = 4 * (part + 2 * m);
      const float4 qv = fb_ldg4(qg + gr * a.q_rs + c, ok);
#pragma unroll
      for (int x = 0; x < 4; ++x) qt[(c + x) * BQ + row] = fb_at(qv, x) * mul;
    }
  }
  // the block's rows of rel_h and rel_w, side by side in each row's read
  if (has_rel) {
    const int hw = a.gh + a.gw;
    for (int i = t; i < BQ * hw; i += kFfThreads) {
      const int r = i / hw, j = i - r * hw;
      float val = 0.f;
      if (q0 + r < a.nq) {
        const long long stat = ((long long)b * a.nq + q0 + r) * a.heads + h;
        val = j < a.gh ? __ldg(a.relh + stat * a.gh + j) : __ldg(a.relw + stat * a.gw + j - a.gh);
      }
      if (j < a.gh)
        rhs[r * ldh + j] = val;
      else
        rws[r * ldw + j - a.gh] = val;
    }
  }

  // Warp w owns rows 16w .. 16w+15; lane (kl, rg) rows ff_row(rA, e), keys
  // kl + 16n of a tile, output columns 4kl + 64g .. +3 (and 64 NV + kl).
  const int rg = lane & 1, kl = lane >> 1;
  const int rA = 16 * warp + 4 * rg;
  float m[8], l[8], acc[8][NX];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = -INFINITY;
    l[e] = 0.f;
#pragma unroll
    for (int x = 0; x < NX; ++x) acc[e][x] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    fb_wait<1>();     // K of tile kt
    __syncthreads();

    // s = (q*scale) . k over c = 0 .. D-1 in order
    float s[8][NJ];
    ff_scores<D, NJ>(s, qt, rA, ks, kl);

    // the scale on the scores, the bias, the mask, then the online softmax
    // of the thread's rows: the tile's max across the 16 lanes of a row,
    // the output and the partial sum scaled to the new max
    int kh[NJ], kw[NJ];
    if (has_rel) {
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const int key = min(k0 + kl + 16 * n, a.nk - 1);
        kh[n] = key / a.gw;
        kw[n] = key - kh[n] * a.gw;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int r = ff_row(rA, e);
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        float sv = s[e][n];
        if (SCALE_SCORES) sv *= a.scale;
        if (has_rel) sv += rhs[r * ldh + kh[n]] + rws[r * ldw + kw[n]];
        s[e][n] = k0 + kl + 16 * n < a.nk ? sv : -INFINITY;
        mx = fmaxf(mx, s[e][n]);
      }
#pragma unroll
      for (int off = 2; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[e], mx);  // finite: every tile holds a key
      const float alpha = __expf(m[e] - mn);
      m[e] = mn;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        s[e][n] = __expf(s[e][n] - mn);
        sum += s[e][n];
      }
      l[e] = fmaf(l[e], alpha, sum);
#pragma unroll
      for (int x = 0; x < NX; ++x) acc[e][x] *= alpha;
    }

    if constexpr (OWN) {
      fb_wait<0>();     // V of tile kt
      __syncthreads();  // every warp is past the scores: K's tile is free
      load(ks, kg, a.k_rs, kt + 1);
      // acc += p . v, 32 keys at a time through the warp's own strip
#pragma unroll
      for (int cnk = 0; cnk < BK / kFfPKeys; ++cnk) {
#pragma unroll
        for (int nn = 0; nn < kFfPKeys / 16; ++nn)
          ff_put_p<NJ>(pw, kFfPLd, 4 * rg, kl, cnk * (kFfPKeys / 16) + nn, nn, s);
        __syncwarp();
        ff_pv<D, kFfPKeys>(acc, pw, kFfPLd, 4 * rg, vs + cnk * kFfPKeys * LDT, kl);
        __syncwarp();     // the strip is read before the next chunk's p
      }
      __syncthreads();    // V's tile is read
      load(vs, vg, a.v_rs, kt + 1);
    } else {
      fb_wait<0>();     // V of tile kt
      __syncthreads();  // every warp is past the scores: K's tile is free
      // p, this warp's rows only, over K's tile
#pragma unroll
      for (int n = 0; n < NJ; ++n) ff_put_p<NJ>(ks, BQ + 4, rA, kl, n, n, s);
      __syncwarp();
      // acc += p . v over the tile's keys in order
      ff_pv<D, BK>(acc, ks, BQ + 4, rA, vs, kl);
      __syncthreads();  // the p (K) and V tiles are read
      load(ks, kg, a.k_rs, kt + 1);
      load(vs, vg, a.v_rs, kt + 1);
    }
  }

  // the row sums across the row's 16 lanes (pair sums: the same in every
  // lane bit for bit), then out = acc / l and lse = m + log l
  float* og = a.o + b * a.o_bs + h * D;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float sum = l[e];
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + ff_row(rA, e);
    if (row >= a.nq) continue;
    const float inv = 1.f / sum;
    float* orow = og + row * a.o_rs;
#pragma unroll
    for (int g = 0; g < NV; ++g)
      *reinterpret_cast<float4*>(orow + 64 * g + 4 * kl) =
          make_float4(acc[e][4 * g] * inv, acc[e][4 * g + 1] * inv, acc[e][4 * g + 2] * inv,
                      acc[e][4 * g + 3] * inv);
    if constexpr (NX > 4 * NV) orow[64 * NV + kl] = acc[e][4 * NV] * inv;
    if (a.lse != nullptr && kl == 0)
      a.lse[((long long)b * a.nq + row) * a.heads + h] = m[e] + logf(sum);
  }
}

template <int D, int BK, bool SCALE_SCORES>
cudaError_t launch_f32_fwd(const F32FwdArgs& a, int batch, cudaStream_t stream) {
  static_assert(ff_smem_bytes<D, BK>(0, 0) <= kMaxSmemBytes, "shared memory");
  const size_t smem = ff_smem_bytes<D, BK>(a.gh, a.gw);
  if (batch > 65535 || a.heads > 65535 || smem > (size_t)kMaxSmemBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32_kernel<D, BK, SCALE_SCORES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + kFfRows - 1) / kFfRows, a.heads, batch);
  attn_fwd_f32_kernel<D, BK, SCALE_SCORES><<<grid, kFfThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The body of a plain C entry with the forward's arguments
// (attention_fwd.cuh). Refuses what the body does not take: another dtype
// than f32, a head dim other than 64, 80 or 128, rel tables at d 128 or in a
// grid of more than kFfRelCols columns (gh + gw) or that does not cover the
// keys, the scale on the scores at d 128.
template <bool SCALE_SCORES>
inline int attention_fwd_f32_entry(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* relh, const void* relw, void* lse,
                                   int batch, int heads, int nq, int nk, int d, long long q_bs,
                                   long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs, long long o_rs, int gh, int gw,
                                   float scale, void* stream) {
  const bool rel = relh != nullptr;
  if (dtype != kFloat32 || (d != 64 && d != 80 && d != 128) || nq < 1 || nk < 1 ||
      rel != (relw != nullptr))
    return (int)cudaErrorInvalidValue;
  if (d == 128 && (rel || SCALE_SCORES)) return (int)cudaErrorInvalidValue;
  if (rel && (gh < 1 || gw < 1 || gh + gw > kFfRelCols || (long long)gh * gw != nk))
    return (int)cudaErrorInvalidValue;
  F32FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.relh = static_cast<const float*>(relh);
  a.relw = static_cast<const float*>(relw);
  a.lse = static_cast<float*>(lse);
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.gh = rel ? gh : 0;
  a.gw = rel ? gw : 0;
  a.scale = scale;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 64) return (int)launch_f32_fwd<64, kFfKeys, SCALE_SCORES>(a, batch, st);
  if (d == 80) return (int)launch_f32_fwd<80, kFfKeys, SCALE_SCORES>(a, batch, st);
  if constexpr (!SCALE_SCORES) return (int)launch_f32_fwd<128, kFfKeys, false>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header,
// for the packed family (scale_scores false) or the grouped one (true).
#define WM_DEFINE_ATTENTION_FWD_F32(name, scale_scores)                                    \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, void* o,     \
                      const void* relh, const void* relw, void* lse, int batch, int heads, \
                      int nq, int nk, int d, long long q_bs, long long q_rs,               \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,      \
                      long long o_bs, long long o_rs, int gh, int gw, float scale,         \
                      void* stream) {                                                       \
    return wm::attention_fwd_f32_entry<scale_scores>(                                      \
        dtype, q, k, v, o, relh, relw, lse, batch, heads, nq, nk, d, q_bs, q_rs, k_bs,     \
        k_rs, v_bs, v_rs, o_bs, o_rs, gh, gw, scale, stream);                              \
  }
