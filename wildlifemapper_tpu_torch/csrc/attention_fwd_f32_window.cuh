// Forward of the windowed attention in f32 on Hopper's CUDA cores: one
// register-tiled kernel, a template on the head dim, the family and the
// block's layout. Two sources instantiate it, one nvcc each:
//
//   attention_fwd_f32_window.cu (SCALE_SCORES = false), the packed family:
//   K1 wildlifemapper_tpu/ops/windowed_attention_v2.py::_fwd_kernel (:105,
//      pallas_call :227), the windowed ViT blocks on the packed (BW, N, 3C)
//      qkv: BW 100 (batch 4 x 25 windows), H 12, N 196, d 64 on the full
//      canvas, BW 64, N 144 from scratch, ViT-H's BW 25 or 100, H 16, d 80.
//
//   grouped_attention_fwd_f32_window.cu (SCALE_SCORES = true), the grouped
//   family:
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::_fwd_kernel (:52,
//      pallas_call :144): the same windows as (BWH, N, d) operands, one head
//      and BWH batches (BWH 1200 at N 196, 768 at N 144, 400 at d 80).
//
// The function is the tile body's (attention_fwd.cuh) and the _fwd_kernels':
// s = round(q*scale) . k (packed; q*scale in f32 is the input type) or
// (q . k) * scale on the f32 sum (grouped), plus the decomposed rel bias
// rel_h[q, k / gw] + rel_w[q, k % gw] added as one sum, a softmax in f32,
// p = exp(s - m) unrounded, out = (p . v) / l, and, when an lse buffer is
// given, the (B, N, H) f32 lse = m + log(l) that the f32 window backward
// (attention_bwd_f32_window.cuh) reads. No TF32: every product is an f32
// FMA. ops/_attention.py::attention_body sends here the f32 forward of the
// windows it sends to that backward: d = 64 or 80, N = M <= 208, rel tables
// at most 16 wide, so "f32_window" takes a window both ways. d 32, grids of
// gh + gw > 128, fewer than 512 keys that are no window and a global block
// of 209 to 511 tokens stay on the tile body's f32 forward.
//
// What bounds it on the H100: operations. A window-head is two products of
// N^2 d MACs against O(N d) bytes: 4 BW H N^2 d f32 operations plus the
// tables' two adds a score, 11.8 GFLOP and 0.178 ms at 67 TFLOP/s for BW 100,
// H 12, N 196, d 64 (0.061 ms at BW 64, N 144). The tile body took 1.575 ms
// there (8.9x the bound; 0.605 ms at N 144, 0.733 ms for ViT-H's BW 25):
//  * padding: blocks of 64 queries walk 64-key tiles, so a 196-token window
//    is computed as 256 x 256 (1.71x the work) and 144 as 192 x 192 (1.78x);
//  * shared-memory traffic: 4 threads a query row, about one shared load a
//    FMA (an SM's shared memory delivers 128 bytes a clock to its 128 FMA
//    lanes, so a product runs at the FMA rate only where a thread makes
//    about 4 FMAs of every float it loads);
//  * reloads: each block of queries reloads K and V of the window-head.
// The design (the frame of attention_bwd_f32_window.cuh, whose helpers it
// includes):
//  * a block's queries (q*scale in the packed family) stay resident,
//    k-major, and K and V arrive in slabs of 32 keys by 16-byte cp.async,
//    double-buffered, so the next slab's copy runs under this slab's
//    products;
//  * two blocks a window-head, each half of its queries, where two such
//    blocks fit an SM: each block's barriers and copies run under the
//    other's products, which beat one block of all the queries by 3.5-7 %
//    at d 64 (scripts/sweep_f32_window.py --forward: 0.572-0.581 against
//    0.615-0.625 ms at N 196), though K and V are read twice and 196 tokens
//    take 224 rows; at d 80 only a window of up to 160 tokens leaves room for
//    two, so 196 takes one block of 7 warps there (two blocks of 4 warps, one
//    an SM, were 14-25 % slower);
//  * the fw_ layout of the backward: 3 warps of 32 resident rows a block up
//    to 160 tokens (a 144-token window takes 2 x 96 rows); at d 64 4 warps of
//    28 up to 196 (7 x 4 score tiles, a thread drops the last of its 8 rows)
//    and 4 of 32 up to 224; at d 80 one block of 7 warps of 28 up to 196 (no
//    padded resident row) and 7 of 32 up to 224; a thread holds its rows'
//    scores of 4 keys of the slab, 12 shared loads for 128 FMAs;
//  * an online softmax over the slabs: a row's max is taken across the 8
//    lanes that share it by shuffles, never through shared memory, the
//    output and the partial sum are scaled to the new max, and the partial
//    sums are added across the lanes once at the end;
//  * P . V into an 8 x 8 register tile of the output (8 x 10 at d 80: 4 lk
//    .. 4 lk + 3 and 32 + 4 lk .. of each row, then 64 + lk and 72 + lk),
//    the thread's own rows, 4 shared loads (6 at d 80) for 64 (80) FMAs;
//  * p in a tile of its own, [32 keys][rows]: a warp writes and reads only
//    its own rows of it, so __syncwarp, and no block barrier, stands
//    between the scores, p and P . V; its row stride is the rows + 16, so
//    the 128-bit loads and stores of a quarter-warp fall in eight different
//    bank quads;
//  * the tables: each thread stages its row of rel_h and of rel_w once
//    ([16][rows] each, by its index), and before each slab's score product
//    writes its row of the slab's bias into the p tile, keys in order (slabs
//    of 32 keys need no whole grid rows: 144 tokens take 5 slabs, not 6);
//    the score epilogue reads it back 4 rows at a time;
//  * every output element has one owner that sums in a fixed order (c, then
//    the slab's keys, then the slabs; the lanes' sums by a butterfly, the
//    same in every lane), so a repeated call is bit-identical;
//  * d 64 and 80, 3, 4 or 7 warps, 7 or 8 rows a thread and one or two blocks
//    a window-head are template instances.
// Shared memory (ops/_attention.py::f32_window_forward_smem_bytes mirrors
// fwf_smem_bytes): the block's resident [D][T] queries, two stages of the
// [32][D + 4] K and V slabs, the [32][T + 16] p tile and the [2][16][T]
// tables: 86,016 B at d 64 and 100,352 B at d 80 for 96 rows, 102,400 B at
// d 64 for 128, 174,080 B at d 80 for 224, of the 232,448 a block may have
// (two blocks an SM take at most 233,472 B with 1,024 B reserved for each);
// registers up to 255 a thread (__launch_bounds__(32 * W, 1)), 0 bytes
// spilled, and chip_smoke.py phase 1 prints ptxas's counts and fails on a
// spill.
//
// Keys past n get s = -inf (p = 0) and are zeros in shared memory; rows past
// n and the 28-row layout's holes are computed and not written.

#pragma once

#include <math.h>

#include "attention_bwd_f32_window.cuh"  // the fw_ tiles, cp.async and loads
#include "common.cuh"

namespace wm {
namespace {

constexpr int kFwfLdPad = 16;  // the p tile's row stride is the rows + 16
constexpr int kSmSmemBytes = 233472;  // an SM's shared memory (228 KB)
constexpr int kSmBlockReserve = 1024; // of it reserved for each resident block

struct F32WinFwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  const float* relh;  // (B, n, H, gh) or null
  const float* relw;  // (B, n, H, gw)
  float* lse;         // (B, n, H) or null: not written
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // element strides
  int heads, n, gh, gw;
  float scale;
};

// Shared-memory bytes of an instantiation: D head columns, W warps.
__host__ __device__ constexpr int fwf_smem_bytes(int d, int w) {
  return 4 * (d * 32 * w + 2 * 2 * kFwSlab * (d + 4) + kFwSlab * (32 * w + kFwfLdPad) +
              2 * kFwMaxGrid * 32 * w);
}

// P blocks a window-head (blockIdx.x = (b * heads + h) * P + part), block
// `part` holding the tokens from part * T / 8 * R: W warps of 32 resident
// indices, R of every 8 a thread's rows (T / 8 * R tokens).
template <int D, int W, int R, int P, bool SCALE_SCORES>
__global__ void __launch_bounds__(32 * W, 1) attn_fwd_f32_window_kernel(F32WinFwdArgs a) {
  constexpr int T = 32 * W;       // threads, resident indices, the tables' row stride
  constexpr int LDX = T + kFwfLdPad;
  constexpr int S = kFwSlab;
  constexpr int LDT = D + 4;      // row stride of a slab
  constexpr int CH = D / 4;       // 16-byte chunks a row
  constexpr int NC = D / 8;       // output columns a thread holds
  constexpr int STAGE = 2 * S * LDT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [D][T] q*scale (packed) or q
  float* stages = qs + D * T;        // two stages of two [S][LDT] slabs: K, V
  float* xs = stages + 2 * STAGE;    // [S][LDX] the slab's bias, then p, key-major
  float* tabh = xs + S * LDX;        // [16][T] rel_h of the resident rows
  float* tabw = tabh + kFwMaxGrid * T;  // [16][T] rel_w

  const int wh = blockIdx.x / P, q0 = blockIdx.x % P * (T / 8 * R);  // q0: the block's first token
  const int h = wh % a.heads, b = wh / a.heads;
  const int n = a.n;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int lk = lane >> 2;
  const int r0 = 32 * warp + 4 * (lane & 3);
  const bool has_rel = a.relh != nullptr;
  const int gh = a.gh, gw = a.gw;
  const float* qg = a.q + b * a.q_bs + h * D;
  const float* kg = a.k + b * a.k_bs + h * D;
  const float* vg = a.v + b * a.v_bs + h * D;
  // row strides within a window-head, and the (B, N, H) index of token r,
  // tab0 + r * heads (32-bit: the entry refuses larger tensors)
  const int k_rs = (int)a.k_rs, v_rs = (int)a.v_rs;
  const int tab0 = b * n * a.heads + h;
  // the tokens of a thread's R rows (-1 for none), and of its index t
  int tok[R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    tok[e] = fw_real<R>(fb_row(r0, e));
    if (tok[e] >= 0) tok[e] += q0;
  }
  const int ttok = fw_real<R>(t) < 0 ? -1 : q0 + fw_real<R>(t);

  auto load_kv = [&](int kt) {
    float* s0 = stages + (kt & 1) * STAGE;
    float* s1 = s0 + S * LDT;
    const int k0 = kt * S;
    for (int e = t; e < S * CH; e += T) {
      const int r = e / CH, c = (e % CH) * 4;
      const bool in = k0 + r < n;
      const int row = in ? k0 + r : 0;
      fb_cp16(s0 + r * LDT + c, kg + row * k_rs + c, in);
      fb_cp16(s1 + r * LDT + c, vg + row * v_rs + c, in);
    }
    fb_commit();
  };
  load_kv(0);
  // the block's q*scale (or q), k-major at the tokens' indices; zeros past n
  fw_resident<D, T, R>(qs, qg + q0 * a.q_rs, (int)a.q_rs, n - q0,
                       SCALE_SCORES ? 1.f : a.scale);
  // thread t's rows of rel_h and rel_w, by its index
  if (has_rel) {
    const bool ok = ttok >= 0 && ttok < n;
    const int row = tab0 + (ok ? ttok : 0) * a.heads;
#pragma unroll
    for (int c = 0; c < kFwMaxGrid; ++c) {
      tabh[c * T + t] = (c < gh && ok) ? __ldg(a.relh + row * gh + c) : 0.f;
      tabw[c * T + t] = (c < gw && ok) ? __ldg(a.relw + row * gw + c) : 0.f;
    }
  }

  float acc[R][NC], m[R], l[R];
  fw_zero(acc);
#pragma unroll
  for (int e = 0; e < R; ++e) {
    m[e] = -INFINITY;
    l[e] = 0.f;
  }

  const int nkt = (n + S - 1) / S;
  for (int kt = 0; kt < nkt; ++kt) {
    fb_wait_all();
    __syncthreads();  // slab kt landed (q and the tables too); slab kt - 1 is read
    if (kt + 1 < nkt) load_kv(kt + 1);
    const float* ksl = stages + (kt & 1) * STAGE;
    const float* vsl = ksl + S * LDT;
    const int k0 = kt * S;
    const int kn = min(S, n - k0);  // keys of the slab
    if (has_rel) {
      // thread t's row of the slab's bias, keys in order (0 past n)
      int kh = k0 / gw, kw = k0 - kh * gw;
#pragma unroll 4
      for (int j = 0; j < S; ++j) {
        float bias = 0.f;
        if (j < kn) {
          bias = tabh[kh * T + t] + tabw[kw * T + t];
          if (++kw == gw) {
            kw = 0;
            ++kh;
          }
        }
        xs[j * LDX + t] = bias;
      }
    }

    // s = (q*scale) . k over c = 0 .. D-1 in order
    float s[R][4];
    fw_zero(s);
    fw_scores<D, 4, R>(s, qs, T, r0, ksl, LDT, lk);
    __syncwarp();  // the warp's rows of the bias tile

    // the scale on the scores, the bias, the mask
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int slot = lk + 8 * j;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (has_rel) {
        lo = fb_ld4(xs + slot * LDX + r0);
        hi = fb_ld4(xs + slot * LDX + r0 + 16);
      }
#pragma unroll
      for (int e = 0; e < R; ++e) {
        float sv = SCALE_SCORES ? s[e][j] * a.scale : s[e][j];
        sv += e < 4 ? fb_at(lo, e) : fb_at(hi, e - 4);
        s[e][j] = slot < kn ? sv : -INFINITY;
      }
    }
    // the online softmax of the thread's rows: the slab's max across the 8
    // lanes of a row, the output and the partial sum scaled to the new max
#pragma unroll
    for (int e = 0; e < R; ++e) {
      float mx = fmaxf(fmaxf(s[e][0], s[e][1]), fmaxf(s[e][2], s[e][3]));
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[e], mx);  // finite: every slab holds a key
      const float alpha = __expf(m[e] - mn);
      m[e] = mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[e][j] = __expf(s[e][j] - mn);
        sum += s[e][j];
      }
      l[e] = fmaf(l[e], alpha, sum);
#pragma unroll
      for (int x = 0; x < NC; ++x) acc[e][x] *= alpha;
    }

    // acc += p . v over the slab's keys in order, p through the warp's rows
    // of the tile
    __syncwarp();  // the warp's reads of its bias rows are done
    fw_put<R>(xs, LDX, r0, lk, s);
    __syncwarp();  // the warp's rows of p
    fw_grad<D, R>(acc, xs, LDX, r0, vsl, LDT, lk, kn);
  }

  // the row sums across the row's 8 lanes (a butterfly: the same in every
  // lane bit for bit), then out = acc / l and lse = m + log l
  float* og = a.o + b * a.o_bs + h * D;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    float sum = l[e];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tok[e] < 0 || tok[e] >= n) continue;
    fw_store_row<D>(og + tok[e] * (int)a.o_rs, acc[e], 1.f / sum, lk);
    if (a.lse != nullptr && lk == 0) a.lse[tab0 + tok[e] * a.heads] = m[e] + logf(sum);
  }
}

template <int D, int W, int R, int P, bool SCALE_SCORES>
cudaError_t launch_f32_window_fwd(const F32WinFwdArgs& a, int batch, cudaStream_t stream) {
  static_assert(fwf_smem_bytes(D, W) <= kMaxSmemBytes, "shared memory");
  static_assert(P == 1 || 2 * (fwf_smem_bytes(D, W) + kSmBlockReserve) <= kSmSmemBytes,
                "two blocks an SM");
  const size_t smem = fwf_smem_bytes(D, W);
  auto kernel = attn_fwd_f32_window_kernel<D, W, R, P, SCALE_SCORES>;
  const long long blocks = (long long)batch * a.heads * P;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, 32 * W, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instantiation a window of n tokens takes: two blocks a window-head,
// each half of the queries, where two such blocks fit an SM (two blocks an SM
// hide each other's barriers and copies: 3.5-7 % faster than one block of
// all the queries, for 14 % more padded rows at 196 tokens): 3 warps of 32
// rows up to 160 tokens, and at d 64 4 warps of 28 up to 196 and 4 of 32 up
// to kFwMaxTokens. At d 80 a block of 4 warps takes 118,784 B, so one block
// an SM: one block a window-head there, 7 warps of 28 rows up to 196 and 7 of
// 32 up to kFwMaxTokens (two blocks of 4 warps were 14-25 % slower).
template <int D, bool SCALE_SCORES>
cudaError_t launch_f32_window_fwd_for(const F32WinFwdArgs& a, int batch, cudaStream_t stream) {
  if (a.n <= 160) return launch_f32_window_fwd<D, 3, 8, 2, SCALE_SCORES>(a, batch, stream);
  if constexpr (D == 64) {
    if (a.n <= 196) return launch_f32_window_fwd<D, 4, 7, 2, SCALE_SCORES>(a, batch, stream);
    return launch_f32_window_fwd<D, 4, 8, 2, SCALE_SCORES>(a, batch, stream);
  } else {
    if (a.n <= 196) return launch_f32_window_fwd<D, 7, 7, 1, SCALE_SCORES>(a, batch, stream);
    return launch_f32_window_fwd<D, 7, 8, 1, SCALE_SCORES>(a, batch, stream);
  }
}

// The body of a plain C entry with the forward's arguments
// (attention_fwd.cuh): out and, when lse is given, the lse of every
// window-head. relh / relw may be null (no bias). Refuses another dtype than
// f32, a head dim other than 64 or 80, N != M, more than kFwMaxTokens tokens,
// tables wider or taller than kFwMaxGrid or that do not cover the keys, and
// tensors whose offsets do not fit 32 bits.
template <bool SCALE_SCORES>
int attention_fwd_f32_window_entry(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* relh, const void* relw, void* lse,
                                   int batch, int heads, int nq, int nk, int d, long long q_bs,
                                   long long q_rs, long long k_bs, long long k_rs,
                                   long long v_bs, long long v_rs, long long o_bs,
                                   long long o_rs, int gh, int gw, float scale, void* stream) {
  const bool rel = relh != nullptr;
  const long long strides[4] = {q_rs, k_rs, v_rs, o_rs};
  long long rs_max = 0;
  for (long long rs : strides) rs_max = rs > rs_max ? rs : rs_max;
  const long long tab_elems = (long long)batch * nq * heads * kFwMaxGrid;
  if (dtype != kFloat32 || (d != 64 && d != 80) || nq != nk || nq < 1 || nq > kFwMaxTokens ||
      batch < 1 || heads < 1 || rel != (relw != nullptr) ||
      (rel && (gh < 1 || gw < 1 || gh > kFwMaxGrid || gw > kFwMaxGrid || gh * gw != nk)) ||
      rs_max * nq > 2147483647LL || tab_elems > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  F32WinFwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.relh = static_cast<const float*>(relh);
  a.relw = static_cast<const float*>(relw);
  a.lse = static_cast<float*>(lse);
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.heads = heads;
  a.n = nq;
  a.gh = rel ? gh : 0;
  a.gw = rel ? gw : 0;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(d == 64 ? launch_f32_window_fwd_for<64, SCALE_SCORES>(a, batch, s)
                       : launch_f32_window_fwd_for<80, SCALE_SCORES>(a, batch, s));
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header,
// for the packed family (scale_scores false) or the grouped one (true).
#define WM_DEFINE_ATTENTION_FWD_F32_WINDOW(name, scale_scores)                            \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, void* o,     \
                      const void* relh, const void* relw, void* lse, int batch, int heads, \
                      int nq, int nk, int d, long long q_bs, long long q_rs,               \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,      \
                      long long o_bs, long long o_rs, int gh, int gw, float scale,         \
                      void* stream) {                                                       \
    return wm::attention_fwd_f32_window_entry<scale_scores>(                               \
        dtype, q, k, v, o, relh, relw, lse, batch, heads, nq, nk, d, q_bs, q_rs, k_bs,     \
        k_rs, v_bs, v_rs, o_bs, o_rs, gh, gw, scale, stream);                              \
  }
