// Backward of the multi-head attention in f32 on Hopper's CUDA cores, at the
// streaming shapes: two kernels, register-tiled. Two sources instantiate
// them, one nvcc each:
//
//   attention_bwd_f32.cu (SCALE_SCORES = false), the packed family:
//   K2 wildlifemapper_tpu/ops/flash_attention_v2.py::_bwd_dq_kernel (:229,
//      pallas_call :364) and ::_bwd_dkv_kernel (:276, pallas_call :392)
//
//   grouped_attention_bwd_f32.cu (SCALE_SCORES = true), the grouped family:
//   K5 wildlifemapper_tpu/ops/flash_attention.py::_bwd_kernel (:133,
//      pallas_call :268)
//
// The function is the tile body's (attention_bwd.cuh), with each family's
// rounding points: s = (q*scale).k (packed) or (q.k)*scale (grouped), plus
// bias = rel_h[q, k / gw] + rel_w[q, k % gw]; p = exp(s - lse) from the
// forward's lse; delta = rowsum(do * o); ds = p * (dp - delta) with
// dp = do . v^T; dq = (ds . k) * scale, dk = (ds^T . q) * scale,
// dv = p^T . do; drel_h / drel_w the row and column sums of ds over the
// grid, written only when wanted. No TF32: every product is an f32 FMA.
// ops/_attention.py::attention_body sends here f32 backward launches at
// d = 64 or 80 with at least 512 keys whose rel grid (if any) has gw of 16,
// 24, 32, 48 or 64: K2 at N 4096 and 2304, K5 at BH 48, ViT-H's K2 / K5 at
// d 80 and the tensor-parallel ranks' heads. K4 (d 128, no tables) takes the
// d-128 kernels of attention_bwd_f32_d128.cuh, built on this header's
// helpers; the f32 windows take attention_bwd_f32_window.cuh; other grids,
// d 32 and d 128 with tables stay on the tile bodies.
//
// What bounds it on the H100: seven products of N^2 d MACs a head (S, dP
// and dq in the dq kernel; S, dP, dV and dK in the dk/dv kernel: two more
// than the function needs, so that no output is summed by two blocks)
// against O(N d) bytes, so operations, at 67 TFLOP/s without tensor cores.
// At B 4, H 12, N 4096, d 64 that is 721 GFLOP, 10.8 ms at the peak (the
// function's five products 7.74 ms). The tile body reached 10.5x that bound:
// one shared load per FMA, 64 x 64 tiles at one row a thread, scalar loads
// behind a barrier. On the CUDA cores the next limit is shared memory: an SM
// delivers 128 bytes a clock to its 128 FMA lanes, so a product runs at the
// FMA rate only where a thread makes 4 FMAs of every float it loads. The
// design:
//  * each kernel keeps a block of 128 rows resident (queries in the dq
//    kernel: q, scaled for the packed family, and do; keys in the dk/dv
//    kernel: K and V), staged k-major in shared memory, and walks tiles of
//    64 rows of the other side that arrive by 16-byte cp.async,
//    double-buffered: the next tile's copy runs under this tile's products;
//  * 256 threads, 8 warps of 32 rows x 32 columns of a score tile; a thread
//    holds an 8 x 4 register tile (8 x 3 on 48-key tiles): its 8 resident
//    rows are two 128-bit loads a step (two runs of 64 bytes a warp), each
//    streamed row's next 4 columns one more, 12 shared loads for 128 FMAs,
//    2.67 FMAs a float; the 8 streamed rows a warp reads at once sit in 8
//    different bank quads (row stride d + 4). A wider tile does not fit:
//    the scores, the dq (or dK and dV) accumulators and the rel columns
//    held over the walk take 200-255 registers a thread as it is;
//  * S and dP never live together: p goes to the tile in shared memory,
//    then dP is taken and ds = p * (dp - delta) is made over p in place,
//    each thread its own elements; the gradient products read that tile
//    key-major (query-major in the dk/dv kernel) with the same 8 x 4 (8 x 5
//    at d 80) register tiling, the dk/dv kernel p for dV, then ds for dK;
//  * delta inside the dq kernel: two lanes a row take rowsum(do * o) as the
//    block loads do, and leave it in a (B, N, H) scratch for the dk/dv
//    kernel; no plain delta pass runs;
//  * the rel tables by whole grid rows: a key tile of the dq kernel is 64
//    keys (48 where gw divides 48 but not 64), a whole number of grid rows,
//    so every key slot of a thread has one rel_w column over the walk:
//    rel_w sits in registers and drel_w sums in registers per slot, folded
//    over the slots of one column once at the end; rel_h is read once a
//    tile for at most two grid rows, and drel_h is each tile's grid rows
//    summed from the ds tile, two lanes a row. In the dk/dv kernel each
//    run of 4 keys lies in one grid row, so a query's bias is one rel_h
//    value and one 16-byte piece of rel_w, read before the products;
//  * d 64 and 80 are template instances: 16 or 20 chunks of 4 a row, and at
//    d 80 one more output column a thread in the gradient products.
// Shared memory: the dq kernel 169,984 B (d 64) / 202,752 B (d 80), the
// dk/dv kernel up to 224,256 B (d 80, packed: q*scale once a tile): one
// block an SM, 8 warps; registers up to 255 a thread
// (__launch_bounds__(256, 1)), 0 bytes spilled, and chip_smoke.py phase 1
// prints ptxas's counts. Every output element has one owner that sums in a
// fixed order (c, then j, then tile; the pair sums are commutative), so
// there are no atomics and a repeated call is bit-identical.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

constexpr int kFbRows = 128;     // resident rows of a block: queries or keys
constexpr int kFbQTile = 64;     // queries of a tile in the dk/dv kernel's walk
constexpr int kFbThreads = 256;

struct F32BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* out;
  const float* lse;      // (B, nq, H)
  float* delta;          // (B, nq, H): written by the dq kernel for the dk/dv kernel
  const float* relh;     // (B, nq, H, gh) or null
  const float* relw;     // (B, nq, H, gw)
  float* dq;
  float* dk;
  float* dv;
  float* drelh;          // (B, nq, H, gh) or null: not wanted
  float* drelw;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs;  // element strides
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int heads, nq, nk, gh, gw;
  float scale;
};

// The key tile of the dq kernel for a grid gw wide (0: no tables): 64 keys,
// or 48 where gw divides 48 and not 64; 0 where the body takes no such grid.
__host__ __device__ inline int f32_key_tile(int gw) {
  if (gw == 0) return 64;
  if (gw < 16 || gw % 8 != 0) return 0;
  if (64 % gw == 0) return 64;
  if (48 % gw == 0) return 48;
  return 0;
}

__device__ __forceinline__ unsigned fb_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared memory; zeros where !in.
__device__ __forceinline__ void fb_cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fb_smem(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void fb_cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(fb_smem(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void fb_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void fb_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
// Until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void fb_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float4 fb_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 fb_ldg4(const float* p, bool in) {
  return in ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float fb_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// `rows` rows of COLS floats from row r0 of `src` (row stride rs) into a
// [rows][ld] tile by 16-byte cp.async, zeros from row n on; no commit.
template <int COLS>
__device__ __forceinline__ void fb_copy_rows(float* dst, int ld, const float* src, long long rs,
                                             int r0, int rows, int n, int t) {
  constexpr int CH = COLS / 4;
  for (int e = t; e < rows * CH; e += kFbThreads) {
    const int r = e / CH, c = (e % CH) * 4;
    const bool in = r0 + r < n;
    fb_cp16(dst + r * ld + c, src + (in ? r0 + r : 0) * rs + c, in);
  }
}

// A thread's 8 resident rows: r0 .. r0+3 and r0+16 .. r0+19, so that a
// warp's 128-bit loads of them read two runs of 64 contiguous bytes.
__device__ __forceinline__ int fb_row(int r0, int e) { return r0 + (e & 3) + 16 * (e >> 2); }

// acc[e][n] += sum_c at[c * lda + fb_row(r0, e)] * b[(j0 + 8n) * ldb + c],
// c = 0 .. D-1 in order: `at` k-major (the resident rows), `b` row-major (the
// streamed rows). 8 + N shared loads for 32 N FMAs every 4 c.
template <int D, int N>
__device__ __forceinline__ void fb_scores(float (&acc)[8][N], const float* at, int lda, int r0,
                                          const float* b, int ldb, int j0) {
#pragma unroll
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
        acc[7][n] = fmaf(hi.w, bn, acc[7][n]);
      }
    }
  }
}

// The output columns a thread holds in a gradient product: c4 .. c4+3 and,
// at d 80, one of the last 16.
template <int D>
struct FbCols {
  static constexpr int N = D == 80 ? 5 : 4;
};

// acc[e][x] += sum_j g[j * ldg + fb_row(r0, e)] * b[j * ldb + col_x], j = 0 ..
// J-1 in order, col = c4 .. c4+3 (and ce at d 80): `g` k-major (p or ds),
// `b` row-major (K, q or do). 3 shared loads (4 at d 80) for 32 (40) FMAs.
template <int D, int J>
__device__ __forceinline__ void fb_grad(float (&acc)[8][FbCols<D>::N], const float* g, int ldg,
                                        int r0, const float* b, int ldb, int c4, int ce) {
#pragma unroll 8
  for (int j = 0; j < J; ++j) {
    const float4 lo = fb_ld4(g + j * ldg + r0);
    const float4 hi = fb_ld4(g + j * ldg + r0 + 16);
    const float4 bv = fb_ld4(b + j * ldb + c4);
    float bx[FbCols<D>::N];
    bx[0] = bv.x;
    bx[1] = bv.y;
    bx[2] = bv.z;
    bx[3] = bv.w;
    if constexpr (D == 80) bx[4] = b[j * ldb + ce];
#pragma unroll
    for (int x = 0; x < FbCols<D>::N; ++x) {
      acc[0][x] = fmaf(lo.x, bx[x], acc[0][x]);
      acc[1][x] = fmaf(lo.y, bx[x], acc[1][x]);
      acc[2][x] = fmaf(lo.z, bx[x], acc[2][x]);
      acc[3][x] = fmaf(lo.w, bx[x], acc[3][x]);
      acc[4][x] = fmaf(hi.x, bx[x], acc[4][x]);
      acc[5][x] = fmaf(hi.y, bx[x], acc[5][x]);
      acc[6][x] = fmaf(hi.z, bx[x], acc[6][x]);
      acc[7][x] = fmaf(hi.w, bx[x], acc[7][x]);
    }
  }
}

// Two lanes' partial sums of one row, the same in each lane bit for bit.
__device__ __forceinline__ float fb_pair_sum(float x) {
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

// A thread's 8 x N tile into a k-major tile of shared memory (row stride ld):
// element [e][n] at x[(j0 + 8n) * ld + fb_row(r0, e)], or back.
template <int N>
__device__ __forceinline__ void fb_put(float* x, int ld, int r0, int j0, const float (&v)[8][N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float* at = x + (j0 + 8 * n) * ld + r0;
    *reinterpret_cast<float4*>(at) = make_float4(v[0][n], v[1][n], v[2][n], v[3][n]);
    *reinterpret_cast<float4*>(at + 16) = make_float4(v[4][n], v[5][n], v[6][n], v[7][n]);
  }
}
template <int N>
__device__ __forceinline__ void fb_get(const float* x, int ld, int r0, int j0, float (&v)[8][N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const float4 lo = fb_ld4(x + (j0 + 8 * n) * ld + r0);
    const float4 hi = fb_ld4(x + (j0 + 8 * n) * ld + r0 + 16);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e][n] = fb_at(lo, e);
      v[e + 4][n] = fb_at(hi, e);
    }
  }
}

template <int D>
__device__ __forceinline__ void fb_store_row(float* row, const float (&acc)[FbCols<D>::N],
                                             float mul, int c4, int ce) {
  *reinterpret_cast<float4*>(row + c4) =
      make_float4(acc[0] * mul, acc[1] * mul, acc[2] * mul, acc[3] * mul);
  if constexpr (D == 80) row[ce] = acc[4] * mul;
}

// ---- the dq kernel: q-blocks of 128 rows walk K/V tiles of BK keys ---------

template <int D, int BK, bool SCALE_SCORES>
__global__ void __launch_bounds__(kFbThreads, 1) attn_bwd_f32_dq_kernel(F32BwdArgs a) {
  constexpr int BQ = kFbRows;
  constexpr int NJ = BK / 16;   // keys of a tile a thread holds
  constexpr int LDT = D + 4;    // row stride of the K and V tiles
  constexpr int LDX = BQ + 4;   // row stride of the p / ds tile
  constexpr int CH = D / 4;     // 16-byte chunks a row
  constexpr int NC = FbCols<D>::N;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [D][BQ] q*scale (packed) or q, k-major
  float* dot = qt + D * BQ;     // [D][BQ] do, k-major
  float* kv = dot + D * BQ;     // two stages of K [BK][LDT] then V [BK][LDT]
  float* xs = kv + 4 * BK * LDT;   // [BK][LDX] the tile's p, then its ds, key-major
  float* lses = xs + BK * LDX;     // [BQ]
  float* dels = lses + BQ;         // [BQ]

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bool has_rel = a.relh != nullptr;
  const bool want_drel = a.drelh != nullptr;
  const float* qg = a.q + b * a.q_bs + h * D;
  const float* kg = a.k + b * a.k_bs + h * D;
  const float* vg = a.v + b * a.v_bs + h * D;
  const float* dog = a.dout + b * a.do_bs + h * D;
  const float* og = a.out + b * a.o_bs + h * D;

  auto load_tile = [&](int kt) {
    float* ks = kv + (kt & 1) * 2 * BK * LDT;
    float* vs = ks + BK * LDT;
    const int k0 = kt * BK;
    for (int e = t; e < BK * CH; e += kFbThreads) {
      const int r = e / CH, c = (e % CH) * 4;
      const bool in = k0 + r < a.nk;
      const long long row = in ? k0 + r : 0;
      fb_cp16(ks + r * LDT + c, kg + row * a.k_rs + c, in);
      fb_cp16(vs + r * LDT + c, vg + row * a.v_rs + c, in);
    }
    fb_commit();
  };
  load_tile(0);

  // q and do, k-major, and delta = rowsum(do * o): two lanes a row, each its
  // chunks part, part + 2, ... in order, then the pair's sum.
  {
    const int row = t >> 1, part = t & 1;
    const bool ok = q0 + row < a.nq;
    const long long gr = ok ? q0 + row : 0;
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      const int c = 4 * (part + 2 * m);
      float4 qv = fb_ldg4(qg + gr * a.q_rs + c, ok);
      const float4 dv = fb_ldg4(dog + gr * a.do_rs + c, ok);
      const float4 ov = fb_ldg4(og + gr * a.o_rs + c, ok);
      if (!SCALE_SCORES) {
        qv.x *= a.scale;
        qv.y *= a.scale;
        qv.z *= a.scale;
        qv.w *= a.scale;
      }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        qt[(c + x) * BQ + row] = fb_at(qv, x);
        dot[(c + x) * BQ + row] = fb_at(dv, x);
        sum = fmaf(fb_at(dv, x), fb_at(ov, x), sum);
      }
    }
    sum = fb_pair_sum(sum);
    if (part == 0) {
      const long long stat = ((long long)b * a.nq + gr) * a.heads + h;
      lses[row] = ok ? a.lse[stat] : 0.f;
      dels[row] = ok ? sum : 0.f;
      if (ok) a.delta[stat] = sum;
    }
  }

  // Scores: warp (wr, wc) takes rows 32 wr .. +31 and keys wc * 8 NJ ..; a
  // thread rows fb_row(r0, e) and keys j0 + 8n. dq: the same rows, columns
  // c4 .. c4+3 and ce (d 80).
  const int wr = warp & 3, wc = warp >> 2;
  const int lr = lane & 3, lk = lane >> 2;
  const int r0 = 32 * wr + 4 * lr;
  const int j0 = wc * 8 * NJ + lk;
  const int c4 = 32 * wc + 4 * lk;
  const int ce = 64 + 8 * wc + lk;
  // the rel tables' rows of the thread's queries: rows(e) + the row's offset
  const float* relh_row = a.relh + (((long long)b * a.nq + q0) * a.heads + h) * a.gh;
  const float* relw_row = a.relw + (((long long)b * a.nq + q0) * a.heads + h) * a.gw;
  const int relh_step = a.heads * a.gh, relw_step = a.heads * a.gw;
  bool rok[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) rok[e] = q0 + fb_row(r0, e) < a.nq;
  // A tile is a whole number of grid rows, so slot j0 + 8n reads one rel_w
  // column over the whole walk.
  float relw[8][NJ], drw[8][NJ];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      relw[e][n] = (has_rel && rok[e])
                       ? __ldg(relw_row + fb_row(r0, e) * relw_step + (j0 + 8 * n) % a.gw)
                       : 0.f;
      drw[e][n] = 0.f;
    }
  const int grid_rows = has_rel ? BK / a.gw : 0;  // grid rows a tile

  float acc[8][NC];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int x = 0; x < NC; ++x) acc[e][x] = 0.f;

  const int nkt = (a.nk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    fb_wait_all();
    __syncthreads();  // tile kt landed; the previous tile's products are done
    if (kt + 1 < nkt) load_tile(kt + 1);
    const float* ks = kv + (kt & 1) * 2 * BK * LDT;
    const float* vs = ks + BK * LDT;
    const int k0 = kt * BK;

    // rel_h of the thread's keys: at most two grid rows (gw >= 16 and the
    // slots lie in 8 NJ keys), read before the products
    int grA = 0, grB = 0;
    float rhA[8], rhB[8];
    if (has_rel) {
      grA = min((k0 + j0) / a.gw, a.gh - 1);
      grB = min((k0 + j0 + 8 * (NJ - 1)) / a.gw, a.gh - 1);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float* rh = relh_row + fb_row(r0, e) * relh_step;
        rhA[e] = rok[e] ? __ldg(rh + grA) : 0.f;
        rhB[e] = (rok[e] && grB != grA) ? __ldg(rh + grB) : rhA[e];
      }
    }

    // p = exp(s + bias - lse), into the tile; 0 past the keys and rows
    {
      float s[8][NJ];
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int n = 0; n < NJ; ++n) s[e][n] = 0.f;
      fb_scores<D, NJ>(s, qt, BQ, r0, ks, LDT, j0);
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        const int key = k0 + j0 + 8 * n;
        const bool rowA = has_rel && min(key / a.gw, a.gh - 1) == grA;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float p = 0.f;
          if (key < a.nk && rok[e]) {
            float sv = SCALE_SCORES ? s[e][n] * a.scale : s[e][n];
            if (has_rel) sv += (rowA ? rhA[e] : rhB[e]) + relw[e][n];
            p = __expf(sv - lses[fb_row(r0, e)]);
          }
          s[e][n] = p;
        }
      }
      fb_put<NJ>(xs, LDX, r0, j0, s);
    }
    // ds = p * (dp - delta), over p in place (each thread its own elements)
    {
      float dp[8][NJ], p[8][NJ];
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int n = 0; n < NJ; ++n) dp[e][n] = 0.f;
      fb_scores<D, NJ>(dp, dot, BQ, r0, vs, LDT, j0);
      fb_get<NJ>(xs, LDX, r0, j0, p);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float del = dels[fb_row(r0, e)];
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
          p[e][n] *= dp[e][n] - del;
          drw[e][n] += p[e][n];
        }
      }
      fb_put<NJ>(xs, LDX, r0, j0, p);
    }
    __syncthreads();  // the ds tile

    fb_grad<D, BK>(acc, xs, LDX, r0, ks, LDT, c4, ce);
    if (want_drel) {
      // drel_h: each grid row of the tile, gw keys, two lanes a query row
      const int row = t >> 1, part = t & 1;
      for (int rr = 0; rr < grid_rows; ++rr) {
        float sum = 0.f;
        for (int j = rr * a.gw + part; j < (rr + 1) * a.gw; j += 2) sum += xs[j * LDX + row];
        sum = fb_pair_sum(sum);
        const int gr = kt * grid_rows + rr;
        if (part == 0 && q0 + row < a.nq && gr < a.gh)
          a.drelh[(((long long)b * a.nq + q0 + row) * a.heads + h) * a.gh + gr] = sum;
      }
    }
  }

  float* dqg = a.dq + b * a.dq_bs + h * D;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (rok[e]) fb_store_row<D>(dqg + (q0 + fb_row(r0, e)) * a.dq_rs, acc[e], a.scale, c4, ce);

  if (want_drel) {
    // drel_w: each slot's sum over the walk, folded over the slots of one
    // column (j = c, c + gw, ...) in order
    constexpr int LDW = BK + 1;
    float* w = kv;  // [BQ][LDW]; the stages are free after the walk
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int n = 0; n < NJ; ++n) w[fb_row(r0, e) * LDW + j0 + 8 * n] = drw[e][n];
    __syncthreads();
    for (int x = t; x < BQ * a.gw; x += kFbThreads) {
      const int row = x / a.gw, c = x % a.gw;
      if (q0 + row >= a.nq) continue;
      float sum = 0.f;
      for (int j = c; j < BK; j += a.gw) sum += w[row * LDW + j];
      a.drelw[(((long long)b * a.nq + q0 + row) * a.heads + h) * a.gw + c] = sum;
    }
  }
}

// ---- the dk/dv kernel: k-blocks of 128 keys walk q/do tiles of 64 queries --

template <int D, bool SCALE_SCORES>
__global__ void __launch_bounds__(kFbThreads, 1) attn_bwd_f32_dkv_kernel(F32BwdArgs a) {
  constexpr int BKB = kFbRows;
  constexpr int BQT = kFbQTile;
  constexpr int NI = BQT / 16;  // queries of a tile a thread holds
  constexpr int LDT = D + 4;    // row stride of the q, do and q*scale tiles
  constexpr int LDX = BKB + 4;  // row stride of the p / ds tile
  constexpr int CH = D / 4;
  constexpr int NC = FbCols<D>::N;
  constexpr int STAGE = 2 * BQT * LDT + 2 * BQT;  // q, do [BQT][LDT]; lse, delta [BQT]
  extern __shared__ __align__(16) float smem[];
  float* kt_ = smem;                // [D][BKB] K, k-major
  float* vt_ = kt_ + D * BKB;       // [D][BKB] V, k-major
  float* xs = vt_ + D * BKB;        // [BQT][LDX] the tile's p, then its ds, query-major
  float* qsc = xs + BQT * LDX;      // [BQT][LDT] q*scale (packed family)
  float* stages = qsc + (SCALE_SCORES ? 0 : BQT * LDT);

  const int k0 = blockIdx.x * BKB, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const bool has_rel = a.relh != nullptr;
  const float* qg = a.q + b * a.q_bs + h * D;
  const float* kg = a.k + b * a.k_bs + h * D;
  const float* vg = a.v + b * a.v_bs + h * D;
  const float* dog = a.dout + b * a.do_bs + h * D;

  auto load_tile = [&](int qt) {
    float* qs = stages + (qt & 1) * STAGE;
    float* dos = qs + BQT * LDT;
    float* ls = dos + BQT * LDT;
    float* dl = ls + BQT;
    const int q0 = qt * BQT;
    for (int e = t; e < BQT * CH; e += kFbThreads) {
      const int r = e / CH, c = (e % CH) * 4;
      const bool in = q0 + r < a.nq;
      const long long row = in ? q0 + r : 0;
      fb_cp16(qs + r * LDT + c, qg + row * a.q_rs + c, in);
      fb_cp16(dos + r * LDT + c, dog + row * a.do_rs + c, in);
    }
    if (t < 2 * BQT) {
      const int r = t % BQT;
      const bool in = q0 + r < a.nq;
      const long long stat = ((long long)b * a.nq + (in ? q0 + r : 0)) * a.heads + h;
      if (t < BQT)
        fb_cp4(ls + r, a.lse + stat, in);
      else
        fb_cp4(dl + r, a.delta + stat, in);
    }
    fb_commit();
  };
  load_tile(0);

  // K and V, k-major: two lanes a key
  {
    const int row = t >> 1, part = t & 1;
    const bool ok = k0 + row < a.nk;
    const long long gr = ok ? k0 + row : 0;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      const int c = 4 * (part + 2 * m);
      const float4 kv4 = fb_ldg4(kg + gr * a.k_rs + c, ok);
      const float4 vv4 = fb_ldg4(vg + gr * a.v_rs + c, ok);
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        kt_[(c + x) * BKB + row] = fb_at(kv4, x);
        vt_[(c + x) * BKB + row] = fb_at(vv4, x);
      }
    }
  }

  // Scores transposed: warp (wr, wc) takes keys 32 wr .. +31 and queries
  // 32 wc ..; a thread keys fb_row(r0, e) and queries i0 + 8n. dK, dV: the
  // same keys, columns c4 .. c4+3 and ce (d 80).
  const int wr = warp & 3, wc = warp >> 2;
  const int lr = lane & 3, lk = lane >> 2;
  const int r0 = 32 * wr + 4 * lr;
  const int i0 = 32 * wc + lk;
  const int c4 = 32 * wc + 4 * lk;
  const int ce = 64 + 8 * wc + lk;
  bool kok[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) kok[e] = k0 + fb_row(r0, e) < a.nk;
  // The thread's keys are two runs of 4 from a multiple of 4, each in one
  // grid row (gw is a multiple of 8): its grid row and first column.
  int kh[2] = {0, 0}, kw[2] = {0, 0};
  if (has_rel) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const int key = min(k0 + r0 + 16 * g, a.nk - 1);
      kh[g] = key / a.gw;
      kw[g] = key % a.gw / 4 * 4;
    }
  }
  float dkacc[8][NC], dvacc[8][NC];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int x = 0; x < NC; ++x) dkacc[e][x] = dvacc[e][x] = 0.f;

  const int nqt = (a.nq + BQT - 1) / BQT;
  for (int qt = 0; qt < nqt; ++qt) {
    fb_wait_all();
    __syncthreads();  // tile qt landed; the previous tile's products are done
    if (qt + 1 < nqt) load_tile(qt + 1);
    const float* qs = stages + (qt & 1) * STAGE;
    const float* dos = qs + BQT * LDT;
    const float* ls = dos + BQT * LDT;
    const float* dl = ls + BQT;
    const int q0 = qt * BQT;
    const float* qa = qs;
    if (!SCALE_SCORES) {  // the packed family's q*scale, once a tile
      for (int e = t; e < BQT * CH; e += kFbThreads) {
        const int r = e / CH, c = (e % CH) * 4;
        float4 v = fb_ld4(qs + r * LDT + c);
        v.x *= a.scale;
        v.y *= a.scale;
        v.z *= a.scale;
        v.w *= a.scale;
        *reinterpret_cast<float4*>(qsc + r * LDT + c) = v;
      }
      __syncthreads();
      qa = qsc;
    }

    // the tables' bias of the thread's scores, read before the products
    float4 rw4[NI][2];
    float rh1[NI][2];
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int qi = q0 + i0 + 8 * n;
      const bool in = has_rel && qi < a.nq;
      const long long stat = ((long long)b * a.nq + (in ? qi : 0)) * a.heads + h;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        rw4[n][g] = fb_ldg4(a.relw + stat * a.gw + kw[g], in);
        rh1[n][g] = in ? __ldg(a.relh + stat * a.gh + kh[g]) : 0.f;
      }
    }

    float p[8][NI], ds[8][NI];
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int n = 0; n < NI; ++n) p[e][n] = ds[e][n] = 0.f;
    fb_scores<D, NI>(p, kt_, BKB, r0, qa, LDT, i0);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int i = i0 + 8 * n;
      const bool qok = q0 + i < a.nq;
      const float lse = ls[i];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float pv = 0.f;
        if (kok[e] && qok) {
          float sv = SCALE_SCORES ? p[e][n] * a.scale : p[e][n];
          if (has_rel) sv += rh1[n][e >> 2] + fb_at(rw4[n][e >> 2], e & 3);
          pv = __expf(sv - lse);
        }
        p[e][n] = pv;
      }
    }
    fb_scores<D, NI>(ds, vt_, BKB, r0, dos, LDT, i0);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const float del = dl[i0 + 8 * n];
#pragma unroll
      for (int e = 0; e < 8; ++e) ds[e][n] = p[e][n] * (ds[e][n] - del);
    }

    // dV += p^T . do, then dK += ds^T . q through the one tile
    fb_put<NI>(xs, LDX, r0, i0, p);
    __syncthreads();
    fb_grad<D, BQT>(dvacc, xs, LDX, r0, dos, LDT, c4, ce);
    __syncthreads();
    fb_put<NI>(xs, LDX, r0, i0, ds);
    __syncthreads();
    fb_grad<D, BQT>(dkacc, xs, LDX, r0, qs, LDT, c4, ce);
  }

  float* dkg = a.dk + b * a.dk_bs + h * D;
  float* dvg = a.dv + b * a.dv_bs + h * D;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (kok[e]) {
      const int key = k0 + fb_row(r0, e);
      fb_store_row<D>(dkg + key * a.dk_rs, dkacc[e], a.scale, c4, ce);
      fb_store_row<D>(dvg + key * a.dv_rs, dvacc[e], 1.f, c4, ce);
    }
}

// ---- launchers ----------------------------------------------------------------

template <typename Kernel>
cudaError_t fb_launch(Kernel kernel, const F32BwdArgs& a, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  if (smem > (size_t)kMaxSmemBytes || grid.y > 65535u || grid.z > 65535u)
    return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFbThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, int BK, bool SCALE_SCORES>
cudaError_t launch_f32_dq(const F32BwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem =
      4 * (size_t)(2 * D * kFbRows + 4 * BK * (D + 4) + BK * (kFbRows + 4) + 2 * kFbRows);
  const dim3 grid((a.nq + kFbRows - 1) / kFbRows, a.heads, batch);
  return fb_launch(attn_bwd_f32_dq_kernel<D, BK, SCALE_SCORES>, a, grid, smem, stream);
}

template <int D, bool SCALE_SCORES>
cudaError_t launch_f32_dkv(const F32BwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = 4 * (size_t)(2 * D * kFbRows + kFbQTile * (kFbRows + 4) +
                                   (SCALE_SCORES ? 0 : kFbQTile * (D + 4)) +
                                   2 * (2 * kFbQTile * (D + 4) + 2 * kFbQTile));
  const dim3 grid((a.nk + kFbRows - 1) / kFbRows, a.heads, batch);
  return fb_launch(attn_bwd_f32_dkv_kernel<D, SCALE_SCORES>, a, grid, smem, stream);
}

// The body of a plain C entry. `which` 0 launches the dq kernel (dq, delta
// into `delta`, and drel_h / drel_w when drelh / drelw are given), 1 the
// dk/dv kernel, which reads that delta: it runs after the dq kernel on the
// same stream. relh / relw may be null (no bias). Returns the cudaError_t of
// the launch; refuses a head dim other than 64 or 80 and a grid whose width
// f32_key_tile does not take.
template <bool SCALE_SCORES>
int attention_bwd_f32_entry(int which, const void* q, const void* k, const void* v,
                            const void* dout, const void* out, const void* lse, void* delta,
                            const void* relh, const void* relw, void* dq, void* dk, void* dv,
                            void* drelh, void* drelw, int batch, int heads, int nq, int nk,
                            int d, long long q_bs, long long q_rs, long long k_bs,
                            long long k_rs, long long v_bs, long long v_rs, long long do_bs,
                            long long do_rs, long long o_bs, long long o_rs, long long dq_bs,
                            long long dq_rs, long long dk_bs, long long dk_rs, long long dv_bs,
                            long long dv_rs, int gh, int gw, float scale, void* stream) {
  F32BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.out = static_cast<const float*>(out);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
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
  const int bk = f32_key_tile(a.gw);
  if ((d != 64 && d != 80) || bk == 0 || (relh && gh * gw != nk) || nq < 1 || nk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    if (d == 64)
      return (int)(bk == 64 ? launch_f32_dq<64, 64, SCALE_SCORES>(a, batch, s)
                            : launch_f32_dq<64, 48, SCALE_SCORES>(a, batch, s));
    return (int)(bk == 64 ? launch_f32_dq<80, 64, SCALE_SCORES>(a, batch, s)
                          : launch_f32_dq<80, 48, SCALE_SCORES>(a, batch, s));
  }
  if (which == 1)
    return (int)(d == 64 ? launch_f32_dkv<64, SCALE_SCORES>(a, batch, s)
                         : launch_f32_dkv<80, SCALE_SCORES>(a, batch, s));
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_BWD_F32(name, scale_scores)                                       \
  extern "C" int name(int which, const void* q, const void* k, const void* v,                \
                      const void* dout, const void* out, const void* lse, void* delta,       \
                      const void* relh, const void* relw, void* dq, void* dk, void* dv,      \
                      void* drelh, void* drelw, int batch, int heads, int nq, int nk, int d, \
                      long long q_bs, long long q_rs, long long k_bs, long long k_rs,        \
                      long long v_bs, long long v_rs, long long do_bs, long long do_rs,      \
                      long long o_bs, long long o_rs, long long dq_bs, long long dq_rs,      \
                      long long dk_bs, long long dk_rs, long long dv_bs, long long dv_rs,    \
                      int gh, int gw, float scale, void* stream) {                            \
    return wm::attention_bwd_f32_entry<scale_scores>(                                         \
        which, q, k, v, dout, out, lse, delta, relh, relw, dq, dk, dv, drelh, drelw, batch,  \
        heads, nq, nk, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs,       \
        dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs, gh, gw, scale, stream);                    \
  }
