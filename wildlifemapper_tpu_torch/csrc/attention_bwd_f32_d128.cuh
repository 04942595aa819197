// Backward of the multi-head attention in f32 on Hopper's CUDA cores at head
// dim 128 without rel tables: three register-tiled kernels on the helpers of
// attention_bwd_f32.cuh, the function's five products and no more.
// attention_bwd_f32_d128.cu instantiates them for the packed family:
//
//   K4 wildlifemapper_tpu/ops/cross_attention.py::_bwd_dq_kernel (:90,
//      pallas_call :208) and ::_bwd_dkv_kernel (:116, pallas_call :227):
//      B 4, H 8, N = M = 4096 or 2304, a tensor-parallel rank's 4 heads;
//      N != M and ragged N or M allowed.
//
// The function is _bwd_dq_kernel's and _bwd_dkv_kernel's, from the forward's
// lse: s = (q*scale) . k, p = exp(s - lse), delta = rowsum(do * o),
// ds = p * (dp - delta) with dp = do . v^T; dq = (ds . k) * scale,
// dk = (ds^T . q) * scale, dv = p^T . do. The dk/dv kernel rounds q*scale
// to f32 as it loads q for the scores (dK needs q itself, and a second q
// tile does not fit: see below), so s is the forward's bit for bit: the same
// products summed in the same order. No TF32: every product is an f32 FMA. ops/_attention.py::attention_body sends here
// the f32 backward launches at d = 128 without tables from 512 keys, the
// body it calls "f32" (the forward attention_fwd_f32.cuh).
//
// What bounds it on the H100: five products of N M d MACs a head against
// O((N + M) d) bytes of operands, so operations, at 67 TFLOP/s without
// tensor cores. At B 4, H 8, N = M 4096 that is 687 GFLOP, 10.3 ms at the
// peak. The tile body ran seven products at 13 TFLOP/s (one shared load an
// FMA, a plain delta pass outside). At d 128 a block's 128 resident rows of
// two tensors are 128 KB of shared memory, so the tiles it walks cannot be
// double-buffered as attention_bwd_f32.cuh's are; and that body's structure,
// where a dq kernel recomputes S and dP so that no output is summed by two
// blocks, ran seven products here at 40 TFLOP/s, slower than the plain
// version. So the design:
//  * the delta kernel: a warp a query row takes rowsum(do * o) of every head
//    into a (B, N, H) scratch; no plain delta pass runs;
//  * the dk/dv kernel keeps 128 keys resident k-major (K and V, 128 KB) and
//    walks single 64-query tiles of q and do (with their lse and delta) that
//    arrive by 16-byte cp.async, each tile's copy issued as soon as its
//    buffer is read: dP first, so do's next tile is copied under dK and q's
//    under the next dP. It takes dP, S, dV and dK, and writes ds, f32, to a
//    (B, H, M, N') scratch, keys by rows (N' is N rounded up to 128), 2.15
//    GB at B 4, H 8, N = M 4096 and 0.68 GB at 2304;
//  * the dq kernel is a batched GEMM, dq = (ds . K) * scale: a block of 256
//    threads computes 128 queries x 128 columns of one head from 32-key
//    slabs of the scratch and of K, three stages by 16-byte cp.async, both
//    slabs k-major as they lie (nothing transposed), two blocks an SM;
//  * 256 threads, 8 warps of 32 rows x 32 columns of a score tile, 8 x 4
//    register tiles (2.67 FMAs a float loaded), as attention_bwd_f32.cuh; the
//    gradient products on 8 x 8 register tiles, 8 rows by columns c4 .. c4+3
//    and c4+64 .. c4+67: four 128-bit loads for 64 FMAs, 4 FMAs a float;
//  * the dk/dv kernel's p / ds tile is 64 x 128 floats without padding (its
//    writes conflict in the banks, its reads do not), so that everything
//    fits: 231,936 B (K, V, q, do, the p / ds tile, lse and delta), one block
//    an SM; it parks dP in the tile while it takes S. The dq kernel takes
//    98,304 B.
// Registers up to 255 a thread in the dk/dv kernel (__launch_bounds__(256,
// 1)), 128 in the dq kernel (__launch_bounds__(256, 2)), and chip_smoke.py
// phase 1 holds ptxas to 0 bytes spilled. Every output element has one owner
// that sums in a fixed order (c, then j, then tile; the pair sums are
// commutative), so there are no atomics and a repeated call is bit-identical.

#pragma once

#include <math.h>
#include <stdint.h>

#include "attention_bwd_f32.cuh"
#include "common.cuh"

namespace wm {
namespace {

constexpr int kFdRows = 128;       // resident rows of a dk/dv block, dq rows
constexpr int kFdTile = 64;        // queries of a tile the dk/dv kernel walks
constexpr int kFdSlab = 32;        // keys of a slab the dq kernel walks
constexpr int kFdStages = 3;       // slabs in flight in the dq kernel

struct F32D128Args {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* out;
  const float* lse;   // (B, nq, H)
  float* delta;       // (B, nq, H): written by the delta kernel
  float* ds;          // (B, H, nk, np): written by the dk/dv kernel
  float* dq;
  float* dk;
  float* dv;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs;  // element strides
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int batch, heads, nq, nk, np;
  float scale;
};

// acc[e][n] += sum_c at[c * lda + fb_row(r0, e)] * (b[(j0 + 8n) * ldb + c] *
// bmul) over c = 0 .. D-1 in order, b * bmul rounded to f32: fb_scores with
// its column loop unrolled in part.
template <int D, int N>
__device__ __forceinline__ void fd_scores(float (&acc)[8][N], const float* at, int lda, int r0,
                                          const float* b, int ldb, int j0, float bmul) {
#pragma unroll 4
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
        const float bn = fb_at(bv[n], cc) * bmul;
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

// acc[e][x] += sum_j g[j * ldg + fb_row(r0, e)] * b[j * ldb + col_x], j = 0 ..
// J-1 in order, col = c4 .. c4+3 and c4+64 .. c4+67: `g` k-major (p or ds),
// `b` row-major (K, q or do). 4 shared loads for 64 FMAs.
template <int J>
__device__ __forceinline__ void fd_grad(float (&acc)[8][8], const float* g, int ldg, int r0,
                                        const float* b, int ldb, int c4) {
#pragma unroll 4
  for (int j = 0; j < J; ++j) {
    const float4 lo = fb_ld4(g + j * ldg + r0);
    const float4 hi = fb_ld4(g + j * ldg + r0 + 16);
    const float4 b0 = fb_ld4(b + j * ldb + c4);
    const float4 b1 = fb_ld4(b + j * ldb + c4 + 64);
    const float bx[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int x = 0; x < 8; ++x) {
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

__device__ __forceinline__ void fd_store_row(float* row, const float (&acc)[8], float mul,
                                             int c4) {
  *reinterpret_cast<float4*>(row + c4) =
      make_float4(acc[0] * mul, acc[1] * mul, acc[2] * mul, acc[3] * mul);
  *reinterpret_cast<float4*>(row + c4 + 64) =
      make_float4(acc[4] * mul, acc[5] * mul, acc[6] * mul, acc[7] * mul);
}

// ---- the delta kernel: a warp a query row, every head ---------------------

template <int D>
__global__ void __launch_bounds__(kFbThreads) attn_bwd_f32_d128_delta_kernel(F32D128Args a) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kFbThreads / 32) + (threadIdx.x >> 5);
  if (row >= (long long)a.batch * a.nq) return;
  const int b = (int)(row / a.nq), q = (int)(row % a.nq);
  const float* dog = a.dout + b * a.do_bs + q * a.do_rs;
  const float* og = a.out + b * a.o_bs + q * a.o_rs;
  for (int h = 0; h < a.heads; ++h) {
    float sum = 0.f;
#pragma unroll
    for (int c = 4 * lane; c < D; c += 128) {
      const float4 dv = fb_ldg4(dog + h * D + c, true);
      const float4 ov = fb_ldg4(og + h * D + c, true);
      sum = fmaf(dv.x, ov.x, sum);
      sum = fmaf(dv.y, ov.y, sum);
      sum = fmaf(dv.z, ov.z, sum);
      sum = fmaf(dv.w, ov.w, sum);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) a.delta[row * a.heads + h] = sum;
  }
}

// ---- the dk/dv kernel: k-blocks of 128 keys walk q/do tiles of 64 queries --

template <int D>
__global__ void __launch_bounds__(kFbThreads, 1) attn_bwd_f32_d128_dkv_kernel(F32D128Args a) {
  constexpr int BKB = kFdRows, BQT = kFdTile, NI = BQT / 16;
  constexpr int LDT = D + 4;    // row stride of the q and do tiles
  constexpr int LDX = BKB;      // row stride of the p / ds tile
  extern __shared__ __align__(16) float smem[];
  float* kt_ = smem;             // [D][BKB] K, k-major
  float* vt_ = kt_ + D * BKB;    // [D][BKB] V, k-major
  float* qs = vt_ + D * BKB;     // [BQT][LDT] q
  float* dos = qs + BQT * LDT;   // [BQT][LDT] do
  float* xs = dos + BQT * LDT;   // [BQT][LDX] dP, then p, then ds, query-major
  float* ls = xs + BQT * LDX;    // [BQT] lse
  float* dl = ls + BQT;          // [BQT] delta

  const int k0 = blockIdx.x * BKB, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* qg = a.q + b * a.q_bs + h * D;
  const float* kg = a.k + b * a.k_bs + h * D;
  const float* vg = a.v + b * a.v_bs + h * D;
  const float* dog = a.dout + b * a.do_bs + h * D;
  float* dsg = a.ds + ((long long)b * a.heads + h) * a.nk * a.np;
  const int nqt = (a.nq + BQT - 1) / BQT;

  // do and delta, then q and lse, of query tile qt: one commit group each
  // (an empty group past the last tile, so the waits below count alike)
  auto copy_stats = [&](float* dst, const float* src, int q0) {
    if (t < BQT) {
      const bool in = q0 + t < a.nq;
      fb_cp4(dst + t, src + ((long long)b * a.nq + (in ? q0 + t : 0)) * a.heads + h, in);
    }
  };
  auto load_do = [&](int qt) {
    if (qt < nqt) {
      fb_copy_rows<D>(dos, LDT, dog, a.do_rs, qt * BQT, BQT, a.nq, t);
      copy_stats(dl, a.delta, qt * BQT);
    }
    fb_commit();
  };
  auto load_q = [&](int qt) {
    if (qt < nqt) {
      fb_copy_rows<D>(qs, LDT, qg, a.q_rs, qt * BQT, BQT, a.nq, t);
      copy_stats(ls, a.lse, qt * BQT);
    }
    fb_commit();
  };
  load_do(0);
  load_q(0);

  // K and V, k-major: two lanes a key
  {
    const int row = t >> 1, part = t & 1;
    const bool ok = k0 + row < a.nk;
    const long long gr = ok ? k0 + row : 0;
#pragma unroll 4
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
  // same keys, columns c4 .. c4+3 and c4+64 .. c4+67.
  const int wr = warp & 3, wc = warp >> 2;
  const int lr = lane & 3, lk = lane >> 2;
  const int r0 = 32 * wr + 4 * lr;
  const int i0 = 32 * wc + lk;
  const int c4 = 32 * wc + 4 * lk;
  bool kok[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) kok[e] = k0 + fb_row(r0, e) < a.nk;
  float dkacc[8][8], dvacc[8][8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int x = 0; x < 8; ++x) dkacc[e][x] = dvacc[e][x] = 0.f;

  for (int qt = 0; qt < nqt; ++qt) {
    const int q0 = qt * BQT;
    fb_wait<1>();     // do and delta of tile qt
    __syncthreads();  // (first tile: K and V too)
    {
      float dp[8][NI];
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int n = 0; n < NI; ++n) dp[e][n] = 0.f;
      fd_scores<D, NI>(dp, vt_, BKB, r0, dos, LDT, i0, 1.f);
      fb_put<NI>(xs, LDX, r0, i0, dp);  // parked: each thread its own elements
    }
    fb_wait<0>();     // q and lse of tile qt
    __syncthreads();

    float p[8][NI], ds[8][NI];
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int n = 0; n < NI; ++n) p[e][n] = 0.f;
    fd_scores<D, NI>(p, kt_, BKB, r0, qs, LDT, i0, a.scale);  // s = (q*scale) . k
    fb_get<NI>(xs, LDX, r0, i0, ds);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int i = i0 + 8 * n;
      const bool qok = q0 + i < a.nq;
      const float lse = ls[i], del = dl[i];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float pv = (kok[e] && qok) ? __expf(p[e][n] - lse) : 0.f;
        p[e][n] = pv;
        ds[e][n] = pv * (ds[e][n] - del);
        if (kok[e] && qok) dsg[(long long)(k0 + fb_row(r0, e)) * a.np + q0 + i] = ds[e][n];
      }
    }

    // dV += p^T . do, then dK += ds^T . q through the one tile
    fb_put<NI>(xs, LDX, r0, i0, p);
    __syncthreads();
    fd_grad<BQT>(dvacc, xs, LDX, r0, dos, LDT, c4);
    __syncthreads();  // do's buffer is read
    load_do(qt + 1);
    fb_put<NI>(xs, LDX, r0, i0, ds);
    __syncthreads();
    fd_grad<BQT>(dkacc, xs, LDX, r0, qs, LDT, c4);
    __syncthreads();  // q's buffer is read
    load_q(qt + 1);
  }

  float* dkg = a.dk + b * a.dk_bs + h * D;
  float* dvg = a.dv + b * a.dv_bs + h * D;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (kok[e]) {
      const int key = k0 + fb_row(r0, e);
      fd_store_row(dkg + key * a.dk_rs, dkacc[e], a.scale, c4);
      fd_store_row(dvg + key * a.dv_rs, dvacc[e], 1.f, c4);
    }
}

// ---- the dq kernel: dq = (ds . K) * scale, 128 x 128 a block ---------------

template <int D>
__global__ void __launch_bounds__(kFbThreads, 2) attn_bwd_f32_d128_dq_kernel(F32D128Args a) {
  constexpr int BQ = kFdRows, BK = kFdSlab, S = kFdStages;
  static_assert(D == 128, "a block's columns are one head");
  extern __shared__ __align__(16) float smem[];  // S x (ds [BK][BQ], K [BK][D])

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const float* dsg = a.ds + ((long long)b * a.heads + h) * a.nk * a.np + q0;
  const float* kg = a.k + b * a.k_bs + h * D;
  const int nkt = (a.nk + BK - 1) / BK;

  // slab kt of ds (keys by rows, this block's 128 queries; the scratch's
  // rows are N' >= q0 + 128 wide) and of K into stage kt % S, one group
  auto load_slab = [&](int kt) {
    if (kt < nkt) {
      float* xs = smem + (kt % S) * BK * (BQ + D);
      fb_copy_rows<BQ>(xs, BQ, dsg, a.np, kt * BK, BK, a.nk, t);
      fb_copy_rows<D>(xs + BK * BQ, D, kg, a.k_rs, kt * BK, BK, a.nk, t);
    }
    fb_commit();
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) load_slab(s);

  // warp (wr, wc) takes rows 32 wr .. +31; a thread rows fb_row(r0, e),
  // columns c4 .. c4+3 and c4+64 .. c4+67
  const int wr = warp & 3, wc = warp >> 2;
  const int lr = lane & 3, lk = lane >> 2;
  const int r0 = 32 * wr + 4 * lr;
  const int c4 = 32 * wc + 4 * lk;
  float acc[8][8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[e][x] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    fb_wait<S - 2>();  // slab kt
    __syncthreads();   // every warp is past slab kt - 1: its stage is free
    load_slab(kt + S - 1);
    const float* xs = smem + (kt % S) * BK * (BQ + D);
    fd_grad<BK>(acc, xs, BQ, r0, xs + BK * BQ, D, c4);
  }

  float* dqg = a.dq + b * a.dq_bs + h * D;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (q0 + fb_row(r0, e) < a.nq)
      fd_store_row(dqg + (q0 + fb_row(r0, e)) * a.dq_rs, acc[e], a.scale, c4);
}

template <int D>
constexpr size_t fd_dkv_smem() {
  return 4 * (size_t)(2 * D * kFdRows + 2 * kFdTile * (D + 4) + kFdTile * kFdRows + 2 * kFdTile);
}
template <int D>
constexpr size_t fd_dq_smem() {
  return 4 * (size_t)kFdStages * kFdSlab * (kFdRows + D);
}
static_assert(fd_dkv_smem<128>() == 231936 && fd_dq_smem<128>() == 98304,
              "the shared memory of record");
static_assert(fd_dkv_smem<128>() <= (size_t)kMaxSmemBytes, "shared memory");

template <typename Kernel>
cudaError_t fd_launch(Kernel kernel, const F32D128Args& a, dim3 grid, size_t smem,
                      cudaStream_t stream) {
  if (grid.y > 65535u || grid.z > 65535u) return cudaErrorInvalidValue;
  if (smem > 0) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kFbThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The body of a plain C entry. `which` 0 launches the delta kernel and then
// the dk/dv kernel (dk, dv, and ds into the scratch `ds`, its rows `np`
// floats: np >= nq, a multiple of 128), two launches from one host call; 1
// the dq kernel, which reads that scratch: it runs after them on the same
// stream. Refuses a head dim other than 128 and a scratch too narrow.
inline int attention_bwd_f32_d128_entry(
    int which, const void* q, const void* k, const void* v, const void* dout, const void* out,
    const void* lse, void* delta, void* ds, void* dq, void* dk, void* dv, int batch, int heads,
    int nq, int nk, int d, int np, long long q_bs, long long q_rs, long long k_bs,
    long long k_rs, long long v_bs, long long v_rs, long long do_bs, long long do_rs,
    long long o_bs, long long o_rs, long long dq_bs, long long dq_rs, long long dk_bs,
    long long dk_rs, long long dv_bs, long long dv_rs, float scale, void* stream) {
  if (d != 128 || nq < 1 || nk < 1 || np < nq || np % kFdRows != 0)
    return (int)cudaErrorInvalidValue;
  F32D128Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.out = static_cast<const float*>(out);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.ds = static_cast<float*>(ds);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.do_bs = do_bs; a.do_rs = do_rs;
  a.o_bs = o_bs; a.o_rs = o_rs;
  a.dq_bs = dq_bs; a.dq_rs = dq_rs; a.dk_bs = dk_bs; a.dk_rs = dk_rs;
  a.dv_bs = dv_bs; a.dv_rs = dv_rs;
  a.batch = batch; a.heads = heads; a.nq = nq; a.nk = nk; a.np = np;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0) {
    const long long rows = (long long)batch * nq, warps = kFbThreads / 32;
    if ((rows + warps - 1) / warps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t err = fd_launch(attn_bwd_f32_d128_delta_kernel<128>, a,
                                dim3((unsigned)((rows + warps - 1) / warps)), 0, s);
    if (err != cudaSuccess) return (int)err;
    return (int)fd_launch(attn_bwd_f32_d128_dkv_kernel<128>, a,
                          dim3((nk + kFdRows - 1) / kFdRows, heads, batch), fd_dkv_smem<128>(),
                          s);
  }
  if (which == 1)
    return (int)fd_launch(attn_bwd_f32_d128_dq_kernel<128>, a,
                          dim3((nq + kFdRows - 1) / kFdRows, heads, batch), fd_dq_smem<128>(), s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_BWD_F32_D128(name)                                                 \
  extern "C" int name(int which, const void* q, const void* k, const void* v,                 \
                      const void* dout, const void* out, const void* lse, void* delta,        \
                      void* ds, void* dq, void* dk, void* dv, int batch, int heads, int nq,   \
                      int nk, int d, int np, long long q_bs, long long q_rs, long long k_bs,  \
                      long long k_rs, long long v_bs, long long v_rs, long long do_bs,        \
                      long long do_rs, long long o_bs, long long o_rs, long long dq_bs,       \
                      long long dq_rs, long long dk_bs, long long dk_rs, long long dv_bs,     \
                      long long dv_rs, float scale, void* stream) {                            \
    return wm::attention_bwd_f32_d128_entry(which, q, k, v, dout, out, lse, delta, ds, dq, dk, \
                                            dv, batch, heads, nq, nk, d, np, q_bs, q_rs, k_bs, \
                                            k_rs, v_bs, v_rs, do_bs, do_rs, o_bs, o_rs, dq_bs, \
                                            dq_rs, dk_bs, dk_rs, dv_bs, dv_rs, scale, stream);  \
  }
