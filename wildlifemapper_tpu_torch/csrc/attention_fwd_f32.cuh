// Forward of the multi-head attention in f32 on Hopper's CUDA cores, at the
// streaming shapes: one register-tiled kernel. attention_fwd_f32.cu
// instantiates it for the packed family without rel tables at head dim 128:
//
//   K4 wildlifemapper_tpu/ops/cross_attention.py::_fwd_kernel (:64,
//      pallas_call :160), the HFC adaptor's cross attention: B 4, H 8,
//      N = M = 4096 (full canvas, compat crop) or 2304 (crop_prologue), a
//      tensor-parallel rank's 4 heads; N != M and ragged N or M allowed.
//
// The function is the tile body's (attention_fwd.cuh) and _fwd_kernel's:
// s = round(q*scale) . k (q*scale in f32 is the input type), an online
// softmax in f32 (running max m and sum l a row), p = exp(s - m) unrounded
// (f32), out = acc / l, and lse = m + log(l) when an lse buffer is given.
// No TF32: every product is an f32 FMA. ops/_attention.py::attention_body
// sends here the f32 forward launches at d = 128 without tables from
// STREAM_MIN_KEYS (512) keys, the body it calls "f32" (whose backward is
// attention_bwd_f32.cuh, at d 128 attention_bwd_f32_d128.cuh). The f32
// forward of K1, K2, K5 and K6 (d 64 / 80, tables) and d 32 stays on the tile
// body of attention_fwd.cuh; bf16 K4 runs the Hopper body.
//
// What bounds it on the H100: two products of N M d MACs a head against
// O((N + M) d) bytes, so operations, at 67 TFLOP/s without tensor cores. At
// B 4, H 8, N = M 4096, d 128 that is 274.9 GFLOP, 4.10 ms at the peak (N
// 2304: 87.0 GFLOP, 1.30 ms). The tile body reached 13.7 TFLOP/s there: 4
// threads a query row, about one shared load per FMA, and an SM's shared
// memory delivers 128 bytes a clock to its 128 FMA lanes, so a product runs
// at the FMA rate only where a thread makes about 4 FMAs of every float it
// loads. The design (the lessons of attention_bwd_f32.cuh's backward):
//  * a block of 256 threads keeps 128 queries resident, q*scale staged
//    k-major in shared memory (64 KB at d 128), and walks K and V tiles of
//    BK = 128 keys that arrive by 16-byte cp.async, one stage: V's next
//    tile is copied under the next tile's scores, K's after P.V (its buffer
//    holds p until then);
//  * a warp owns 16 whole query rows, so a row's max and sum are taken
//    across the 16 lanes that share it by warp shuffles, never through
//    shared memory; a thread holds an 8 x 8 register tile of scores (8 rows,
//    two runs of 4; keys kl + 16 n), 16 shared loads for 256 FMAs, 4 FMAs a
//    float;
//  * p goes to shared memory into the K tile it was made from (its keys are
//    no longer read once every warp is past the scores), k-major, and P.V
//    runs on an 8 x 8 register tile of the output (8 rows by columns 4 kl ..
//    4 kl + 3 and 64 + 4 kl ..): four 128-bit loads for 64 FMAs, 4 FMAs a
//    float; the row sum l stays a per-thread partial over the thread's keys,
//    scaled with the output at every new max and summed across the row's
//    lanes once at the end;
//  * nothing runs on a plain pass outside the kernel.
// Shared memory: 64 KB of q*scale and two 128 x 132 f32 tiles (K and V),
// 200,704 B at d 128, one block an SM; registers up to 255 a thread
// (__launch_bounds__(256, 1)), and chip_smoke.py phase 1 holds ptxas to 0
// bytes spilled. On the H100 the fuller score tile outweighs the copy of K
// it leaves exposed: two stages of 64-key tiles (8 x 4 score tiles, 2.67
// FMAs a float, every copy under the products) took the same shared memory
// and were 7 % slower, and 64-, 80- and 96-key tiles with p in a tile of its
// own and K's copy under P.V 3-8 % (scripts/sweep_f32_attention.py builds
// them from this header by text edits and times them beside it). The kernel
// is a template on D, the resident rows' chunks and the output's column runs
// following D / 64; it takes D a multiple of 64 whose K tile holds p
// (D >= 128): d 64 and 80 and the rel tables, for the f32 forward of K1, K2,
// K5 and K6, need p in a tile of their own and come with that forward. Every
// output element has one owner that sums in a fixed order, so a repeated
// call is bit-identical.
// At N 2304 a launch is 4 * 8 * 18 = 576 blocks on 132 SMs: 4.36 rounds of
// one block an SM, the fifth round 36 % full.

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

struct F32FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (B, nq, H) or null: not written
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;  // element strides
  int heads, nq, nk;
  float scale;
};

// A thread's 8 rows of its warp's 16: rA .. rA+3 and rA+8 .. rA+11.
__device__ __forceinline__ int ff_row(int rA, int e) { return rA + (e & 3) + 8 * (e >> 2); }

template <int D, int BK>
__host__ __device__ constexpr int ff_smem_bytes() {
  return 4 * (D * kFfRows + 2 * BK * (D + 4));
}

template <int D, int BK>
__global__ void __launch_bounds__(kFfThreads, 1) attn_fwd_f32_kernel(F32FwdArgs a) {
  constexpr int BQ = kFfRows;
  constexpr int NJ = BK / 16;               // keys of a tile a thread holds
  constexpr int LDT = D + 4;                // row stride of the K and V tiles
  constexpr int LDP = BQ + 4;               // row stride of the p tile
  constexpr int NV = D / 64;                // runs of 4 output columns a thread
  static_assert(D % 64 == 0 && BK % 16 == 0 && LDP <= LDT, "p fits a K tile");
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [D][BQ] q*scale, k-major
  float* ks = qt + D * BQ;      // [BK][LDT]
  float* vs = ks + BK * LDT;    // [BK][LDT]
  float* pt = ks;               // [BK][LDP] p, k-major, over K's tile

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
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

  // q*scale, k-major: two lanes a row, chunks part, part + 2, ...
  {
    const int row = t >> 1, part = t & 1;
    const bool ok = q0 + row < a.nq;
    const long long gr = ok ? q0 + row : 0;
#pragma unroll
    for (int m = 0; m < D / 8; ++m) {
      const int c = 4 * (part + 2 * m);
      const float4 qv = fb_ldg4(qg + gr * a.q_rs + c, ok);
#pragma unroll
      for (int x = 0; x < 4; ++x) qt[(c + x) * BQ + row] = fb_at(qv, x) * a.scale;
    }
  }

  // Warp w owns rows 16w .. 16w+15; lane (kl, rg) rows ff_row(rA, e), keys
  // kl + 16n of a tile, output columns 4kl + 64v .. +3.
  const int rg = lane & 1, kl = lane >> 1;
  const int rA = 16 * warp + 4 * rg;
  float m[8], l[8], acc[8][4 * NV];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    m[e] = -INFINITY;
    l[e] = 0.f;
#pragma unroll
    for (int x = 0; x < 4 * NV; ++x) acc[e][x] = 0.f;
  }

  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    fb_wait<1>();     // K of tile kt
    __syncthreads();

    // s = (q*scale) . k over c = 0 .. D-1 in order
    float s[8][NJ];
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

    // the online softmax of the thread's rows: the tile's max across the 16
    // lanes of a row, the output and the partial sum scaled to the new max
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NJ; ++n) {
        if (k0 + kl + 16 * n >= a.nk) s[e][n] = -INFINITY;
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
      for (int x = 0; x < 4 * NV; ++x) acc[e][x] *= alpha;
    }

    fb_wait<0>();     // V of tile kt
    __syncthreads();  // every warp is past the scores: K's tile is free
    // p, this warp's rows only
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      float* at = pt + (kl + 16 * n) * LDP + rA;
      *reinterpret_cast<float4*>(at) = make_float4(s[0][n], s[1][n], s[2][n], s[3][n]);
      *reinterpret_cast<float4*>(at + 8) = make_float4(s[4][n], s[5][n], s[6][n], s[7][n]);
    }
    __syncwarp();

    // acc += p . v over the tile's keys in order
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 lo = fb_ld4(pt + j * LDP + rA);
      const float4 hi = fb_ld4(pt + j * LDP + rA + 8);
      float vx[4 * NV];
#pragma unroll
      for (int g = 0; g < NV; ++g) {
        const float4 vv = fb_ld4(vs + j * LDT + 64 * g + 4 * kl);
        vx[4 * g] = vv.x;
        vx[4 * g + 1] = vv.y;
        vx[4 * g + 2] = vv.z;
        vx[4 * g + 3] = vv.w;
      }
#pragma unroll
      for (int x = 0; x < 4 * NV; ++x) {
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
    __syncthreads();  // the p (K) and V tiles are read
    load(ks, kg, a.k_rs, kt + 1);
    load(vs, vg, a.v_rs, kt + 1);
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
    if (a.lse != nullptr && kl == 0)
      a.lse[((long long)b * a.nq + row) * a.heads + h] = m[e] + logf(sum);
  }
}

template <int D, int BK>
cudaError_t launch_f32_fwd(const F32FwdArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t smem = ff_smem_bytes<D, BK>();
  static_assert(smem <= (size_t)kMaxSmemBytes, "shared memory");
  if (batch > 65535 || a.heads > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32_kernel<D, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.nq + kFfRows - 1) / kFfRows, a.heads, batch);
  attn_fwd_f32_kernel<D, BK><<<grid, kFfThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The body of a plain C entry with the forward's arguments
// (attention_fwd.cuh). Refuses what the body does not take: another dtype
// than f32, a head dim other than 128, rel tables.
inline int attention_fwd_f32_entry(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* relh, const void* relw, void* lse,
                                   int batch, int heads, int nq, int nk, int d, long long q_bs,
                                   long long q_rs, long long k_bs, long long k_rs, long long v_bs,
                                   long long v_rs, long long o_bs, long long o_rs, int gh, int gw,
                                   float scale, void* stream) {
  (void)gh;
  (void)gw;
  if (dtype != kFloat32 || d != 128 || relh != nullptr || relw != nullptr || nq < 1 || nk < 1)
    return (int)cudaErrorInvalidValue;
  F32FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.q_bs = q_bs; a.q_rs = q_rs; a.k_bs = k_bs; a.k_rs = k_rs;
  a.v_bs = v_bs; a.v_rs = v_rs; a.o_bs = o_bs; a.o_rs = o_rs;
  a.heads = heads; a.nq = nq; a.nk = nk;
  a.scale = scale;
  return (int)launch_f32_fwd<128, kFfKeys>(a, batch, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace wm

// Defines the plain C entry `name` of a source that includes this header.
#define WM_DEFINE_ATTENTION_FWD_F32(name)                                                   \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, void* o,     \
                      const void* relh, const void* relw, void* lse, int batch, int heads, \
                      int nq, int nk, int d, long long q_bs, long long q_rs,               \
                      long long k_bs, long long k_rs, long long v_bs, long long v_rs,      \
                      long long o_bs, long long o_rs, int gh, int gw, float scale,         \
                      void* stream) {                                                       \
    return wm::attention_fwd_f32_entry(dtype, q, k, v, o, relh, relw, lse, batch, heads,   \
                                       nq, nk, d, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, \
                                       o_rs, gh, gw, scale, stream);                        \
  }
