// The MLP's matrix products on Hopper, f32 (the parity path): one
// register-tiled GEMM body on the CUDA cores, with three epilogues,
//
//   C = epilogue(A . B^T)     A (M, K) row-major, B (N, K) in the torch
//                             Linear layout, f32 sums
//
//   BiasGelu      hidden = gelu_erf(acc + b)                      (M, N)
//   Bias          out    = acc + b                                (M, N)
//   BiasGeluGrad  h = acc + b;  a = h * cdf(h) (optional),
//                 dh = da * (cdf(h) + h * pdf(h))                 (M, N) each
//
// It replaces K3 of the JAX package for f32 inputs,
// wildlifemapper_tpu/ops/fused_mlp.py:
//  * fused_mlp (:97, pallas_call :103) is two launches from one host call
//    (fused_mlp.cu::wm_fused_mlp_fwd): BiasGelu with A = x (R, D), B = w1
//    (F, D) into an f32 hidden (R, F) in device memory, then Bias with A =
//    hidden, B = w2 (D, F);
//  * _bwd_dh_kernel (:120, pallas_call :148) is one launch of BiasGeluGrad
//    with A = x, B = w1 and the gradient da (R, F) of the GELU output
//    (fused_mlp_bwd.cu::wm_fused_mlp_dh).
// Both products are K-contiguous as they lie, so nothing is copied or
// transposed in device memory. Each output is one f32 sum over k = 0 .. K-1
// in that order, fmaf by fmaf from 0 (no TF32, no split-K), then the bias
// and the epilogue in f32: the function and the rounding points of the
// plain versions (ops/fused_mlp.py::fused_mlp_plain, fused_mlp_dh_plain),
// and every repeated call bit-identical.
//
// What bounds it on the H100: f32 without TF32 has no tensor core, so the
// products run on the FMA pipes, 67 TFLOP/s. At ViT-B's R 16384, D 768, F
// 3072 the forward is 154.6 GFLOP (2.31 ms) against 101 MB of x and out and
// the f32 hidden's 403 MB round trip (0.12 ms), dh 77.3 GFLOP (1.15 ms)
// against 604 MB of da, a and dh (0.18 ms): operations, and so the rate at
// which the SMs dispatch FMAs and the shared loads that feed them. The
// design:
//  * a block of 256 threads computes a 128 x 128 output tile, its 8 warps
//    4 (rows) x 2 (columns) pieces of 32 x 64; each thread holds an 8 x 8
//    accumulator tile in registers, two 4-row quads 16 rows apart by two
//    4-column quads 32 columns apart, so that a warp's 128-bit shared loads
//    each read one contiguous run (64 bytes of A, 128 of B) and its
//    epilogue writes 128 contiguous bytes a row;
//  * A and B come in 16-deep k slabs, staged k-major in shared memory: a
//    thread reads its 8 A and 8 B values of one k-step as four 128-bit
//    loads, 4 shared loads for 64 FMAs. The slabs are transposed on the way
//    in through registers: 16-byte global loads (a warp reads 16 rows x 32
//    contiguous bytes), four 4-byte shared stores each, the rows of a warp
//    placed so that the 32 stores of one instruction hit 32 banks (row
//    stride 132 floats, quads of rows interleaved by k);
//  * two slabs in shared memory: the next slab's global loads start
//    before the current slab's 16 k-steps and are stored after them, one
//    barrier a slab;
//  * tiles in grouped raster order: kF32GroupM row tiles sweep the columns
//    together, column-major inside the group, so consecutive blocks share a
//    weight panel and the resident blocks an activation panel in L2;
//  * 33.8 KB of shared memory and at most 128 registers a thread
//    (__launch_bounds__(256, 2)), so two blocks fit on an SM;
//  * the epilogue runs in registers on each thread's 8 x 8 tile and writes
//    16-byte pieces; dh reads its da pieces the same way.
// Ragged edges: rows past M, and columns past N or K, are loaded as zeros
// (a zero product leaves a sum as it is) and not stored, so M is any size;
// N and K must be multiples of 4 (16-byte rows), and A, B, da and the
// outputs 16-byte aligned. That covers D 64 ... 1280, F = 4D of ViT-B/L/H and
// the tensor-parallel shards (F 1536, 2560).
// bf16 runs the wgmma body of mlp_gemm_sm90.cuh instead.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace wm {
namespace {

enum F32Epilogue : int { kF32BiasGelu = 0, kF32Bias = 1, kF32BiasGeluGrad = 2 };

constexpr int kF32Tile = 128;        // rows and columns of an output tile
constexpr int kF32K = 16;            // depth of a k slab
constexpr int kF32Ld = kF32Tile + 4; // row stride of a k-major slab, in floats
constexpr int kF32Threads = 256;
constexpr int kF32GroupM = 8;        // row tiles of one raster group

constexpr float kRsqrt2 = 0.70710678118654752f;
constexpr float kRsqrt2Pi = 0.39894228040143268f;

struct F32Slab {
  float a[kF32K][kF32Ld];            // [k][row of the tile]
  float b[kF32K][kF32Ld];            // [k][column of the tile]
};

// The epilogues' arithmetic rounds every product and sum by itself (the
// _rn intrinsics are never contracted into FMAs), as the plain versions do:
// the compiler may make dh's epilogue twice, with and without the store of
// a, and contracted differently the two gave dh one ulp apart.

// gelu_erf(h) = 0.5 h (1 + erf(h / sqrt 2)).
__device__ __forceinline__ float gelu(float h) {
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, erff(__fmul_rn(h, kRsqrt2))));
}

// a = h * cdf and the factor of da in dh, for one hidden value.
__device__ __forceinline__ void gelu_and_grad(float h, float* act, float* dact) {
  const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, erff(__fmul_rn(h, kRsqrt2))));
  const float pdf = __fmul_rn(expf(__fmul_rn(__fmul_rn(-0.5f, h), h)), kRsqrt2Pi);
  *act = __fmul_rn(h, cdf);
  *dact = __fadd_rn(cdf, __fmul_rn(h, pdf));
}

__device__ __forceinline__ float4 load4(const float* p, bool in) {
  return in ? *reinterpret_cast<const float4*>(p) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Four consecutive k of one row, stored into the k-major slab.
__device__ __forceinline__ void store_k4(float (*s)[kF32Ld], int k4, int row, float4 v) {
  s[k4 + 0][row] = v.x;
  s[k4 + 1][row] = v.y;
  s[k4 + 2][row] = v.z;
  s[k4 + 3][row] = v.w;
}

template <int E>
__global__ void __launch_bounds__(kF32Threads, 2)
fused_mlp_gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          const float* __restrict__ bias, const float* __restrict__ da,
                          float* __restrict__ out, float* __restrict__ act, int m, int n,
                          int k) {
  __shared__ __align__(16) F32Slab slab[2];

  // grouped raster: kF32GroupM row tiles x every column tile, column-major
  const int tiles_m = (m + kF32Tile - 1) / kF32Tile;
  const int tiles_n = (n + kF32Tile - 1) / kF32Tile;
  const int per_group = kF32GroupM * tiles_n;
  const int first_m = (blockIdx.x / per_group) * kF32GroupM;
  const int group_m = min(tiles_m - first_m, kF32GroupM);
  const int in_group = blockIdx.x % per_group;
  const int row0 = (first_m + in_group % group_m) * kF32Tile;
  const int col0 = (in_group / group_m) * kF32Tile;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  // Loader: warp w brings rows 16w .. 16w+15 of the A and the B slab, a
  // thread one 16-byte piece (k4 = 4 * (lane & 3)) of two rows, 8 apart;
  // the rows of k pieces 0-1 and 2-3 are swapped between the two, so that
  // each shared store instruction covers 32 banks.
  const int k4 = 4 * (lane & 3);
  const int lrow0 = warp * 16 + (lane >> 2) + 8 * ((lane >> 1) & 1);
  const int lrow1 = lrow0 ^ 8;
  const bool a_in0 = row0 + lrow0 < m, a_in1 = row0 + lrow1 < m;
  const bool b_in0 = col0 + lrow0 < n, b_in1 = col0 + lrow1 < n;
  const float* a0 = a + (long long)(a_in0 ? row0 + lrow0 : 0) * k + k4;
  const float* a1 = a + (long long)(a_in1 ? row0 + lrow1 : 0) * k + k4;
  const float* b0 = b + (long long)(b_in0 ? col0 + lrow0 : 0) * k + k4;
  const float* b1 = b + (long long)(b_in1 ? col0 + lrow1 : 0) * k + k4;
  float4 ra0, ra1, rb0, rb1;
  auto load = [&](int k0) {
    const bool kin = k0 + k4 < k;
    ra0 = load4(a0 + k0, kin && a_in0);
    ra1 = load4(a1 + k0, kin && a_in1);
    rb0 = load4(b0 + k0, kin && b_in0);
    rb1 = load4(b1 + k0, kin && b_in1);
  };
  auto store = [&](F32Slab& s) {
    store_k4(s.a, k4, lrow0, ra0);
    store_k4(s.a, k4, lrow1, ra1);
    store_k4(s.b, k4, lrow0, rb0);
    store_k4(s.b, k4, lrow1, rb1);
  };

  // Compute: warps 4 (rows) x 2 (columns), each a 32 x 64 piece, its lanes
  // 4 x 8; a thread's rows m_base + {0..3, 16..19}, columns n_base +
  // {0..3, 32..35}.
  const int m_base = (warp & 3) * 32 + (lane & 3) * 4;
  const int n_base = (warp >> 2) * 64 + (lane >> 2) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(slab[0]);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < k; k0 += kF32K) {
    const bool more = k0 + kF32K < k;
    if (more) load(k0 + kF32K);
    const F32Slab& cur = slab[s];
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&cur.a[kk][m_base]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&cur.a[kk][m_base + 16]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&cur.b[kk][n_base]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&cur.b[kk][n_base + 32]);
      const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store(slab[s ^ 1]);
    __syncthreads();
    s ^= 1;
  }

  // Epilogue, 16 bytes at a time: N is a multiple of 4, so a quad of
  // columns is wholly inside or outside.
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int col = col0 + n_base + 32 * jh;
    if (col >= n) continue;
    const float bv[4] = {bias[col], bias[col + 1], bias[col + 2], bias[col + 3]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = row0 + m_base + (i & 3) + 16 * (i >> 2);
      if (row >= m) continue;
      const long long at = (long long)row * n + col;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(acc[i][4 * jh + j], bv[j]);
      if (E == kF32BiasGelu) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = gelu(v[j]);
      } else if (E == kF32BiasGeluGrad) {
        const float4 g = *reinterpret_cast<const float4*>(da + at);
        const float gv[4] = {g.x, g.y, g.z, g.w};
        float av[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float dact;
          gelu_and_grad(v[j], &av[j], &dact);
          v[j] = __fmul_rn(gv[j], dact);
        }
        if (act != nullptr)
          *reinterpret_cast<float4*>(act + at) = make_float4(av[0], av[1], av[2], av[3]);
      }
      *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One launch: out = epilogue(a . b^T + bias) with a (m, k), b (n, k), out
// (m, n); for BiasGeluGrad da (m, n) and act (m, n) or null. Returns the
// cudaError_t of the launch.
template <int E>
cudaError_t launch_f32_gemm(const void* a, const void* b, const void* bias, const void* da,
                            void* out, void* act, int m, int n, int k, cudaStream_t stream) {
  if (m < 0 || n <= 0 || k <= 0 || n % 4 != 0 || k % 4 != 0) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  const long long tiles = (long long)((m + kF32Tile - 1) / kF32Tile) *
                          ((n + kF32Tile - 1) / kF32Tile);
  fused_mlp_gemm_f32_kernel<E><<<(unsigned)tiles, kF32Threads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(bias), static_cast<const float*>(da),
      static_cast<float*>(out), static_cast<float*>(act), m, n, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wm
