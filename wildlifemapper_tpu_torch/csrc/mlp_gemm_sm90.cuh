// The MLP's matrix products on Hopper, bf16: one persistent, warp-specialised
// wgmma GEMM body fed by TMA, with three epilogues,
//
//   C = epilogue(A . B^T)     A (R, K) row-major, B (N, K) in the torch
//                             Linear layout, f32 accumulators
//
//   BiasGelu      hidden = bf16(gelu_erf(acc + b))                (R, N)
//   Bias          out    = bf16(acc + b)                          (R, N)
//   BiasGeluGrad  h = acc + b;  a = bf16(h * cdf(h)) (optional),
//                 dh = bf16(da * (cdf(h) + h * pdf(h)))            (R, N) each
//
// It replaces K3 of the JAX package, wildlifemapper_tpu/ops/fused_mlp.py:
//  * fused_mlp (:97, pallas_call :103) is two launches, pass 1 BiasGelu with
//    A = x (R, D), B = w1 (F, D), then pass 2 Bias with A = hidden (R, F),
//    B = w2 (D, F) (ops/fused_mlp.py::_FusedMlpFn);
//  * _bwd_dh_kernel (:120, pallas_call :148) is one launch of BiasGeluGrad
//    with A = x, B = w1 and the gradient da (R, F) of the GELU output.
// Both products of K3 are already K-contiguous, so no operand is copied or
// transposed. Rounding points are those of the plain versions
// (ops/fused_mlp.py::fused_mlp_plain, fused_mlp_dh_plain): f32 sums, the
// GELU in f32 with erff, its output rounded to bf16 before fc2
// (fused_mlp.py:77), each output rounded once.
//
// What bounds it on the H100: each product of K3 at R 16384, D 768, F 3072
// is 77 GFLOP, 0.078 ms at 989 TFLOP/s, against 25-100 MB a side, so
// operations; dh moves 300 MB of da, a and dh (0.09 ms at 3.35 TB/s), so
// bytes as much as operations. Why the hidden (R, F) now goes through device
// memory, where the Pallas kernel kept it on chip by holding both weights in
// VMEM (9.4 MB): a block has 227 KB of shared memory, so the fused body
// before this one streamed all of w1 and w2 from L2 for every 64-row tile
// (256 tiles x 9.4 MB = 2.4 GB of L2 reads a call), and its fc2 accumulator
// (64 x D f32) took most of the register file, which capped the tile at 64
// rows (32 at D 1024) and left no room at all at D 1280. Un-fused, the
// hidden is 100.7 MB in bf16 written once and read once (0.06 ms), and each
// product is one large GEMM that runs near the tensor cores' rate. The
// design:
//  * a persistent grid: one block an SM walks output tiles of 128 x 256 in
//    grouped raster order (kGemmGroupM row tiles sweep the columns
//    together, so consecutive tiles share rows of A and columns of B in
//    L2); no wave tail beyond the last partial round;
//  * warp specialisation as in the streaming attention bodies: one producer
//    thread keeps TMA loads of 128 x 64 A and 256 x 64 B k-blocks (128-byte
//    swizzle) in flight through a ring of stages with full / empty
//    mbarriers; two cooperative consumer warpgroups (64 rows of the tile
//    each) run wgmma m64n256k16 from shared memory with 128 f32
//    accumulators a thread, keep one k-block of products in flight, and
//    take the producer's registers by setmaxnreg. (Ping-pong warpgroups,
//    each on a 128 x 128 tile of its own, were tried: the erff of fc1's
//    GELU epilogue outlasts a tile's products, so fc1 ran no faster, and
//    the narrower tiles slowed fc2.)
//  * the epilogue goes through shared memory and TMA stores, 64 columns at a
//    time into two alternating 64 x 64 boxes a warpgroup, written in the
//    128-byte swizzle (conflict-free from the accumulator fragments), so the
//    (R, N) outputs leave as whole 128-byte lines; for dh the producer loads
//    the tile's da by TMA while the tile's products run, dh is written over
//    it in place and stored from there;
//  * ragged edges by TMA: rows past R and columns past N or K arrive as
//    zeros and are clipped on the store, so R is any size >= 1; N and K must
//    be multiples of 8 (16-byte rows for the tensor maps), and every pointer
//    16-byte aligned. That covers D 64 ... 1280 and F = 4D of ViT-B/L/H.
// The f32 parity path keeps its scalar bodies (fused_mlp.cu,
// fused_mlp_bwd.cu).
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace wm {
namespace {

enum MlpEpilogue : int { kBiasGelu = 0, kBias = 1, kBiasGeluGrad = 2 };

constexpr int kGemmRows = 128;       // rows of an output tile: two warpgroups of 64
constexpr int kGemmCols = 256;       // columns of an output tile
constexpr int kGemmK = 64;           // depth of a k-block: one 128-byte swizzled row
constexpr int kGemmThreads = 384;    // two consumer warpgroups and the producer's
constexpr int kGemmConsumers = 256;
constexpr int kGemmConsumerRegs = 232;
constexpr int kGemmProducerRegs = 40;
constexpr int kGemmGroupM = 8;       // row tiles of one raster group
constexpr int kABytes = kGemmRows * 128;   // a 128 x 64 bf16 box: an A k-block, a da region
constexpr int kEpiBox = 64 * 128;          // a 64 x 64 bf16 store box

template <int EPI>
struct MlpGemmShape {
  static constexpr int kStageBytes = kABytes + kGemmCols * 128;  // A and B k-blocks
  // store boxes a warpgroup: two alternate; dh keeps one, for its da tile
  static constexpr int kBoxes = EPI == kBiasGeluGrad ? 1 : 2;
  static constexpr int kStagingBytes = 2 * kBoxes * kEpiBox;
  static constexpr int kDaBytes = EPI == kBiasGeluGrad ? (kGemmCols / 64) * kABytes : 0;
  static constexpr int kBarBytes = 128;
  static constexpr int kFit =
      (kMaxSmemBytes - 1024 - kStagingBytes - kDaBytes - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < 6 ? kFit : 6;
  static constexpr int kSmemBytes =
      1024 + kStages * kStageBytes + kStagingBytes + kDaBytes + kBarBytes;
};

struct MlpGemmArgs {
  const float* bias;  // (N,) f32
  int rows, n, k;
  int want_act;       // BiasGeluGrad: write a as well
};

// Output tile `tile` in grouped raster order: kGemmGroupM row tiles walk
// the column tiles together.
__device__ __forceinline__ void gemm_tile_coords(int tile, int tiles_m, int tiles_n, int* tm,
                                                 int* tn) {
  const int per_group = kGemmGroupM * tiles_n;
  const int group = tile / per_group;
  const int first = group * kGemmGroupM;
  const int size = min(tiles_m - first, kGemmGroupM);
  const int in = tile - group * per_group;
  *tm = first + in % size;
  *tn = in / size;
}

__device__ __forceinline__ float gelu_erf(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// a = h * cdf and the factor of da in dh, for one hidden value.
__device__ __forceinline__ void gelu_and_grad(float h, float* act, float* dact) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
  *act = h * cdf;
  *dact = cdf + h * pdf;
}

template <int EPI>
__global__ void __launch_bounds__(kGemmThreads, 1)
    fused_mlp_gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                               const __grid_constant__ CUtensorMap map_b,
                               const __grid_constant__ CUtensorMap map_out,
                               const __grid_constant__ CUtensorMap map_act,
                               const __grid_constant__ CUtensorMap map_da, MlpGemmArgs g) {
  using namespace sm90;
  using S = MlpGemmShape<EPI>;
  constexpr int STAGES = S::kStages;
  constexpr int NCHUNK = kGemmCols / 64;  // 64-column store boxes of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  // offsets from base
  constexpr uint32_t kStaging = STAGES * S::kStageBytes;
  constexpr uint32_t kDa = kStaging + S::kStagingBytes;
  constexpr uint32_t kBars = kDa + S::kDaBytes;
  const uint32_t full0 = base + kBars, empty0 = full0 + 8 * STAGES;
  const uint32_t da_full = empty0 + 8 * STAGES, da_empty = da_full + 8;

  const int t = threadIdx.x;
  const int tiles_m = (g.rows + kGemmRows - 1) / kGemmRows;
  const int tiles_n = (g.n + kGemmCols - 1) / kGemmCols;
  const int ntiles = tiles_m * tiles_n;
  const int nkb = (g.k + kGemmK - 1) / kGemmK;

  if (t == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);  // one arrival a warpgroup
    }
    if (EPI == kBiasGeluGrad) {
      mbar_init(da_full, 1);
      mbar_init(da_empty, 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (t >= kGemmConsumers) {
    // ---- producer: one thread ----
    reg_dealloc<kGemmProducerRegs>();
    if (t != kGemmConsumers) return;
    int stage = 0;
    uint32_t phase = 1, da_phase = 1;  // the ring and the da tile start empty
    const int da_at = (STAGES < nkb ? STAGES : nkb) - 1;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      int tm, tn;
      gemm_tile_coords(tile, tiles_m, tiles_n, &tm, &tn);
      const int row0 = tm * kGemmRows, col0 = tn * kGemmCols;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(empty0 + 8 * stage, phase);
        const uint32_t full = full0 + 8 * stage;
        mbar_expect_tx(full, S::kStageBytes);
        const uint32_t dst = base + stage * S::kStageBytes;
        tma_load_3d(dst, &map_a, kb * kGemmK, row0, 0, full);
        tma_load_3d(dst + kABytes, &map_b, kb * kGemmK, col0, 0, full);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        if (EPI == kBiasGeluGrad && kb == da_at) {
          // the tile's da, once the previous tile's epilogue has let go of
          // the buffer; the ring already holds this tile's first k-blocks
          mbar_wait(da_empty, da_phase);
          da_phase ^= 1;
          mbar_expect_tx(da_full, S::kDaBytes);
#pragma unroll
          for (int j = 0; j < NCHUNK; ++j)
            tma_load_3d(base + kDa + j * kABytes, &map_da, col0 + j * 64, row0, 0, da_full);
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups, 64 rows of the tile each ----
  reg_alloc<kGemmConsumerRegs>();
  const int wg = t >> 7;
  const int wt = t & 127;
  const int lane = t & 31, warp = wt >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const int r0 = warp * 16 + gq;  // this thread's rows r0 and r0 + 8 of the warpgroup's 64
  const int bar_id = 1 + wg;      // named barrier of the warpgroup
  // byte offset of this thread's pair in a swizzled 64 x 64 box, column
  // group nn: rows r0 and r0 + 8 share r0 % 8, hence the swizzle
  const uint32_t row_off = r0 * 128 + 4 * t4;
  const int sw = r0 & 7;

  float acc[kGemmCols / 8][4];
#pragma unroll
  for (int i = 0; i < kGemmCols / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int stage = 0;
  uint32_t phase = 0, da_phase = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    int tm, tn;
    gemm_tile_coords(tile, tiles_m, tiles_n, &tm, &tn);
    const int col0 = tn * kGemmCols;
    const int row_w = tm * kGemmRows + wg * 64;

    int prev = 0;
    for (int kb = 0; kb < nkb; ++kb) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t a_s = base + stage * S::kStageBytes + wg * 64 * 128;
      const uint32_t b_s = base + stage * S::kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmK / 16; ++kk)
        wgmma_ss<0, kGemmCols>(acc, desc_kmajor(a_s + kk * 32), desc_kmajor(b_s + kk * 32),
                               (kb | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous k-block's products are done with their stage
      // a wgmma is one operation of the warpgroup: once one warp has waited
      // for it, the warpgroup is done with the stage
      if (kb > 0 && wt == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (wt == 0) mbar_arrive(empty0 + 8 * prev);

    // ---- epilogue: 64 columns at a time through a swizzled box ----
    if (EPI == kBiasGeluGrad) {
      mbar_wait(da_full, da_phase);
      da_phase ^= 1;
    }
#pragma unroll
    for (int j = 0; j < NCHUNK; ++j) {
      const uint32_t box = kStaging + (wg * S::kBoxes + j % S::kBoxes) * kEpiBox;
      const uint32_t da_box = kDa + j * kABytes + wg * kEpiBox;
      if (wt == 0) {  // the store that last used this box has read it
        if (S::kBoxes == 2) bulk_wait_read<1>();
        else bulk_wait_read<0>();
      }
      named_barrier(bar_id, 128);
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        const int n = j * 8 + nn;
        const int c = col0 + n * 8 + 2 * t4;
        const float bb0 = c < g.n ? g.bias[c] : 0.f;
        const float bb1 = c < g.n ? g.bias[c + 1] : 0.f;
        const uint32_t off = row_off + ((nn ^ sw) << 4);
        const float v0 = acc[n][0] + bb0, v1 = acc[n][1] + bb1;
        const float v2 = acc[n][2] + bb0, v3 = acc[n][3] + bb1;
        uint32_t* out0 = reinterpret_cast<uint32_t*>(gen + box + off);
        uint32_t* out1 = reinterpret_cast<uint32_t*>(gen + box + off + 8 * 128);
        if (EPI == kBias) {
          *out0 = pack_bf16x2(v0, v1);
          *out1 = pack_bf16x2(v2, v3);
        } else if (EPI == kBiasGelu) {
          *out0 = pack_bf16x2(gelu_erf(v0), gelu_erf(v1));
          *out1 = pack_bf16x2(gelu_erf(v2), gelu_erf(v3));
        } else {
          uint32_t* d0 = reinterpret_cast<uint32_t*>(gen + da_box + off);
          uint32_t* d1 = reinterpret_cast<uint32_t*>(gen + da_box + off + 8 * 128);
          float a0, a1, a2, a3, f0, f1, f2, f3;
          gelu_and_grad(v0, &a0, &f0);
          gelu_and_grad(v1, &a1, &f1);
          gelu_and_grad(v2, &a2, &f2);
          gelu_and_grad(v3, &a3, &f3);
          if (g.want_act) {
            *out0 = pack_bf16x2(a0, a1);
            *out1 = pack_bf16x2(a2, a3);
          }
          const uint32_t w0 = *d0, w1 = *d1;  // da of the same four elements
          *d0 = pack_bf16x2(__uint_as_float(w0 << 16) * f0,
                            __uint_as_float(w0 & 0xffff0000u) * f1);
          *d1 = pack_bf16x2(__uint_as_float(w1 << 16) * f2,
                            __uint_as_float(w1 & 0xffff0000u) * f3);
        }
      }
      fence_proxy_async();
      named_barrier(bar_id, 128);
      if (wt == 0) {
        if (EPI == kBiasGeluGrad) {
          if (g.want_act) tma_store_3d(&map_act, base + box, col0 + j * 64, row_w, 0);
          tma_store_3d(&map_out, base + da_box, col0 + j * 64, row_w, 0);
        } else {
          tma_store_3d(&map_out, base + box, col0 + j * 64, row_w, 0);
        }
        bulk_commit();
      }
    }
    if (EPI == kBiasGeluGrad && wt == 0) {
      bulk_wait_read<0>();  // dh has left the da buffer: the producer may refill it
      mbar_arrive(da_empty);
    }
  }
  if (wt == 0) bulk_wait<0>();
}

// Asked of the runtime once an instantiation, on the device of its first
// launch (as the resident bodies' res_sm_count), and kept: the opt-in to the
// instantiation's shared memory and the SM count that sizes the persistent
// grid. A launch is then host work of its tensor maps and the launch alone.
struct GemmSetup {
  cudaError_t err;
  int sms;
};

template <int EPI>
GemmSetup mlp_gemm_setup() {
  static const GemmSetup once = [] {
    GemmSetup s{cudaSuccess, 0};
    int dev = 0;
    s.err = cudaFuncSetAttribute(fused_mlp_gemm_sm90_kernel<EPI>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 MlpGemmShape<EPI>::kSmemBytes);
    if (s.err == cudaSuccess) s.err = cudaGetDevice(&dev);
    if (s.err == cudaSuccess)
      s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (s.err == cudaSuccess && s.sms <= 0) s.err = cudaErrorInvalidDevice;
    return s;
  }();
  return once;
}

template <int EPI>
cudaError_t launch_mlp_gemm(const void* a, const void* b, const float* bias, const void* da,
                            void* out, void* act, int rows, int n, int k, cudaStream_t stream) {
  using S = MlpGemmShape<EPI>;
  static_assert(S::kStages >= 3 && S::kSmemBytes <= kMaxSmemBytes,
                "fused_mlp_gemm_sm90_kernel: shared memory");
  CUtensorMap map_a, map_b, map_out, map_act, map_da;
  cudaError_t err = sm90::make_map(&map_a, a, k, rows, 1, k, 0, kGemmRows);
  if (err == cudaSuccess) err = sm90::make_map(&map_b, b, k, n, 1, k, 0, kGemmCols);
  if (err == cudaSuccess) err = sm90::make_map(&map_out, out, n, rows, 1, n, 0, 64);
  map_act = map_out;
  map_da = map_out;
  if (EPI == kBiasGeluGrad) {
    if (err == cudaSuccess) err = sm90::make_map(&map_da, da, n, rows, 1, n, 0, kGemmRows);
    if (err == cudaSuccess && act != nullptr)
      err = sm90::make_map(&map_act, act, n, rows, 1, n, 0, 64);
  }
  if (err != cudaSuccess) return err;
  const GemmSetup setup = mlp_gemm_setup<EPI>();
  if (setup.err != cudaSuccess) return setup.err;
  const long long tiles =
      (long long)((rows + kGemmRows - 1) / kGemmRows) * ((n + kGemmCols - 1) / kGemmCols);
  const int grid = (int)(tiles < setup.sms ? tiles : setup.sms);
  MlpGemmArgs args{bias, rows, n, k, act != nullptr};
  fused_mlp_gemm_sm90_kernel<EPI><<<grid, kGemmThreads, S::kSmemBytes, stream>>>(
      map_a, map_b, map_out, map_act, map_da, args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wm
