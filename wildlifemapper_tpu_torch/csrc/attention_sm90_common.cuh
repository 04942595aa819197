// What the Hopper attention bodies share (attention_fwd_sm90.cuh,
// attention_bwd_sm90.cuh): the block's shape, the ring's barriers, the
// grid-row division, the swizzled offsets, the exponential, the products
// from registers and the warpgroups' turns.
//
// A block is two consumer warpgroups, each owning 64 of the block's 128 rows
// (warp w of 8 owns rows 16w..16w+15; thread (g = lane / 4, t4 = lane % 4)
// holds rows g and g + 8 and, of every 8-wide column group n of a wgmma
// accumulator, columns 2*t4 and 2*t4 + 1: d[n][0..1] for row g, d[n][2..3]
// for row g + 8, the m16n8 fragment layout), and a producer warp that only
// issues TMA copies.
#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "sm90.cuh"

namespace wm {
namespace {

constexpr int kSm90Rows = 128;       // query (or key) rows a block owns
constexpr int kSm90Threads = 384;    // two consumer warpgroups and the producer's
constexpr int kConsumerThreads = 256;
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU; exp(s - m) is exp2(s*log2e - m*log2e), one FFMA and this.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of element (row, col) in a tile of 64-column swizzled regions
// of `region` bytes each (see sm90.cuh).
__device__ __forceinline__ int swz(int row, int col, int region) {
  return (col >> 6) * region + row * sm90::kRegionRowBytes +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// Byte offset of element (row, col < 16) in a narrow region of 32-byte rows
// (see sm90.cuh).
__device__ __forceinline__ int swz32(int row, int col) {
  return row * 32 + ((((col >> 3) & 1) ^ ((row >> 2) & 1)) << 4) + (col & 7) * 2;
}

// Regions of a head of D columns in shared memory: D / 64 regions of 64
// columns and, at d = 80, a narrow region of the last 16 (sm90.cuh).
template <int D> struct HeadRegions {
  static constexpr int NR = D / 64;         // full regions
  static constexpr int NARROW = D % 64;     // columns of the narrow region: 0 or 16
};

// D (+)= A . B over TK / 16 steps, A (TK columns) in registers, B
// MN-major: TK rows of a tile of 64-column regions `region` bytes apart.
template <int N, int TK>
__device__ __forceinline__ void wgmma_rs_k(float (&d)[N / 8][4], const uint32_t (&a)[TK / 16][4],
                                           uint32_t b, int region, bool acc) {
  using namespace sm90;
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
    wgmma_rs<1, N>(d, a[kk], desc_mnmajor(b + kk * 16 * kRegionRowBytes, region), acc || kk > 0);
}

// The two consumer warpgroups issue their products in turns: warpgroup w
// waits at barrier 4 + w, which completes when the other one has arrived
// there after issuing its own, so one's exponentials run under the other's
// products. Each warpgroup passes my_turn / your_turn once per issue point,
// warpgroup 1 arrives once first and warpgroup 0 waits once last.
__device__ __forceinline__ void my_turn(int wg) {
  sm90::named_barrier(4 + wg, kConsumerThreads);
}
__device__ __forceinline__ void your_turn(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(4 + (wg ^ 1)), "r"(kConsumerThreads) : "memory");
}

// The barriers of a ring of STAGES stages: each stage's full barrier
// (`full_arrivals`: the producer's with the bytes, and any it adds after
// writing beside the tiles) and its empty barrier (one arrival a consumer
// warp). One thread initialises; the block then syncs.
template <int STAGES>
__device__ __forceinline__ void init_ring_barriers(uint32_t full0, uint32_t empty0,
                                                   int full_arrivals) {
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    sm90::mbar_init(full0 + 8 * s, full_arrivals);
    sm90::mbar_init(empty0 + 8 * s, kConsumerThreads / 32);
  }
  sm90::mbar_init_fence();
}

// The producer thread's K and V in the forward kernel: every K and V tile
// (stage s: a K tile and a V tile of TK keys, each the regions of
// HeadRegions<D>, the narrow one through its own maps) of head h of batch b
// into the ring, as far ahead as it allows.
template <int D, int TK, int STAGES>
__device__ __forceinline__ void produce_kv_tiles(uint32_t ring, uint32_t full0, uint32_t empty0,
                                                 const CUtensorMap* map_k,
                                                 const CUtensorMap* map_v,
                                                 const CUtensorMap* map_kn,
                                                 const CUtensorMap* map_vn, int h, int b,
                                                 int nkt) {
  constexpr int NR = HeadRegions<D>::NR, NARROW = HeadRegions<D>::NARROW;
  constexpr int REGION = TK * sm90::kRegionRowBytes;
  constexpr int TILE = NR * REGION + TK * NARROW * 2;
  int stage = 0;
  uint32_t phase = 1;  // the ring starts empty: the first waits pass
  for (int kt = 0; kt < nkt; ++kt) {
    sm90::mbar_wait(empty0 + 8 * stage, phase);
    const uint32_t full = full0 + 8 * stage;
    sm90::mbar_expect_tx(full, 2 * TILE);
    const uint32_t dst = ring + stage * 2 * TILE;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      sm90::tma_load_3d(dst + r * REGION, map_k, h * D + r * 64, kt * TK, b, full);
      sm90::tma_load_3d(dst + TILE + r * REGION, map_v, h * D + r * 64, kt * TK, b, full);
    }
    if constexpr (NARROW != 0) {
      sm90::tma_load_3d(dst + NR * REGION, map_kn, h * D + NR * 64, kt * TK, b, full);
      sm90::tma_load_3d(dst + TILE + NR * REGION, map_vn, h * D + NR * 64, kt * TK, b, full);
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// key / gw by one multiply (gw_magic = 2^32 / gw + 1, exact below 2^16 keys).
__device__ __forceinline__ int div_gw(int key, int gw, unsigned gw_magic) {
  return gw == 1 ? key : (int)__umulhi((unsigned)key, gw_magic);
}
inline unsigned gw_magic_of(int gw) {
  return gw > 0 ? (unsigned)(0x100000000ull / (unsigned)gw + 1ull) : 0u;
}

}  // namespace
}  // namespace wm
