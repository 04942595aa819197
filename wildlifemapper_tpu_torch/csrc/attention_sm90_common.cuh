// What the Hopper attention bodies share (attention_fwd_sm90.cuh,
// attention_bwd_sm90.cuh): the block's shape, the ring's barriers and the
// grid-row division; for the forward also the A-operand loads of a resident
// q row and the decomposed rel-pos bias on a score fragment.
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

// Row length, in bf16 elements, of a rel table staged in shared memory: an
// odd number of 32-bit words, so the 8 rows a warp reads fall in 8 banks.
__host__ __device__ inline int rel_row_len(int g) {
  int e = (g + 1) & ~1;
  if (((e / 2) & 1) == 0) e += 2;
  return e;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf16_at(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Two adjacent bf16 of q as one 32-bit A-fragment register; with PRESCALE
// each is round(q * scale).
template <bool PRESCALE>
__device__ __forceinline__ uint32_t load_a_pair(const __nv_bfloat16* row, int c, bool ok,
                                                float scale) {
  if (!ok) return 0u;
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c);
  if (!PRESCALE) return w;
  return pack_bf16x2(bf16_lo(w) * scale, bf16_hi(w) * scale);
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

// The producer thread's whole life in the forward kernel: every K and V
// tile (stage s: a K tile and a V tile of TK keys, each D / 64 swizzled
// regions) of head h of batch b into the ring, as far ahead as it allows.
template <int D, int TK, int STAGES>
__device__ __forceinline__ void produce_kv_tiles(uint32_t ring, uint32_t full0, uint32_t empty0,
                                                 const CUtensorMap* map_k,
                                                 const CUtensorMap* map_v, int h, int b,
                                                 int nkt) {
  constexpr int NR = D / 64;
  constexpr int REGION = TK * sm90::kRegionRowBytes;
  constexpr int TILE = NR * REGION;
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

// The rel tables of the block's 128 rows into shared memory, in bf16 as they
// are, rows of rel_row_len elements; rows past nq hold zeros. All consumer
// threads (t < kConsumerThreads) call it and meet at a barrier afterwards.
__device__ __forceinline__ void stage_rel_tables(__nv_bfloat16* rhs, __nv_bfloat16* rws, int sh,
                                                 int sw, const void* relh, const void* relw,
                                                 int b, int h, int q0, int nq, int heads,
                                                 int gh, int gw, int t) {
  using bf16 = __nv_bfloat16;
  const bf16* rh = static_cast<const bf16*>(relh);
  const bf16* rw = static_cast<const bf16*>(relw);
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int i = t; i < kSm90Rows * gh; i += kConsumerThreads) {
    const int r = i / gh, j = i - r * gh;
    const long long row = (long long)b * nq + q0 + r;
    rhs[r * sh + j] = (q0 + r < nq) ? rh[(row * heads + h) * gh + j] : zero;
  }
  for (int i = t; i < kSm90Rows * gw; i += kConsumerThreads) {
    const int r = i / gw, j = i - r * gw;
    const long long row = (long long)b * nq + q0 + r;
    rws[r * sw + j] = (q0 + r < nq) ? rw[(row * heads + h) * gw + j] : zero;
  }
}

// s[n][0..1] += bias(row rA, key), s[n][2..3] += bias(row rB, key) for the
// keys k0 + 8n + 2*t4 + {0, 1} of a tile, bias = rel_h[row][key / gw] +
// rel_w[row][key % gw] from the staged tables. Keys past nk read the last
// key's entries (the caller masks them). With `fast` (gw % 8 == 0) an 8-key
// group lies in one grid row at 8 adjacent columns: one 32-bit read of rel_w
// a row and group, and rel_h is read again only where the grid row changes.
template <int NS>
__device__ __forceinline__ void add_rel_bias(float (&s)[NS][4], const __nv_bfloat16* rhs,
                                             const __nv_bfloat16* rws, int sh, int sw, int rA,
                                             int rB, int t4, int k0, int nk, int gh, int gw,
                                             unsigned gw_magic, bool fast) {
  if (fast) {
    int kh = div_gw(k0, gw, gw_magic);
    int kw0 = k0 - kh * gw;
    float hA = 0.f, hB = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      if (n == 0 || kw0 == 0) {
        const int khc = min(kh, gh - 1);
        hA = bf16_at(rhs + rA * sh + khc);
        hB = bf16_at(rhs + rB * sh + khc);
      }
      const uint32_t wA = *reinterpret_cast<const uint32_t*>(rws + rA * sw + kw0 + 2 * t4);
      const uint32_t wB = *reinterpret_cast<const uint32_t*>(rws + rB * sw + kw0 + 2 * t4);
      s[n][0] += hA + bf16_lo(wA);
      s[n][1] += hA + bf16_hi(wA);
      s[n][2] += hB + bf16_lo(wB);
      s[n][3] += hB + bf16_hi(wB);
      kw0 += 8;
      if (kw0 == gw) {
        kw0 = 0;
        ++kh;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = min(k0 + n * 8 + 2 * t4 + j, nk - 1);
        const int kh = div_gw(key, gw, gw_magic);
        const int kw = key - kh * gw;
        s[n][j] += bf16_at(rhs + rA * sh + kh) + bf16_at(rws + rA * sw + kw);
        s[n][j + 2] += bf16_at(rhs + rB * sh + kh) + bf16_at(rws + rB * sw + kw);
      }
    }
  }
}

}  // namespace
}  // namespace wm
