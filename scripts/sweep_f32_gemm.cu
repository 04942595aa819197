// Variants of K3's f32 GEMM body (wildlifemapper_tpu_torch/csrc/
// mlp_gemm_f32.cuh) for scripts/sweep_f32_gemm.py, which builds this file
// once a variant with the macros below set by -D and times each beside
// F.linear. Every variant computes each output as one f32 sum in k order,
// as the body does, so all of them agree bit for bit. Not part of the
// port's kernel library (ops/_build.py builds csrc/ alone).
//
//   THREADS, WARPS_M  threads of a block and its warps along the rows
//   LANES_M           lanes of a warp along the rows (32 / LANES_M along the
//                     columns)
//   TMQ, TNQ          4-row and 4-column quads of a thread's accumulator tile
//   BK                depth of a k slab (16 or 8)
//   MINB              blocks an SM for __launch_bounds__ (2: 128 registers)
//   STAGES            slabs in shared memory
//   KK_UNROLL         unroll of the k-steps of a slab
//   ASYNC             1: 4-byte cp.async straight into the k-major slab,
//                     STAGES deep, in place of the registers' transpose
// The defaults are the body's shape as it was first written (warps 2 x 4,
// lanes 8 x 4); the body now has WARPS_M=4, LANES_M=4.
#include <math.h>
#include <stdint.h>
#include <cuda_runtime.h>

#ifndef THREADS
#define THREADS 256
#endif
#ifndef WARPS_M
#define WARPS_M 2
#endif
#ifndef LANES_M
#define LANES_M 8
#endif
#ifndef TMQ
#define TMQ 2
#endif
#ifndef TNQ
#define TNQ 2
#endif
#ifndef BK
#define BK 16
#endif
#ifndef MINB
#define MINB 2
#endif
#ifndef STAGES
#define STAGES 2
#endif
#ifndef KK_UNROLL
#define KK_UNROLL 16
#endif
#ifndef ASYNC
#define ASYNC 0
#endif
#define STR2(x) #x
#define STR(x) STR2(x)

constexpr int WARPS = THREADS / 32;
constexpr int WARPS_N = WARPS / WARPS_M;
constexpr int LANES_N = 32 / LANES_M;
constexpr int WTM = TMQ * LANES_M * 4;
constexpr int WTN = TNQ * LANES_N * 4;
constexpr int BM = WARPS_M * WTM;
constexpr int BN = WARPS_N * WTN;
constexpr int LDA = BM + 4;
constexpr int LDB = BN + 4;
constexpr int KQ = BK / 4;             // 16-byte pieces of a row of a slab
constexpr int ROWS_PER_INSTR = 32 / KQ;
constexpr int PA = BM * KQ / THREADS;  // pieces a thread, A
constexpr int PB = BN * KQ / THREADS;
constexpr int GROUP_M = 8;

struct Slab { float a[BK][LDA]; float b[BK][LDB]; };

__device__ __forceinline__ void gelu_and_grad(float h, float* act, float* dact) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  const float pdf = expf(-0.5f * h * h) * 0.39894228040143268f;
  *act = h * cdf;
  *dact = cdf + h * pdf;
}

// the row of piece `it` for this lane (BK 16: the swap trick; BK 8: plain)
__device__ __forceinline__ int piece_row(int it, int warp, int lane) {
  if (KQ == 4) {
    const int kq = lane & 3;
    return 16 * (warp + WARPS * (it >> 1)) + (lane >> 2) + 8 * ((kq >> 1) ^ (it & 1));
  }
  return ROWS_PER_INSTR * (warp + WARPS * it) + lane / KQ;
}

template <int E>
__global__ void __launch_bounds__(THREADS, MINB)
gemm_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ bias, const float* __restrict__ da,
            float* __restrict__ out, float* __restrict__ act, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Slab* slab = reinterpret_cast<Slab*>(smem_raw);
  const int tiles_m = (m + BM - 1) / BM;
  const int tiles_n = (n + BN - 1) / BN;
  const int per_group = GROUP_M * tiles_n;
  const int first_m = (blockIdx.x / per_group) * GROUP_M;
  const int group_m = min(tiles_m - first_m, GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int row0 = (first_m + in_group % group_m) * BM;
  const int col0 = (in_group / group_m) * BN;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int k4 = 4 * (lane % KQ);

  int arow[PA], brow[PB];
  bool ain[PA], bin[PB];
#pragma unroll
  for (int p = 0; p < PA; ++p) {
    arow[p] = piece_row(p, warp, lane);
    ain[p] = row0 + arow[p] < m;
  }
#pragma unroll
  for (int p = 0; p < PB; ++p) {
    brow[p] = piece_row(p, warp, lane);
    bin[p] = col0 + brow[p] < n;
  }
  float4 ra[PA], rb[PB];
  auto load = [&](int k0) {
    const bool kin = k0 + k4 < k;
#pragma unroll
    for (int p = 0; p < PA; ++p)
      ra[p] = (kin && ain[p]) ? *reinterpret_cast<const float4*>(
                                    a + (long long)(row0 + arow[p]) * k + k0 + k4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int p = 0; p < PB; ++p)
      rb[p] = (kin && bin[p]) ? *reinterpret_cast<const float4*>(
                                    b + (long long)(col0 + brow[p]) * k + k0 + k4)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store = [&](Slab& s) {
#pragma unroll
    for (int p = 0; p < PA; ++p) {
      s.a[k4 + 0][arow[p]] = ra[p].x; s.a[k4 + 1][arow[p]] = ra[p].y;
      s.a[k4 + 2][arow[p]] = ra[p].z; s.a[k4 + 3][arow[p]] = ra[p].w;
    }
#pragma unroll
    for (int p = 0; p < PB; ++p) {
      s.b[k4 + 0][brow[p]] = rb[p].x; s.b[k4 + 1][brow[p]] = rb[p].y;
      s.b[k4 + 2][brow[p]] = rb[p].z; s.b[k4 + 3][brow[p]] = rb[p].w;
    }
  };

  // ASYNC: 4-byte cp.async straight into the k-major slab, zero-filled
  // past the edges
  auto fetch = [&](int k0, Slab& sl) {
    constexpr int EA = BM * BK / THREADS, EB = BN * BK / THREADS;
    const int kk = t % BK;
    const bool kin = k0 + kk < k;
#pragma unroll
    for (int i = 0; i < EA; ++i) {
      const int row = t / BK + (THREADS / BK) * i;
      const bool in = kin && row0 + row < m;
      const float* src = a + (in ? (long long)(row0 + row) * k + k0 + kk : 0);
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&sl.a[kk][row]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 4 : 0));
    }
#pragma unroll
    for (int i = 0; i < EB; ++i) {
      const int row = t / BK + (THREADS / BK) * i;
      const bool in = kin && col0 + row < n;
      const float* src = b + (in ? (long long)(col0 + row) * k + k0 + kk : 0);
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&sl.b[kk][row]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(in ? 4 : 0));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int m_base = wm * WTM + (lane % LANES_M) * 4;
  const int n_base = wn * WTN + (lane / LANES_M) * 4;
  float acc[TMQ * 4][TNQ * 4];
#pragma unroll
  for (int i = 0; i < TMQ * 4; ++i)
#pragma unroll
    for (int j = 0; j < TNQ * 4; ++j) acc[i][j] = 0.f;

  int s = 0;
#if ASYNC
  for (int st = 0; st < STAGES - 1; ++st) fetch(st * BK, slab[st]);
#else
  load(0);
  store(slab[0]);
  __syncthreads();
#endif
  for (int k0 = 0; k0 < k; k0 += BK) {
    const bool more = k0 + BK < k;
#if ASYNC
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncthreads();
    fetch(k0 + (STAGES - 1) * BK, slab[(s + STAGES - 1) % STAGES]);
#else
    if (more) load(k0 + BK);
#endif
    const Slab& cur = slab[s];
_Pragma(STR(unroll KK_UNROLL))
    for (int kk = 0; kk < BK; ++kk) {
      float av[TMQ * 4], bv[TNQ * 4];
#pragma unroll
      for (int q = 0; q < TMQ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&cur.a[kk][m_base + q * LANES_M * 4]);
        av[4 * q] = v.x; av[4 * q + 1] = v.y; av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TNQ; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(&cur.b[kk][n_base + q * LANES_N * 4]);
        bv[4 * q] = v.x; bv[4 * q + 1] = v.y; bv[4 * q + 2] = v.z; bv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TMQ * 4; ++i)
#pragma unroll
        for (int j = 0; j < TNQ * 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#if !ASYNC
    if (more) store(slab[(s + 1) % STAGES]);
    __syncthreads();
#endif
    s = (s + 1) % STAGES;
  }
#if ASYNC
  asm volatile("cp.async.wait_all;\n" ::);
#endif

#pragma unroll
  for (int qn = 0; qn < TNQ; ++qn) {
    const int col = col0 + n_base + qn * LANES_N * 4;
    if (col >= n) continue;
    const float bb[4] = {bias[col], bias[col + 1], bias[col + 2], bias[col + 3]};
#pragma unroll
    for (int i = 0; i < TMQ * 4; ++i) {
      const int row = row0 + m_base + (i & 3) + (i >> 2) * LANES_M * 4;
      if (row >= m) continue;
      const long long at = (long long)row * n + col;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * qn + j] + bb[j];
      if (E == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = 0.5f * v[j] * (1.f + erff(v[j] * 0.70710678118654752f));
      } else if (E == 2) {
        const float4 g = *reinterpret_cast<const float4*>(da + at);
        const float gv[4] = {g.x, g.y, g.z, g.w};
        float avv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float dact;
          gelu_and_grad(v[j], &avv[j], &dact);
          v[j] = gv[j] * dact;
        }
        if (act != nullptr)
          *reinterpret_cast<float4*>(act + at) = make_float4(avv[0], avv[1], avv[2], avv[3]);
      }
      *reinterpret_cast<float4*>(out + at) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int E>
int launch(const void* a, const void* b, const void* bias, const void* da, void* out,
           void* act, int m, int n, int k, void* stream) {
  const int smem = STAGES * sizeof(Slab);
  cudaFuncSetAttribute(gemm_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  gemm_kernel<E><<<(unsigned)tiles, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (const float*)bias, (const float*)da, (float*)out,
      (float*)act, m, n, k);
  return (int)cudaGetLastError();
}

extern "C" int sweep_gemm(int e, const void* a, const void* b, const void* bias,
                          const void* da, void* out, void* act, int m, int n, int k,
                          void* stream) {
  if (e == 0) return launch<0>(a, b, bias, da, out, act, m, n, k, stream);
  if (e == 1) return launch<1>(a, b, bias, da, out, act, m, n, k, stream);
  return launch<2>(a, b, bias, da, out, act, m, n, k, stream);
}
