// Forward of the grouped attention family: the two TPU kernels of the JAX
// package's grouped ("v1") data flow, which take q, k, v per head as
// contiguous (BH, N, d) and the rel tables as (BH, N, gh) / (BH, N, gw):
//
//   K5 wildlifemapper_tpu/ops/flash_attention.py::flash_attention_rel_pos
//      (:207, kernel body :88; global ViT blocks: BH = B*12, N = 4096 or
//      2304, d = 64)
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::windowed_attention_rel_pos
//      (:111, kernel body :52; windowed ViT blocks: BWH = B*25*12 window-heads
//      of N = 196, or B*16*12 of N = 144, d = 64; any N below 1024)
//
//   out[b, q, :] = softmax_k((q . k) * scale + rel_h[b, q, k / gw]
//                                            + rel_w[b, q, k % gw]) . v
//
// The operands go to the kernels as they are: (BH, N, d) is the strided
// layout of attention_fwd.cuh with one head and BH batches (batch stride
// N*d, row stride d; tables (BH, N, 1, g); lse (BH, N, 1)), so no operand is
// copied or repacked. The batch rides blockIdx.z: BH <= 65535, else the
// launch is refused.
//
// What still runs here (ops/_attention.py::attention_body): the f32 forward
// of K6 (the windows), of K5 below 512 keys or on a rel grid of gh + gw >
// 128, d = 32 and d = 128, and bf16 below 512 keys off a window. The f32
// forward of K5 from 512 keys at d = 64 or 80 takes the register-tiled f32
// forward of attention_fwd_f32.cuh (grouped_attention_fwd_f32.cu); bf16
// from 512 keys the Hopper body (grouped_attention_sm90.cu), on a window the
// resident body (grouped_attention_resident.cu).
//
// Rounding points, which differ from the packed family's: q goes into the
// product unscaled and the f32 scores take `* scale` (flash_attention.py:110,
// windowed_attention.py:58), where K1/K2/K4 round q*scale to the input type
// first. At d = 64 (scale 2^-3) the two agree bit for bit in bf16; at d = 32
// or 128 they do not. The bias is one indexed read of the two tables per
// score: both branches of the Pallas K5 body (`_bias_tile` for bk % w == 0
// and the expansion matmuls otherwise, :111-117) are that function, and
// non-square grids need nothing more. The unnormalised p = exp(s - m) is
// rounded to the input type before PV and out = acc / l is rounded once;
// the Pallas K6 rounds the normalised softmax instead
// (windowed_attention.py:60), a difference of one rounding of the working
// type. The plain versions (ops/flash_attention.py) do as the kernels do.
// With an lse buffer the kernel writes lse = m + log(l) (flash_attention.py:252),
// for K6 too: the backward kernels take it in place of a second softmax.
//
// What bounds them on the H100 (bf16, batch 4). K5 at (48, 4096, 64):
// 4*N^2*d flops a head, 206 GFLOP against 150 MB, so operations; a head's K
// and V (1 MB) exceed a block's 227 KB of shared memory, so the body streams
// 64-key tiles with an online softmax as K2's does. K6 at (1200, 196, 64):
// 11.8 GFLOP against 133 MB, so bytes. A window-head's K and V (50 KB in
// bf16) would fit a block whole, which is the Pallas design; this first
// version runs the same streaming body instead, one block per 64 query rows:
// the 4 blocks of a window-head read its K and V once from device memory
// and three times from L2 (50 KB, launched back to back), and the last tile
// is filled 4/64 at N = 196 (16/64 at N = 144). What it buys: one body
// covers every N the JAX kernel takes (a global block on a small grid lands
// on K6 with N up to 1023, where K and V no longer fit a block in f32), and
// the lse for the two-kernel backward comes for free. A resident
// one-block-per-window-head body is the redesign to try when K6's time
// matters.

#include "attention_fwd.cuh"

WM_DEFINE_ATTENTION_FWD(wm_grouped_attention_fwd, true)
