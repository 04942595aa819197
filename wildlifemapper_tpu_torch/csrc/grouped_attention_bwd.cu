// Backward of the grouped attention family (see grouped_attention.cu for the
// layout and the rounding points):
//
//   K5 wildlifemapper_tpu/ops/flash_attention.py::_bwd_kernel (:133)
//   K6 wildlifemapper_tpu/ops/windowed_attention.py::_bwd_kernel (:64)
//
// dq, dk, dv in the input type and drel_h (BH, N, gh), drel_w (BH, N, gw) in
// the tables' type, from the forward's out and lse:
//
//   s  = (q . k) * scale + bias            p  = exp(s - lse)
//   ds = round(p * (do . v^T - delta))     delta = rowsum(do * o) in f32
//   dq = round((ds . k) * scale)           dk = round((ds^T . q) * scale)
//   dv = round(round(p)^T . do)            drel = round(sums of ds)
//
// The Pallas K5 backward cannot be carried over: it adds every q-block's
// share of dk and dv into output blocks that all q-blocks of a head share,
// zeroed by the first (flash_attention.py:149-153, :179-182), which relies
// on the TPU walking the grid in order. On the GPU that is a race. Here the
// two kernels of attention_bwd.cuh do the work: one grids the queries and
// walks the keys (dq and the rel-table gradients), the other grids the keys
// and walks the queries (dk and dv), so every output element has one owner,
// accumulates in f32 over the whole walk in a fixed order and is rounded
// once (flash_attention.py:298); no atomics.
//
// The Pallas K6 backward keeps no lse: it holds a group of whole windows on
// chip, recomputes the softmax and takes delta = sum_k p*dp (:75-78). Here
// the K6 forward writes lse when a gradient is recorded and the same two
// kernels run; exp(s - lse) is that softmax, and rowsum(do*o) equals
// sum_k p*dp up to the rounding of out. The 16-window group padding and the
// E/T expansion operands of the Pallas kernel are TPU tiling artefacts and
// have no counterpart.
//
// K5's f32 backward at d = 64 or 80 runs the register-tiled f32 body
// instead (grouped_attention_bwd_f32.cu, attention_bwd_f32.cuh); its
// windows (K6) and bf16 leftovers stay here.

#include "attention_bwd.cuh"

WM_DEFINE_ATTENTION_BWD(wm_grouped_attention_bwd, true)
