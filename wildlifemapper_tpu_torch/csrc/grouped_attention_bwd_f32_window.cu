// Backward of the grouped windowed attention in f32 (K6 of the JAX package:
// wildlifemapper_tpu/ops/windowed_attention.py::_bwd_kernel, :64), d = 64 or
// 80, up to 208 tokens a window: the one-kernel register-tiled body of
// attention_bwd_f32_window.cuh (delta, dq, dk, dv and the rel-table
// gradients of a window-head from one block) with the scale on the f32
// scores, as the forward in grouped_attention.cu. f32 at d = 32 and the
// global blocks that land in K6 with more keys stay on the tile body
// (grouped_attention_bwd.cu); bf16 windows run the resident body.

#include "attention_bwd_f32_window.cuh"

WM_DEFINE_ATTENTION_BWD_F32_WINDOW(wm_grouped_attention_bwd_f32_window, true)
