// Backward of the packed windowed attention in f32 (K1 of the JAX package:
// wildlifemapper_tpu/ops/windowed_attention_v2.py::_bwd_kernel, :125), d = 64
// or 80, up to 208 tokens a window: the one-kernel register-tiled body of
// attention_bwd_f32_window.cuh (delta, dq, dk, dv and the rel-table
// gradients of a window-head from one block) with q*scale taken in f32
// before the QK product, as the forward in attention.cu. f32 at d = 32 and
// the global blocks that land in K1 with more keys stay on the tile body
// (attention_bwd.cu); bf16 windows run the resident body.

#include "attention_bwd_f32_window.cuh"

WM_DEFINE_ATTENTION_BWD_F32_WINDOW(wm_attention_bwd_f32_window, false)
