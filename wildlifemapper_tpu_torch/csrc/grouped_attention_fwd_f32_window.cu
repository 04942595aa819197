// Forward of the grouped windowed attention in f32 (K6 of the JAX package:
// wildlifemapper_tpu/ops/windowed_attention.py::_fwd_kernel, :52), d = 64 or
// 80, up to 208 tokens a window: the register-tiled body of
// attention_fwd_f32_window.cuh (one or two blocks a window-head, an online
// softmax over slabs of 32 keys) with the scale on the f32 scores, as the
// tile body in grouped_attention.cu. f32 at d = 32 and the global blocks that
// land in K6 with more keys stay on the tile body; bf16 windows run the
// resident body (grouped_attention_resident.cu).

#include "attention_fwd_f32_window.cuh"

WM_DEFINE_ATTENTION_FWD_F32_WINDOW(wm_grouped_attention_fwd_f32_window, true)
