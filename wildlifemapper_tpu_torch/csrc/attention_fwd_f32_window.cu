// Forward of the packed windowed attention in f32 (K1 of the JAX package:
// wildlifemapper_tpu/ops/windowed_attention_v2.py::_fwd_kernel, :105), d = 64
// or 80, up to 208 tokens a window: the register-tiled body of
// attention_fwd_f32_window.cuh (one or two blocks a window-head, an online
// softmax over slabs of 32 keys) with q*scale taken in f32 before the QK
// product, as the tile body in attention.cu. f32 at d = 32 and the global
// blocks that land in K1 with more keys stay on the tile body; bf16 windows
// run the resident body (attention_resident.cu).

#include "attention_fwd_f32_window.cuh"

WM_DEFINE_ATTENTION_FWD_F32_WINDOW(wm_attention_fwd_f32_window, false)
