// Backward of the packed windowed attention (K1 of the JAX package:
// windowed_attention_v2.py::_bwd_kernel), bf16, d = 64 or 80, up to 208
// tokens a window: the one-kernel resident body of
// attention_bwd_resident.cuh (delta, dq, dk, dv and the rel-table gradients
// of a window-head from one block)
// with q*scale rounded to the input type before the QK product. See that
// header for the H100 bound and the design; attention_bwd.cu keeps f32,
// d = 32 and the global blocks that land in K1 with more keys.

#include "attention_bwd_resident.cuh"

WM_DEFINE_ATTENTION_BWD_RESIDENT(wm_attention_bwd_resident, false)
