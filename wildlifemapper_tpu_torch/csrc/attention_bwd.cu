// Backward of the packed attention family (K1, K2 and K4 of the JAX
// package): the two kernels of attention_bwd.cuh with q*scale rounded to the
// input type before the QK product, as their forward in attention.cu. K2's
// f32 backward at d = 64 or 80 runs the register-tiled f32 body instead
// (attention_bwd_f32.cu, attention_bwd_f32.cuh).

#include "attention_bwd.cuh"

WM_DEFINE_ATTENTION_BWD(wm_attention_bwd, false)
