// Backward of the packed attention family (K1, K2 and K4 of the JAX
// package): the two kernels of attention_bwd.cuh with q*scale rounded to the
// input type before the QK product, as their forward in attention.cu.

#include "attention_bwd.cuh"

WM_DEFINE_ATTENTION_BWD(wm_attention_bwd, false)
