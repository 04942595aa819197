// Forward of the packed attention family (K1, K2 and K4 of the JAX package):
// the kernel bodies of attention_fwd.cuh with q*scale rounded to the input
// type before the QK product. See that header for the layouts, the H100
// bound and the design.

#include "attention_fwd.cuh"

WM_DEFINE_ATTENTION_FWD(wm_attention_fwd, false)
