// Forward of the packed windowed attention (K1 of the JAX package:
// windowed_attention_v2.py::windowed_attention_packed), bf16, d = 64 or 80, up
// to 208 tokens a window: the resident body of attention_fwd_resident.cuh (one
// block a window-head, Q, K and V whole in shared memory, mma.sync fed by
// ldmatrix, a two-stage cp.async ring across window-heads) with q*scale
// rounded to the input type before the QK product. See that header for the
// H100 bound and the design; attention.cu keeps f32, d = 32 and the global
// blocks that land in K1 with more keys.

#include "attention_fwd_resident.cuh"

WM_DEFINE_ATTENTION_FWD_RESIDENT(wm_attention_fwd_resident, false)
