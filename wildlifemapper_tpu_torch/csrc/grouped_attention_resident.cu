// Forward of the grouped windowed attention (K6 of the JAX package:
// windowed_attention.py::windowed_attention_rel_pos), bf16, d = 64 or 80, up
// to 208 tokens a window: the resident body of attention_fwd_resident.cuh (one
// block a window-head, Q, K and V whole in shared memory, mma.sync fed by
// ldmatrix, a two-stage cp.async ring across window-heads) with the scale on
// the f32 scores. See that header for the H100 bound and the design, and
// grouped_attention.cu for the layout; that source keeps f32, d = 32 and the
// global blocks that land in K6 with more keys.

#include "attention_fwd_resident.cuh"

WM_DEFINE_ATTENTION_FWD_RESIDENT(wm_grouped_attention_fwd_resident, true)
