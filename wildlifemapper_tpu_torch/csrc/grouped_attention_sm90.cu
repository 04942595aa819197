// Forward of the grouped attention family at its streaming shapes (K5 of the
// JAX package: flash_attention.py::flash_attention_rel_pos), bf16: the
// Hopper body of attention_fwd_sm90.cuh (wgmma, a TMA-fed shared-memory
// ring) with the scale on the f32 scores. See that header for the H100 bound
// and the design, and grouped_attention.cu for the layout and the rounding
// points; that source keeps the windowed shapes (K6), d = 32 and f32.

#include "attention_fwd_sm90.cuh"

WM_DEFINE_ATTENTION_FWD_SM90(wm_grouped_attention_fwd_sm90, true)
