// Forward of the packed attention family at its streaming shapes (K2 and K4
// of the JAX package: flash_attention_v2.py::flash_attention_packed,
// cross_attention.py::cross_attention_packed), bf16: the Hopper body of
// attention_fwd_sm90.cuh (wgmma, a TMA-fed shared-memory ring) with q*scale
// rounded to the input type before the QK product. See that header for the
// H100 bound and the design; attention.cu keeps the windowed shapes (K1),
// d = 32 and f32.

#include "attention_fwd_sm90.cuh"

WM_DEFINE_ATTENTION_FWD_SM90(wm_attention_fwd_sm90, false)
