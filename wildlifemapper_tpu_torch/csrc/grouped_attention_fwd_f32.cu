// Forward of the grouped attention family in f32 at the streaming shapes:
// the register-tiled kernel of attention_fwd_f32.cuh, q unscaled and the f32
// scores times the scale. It stands for K5 of the JAX package,
// wildlifemapper_tpu/ops/flash_attention.py::_fwd_kernel (:88, pallas_call
// :230), at head dim 64 and 80 with the rel tables, (BH, N, d) operands read
// as one head and BH batches. The windows of K6 in f32 run the f32 window
// forward (grouped_attention_fwd_f32_window.cu), d 32 and 128 the tile body
// (grouped_attention.cu), bf16 the Hopper and the resident bodies
// (grouped_attention_sm90.cu, grouped_attention_resident.cu).

#include "attention_fwd_f32.cuh"

WM_DEFINE_ATTENTION_FWD_F32(wm_grouped_attention_fwd_f32, true)
