// Forward of the packed attention family in f32 at the streaming shapes
// without rel tables: the register-tiled kernel of attention_fwd_f32.cuh at
// head dim 128, q*scale taken in f32 before the QK product. It stands for K4
// of the JAX package, wildlifemapper_tpu/ops/cross_attention.py::_fwd_kernel
// (:64, pallas_call :160). The other f32 forward launches run the tile body
// (attention.cu), bf16 K4 the Hopper body (attention_sm90.cu).

#include "attention_fwd_f32.cuh"

WM_DEFINE_ATTENTION_FWD_F32(wm_attention_fwd_f32)
