// Backward of the packed attention family in f32 at head dim 128 without rel
// tables: the two register-tiled kernels of attention_bwd_f32_d128.cuh, the
// dq kernel taking delta itself. It stands for K4 of the JAX package,
// wildlifemapper_tpu/ops/cross_attention.py::_bwd_dq_kernel (:90,
// pallas_call :208) and ::_bwd_dkv_kernel (:116, pallas_call :227). The f32
// backward at d 64 and 80 runs attention_bwd_f32.cu, other f32 shapes the
// tile body (attention_bwd.cu), bf16 K4 the Hopper body.

#include "attention_bwd_f32_d128.cuh"

WM_DEFINE_ATTENTION_BWD_F32_D128(wm_attention_bwd_f32_d128)
