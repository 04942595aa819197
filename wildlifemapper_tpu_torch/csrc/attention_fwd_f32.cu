// Forward of the packed attention family in f32 at the streaming shapes: the
// register-tiled kernel of attention_fwd_f32.cuh, q*scale taken in f32 before
// the QK product. It stands for two TPU kernels of the JAX package:
// K2 wildlifemapper_tpu/ops/flash_attention_v2.py::_fwd_kernel (:95,
// pallas_call :199) at head dim 64 and 80 with the rel tables, and K4
// wildlifemapper_tpu/ops/cross_attention.py::_fwd_kernel (:64, pallas_call
// :160) at head dim 128 without them. The windows of K1 in f32 run the f32
// window forward (attention_fwd_f32_window.cu), d 32 the tile body
// (attention.cu), bf16 the Hopper and the resident bodies (attention_sm90.cu,
// attention_resident.cu).

#include "attention_fwd_f32.cuh"

WM_DEFINE_ATTENTION_FWD_F32(wm_attention_fwd_f32, false)
