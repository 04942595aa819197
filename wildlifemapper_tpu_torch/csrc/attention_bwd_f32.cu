// Backward of the packed attention family at the streaming shapes in f32:
// the two register-tiled kernels of attention_bwd_f32.cuh with q*scale
// taken in f32 before the QK product, as the forward in attention.cu. It
// stands for K2 of the JAX package,
// wildlifemapper_tpu/ops/flash_attention_v2.py::_bwd_dq_kernel (:229) and
// ::_bwd_dkv_kernel (:276). Other f32 shapes run the tile body
// (attention_bwd.cu), bf16 the Hopper and resident bodies.

#include "attention_bwd_f32.cuh"

WM_DEFINE_ATTENTION_BWD_F32(wm_attention_bwd_f32, false)
