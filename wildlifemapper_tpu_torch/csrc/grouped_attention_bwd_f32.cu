// Backward of the grouped attention family at the streaming shapes in f32:
// the two register-tiled kernels of attention_bwd_f32.cuh with the scale on
// the f32 scores, as the forward in grouped_attention.cu. It stands for K5
// of the JAX package, wildlifemapper_tpu/ops/flash_attention.py::_bwd_kernel
// (:133), one Pallas kernel whose dk / dv sums across q-blocks become the
// dk/dv kernel here (every output one owner, no atomics). Other f32 shapes
// run the tile body (grouped_attention_bwd.cu), bf16 the Hopper and
// resident bodies.

#include "attention_bwd_f32.cuh"

WM_DEFINE_ATTENTION_BWD_F32(wm_grouped_attention_bwd_f32, true)
