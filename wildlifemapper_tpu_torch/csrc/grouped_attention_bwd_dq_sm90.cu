// Backward of the grouped attention family at its streaming shapes, bf16,
// the dq kernel (with delta, which it leaves for the dk/dv kernel, and the
// rel-table gradients): K5 of the JAX package
// (flash_attention.py::_bwd_kernel, one Pallas kernel, two here).
// The Hopper body of attention_bwd_sm90.cuh (wgmma, a TMA-fed shared-memory
// ring) with the scale on the f32 scores; see that header for the H100 bound
// and the design, grouped_attention_bwd.cu for the layout and why the Pallas
// kernel cannot be carried over. That source keeps the windowed shapes (K6),
// d = 32 and f32. One kernel a source, so that the instantiations compile
// side by side.

#include "attention_bwd_sm90.cuh"

WM_DEFINE_ATTENTION_BWD_SM90(wm_grouped_attention_bwd_dq_sm90, true, 0)
