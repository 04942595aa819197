// Backward of the packed attention family at its streaming shapes, bf16,
// the dq kernel (with delta, which it leaves for the dk/dv kernel, and the
// rel-table gradients): K2 and K4 of the JAX package
// (flash_attention_v2.py::_bwd_dq_kernel, cross_attention.py::_bwd_dq_kernel).
// The Hopper body of attention_bwd_sm90.cuh (wgmma, a TMA-fed shared-memory
// ring) with q*scale rounded to the input type before the QK product; see
// that header for the H100 bound and the design. attention_bwd.cu keeps the
// windowed shapes (K1), d = 32 and f32. One kernel a source, so that the
// instantiations compile side by side.

#include "attention_bwd_sm90.cuh"

WM_DEFINE_ATTENTION_BWD_SM90(wm_attention_bwd_dq_sm90, false, 0)
