"""Fused transformer MLP: fc1 -> exact GELU -> fc2 in one kernel (K3).

Replaces wildlifemapper_tpu/ops/fused_mlp.py::fused_mlp (:97) in the MLP of
all 12 ViT-B blocks: x (R, 768) with R = B*4096 or B*2304, hidden 3072. The
kernel is csrc/fused_mlp.cu; its header says what bounds it on the H100
(the (R, F) hidden round trip through device memory) and how the design
keeps the hidden activations in shared memory.

    out = gelu_erf(x @ w1^T + b1) @ w2^T + b2

w1 (F, D) and w2 (D, F) are in the torch Linear layout (out, in), in the
compute dtype; b1 and b2 are f32. Both products accumulate in f32, the GELU
runs in f32 and its output is rounded to x's dtype (fused_mlp.py:77).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def fused_mlp_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same rounding points)."""
    h = F.linear(x.float(), w1.float(), b1.float())
    a = F.gelu(h).to(x.dtype)
    return F.linear(a.float(), w2.float(), b2.float()).to(x.dtype)


def _check(x, w1, b1, w2, b2):
    r, d = x.shape
    f = w1.shape[0]
    want = {"w1": (w1, (f, d), x.dtype), "b1": (b1, (f,), torch.float32),
            "w2": (w2, (d, f), x.dtype), "b2": (b2, (d,), torch.float32)}
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} {dt} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")


class _FusedMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
        if any(t.data_ptr() % 16 for t in (x, w1, w2)):
            raise ValueError("fused_mlp: x, w1 and w2 must start on a "
                             "16-byte boundary")
        r, d = x.shape
        f = w1.shape[0]
        out = torch.empty_like(x)
        err = _build.load_kernels().wm_fused_mlp_fwd(
            _build.dtype_code(x), x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), r, d, f,
            _build.stream_ptr(x))
        _build.check(err, "fused_mlp kernel")
        fused_mlp.launches += 1
        return out

    @staticmethod
    def backward(ctx, grad):
        raise _build.no_backward("fused_mlp (K3)")


def fused_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """x (R, D) -> (R, D) through fc1 / erf-GELU / fc2."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, D), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_mlp_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w1, b1, w2, b2)
    return _FusedMlpFn.apply(x, w1, b1, w2, b2)


fused_mlp.launches = 0
