"""Transformer MLP: fc1 -> exact GELU -> fc2 (K3).

Replaces wildlifemapper_tpu/ops/fused_mlp.py::fused_mlp (:97, pallas_call
:103) in the MLP of every ViT block: x (R, 768) with R = B*4096 or B*2304,
hidden 3072 at ViT-B (1024 / 4096 at ViT-L, 1280 / 5120 at ViT-H).

    out = gelu_erf(x @ w1^T + b1) @ w2^T + b2

w1 (F, D) and w2 (D, F) are in the torch Linear layout (out, in), in the
compute dtype; b1 and b2 are f32. Both products accumulate in f32, the GELU
runs in f32 and its output is rounded to x's dtype (fused_mlp.py:77).

bf16 runs the Hopper GEMM body of csrc/mlp_gemm_sm90.cuh (a persistent,
warp-specialised wgmma GEMM fed by TMA) in two launches: pass 1 writes
hidden = bf16(gelu(x @ w1^T + b1)) to an (R, F) scratch, pass 2 reads it
for out = bf16(hidden @ w2^T + b2). The Pallas kernel kept the hidden on
chip by holding both weights in VMEM (9.4 MB at ViT-B); a block of the
H100 has 227 KB of shared memory, and the fused body that did the same here
streamed both weights from L2 for every 64-row tile (2.4 GB of L2 reads a
call at R 16384) with an fc2 accumulator that filled the register file (so
no D 1280 at all). Un-fused, the hidden round trip is 100.7 MB (0.06 ms at
3.35 TB/s) against two products of 77 GFLOP each (0.078 ms each at 989
TFLOP/s): operations bound both, and a bf16 hidden in device memory is the
same rounding point as the Pallas kernel's. f32, the parity path, runs the
register-tiled f32 GEMM body of csrc/mlp_gemm_f32.cuh (on the CUDA cores:
f32 without TF32 has no tensor core) in the same two passes from one host
call (csrc/fused_mlp.cu), through an f32 hidden: the Pallas kernel's f32
GELU output is not rounded before fc2 either. It takes D and F that are
multiples of 4.

The backward follows `_mlp_bwd` (fused_mlp.py:139-175): da = g @ w2 rounded
to x's dtype; the dh kernel (`_bwd_dh_kernel` :120, pallas_call :148; bf16:
the same GEMM body with its BiasGeluGrad epilogue, which reads da by TMA
and writes a and dh through shared memory; f32: the f32 body's
BiasGeluGrad epilogue, csrc/fused_mlp_bwd.cu)
recomputes h = x @ w1^T + b1 and writes a = gelu(h) and dh = da * gelu'(h),
both in x's dtype, so h never reaches device memory;
dx = dh @ w1 and the weight and bias gradients are library products and
reductions, as the JAX package leaves them to XLA. The weight gradients are
the f32 products of the rounded operands, rounded once to the weight's
dtype: a bf16 x bf16 product is exact in f32, so the GEMM takes the
operands in their own dtype and accumulates in f32, with PyTorch's
reduced-precision (bf16) split-K reduction switched off around it.

On a CPU tensor the wrapper runs the plain version and autograd
differentiates it; on a CUDA tensor it launches the kernels or raises,
the forward through its operator (ops/_library.py; within
`outputs_unread()` it launches nothing: see there).
"""

from __future__ import annotations

import contextlib
import math
import threading

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


def fused_mlp_dh_plain(x, w1, b1, da):
    """Plain PyTorch version of the backward kernel: (a, dh) from the
    recomputed f32 h, both rounded to x's dtype."""
    h = F.linear(x.float(), w1.float(), b1.float())
    cdf = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
    pdf = torch.exp(-0.5 * h * h) * (2.0 * math.pi) ** -0.5
    return (h * cdf).to(x.dtype), (da.float() * (cdf + h * pdf)).to(x.dtype)


# The GEMM bodies' epilogues (csrc/mlp_gemm_sm90.cuh::MlpEpilogue, the same
# numbers as csrc/mlp_gemm_f32.cuh::F32Epilogue).
_BIAS_GELU, _BIAS, _BIAS_GELU_GRAD = 0, 1, 2
# D and F must be multiples of these: the rows of every operand are whole
# 16-byte pieces (the bf16 body's tensor maps, the f32 body's 16-byte loads)
ROW_MULTIPLE = {torch.bfloat16: 8, torch.float32: 4}


def _check_kernel_shapes(x, *tensors):
    """What the kernels take: D and F multiples of ROW_MULTIPLE (8 in bf16,
    4 in f32), any number of rows; every operand on a 16-byte boundary."""
    d, f = x.shape[1], tensors[0].shape[0]
    mult = ROW_MULTIPLE.get(x.dtype)
    if mult is None:
        raise TypeError(f"fused_mlp: the kernels take float32 or bfloat16, "
                        f"got {x.dtype}")
    if d % mult or f % mult:
        raise ValueError(f"fused_mlp: {str(x.dtype).replace('torch.', '')} "
                         f"needs D and F multiples of {mult}, got D={d}, "
                         f"F={f}")
    if any(t.data_ptr() % 16 for t in (x, *tensors)):
        raise ValueError("fused_mlp: operands must start on a 16-byte "
                         "boundary")


def _gemm(epilogue, a, b, bias, out, da=None, act=None):
    """One launch of the bf16 GEMM body: out = epilogue(a @ b^T + bias).
    The forward's two passes go through wm_mlp_forward instead; chip_smoke
    times each pass alone through this."""
    err = _build.load_kernels().wm_mlp_gemm(
        epilogue, a.data_ptr(), b.data_ptr(), bias.data_ptr(),
        None if da is None else da.data_ptr(), out.data_ptr(),
        None if act is None else act.data_ptr(), a.shape[0], b.shape[0],
        a.shape[1], _build.stream_ptr(a))
    _build.check(err, "fused_mlp GEMM kernel")


def fused_mlp_dh(x, w1, b1, da, want_act: bool = True):
    """Launch K3's dh kernel on CUDA tensors: (a, dh), each (R, F) in x's
    dtype; a is None unless `want_act`. The GEMM body of x's dtype with its
    BiasGeluGrad epilogue (bf16: csrc/mlp_gemm_sm90.cu; f32:
    csrc/fused_mlp_bwd.cu)."""
    x, w1, b1, da = (t.contiguous() for t in (x, w1, b1, da))
    r, d = x.shape
    f = w1.shape[0]
    want = {"w1": (w1, (f, d), x.dtype), "b1": (b1, (f,), torch.float32),
            "da": (da, (r, f), x.dtype)}
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt or t.device != x.device:
            raise ValueError(f"{name}: expected {shape} {dt} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    _check_kernel_shapes(x, w1, da)
    act = torch.empty_like(da) if want_act else None
    dh = torch.empty_like(da)
    if x.dtype == torch.bfloat16:
        _gemm(_BIAS_GELU_GRAD, x, w1, b1, dh, da=da, act=act)
    else:
        err = _build.load_kernels().wm_fused_mlp_dh(
            _build.dtype_code(x), x.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), da.data_ptr(),
            act.data_ptr() if want_act else None, dh.data_ptr(), r, d, f,
            _build.stream_ptr(x))
        _build.check(err, "fused_mlp backward kernel")
    return act, dh


def _weight_grad(rows, cols, like):
    """rows^T @ cols accumulated in f32 and rounded once to like's dtype.
    The operands go in as they are: bf16 x bf16 is exact in f32, so this is
    the f32 product of the rounded operands (fused_mlp.py:168-174) as long
    as no partial sum is rounded to bf16, which the flag below forbids."""
    matmul = torch.backends.cuda.matmul
    keep = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return torch.matmul(rows.t(), cols).to(like.dtype)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = keep


def _mlp_backward(x, w1, b1, w2, g, dh_fn, needs=(True,) * 5):
    """`_mlp_bwd` of the JAX package around `dh_fn` (the kernel or its plain
    version). `needs` says which of (dx, dw1, db1, dw2, db2) are wanted;
    the others are None."""
    dt = x.dtype
    da = torch.matmul(g, w2).to(dt)                           # (R, F)
    act, dh = dh_fn(x, w1, b1, da, needs[3])
    dx = torch.matmul(dh, w1).to(dt) if needs[0] else None
    dw1 = _weight_grad(dh, x, w1) if needs[1] else None
    db1 = dh.float().sum(0).to(b1.dtype) if needs[2] else None
    dw2 = _weight_grad(g, act, w2) if needs[3] else None
    db2 = g.float().sum(0) if needs[4] else None
    return dx, dw1, db1, dw2, db2


def fused_mlp_backward_plain(x, w1, b1, w2, b2, g):
    """Plain PyTorch version of the whole backward: (dx, dw1, db1, dw2,
    db2) with the JAX package's rounding points."""
    return _mlp_backward(
        x, w1, b1, w2, g,
        lambda x_, w1_, b1_, da, _: fused_mlp_dh_plain(x_, w1_, b1_, da))


def _fused_mlp_launch(x, w1, b1, w2, b2):
    """The forward's kernels on CUDA tensors: two launches of the GEMM body
    of x's dtype through an (R, F) hidden scratch in x's dtype, both from
    one host call (bf16 wm_mlp_forward, f32 wm_fused_mlp_fwd: the
    forward's host time is the wrapper's and two launches). Returns out
    (R, D)."""
    r, d = x.shape
    f = w1.shape[0]
    _check_kernel_shapes(x, w1, w2)
    out = torch.empty_like(x)
    hidden = torch.empty((r, f), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), hidden.data_ptr(), out.data_ptr(), r, d, f,
            _build.stream_ptr(x))
    lib = _build.load_kernels()
    if x.dtype == torch.bfloat16:
        err = lib.wm_mlp_forward(*ptrs)
    else:
        err = lib.wm_fused_mlp_fwd(_build.dtype_code(x), *ptrs)
    _build.check(err, "fused_mlp GEMM kernels")
    fused_mlp.kernel_launches += 2
    return out


# per thread, as torch's grad mode: the recompute runs in whichever thread
# the autograd engine runs the backward, and enters the context there
_state = threading.local()


@contextlib.contextmanager
def outputs_unread():
    """For a forward whose output nobody reads: within this context the
    CUDA wrapper keeps what its backward needs (its inputs) and launches no
    kernel; the output it returns is a zero of the output's shape and dtype
    that holds no memory (one element, stride 0), not the MLP's result. A
    recompute of torch.utils.checkpoint is such a forward: it runs only for
    the tensors it saves for the backward, and the backward's dh kernel
    recomputes the hidden from the input, so the MLP's forward need not run
    again, as the JAX package's remat leaves out a forward whose result its
    backward does not read. The plain version (a CPU tensor) saves its
    hidden and runs as always."""
    before = outputs_unread_active()
    _state.outputs_unread = True
    try:
        yield
    finally:
        _state.outputs_unread = before


def outputs_unread_active() -> bool:
    """Whether this thread is within `outputs_unread()`."""
    return getattr(_state, "outputs_unread", False)


class _FusedMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
        if outputs_unread_active():
            out = x.new_zeros(()).expand_as(x)
        else:
            # the forward's operator (ops/_library.py) launches and counts
            out = torch.ops.wm.fused_mlp.default(x, w1, b1, w2, b2)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, w1, b1, w2)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w1, b1, w2 = ctx.saved_tensors

        def dh_kernel(x_, w1_, b1_, da, want_act):
            res = fused_mlp_dh(x_, w1_, b1_, da, want_act)
            fused_mlp.backward_launches += 1
            return res

        return _mlp_backward(x, w1, b1, w2, grad.contiguous(), dh_kernel,
                             ctx.needs_input_grad)


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


# wrapper calls that launched the forward's kernels (one a call), and the
# kernels they launched (the GEMM body's two passes, in either dtype)
fused_mlp.launches = 0
fused_mlp.kernel_launches = 0
# backward kernels launched (one per backward: a and dh from the recompute)
fused_mlp.backward_launches = 0
