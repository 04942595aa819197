"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes (tile edges, odd token counts, every head dim: 32, 64,
80 for ViT-H, 128). They
need CUDA and skip elsewhere with the reason "needs CUDA (H100)".

From 512 keys on, bf16 at d = 64, 80 or 128 runs
the Hopper bodies (wgmma and a TMA-fed ring, csrc/attention_fwd_sm90.cuh
and attention_bwd_sm90.cuh): the
STREAMING cases below are ragged against their 128-row blocks and their
64- and 128-key tiles (grids that are no multiple of 8, N != M, a last tile
of one or six keys, d = 128 with rel tables, d = 80); their backward also
with and without the table gradients, twice, and the delta its dq kernel
writes.

Below 512 keys, bf16 at d = 64 or 80 with rel tables
and N == M <= 208 runs the resident bodies (one block a window-head, csrc/attention_fwd_resident.cuh and
attention_bwd_resident.cuh, whose backward is one kernel): the RESIDENT cases
are the main paths' windows (196 = 14x14, 144 = 12x12) and ragged ones (49 =
7x7 with odd table widths, 100 = 10x10, 208 = 13x16, a window of six tokens,
one window-head, more window-heads than the card has SMs; a window of one
token has gradients that are zero but for rounding, so nothing to compare),
at d = 64 and at d = 80.

In f32 the forward of the same streaming shapes (d = 64 or 80, at least 512
keys, no tables or a grid of gh + gw <= 128) runs the register-tiled f32
forward (csrc/attention_fwd_f32.cuh): the F32_FORWARD cases hold it against
the plain version and the tile body in both families, out and lse, twice.
Their backward (grids 16, 24, 32, 48 or 64 wide) runs the register-tiled f32
body (csrc/attention_bwd_f32.cuh): the F32_STREAMING cases hold it against
the plain version and the tile body in both families, with and without
tables and table gradients, ragged against its 128-row blocks and its 64-
and 48-key tiles, twice, with the delta its dq kernel writes. The f32
backward of the windows the resident bodies take (d = 64 or 80, N = M <=
208, tables at most 16 wide) runs the f32 window body
(csrc/attention_bwd_f32_window.cuh, one kernel, delta inside): the
F32_WINDOW cases hold it against the plain version and the tile body in both
families, with and without the table gradients, ragged against its slabs and
warps, twice, with no delta pass; their forward runs the f32 window forward
(csrc/attention_fwd_f32_window.cuh, one or two blocks a window-head), which
the same cases hold against the plain version and the tile body, out and
lse, twice.

At d = 80 (ViT-H) the D80 cases hold the Hopper and the resident forward
against the tile body and the plain version, twice, with the backward
after them (the Hopper body from 512 keys on, the resident body below), and
one fine-tune step with remat_blocks against the same step without it. The
f32 K3 kernels hold ViT-H's D 1280 against their plain versions.

This file imports neither JAX nor the JAX package's tests. On a machine
without JAX run it as

    python -m pytest tests/test_torch_cuda.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

from wildlifemapper_tpu_torch.ops import _library
from wildlifemapper_tpu_torch.ops._attention import attention_plain
from wildlifemapper_tpu_torch.ops.cross_attention import (
    cross_attention_packed, cross_attention_packed_backward_plain,
    cross_attention_packed_plain)
from wildlifemapper_tpu_torch.ops.flash_attention import (
    flash_attention_rel_pos, grouped_attention_backward_plain,
    grouped_attention_plain)
from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
    flash_attention_packed, flash_attention_packed_plain)
from wildlifemapper_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_backward_plain, fused_mlp_dh, fused_mlp_dh_plain,
    fused_mlp_plain)
from wildlifemapper_tpu_torch.ops.windowed_attention import \
    windowed_attention_rel_pos
from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
    packed_attention_backward_plain, windowed_attention_packed,
    windowed_attention_packed_plain)

pytestmark = pytest.mark.requires_cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, shape, dtype, dev, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dev).to(dtype)


def _compare(wrapper, plain, args, dtype):
    """Kernel in `dtype` against the plain version in f32 on the same
    dtype-rounded inputs; the wrapper's counter moves by one."""
    before = wrapper.launches
    with torch.inference_mode():
        got = wrapper(*args)
        torch.cuda.synchronize()
        ref = plain(*[a.float() if torch.is_tensor(a) and a.is_floating_point()
                      else a for a in args])
    assert wrapper.launches == before + 1
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref, **TOL[dtype])


DTYPES = [torch.float32, torch.bfloat16]

# Shapes that take the Hopper bodies in bf16 (at least 512 keys).
STREAMING_FLASH = [(2, (25, 40), 3, 64), (1, (24, 24), 2, 64),
                   (1, (20, 50), 2, 128), (1, (48, 48), 2, 64)]
STREAMING_CROSS = [(2, 200, 1000, 2, 128), (1, 300, 1030, 4, 64),
                   (1, 1030, 577, 2, 128), (2, 130, 512, 2, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,hw,heads,d", [(5, (4, 4), 2, 32),
                                           (3, (7, 7), 3, 64),
                                           (2, (14, 14), 2, 64),
                                           (2, (12, 12), 2, 64),
                                           (3, (14, 14), 2, 80)])
def test_windowed_kernel(cuda, dtype, bw, hw, heads, d):
    rng = np.random.default_rng(bw * 10 + d)
    n = hw[0] * hw[1]
    args = (_randn(rng, (bw, n, 3 * heads * d), dtype, cuda),
            _randn(rng, (bw, n, heads, hw[0]), dtype, cuda, 0.5),
            _randn(rng, (bw, n, heads, hw[1]), dtype, cuda, 0.5),
            d ** -0.5, heads, hw)
    _compare(windowed_attention_packed, windowed_attention_packed_plain,
             args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,heads,d", [(2, (12, 12), 2, 64),
                                          (1, (8, 24), 3, 64),
                                          (1, (32, 32), 2, 64),
                                          (1, (24, 24), 2, 80),
                                          *STREAMING_FLASH])
def test_flash_kernel(cuda, dtype, b, hw, heads, d):
    rng = np.random.default_rng(b * 100 + hw[1])
    n = hw[0] * hw[1]
    args = (_randn(rng, (b, n, 3 * heads * d), dtype, cuda),
            _randn(rng, (b, n, heads, hw[0]), dtype, cuda, 0.5),
            _randn(rng, (b, n, heads, hw[1]), dtype, cuda, 0.5),
            d ** -0.5, heads, hw)
    _compare(flash_attention_packed, flash_attention_packed_plain, args,
             dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,heads,d", [(2, 100, 70, 2, 128),
                                           (1, 64, 130, 4, 64),
                                           (2, 33, 65, 2, 32),
                                           (1, 70, 600, 2, 80),
                                           *STREAMING_CROSS])
def test_cross_kernel(cuda, dtype, b, n, m, heads, d):
    rng = np.random.default_rng(n + m + d)
    args = (_randn(rng, (b, n, heads * d), dtype, cuda),
            _randn(rng, (b, m, heads * d), dtype, cuda),
            _randn(rng, (b, m, heads * d), dtype, cuda), d ** -0.5, heads)
    _compare(cross_attention_packed, cross_attention_packed_plain, args,
             dtype)


# K3 shapes (rows, D, F). bf16 runs the Hopper GEMM body (128-row tiles, 128
# or 256 columns; csrc/mlp_gemm_sm90.cuh), f32 the f32 GEMM body (128 x 128
# tiles; csrc/mlp_gemm_f32.cuh): rows ragged against the tile (1, 127, 129,
# 257, 1000), F that is no multiple of the column tile (320), and ViT-B / L
# / H widths with F = 4D; f32 also at ViT-H's D 1280 with a tensor-parallel
# rank's F (2560 and 1536: half and a little more than a quarter of 5120)
# and at a D and F that are multiples of 4 and of nothing larger (D 68 is
# also no multiple of the 16-deep k slab).
MLP_SHAPES = [(50, 64, 128), (33, 768, 3072), (70, 1024, 256),
              (1, 768, 3072), (127, 64, 256), (129, 128, 512),
              (1000, 256, 320)]
MLP_CASES = ([(dt, *shape) for dt in DTYPES for shape in MLP_SHAPES]
             + [(torch.bfloat16, *shape) for shape in
                [(300, 768, 3072), (200, 1024, 4096), (130, 1280, 5120),
                 (257, 1280, 320)]]
             + [(torch.float32, *shape) for shape in
                [(257, 1280, 1536), (129, 1280, 2560), (33, 68, 132)]])


def _mlp_inputs(rng, r, dim, hidden, dtype, dev):
    return (_randn(rng, (r, dim), dtype, dev),
            _randn(rng, (hidden, dim), dtype, dev, dim ** -0.5),
            _randn(rng, (hidden,), torch.float32, dev, 0.1),
            _randn(rng, (dim, hidden), dtype, dev, hidden ** -0.5),
            _randn(rng, (dim,), torch.float32, dev, 0.1))


@pytest.mark.parametrize("dtype,r,dim,hidden", MLP_CASES)
def test_fused_mlp_kernel(cuda, dtype, r, dim, hidden):
    rng = np.random.default_rng(r + dim)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, r, dim, hidden, dtype, cuda)
    before = (fused_mlp.launches, fused_mlp.kernel_launches)
    with torch.inference_mode():
        got = fused_mlp(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ref = fused_mlp_plain(x, w1, b1, w2, b2)   # same rounding points
    # one wrapper call; the GEMM body of either dtype runs twice (fc1 +
    # GELU, fc2)
    assert (fused_mlp.launches, fused_mlp.kernel_launches) == (
        before[0] + 1, before[1] + 2)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("want_act", [True, False])
@pytest.mark.parametrize("dtype,r,dim,hidden", MLP_CASES)
def test_fused_mlp_dh_kernel(cuda, want_act, dtype, r, dim, hidden):
    """K3's dh kernel alone: a (or None without `want_act`) and dh against
    the plain version on the same inputs."""
    rng = np.random.default_rng(r * 3 + dim)
    x, w1, b1, _, _ = _mlp_inputs(rng, r, dim, hidden, dtype, cuda)
    da = _randn(rng, (r, hidden), dtype, cuda)
    act, dh = fused_mlp_dh(x, w1, b1, da, want_act)
    torch.cuda.synchronize()
    ref_act, ref_dh = fused_mlp_dh_plain(x, w1, b1, da)
    assert (act is None) == (not want_act)
    _close_grads([dh] + ([act] if want_act else []),
                 [ref_dh] + ([ref_act] if want_act else []), dtype,
                 ("dh", "a"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,dim,hidden", [(1000, 768, 3072),
                                          (130, 1280, 5120)])
def test_fused_mlp_gemm_repeats(cuda, dtype, r, dim, hidden):
    """Every output element of the GEMM bodies (bf16 and f32) has one owner
    and a fixed order of sums: two runs of the forward and of dh are
    bit-identical, and dh without a is the dh written beside a."""
    rng = np.random.default_rng(r)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, r, dim, hidden, dtype, cuda)
    da = _randn(rng, (r, hidden), dtype, cuda)
    with torch.inference_mode():
        first = [fused_mlp(x, w1, b1, w2, b2), *fused_mlp_dh(x, w1, b1, da)]
        second = [fused_mlp(x, w1, b1, w2, b2), *fused_mlp_dh(x, w1, b1, da)]
        no_act, dh_alone = fused_mlp_dh(x, w1, b1, da, False)
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert no_act is None and torch.equal(dh_alone, first[2])


@pytest.mark.parametrize("r,hidden", [(1, 5120), (130, 5120), (257, 320)])
def test_fused_mlp_f32_at_vit_h_width(cuda, r, hidden):
    """The f32 GEMM body at ViT-H's D 1280: the forward, a and dh against
    the plain versions at the f32 tolerance, two kernels a forward."""
    rng = np.random.default_rng(r + hidden)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, r, 1280, hidden, torch.float32, cuda)
    da = _randn(rng, (r, hidden), torch.float32, cuda)
    before = fused_mlp.kernel_launches
    with torch.inference_mode():
        got = fused_mlp(x, w1, b1, w2, b2)
        act, dh = fused_mlp_dh(x, w1, b1, da)
        torch.cuda.synchronize()
        ref = fused_mlp_plain(x, w1, b1, w2, b2)
        ref_act, ref_dh = fused_mlp_dh_plain(x, w1, b1, da)
    assert fused_mlp.kernel_launches == before + 2
    for g, want in ((got, ref), (act, ref_act), (dh, ref_dh)):
        torch.testing.assert_close(g, want, **TOL[torch.float32])


# Backward kernels against their plain versions: f32 at the JAX gradient
# tests' tolerance (tests/test_flash_attention_v2.py:116); bf16 at 2e-2 of
# each output's largest element.
def _close_grads(got, ref, dtype, names):
    for name, g, r in zip(names, got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        g, r = g.float(), r.float()
        if dtype == torch.float32:
            torch.testing.assert_close(g, r, atol=5e-4, rtol=1e-3, msg=name)
        else:
            bound = 2e-2 * max(r.abs().max().item(), 1e-6)
            err = (g - r).abs().max().item()
            assert err <= bound, f"{name}: max abs err {err} > {bound}"


COUNTERS = ("launches", "backward_launches", "backward_dq_launches",
            "backward_dkv_launches")


def _counts(wrapper):
    return tuple(getattr(wrapper, c) for c in COUNTERS)


def _one_backward(dtype, d, n, hw):
    """What one forward and backward add to COUNTERS: the resident body's
    backward and the f32 window body's are one kernel, the others' a dq and
    a dk/dv kernel."""
    from wildlifemapper_tpu_torch.ops._attention import attention_body

    if attention_body(dtype, d, n, n, True, hw, "backward") in (
            "resident", "f32_window"):
        return (1, 1, 0, 0)
    return (1, 0, 1, 1)


def _packed_backward(wrapper, cuda, dtype, bw, hw, heads, d, seed,
                     rel_grad=True):
    """Autograd through the wrapper on the card against the plain backward
    on the kernel forward's own (out, lse)."""
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    qkv = _randn(rng, (bw, n, 3 * heads * d), dtype, cuda).requires_grad_()
    rh = _randn(rng, (bw, n, heads, hw[0]), dtype, cuda, 0.5)
    rw = _randn(rng, (bw, n, heads, hw[1]), dtype, cuda, 0.5)
    if rel_grad:
        rh.requires_grad_(), rw.requires_grad_()
    dout = _randn(rng, (bw, n, heads * d), dtype, cuda)
    before = _counts(wrapper)
    out = wrapper(qkv, rh, rw, d ** -0.5, heads, hw)
    inputs = (qkv, rh, rw) if rel_grad else (qkv,)
    got = torch.autograd.grad(out, inputs, dout)
    torch.cuda.synchronize()
    assert _counts(wrapper) == tuple(
        a + b for a, b in zip(before, _one_backward(dtype, d, n, hw)))
    c = heads * d
    q, k, v = (qkv.detach()[..., i * c:(i + 1) * c] for i in range(3))
    _, lse = attention_plain(q, k, v, d ** -0.5, heads, rh.detach(),
                             rw.detach(), return_lse=True)
    ref = packed_attention_backward_plain(
        qkv.detach(), rh.detach(), rw.detach(), out.detach(), lse, dout,
        d ** -0.5, heads)
    _close_grads(got, ref, dtype, ("dqkv", "drel_h", "drel_w"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,hw,heads,d", [(5, (4, 4), 2, 32),
                                           (3, (7, 7), 3, 64),
                                           (2, (14, 14), 2, 64),
                                           (2, (12, 12), 2, 64),
                                           (3, (14, 14), 2, 80)])
def test_windowed_backward_kernels(cuda, dtype, bw, hw, heads, d):
    _packed_backward(windowed_attention_packed, cuda, dtype, bw, hw, heads,
                     d, seed=bw * 10 + d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,heads,d", [(2, (12, 12), 2, 64),
                                          (1, (8, 24), 3, 64),
                                          (1, (32, 32), 2, 64),
                                          (1, (24, 24), 2, 80),
                                          *STREAMING_FLASH])
def test_flash_backward_kernels(cuda, dtype, b, hw, heads, d):
    _packed_backward(flash_attention_packed, cuda, dtype, b, hw, heads, d,
                     seed=b * 100 + hw[1])


def test_packed_backward_without_rel_gradients(cuda):
    """Frozen rel tables: the dq kernel skips the drel reduction."""
    _packed_backward(flash_attention_packed, cuda, torch.bfloat16, 1,
                     (12, 12), 2, 64, seed=5, rel_grad=False)


def test_forward_lse_matches_plain(cuda):
    """The lse the forward writes for the backward, against the plain one:
    the tile bodies (70 keys) and, in bf16, the Hopper body (600 keys: a
    last tile of 88; d = 128, whose scale is no power of two)."""
    from wildlifemapper_tpu_torch.ops._attention import (attention_body,
                                                         attention_launch)

    rng = np.random.default_rng(11)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for n, heads, d in ((70, 2, 64), (600, 2, 64), (600, 1, 128)):
            q, k, v = (_randn(rng, (2, n, heads * d), dtype, cuda)
                       for _ in range(3))
            scale = d ** -0.5
            _, lse = attention_launch(q, k, v, scale, heads, return_lse=True)
            _, ref = attention_plain(q, k, v, scale, heads, return_lse=True)
            torch.testing.assert_close(lse, ref, atol=tol, rtol=tol)
            if attention_body(dtype, d, n, n, False) == "sm90":
                _, again = attention_launch(q, k, v, scale, heads,
                                            return_lse=True)
                assert torch.equal(lse, again)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,heads,d", [(2, 100, 70, 2, 128),
                                           (1, 64, 130, 4, 64),
                                           (2, 33, 65, 2, 32),
                                           (1, 70, 600, 2, 80),
                                           *STREAMING_CROSS])
def test_cross_backward_kernels(cuda, dtype, b, n, m, heads, d):
    rng = np.random.default_rng(n + m + d)
    q = _randn(rng, (b, n, heads * d), dtype, cuda).requires_grad_()
    k = _randn(rng, (b, m, heads * d), dtype, cuda).requires_grad_()
    v = _randn(rng, (b, m, heads * d), dtype, cuda).requires_grad_()
    dout = _randn(rng, (b, n, heads * d), dtype, cuda)
    before = (cross_attention_packed.backward_dq_launches,
              cross_attention_packed.backward_dkv_launches)
    out = cross_attention_packed(q, k, v, d ** -0.5, heads)
    got = torch.autograd.grad(out, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (cross_attention_packed.backward_dq_launches,
            cross_attention_packed.backward_dkv_launches) == (
        before[0] + 1, before[1] + 1)
    _, lse = attention_plain(q.detach(), k.detach(), v.detach(), d ** -0.5,
                             heads, return_lse=True)
    ref = cross_attention_packed_backward_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), lse, dout,
        d ** -0.5, heads)
    _close_grads(got, ref, dtype, ("dq", "dk", "dv"))


@pytest.mark.parametrize("dtype,r,dim,hidden", MLP_CASES)
def test_fused_mlp_backward_kernel(cuda, dtype, r, dim, hidden):
    rng = np.random.default_rng(r + dim)
    x, w1, b1, w2, b2 = (t.requires_grad_() for t in _mlp_inputs(
        rng, r, dim, hidden, dtype, cuda))
    g = _randn(rng, (r, dim), dtype, cuda)
    before = fused_mlp.backward_launches
    got = torch.autograd.grad(fused_mlp(x, w1, b1, w2, b2),
                              (x, w1, b1, w2, b2), g)
    torch.cuda.synchronize()
    assert fused_mlp.backward_launches == before + 1
    ref = fused_mlp_backward_plain(*(t.detach() for t in (x, w1, b1, w2, b2)),
                                   g)
    _close_grads(got, ref, dtype, ("dx", "dw1", "db1", "dw2", "db2"))


def test_frozen_weights_skip_their_gradients(cuda):
    """With only x requiring grad (a frozen encoder) the MLP backward
    returns dx alone and still launches its kernel once."""
    rng = np.random.default_rng(3)
    x = _randn(rng, (40, 64), torch.bfloat16, cuda).requires_grad_()
    w1 = _randn(rng, (128, 64), torch.bfloat16, cuda, 0.1)
    w2 = _randn(rng, (64, 128), torch.bfloat16, cuda, 0.1)
    b1 = torch.zeros(128, device=cuda)
    b2 = torch.zeros(64, device=cuda)
    before = fused_mlp.backward_launches
    fused_mlp(x, w1, b1, w2, b2).float().sum().backward()
    assert fused_mlp.backward_launches == before + 1
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_criterion_waits_for_the_device_once(cuda):
    """The set criterion synchronises with the host in one place, the copy
    of the matching cost to scipy (ops/lsap.py): PyTorch's sync debug mode
    warns at every call that waits for the device."""
    import warnings

    from wildlifemapper_tpu_torch.config import MatchCriterionConfig
    from wildlifemapper_tpu_torch.train.criterion import set_criterion

    rng = np.random.default_rng(0)
    out = {"pred_logits": _randn(rng, (3, 51, 8), torch.float32, cuda),
           "pred_boxes": torch.sigmoid(_randn(rng, (3, 51, 4), torch.float32,
                                              cuda))}
    out["pred_logits"].requires_grad_()
    tgt = {"labels": torch.randint(1, 7, (3, 128), device=cuda),
           "boxes": torch.rand(3, 128, 4, device=cuda) * 0.5 + 0.1,
           "valid": torch.arange(128, device=cuda)[None, :]
           < torch.tensor([[5], [60], [0]], device=cuda)}
    set_criterion(out, tgt, MatchCriterionConfig())      # warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses = set_criterion(out, tgt, MatchCriterionConfig())
            losses["loss"].backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    waits = [str(w.message) for w in caught
             if "synchroniz" in str(w.message).lower()]
    assert len(waits) == 1, waits
    assert torch.isfinite(losses["loss"])


# The grouped kernels (K5, K6): q, k, v (BH, N, d) per head, tables
# (BH, N, g). d = 32 and 128 are where scaling the f32 scores and scaling q
# before the product round differently in bf16.
GROUPED_CASES = {
    "flash": (flash_attention_rel_pos,
              [(5, (12, 12), 64), (2, (8, 24), 32), (3, (32, 32), 64),
               (2, (9, 9), 128),
               # the Hopper bodies
               (3, (20, 50), 64), (2, (27, 19), 128), (2, (48, 48), 64),
               # ViT-H's head dim: the Hopper forward, the tile backward
               (2, (24, 24), 80)]),
    "windowed": (windowed_attention_rel_pos,
                 [(19, (4, 4), 32), (7, (7, 7), 64), (5, (14, 14), 64),
                  (5, (12, 12), 64), (3, (3, 5), 128), (4, (14, 14), 80)]),
}
GROUPED_IDS = [(w, *c) for w, (_, cs) in GROUPED_CASES.items() for c in cs]


def _grouped_inputs(rng, bh, hw, d, dtype, dev):
    n = hw[0] * hw[1]
    return [_randn(rng, (bh, n, d), dtype, dev) for _ in range(3)] + [
        _randn(rng, (bh, n, hw[0]), dtype, dev, 0.5),
        _randn(rng, (bh, n, hw[1]), dtype, dev, 0.5)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which,bh,hw,d", GROUPED_IDS)
def test_grouped_kernels(cuda, dtype, which, bh, hw, d):
    wrapper = GROUPED_CASES[which][0]
    args = _grouped_inputs(np.random.default_rng(bh + d), bh, hw, d, dtype,
                           cuda)
    _compare(wrapper, grouped_attention_plain, (*args, d ** -0.5, hw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rel_grad", [True, False])
@pytest.mark.parametrize("which,bh,hw,d", GROUPED_IDS)
def test_grouped_backward_kernels(cuda, dtype, rel_grad, which, bh, hw, d):
    """Autograd through the wrapper on the card against the plain backward
    on the kernel forward's own out and the plain lse; without table
    gradients the dq kernel skips the drel reduction. K5 also takes the
    encoder's 4-D tables and returns their gradients 4-D."""
    wrapper = GROUPED_CASES[which][0]
    q, k, v, rh, rw = _grouped_inputs(np.random.default_rng(bh * 7 + d), bh,
                                      hw, d, dtype, cuda)
    if which == "flash":
        rh, rw = rh.reshape(bh, *hw, hw[0]), rw.reshape(bh, *hw, hw[1])
    inputs = (q, k, v, rh, rw) if rel_grad else (q, k, v)
    for t in inputs:
        t.requires_grad_()
    dout = _randn(np.random.default_rng(1), q.shape, dtype, cuda)
    scale = d ** -0.5
    before = _counts(wrapper)
    out = wrapper(q, k, v, rh, rw, scale, hw)
    got = torch.autograd.grad(out, inputs, dout)
    torch.cuda.synchronize()
    assert _counts(wrapper) == tuple(
        a + b for a, b in zip(before, _one_backward(
            dtype, d, hw[0] * hw[1], hw)))
    with torch.no_grad():
        _, lse = grouped_attention_plain(q, k, v, rh, rw, scale, hw,
                                         return_lse=True)
        ref = grouped_attention_backward_plain(q, k, v, rh, rw, out, lse,
                                               dout, scale, hw)
    _close_grads(got, ref, dtype,
                 ("dq", "dk", "dv", "drel_h", "drel_w")[:len(inputs)])


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("n,m,heads,d,hw", [(200, 1000, 2, 64, (25, 40)),
                                            (1000, 1000, 1, 64, (20, 50)),
                                            (300, 1030, 2, 128, None),
                                            (640, 577, 1, 128, None),
                                            # tiles of two grid rows (96 and
                                            # 128 keys), rel_w read once
                                            (768, 768, 2, 64, (16, 48)),
                                            (768, 768, 1, 64, (12, 64))])
def test_streaming_bodies_agree_and_repeat(cuda, family, n, m, heads, d, hw):
    """bf16 at the launcher: the Hopper body against the mma.sync body and
    the plain version, forward (with the lse) and both backward kernels,
    and the forward and the backward twice: no atomics, so bit-identical."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_launch)

    ss = family == "grouped"
    dt = torch.bfloat16
    rng = np.random.default_rng(n + m + d)
    c = heads * d
    q = _randn(rng, (2, n, c), dt, cuda)
    k, v = (_randn(rng, (2, m, c), dt, cuda) for _ in range(2))
    dout = _randn(rng, (2, n, c), dt, cuda)
    rh = rw = None
    if hw is not None:
        rh = _randn(rng, (2, n, heads, hw[0]), dt, cuda, 0.5)
        rw = _randn(rng, (2, n, heads, hw[1]), dt, cuda, 0.5)
    scale = d ** -0.5
    assert attention_body(dt, d, n, m, hw is not None) == "sm90"
    with torch.no_grad():
        ref, lse_ref = attention_plain(q, k, v, scale, heads, rh, rw,
                                       return_lse=True, scale_scores=ss)
        outs = {body: attention_launch(q, k, v, scale, heads, rh, rw,
                                       return_lse=True, scale_scores=ss,
                                       body=body) for body in ("mma", "sm90")}
        without_lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                       scale_scores=ss)
        again = attention_launch(q, k, v, scale, heads, rh, rw,
                                 return_lse=True, scale_scores=ss)
        torch.cuda.synchronize()
        assert torch.equal(without_lse, outs["sm90"][0])
        # the forward twice: one owner for every element, bit-identical
        assert all(torch.equal(a, b) for a, b in zip(again, outs["sm90"]))
        for out, lse in outs.values():
            torch.testing.assert_close(out.float(), ref.float(),
                                       **TOL[dt])
            torch.testing.assert_close(lse, lse_ref, atol=2e-2, rtol=2e-2)
        out, lse = outs["sm90"]
        want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                        heads, rh, rw, scale_scores=ss)
        runs = [attention_backward_launch(q, k, v, out, lse, dout, scale,
                                          heads, rh, rw, scale_scores=ss,
                                          body=body)
                for body in ("sm90", "sm90", "mma")]
        torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for got in runs:
        _close_grads([g for g in got if g is not None],
                     [r for r in want if r is not None], dt, names)
    for g1, g2 in zip(runs[0], runs[1]):
        assert g1 is None or torch.equal(g1, g2)


# queries, keys, heads, head dim, rel grid, scale (None: d ** -0.5) of the
# Hopper backward with tables: grids that are no multiple of 8 or 16,
# N != M, a last tile of a few keys, d = 128 with tables (32-key dq tiles,
# 48-query dk/dv tiles), and scales that are no power of two (the packed
# family's round(q*scale) written by the dq kernel for the dk/dv kernel, the
# grouped family's scale on the scores before the bias)
STREAMING_REL = [(1000, 1000, 2, 64, (25, 40), None),
                 (1000, 1000, 1, 64, (20, 50), None),
                 (200, 1000, 2, 64, (25, 40), None),
                 (513, 513, 1, 128, (27, 19), None),
                 (1000, 1000, 1, 128, (20, 50), None),
                 (600, 520, 2, 64, (8, 65), None),
                 (700, 1024, 2, 64, (32, 32), 0.3),
                 # head dim 80 (ViT-H): 64 + 16 columns, the same grids, a
                 # last tile of 8 keys, and a power-of-two scale (K scaled in
                 # place in the dk/dv kernel, its narrow region too)
                 (1000, 1000, 2, 80, (25, 40), None),
                 (1000, 1000, 1, 80, (20, 50), None),
                 (200, 1000, 2, 80, (25, 40), None),
                 (600, 520, 2, 80, (8, 65), None),
                 (1024, 1024, 2, 80, (32, 32), 0.25)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("n,m,heads,d,hw,scale", STREAMING_REL)
def test_streaming_backward_with_and_without_table_gradients(
        cuda, family, n, m, heads, d, hw, scale):
    """bf16 at the launcher, the Hopper backward (delta inside the dq
    kernel, the table sums as one-hot products) against the plain version
    with every gradient and with the activations' alone, each twice and
    bit-identical; the table gradients change none of dq, dk, dv."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_launch)

    ss = family == "grouped"
    dt = torch.bfloat16
    rng = np.random.default_rng(n + 3 * m + d)
    c = heads * d
    q = _randn(rng, (2, n, c), dt, cuda)
    k, v = (_randn(rng, (2, m, c), dt, cuda) for _ in range(2))
    dout = _randn(rng, (2, n, c), dt, cuda)
    rh = _randn(rng, (2, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (2, n, heads, hw[1]), dt, cuda, 0.5)
    scale = d ** -0.5 if scale is None else scale
    assert attention_body(dt, d, n, m, True, hw) == "sm90"
    with torch.no_grad():
        out, lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                    return_lse=True, scale_scores=ss)
        want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                        heads, rh, rw, scale_scores=ss)
        runs = {drel: [attention_backward_launch(
            q, k, v, out, lse, dout, scale, heads, rh, rw,
            want_drel=drel, scale_scores=ss) for _ in range(2)]
            for drel in (True, False)}
        torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    _close_grads(runs[True][0], want, dt, names)
    _close_grads(runs[False][0][:3], want[:3], dt, names)
    assert runs[False][0][3] is None and runs[False][0][4] is None
    for first, second in runs.values():
        for g1, g2 in zip(first, second):
            assert g1 is None or torch.equal(g1, g2)
    for g1, g2 in zip(runs[True][0][:3], runs[False][0][:3]):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("n,m,heads,d", [(300, 1030, 2, 128),
                                         (1000, 1000, 3, 64),
                                         (300, 1030, 2, 80)])
def test_sm90_dq_kernel_writes_delta(cuda, family, n, m, heads, d):
    """delta = rowsum(do * o) in f32 from the dq kernel, against the plain
    pass (f32 sums in another order), and the dk/dv kernel alone on it."""
    from wildlifemapper_tpu_torch.ops._attention import (
        _sm90_backward_launch, attention_backward_launch, attention_delta,
        attention_launch, sm90_scratch)

    ss = family == "grouped"
    dt = torch.bfloat16
    rng = np.random.default_rng(n + m)
    c = heads * d
    q = _randn(rng, (2, n, c), dt, cuda)
    k, v = (_randn(rng, (2, m, c), dt, cuda) for _ in range(2))
    dout = _randn(rng, (2, n, c), dt, cuda)
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = attention_launch(q, k, v, scale, heads, return_lse=True,
                                    scale_scores=ss)
        scratch = sm90_scratch(q, heads, scale, ss, False)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        for kernel in (0, 1):
            _sm90_backward_launch(kernel, q, k, v, dout, out, lse, scratch,
                                  None, None, *grads, None, None, scale,
                                  heads, d, 0, 0, scale_scores=ss)
        whole = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                          heads, scale_scores=ss)
        torch.cuda.synchronize()
    ref = attention_delta(dout, out, heads)
    torch.testing.assert_close(scratch[0], ref, atol=1e-4, rtol=1e-4)
    for g1, g2 in zip(grads, whole[:3]):
        assert torch.equal(g1, g2)


# queries, keys, heads, head dim, rel grid, scale (None: d ** -0.5) of the
# f32 streaming backward: rows ragged against its 128-row blocks, no tables
# with N != M and a last key tile of one key, 48-key tiles of two grid rows
# (gw 24) with a last tile of half, 64-key tiles of four grid rows (gw 16),
# the 48- and 64-grids of the main paths, d = 80, and scales that are no
# power of two (the packed family's q*scale once a tile in the dk/dv kernel)
F32_STREAMING = [(1000, 700, 2, 64, None, None),
                 (513, 513, 1, 64, None, None),
                 (600, 600, 2, 64, (25, 24), None),
                 (1024, 1024, 2, 64, (64, 16), 0.3),
                 (2304, 2304, 1, 64, (48, 48), None),
                 (1000, 700, 2, 80, None, None),
                 (1008, 1008, 1, 80, (21, 48), None),
                 (576, 576, 2, 80, (24, 24), None),
                 (1024, 1024, 2, 80, (32, 32), 0.25),
                 (4096, 4096, 1, 80, (64, 64), None)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("n,m,heads,d,hw,scale", F32_STREAMING)
def test_f32_streaming_backward(cuda, family, n, m, heads, d, hw, scale):
    """f32 at the launcher, the register-tiled f32 body (delta inside the
    dq kernel) against the plain version and the tile body at the f32
    gradient tolerance, with every gradient and with the activations'
    alone, each twice and bit-identical; the table gradients change none of
    dq, dk, dv; the delta the dq kernel leaves against the plain pass."""
    from wildlifemapper_tpu_torch.ops._attention import (
        _f32_backward_launch, attention_backward_launch,
        attention_backward_plain, attention_body, attention_delta,
        attention_launch)

    ss = family == "grouped"
    dt = torch.float32
    rng = np.random.default_rng(n + 7 * m + d)
    c = heads * d
    q = _randn(rng, (2, n, c), dt, cuda)
    k, v = (_randn(rng, (2, m, c), dt, cuda) for _ in range(2))
    dout = _randn(rng, (2, n, c), dt, cuda)
    rh = rw = None
    if hw:
        rh = _randn(rng, (2, n, heads, hw[0]), dt, cuda, 0.5)
        rw = _randn(rng, (2, n, heads, hw[1]), dt, cuda, 0.5)
    scale = d ** -0.5 if scale is None else scale
    assert attention_body(dt, d, n, m, hw is not None, hw,
                          "backward") == "f32"
    with torch.no_grad():
        out, lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                    return_lse=True, scale_scores=ss)
        want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                        heads, rh, rw, scale_scores=ss)
        runs = {drel: [attention_backward_launch(
            q, k, v, out, lse, dout, scale, heads, rh, rw,
            want_drel=drel, scale_scores=ss) for _ in range(2)]
            for drel in (True, False)}
        tile = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                         heads, rh, rw, scale_scores=ss,
                                         body="mma")
        delta = torch.empty_like(lse)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        _f32_backward_launch(0, q, k, v, dout, out, lse, delta, rh, rw,
                             *grads, None, None, scale, heads, d,
                             *(hw or (0, 0)), scale_scores=ss)
        torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    got = runs[True][0]
    assert [g is None for g in got] == [r is None for r in want]
    pairs = [(nm, g, r, t) for nm, g, r, t in zip(names, got, want, tile)
             if r is not None]
    _close_grads([g for _, g, _, _ in pairs], [r for _, _, r, _ in pairs],
                 dt, [nm for nm, _, _, _ in pairs])
    _close_grads([g for _, g, _, _ in pairs], [t for _, _, _, t in pairs],
                 dt, [nm + " against the tile body" for nm, _, _, _ in pairs])
    assert runs[False][0][3] is None and runs[False][0][4] is None
    for first, second in runs.values():
        for g1, g2 in zip(first, second):
            assert g1 is None or torch.equal(g1, g2)
    for g1, g2 in zip(runs[True][0][:3], runs[False][0][:3]):
        assert torch.equal(g1, g2)
    torch.testing.assert_close(delta, attention_delta(dout, out, heads),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(grads[0], got[0])


def test_f32_body_keeps_other_grids_on_the_tile_body(cuda):
    """A grid whose width no f32 key tile holds (25 x 40) keeps its f32
    backward on the tile body, which matches the plain version; named
    outright, the f32 body refuses it before any launch."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_launch)

    dt, heads, d, hw = torch.float32, 2, 64, (25, 40)
    n = hw[0] * hw[1]
    rng = np.random.default_rng(40)
    q, k, v, dout = (_randn(rng, (1, n, heads * d), dt, cuda)
                     for _ in range(4))
    rh = _randn(rng, (1, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (1, n, heads, hw[1]), dt, cuda, 0.5)
    assert attention_body(dt, d, n, n, True, hw, "backward") == "mma"
    with torch.no_grad():
        out, lse = attention_launch(q, k, v, 0.125, heads, rh, rw,
                                    return_lse=True)
        got = attention_backward_launch(q, k, v, out, lse, dout, 0.125,
                                        heads, rh, rw)
        torch.cuda.synchronize()
        want = attention_backward_plain(q, k, v, out, lse, dout, 0.125,
                                        heads, rh, rw)
        with pytest.raises(ValueError, match="f32 body"):
            attention_backward_launch(q, k, v, out, lse, dout, 0.125, heads,
                                      rh, rw, body="f32")
    _close_grads(got, want, dt, ("dq", "dk", "dv", "drel_h", "drel_w"))


# batch, queries, keys, heads of K4 in f32 (d 128, no tables) on the f32 body
# both ways: the full canvas and the 48-grid, a ragged N against M, N past M,
# a tensor-parallel rank's 4 heads, one key past a 64-key tile
K4_F32 = [(1, 4096, 4096, 2), (2, 2304, 2304, 2), (2, 1000, 1024, 2),
          (1, 1030, 577, 2), (2, 2304, 2304, 4), (1, 300, 513, 1)]


@pytest.mark.parametrize("b,n,m,heads", K4_F32)
def test_k4_f32_body(cuda, b, n, m, heads):
    """K4 in f32 through the register-tiled f32 body both ways against the
    plain version (forward 2e-5 / 1e-4 and the lse, gradients 5e-4 / 1e-3)
    and the tile body, each twice and bit-identical; the delta the delta
    kernel leaves against the plain pass, and dk, dv of the first launch
    alone (delta, dk/dv) as the whole backward's."""
    from wildlifemapper_tpu_torch.ops._attention import (
        _f32_d128_backward_launch, attention_backward_launch,
        attention_backward_plain, attention_body, attention_delta,
        attention_launch, attention_plain, f32_d128_scratch)

    dt, d = torch.float32, 128
    rng = np.random.default_rng(n + 3 * m + heads)
    c, scale = heads * d, d ** -0.5
    q, dout = (_randn(rng, (b, n, c), dt, cuda) for _ in range(2))
    k, v = (_randn(rng, (b, m, c), dt, cuda) for _ in range(2))
    assert attention_body(dt, d, n, m, False) == "f32"
    assert attention_body(dt, d, n, m, False, None, "backward") == "f32"
    with torch.no_grad():
        out, lse = attention_launch(q, k, v, scale, heads, return_lse=True)
        out2, lse2 = attention_launch(q, k, v, scale, heads, return_lse=True)
        ref_out, ref_lse = attention_plain(q, k, v, scale, heads,
                                           return_lse=True)
        tile_out = attention_launch(q, k, v, scale, heads, body="mma")
        runs = [attention_backward_launch(q, k, v, out, lse, dout, scale,
                                          heads)[:3] for _ in range(2)]
        want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                        heads)[:3]
        tile = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                         heads, body="mma")[:3]
        scratch = f32_d128_scratch(q, k, heads)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        _f32_d128_backward_launch(0, q, k, v, dout, out, lse, scratch,
                                  *grads, scale, heads)
        torch.cuda.synchronize()
    assert scratch[1].shape == (b, heads, m, -(-n // 128) * 128)
    torch.testing.assert_close(out, ref_out, **TOL[dt])
    torch.testing.assert_close(out, tile_out, **TOL[dt])
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    _close_grads(runs[0], want, dt, ("dq", "dk", "dv"))
    _close_grads(runs[0], tile, dt, ("dq", "dk", "dv against the tile body"))
    for g1, g2 in zip(*runs):
        assert torch.equal(g1, g2)
    torch.testing.assert_close(scratch[0], attention_delta(dout, out, heads),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(grads[1], runs[0][1])
    assert torch.equal(grads[2], runs[0][2])


# batch, queries, keys, heads, head dim, rel grid, scale (None: d ** -0.5)
# of the f32 forward at d 64 and 80 (K2, K5): the main paths' 64- and
# 48-grids, ViT-H's d 80, a tensor-parallel rank's 6 heads, N != M without
# tables (a last key tile of 60), rows ragged against the 128-row blocks
# (1000 = 25 x 40, a grid the backward's key tiles do not hold; 600 =
# 25 x 24), every grid width the f32 backward takes (16, 24, 32, 48, 64), a
# grid of 8 x 65 (gh + gw 73, the last tile 8 keys), and scales that are no
# power of two
F32_FORWARD = [(1, 4096, 4096, 2, 64, (64, 64), None),
               (2, 2304, 2304, 2, 64, (48, 48), None),
               (1, 4096, 4096, 2, 80, (64, 64), None),
               (1, 2304, 2304, 2, 80, (48, 48), None),
               (1, 2304, 2304, 6, 64, (48, 48), None),
               (2, 1000, 700, 2, 64, None, None),
               (1, 1000, 700, 2, 80, None, None),
               (2, 1000, 1000, 2, 64, (25, 40), None),
               (1, 600, 600, 2, 80, (25, 24), 0.3),
               (1, 1024, 1024, 2, 64, (64, 16), 0.3),
               (1, 1024, 1024, 2, 80, (32, 32), 0.25),
               (1, 1008, 1008, 1, 80, (21, 48), None),
               (1, 520, 520, 2, 64, (8, 65), None)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("b,n,m,heads,d,hw,scale", F32_FORWARD)
def test_f32_streaming_forward(cuda, family, b, n, m, heads, d, hw, scale):
    """The f32 forward of K2 and K5 at d 64 and 80 through the register-
    tiled f32 body, at the launcher: out against the plain version (2e-5 /
    1e-4) and the tile body, the lse against the plain lse, twice and
    bit-identical, and the same out without an lse buffer."""
    from wildlifemapper_tpu_torch.ops._attention import (attention_body,
                                                         attention_launch)

    ss = family == "grouped"
    dt = torch.float32
    rng = np.random.default_rng(n + 5 * m + d + heads)
    c = heads * d
    q = _randn(rng, (b, n, c), dt, cuda)
    k, v = (_randn(rng, (b, m, c), dt, cuda) for _ in range(2))
    rh = rw = None
    if hw:
        rh = _randn(rng, (b, n, heads, hw[0]), dt, cuda, 0.5)
        rw = _randn(rng, (b, n, heads, hw[1]), dt, cuda, 0.5)
    scale = d ** -0.5 if scale is None else scale
    assert attention_body(dt, d, n, m, hw is not None, hw) == "f32"
    with torch.no_grad():
        runs = [attention_launch(q, k, v, scale, heads, rh, rw,
                                 return_lse=True, scale_scores=ss)
                for _ in range(2)]
        alone = attention_launch(q, k, v, scale, heads, rh, rw,
                                 scale_scores=ss)
        ref_out, ref_lse = attention_plain(q, k, v, scale, heads, rh, rw,
                                           return_lse=True, scale_scores=ss)
        tile_out, tile_lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                              return_lse=True,
                                              scale_scores=ss, body="mma")
        torch.cuda.synchronize()
    out, lse = runs[0]
    torch.testing.assert_close(out, ref_out, **TOL[dt])
    torch.testing.assert_close(lse, ref_lse, **TOL[dt])
    torch.testing.assert_close(out, tile_out, **TOL[dt])
    torch.testing.assert_close(lse, tile_lse, **TOL[dt])
    assert torch.equal(out, runs[1][0]) and torch.equal(lse, runs[1][1])
    assert torch.equal(out, alone)


def test_f32_forward_keeps_wide_grids_on_the_tile_body(cuda):
    """A rel grid wider than the f32 forward stages (gh + gw > 128: 130 x 4)
    keeps its f32 forward on the tile body, which matches the plain version;
    named outright, the f32 body refuses it before any launch."""
    from wildlifemapper_tpu_torch.ops._attention import (attention_body,
                                                         attention_launch)

    dt, heads, d, hw = torch.float32, 2, 64, (130, 4)
    n = hw[0] * hw[1]
    rng = np.random.default_rng(41)
    q, k, v = (_randn(rng, (1, n, heads * d), dt, cuda) for _ in range(3))
    rh = _randn(rng, (1, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (1, n, heads, hw[1]), dt, cuda, 0.5)
    assert attention_body(dt, d, n, n, True, hw) == "mma"
    with torch.no_grad():
        out = attention_launch(q, k, v, 0.125, heads, rh, rw)
        torch.cuda.synchronize()
        with pytest.raises(ValueError, match="f32 body"):
            attention_launch(q, k, v, 0.125, heads, rh, rw, body="f32")
    torch.testing.assert_close(
        out, attention_plain(q, k, v, 0.125, heads, rh, rw), **TOL[dt])


# windows, heads, grid, head dim, scale (None: d ** -0.5) of the f32 window
# bodies: the main paths' windows of 14 and 12 (backward 7 warps of 28 rows, 5
# warps of 32; forward two blocks of 4 warps of 28 or 3 of 32 a window-head,
# at d 80 one block of 7 warps of 28), windows padded against the 32-row slabs
# and the warps (100 = 10 x 10, 49, 6 tokens with ten grid rows a key slab,
# 169 = 13 x 13 and 180 = 12 x 15 on 28-row warps, 208 = 13 x 16 and 16 x 13
# on 7 warps of 32 with key slabs of two grid rows of 13), more window-heads
# than SMs, d = 80 (ViT-H), and scales that are no power of two
F32_WINDOW = [(100, 2, (14, 14), 64, None), (37, 3, (12, 12), 64, None),
              (5, 2, (10, 10), 64, None), (3, 1, (7, 7), 64, None),
              (3, 1, (2, 3), 64, None), (2, 2, (13, 16), 64, None),
              (2, 1, (16, 13), 64, None), (141, 1, (12, 12), 64, 0.3),
              (3, 2, (13, 13), 64, None), (2, 1, (12, 15), 80, None),
              (25, 4, (14, 14), 80, None), (9, 2, (12, 12), 80, None),
              (4, 2, (10, 10), 80, None), (3, 2, (14, 14), 80, 0.3)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("bw,heads,hw,d,scale", F32_WINDOW)
def test_f32_window_backward(cuda, family, bw, heads, hw, d, scale):
    """f32 at the launcher, the one-kernel f32 window body (delta inside)
    against the plain version and the tile body at the f32 gradient
    tolerance, with every gradient and with the activations' alone, each
    twice and bit-identical; the table gradients change none of dq, dk, dv;
    no plain delta pass runs."""
    from wildlifemapper_tpu_torch.ops import _attention

    calls = []
    real = _attention.attention_delta

    def counted(*args):
        calls.append(1)
        return real(*args)

    ss = family == "grouped"
    dt = torch.float32
    n = hw[0] * hw[1]
    rng = np.random.default_rng(bw + 7 * n + d)
    c = heads * d
    q, k, v, dout = (_randn(rng, (bw, n, c), dt, cuda) for _ in range(4))
    rh = _randn(rng, (bw, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (bw, n, heads, hw[1]), dt, cuda, 0.5)
    scale = d ** -0.5 if scale is None else scale
    assert _attention.attention_body(dt, d, n, n, True, hw,
                                     "backward") == "f32_window"
    with torch.no_grad():
        out, lse = _attention.attention_launch(q, k, v, scale, heads, rh, rw,
                                               return_lse=True,
                                               scale_scores=ss)
        want = _attention.attention_backward_plain(
            q, k, v, out, lse, dout, scale, heads, rh, rw, scale_scores=ss)
        _attention.attention_delta = counted
        try:
            runs = {drel: [_attention.attention_backward_launch(
                q, k, v, out, lse, dout, scale, heads, rh, rw,
                want_drel=drel, scale_scores=ss) for _ in range(2)]
                for drel in (True, False)}
            torch.cuda.synchronize()
        finally:
            _attention.attention_delta = real
        tile = _attention.attention_backward_launch(
            q, k, v, out, lse, dout, scale, heads, rh, rw, scale_scores=ss,
            body="mma")
        torch.cuda.synchronize()
    assert calls == []
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    got = runs[True][0]
    _close_grads(got, want, dt, names)
    _close_grads(got, tile, dt, [nm + " against the tile body"
                                 for nm in names])
    assert runs[False][0][3] is None and runs[False][0][4] is None
    for first, second in runs.values():
        for g1, g2 in zip(first, second):
            assert g1 is None or torch.equal(g1, g2)
    for g1, g2 in zip(runs[True][0][:3], runs[False][0][:3]):
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("bw,heads,hw,d,scale", F32_WINDOW)
def test_f32_window_forward(cuda, family, bw, heads, hw, d, scale):
    """The f32 forward of K1 and K6 at d 64 and 80 through the register-
    tiled f32 window body, at the launcher (one or two blocks a window-head,
    ragged against its slabs, its warps and its halves of the queries): out
    and the lse against the plain version (2e-5 / 1e-4) and the tile body,
    twice and bit-identical, and the same out without an lse buffer."""
    from wildlifemapper_tpu_torch.ops._attention import (attention_body,
                                                         attention_launch)

    ss = family == "grouped"
    dt = torch.float32
    n = hw[0] * hw[1]
    rng = np.random.default_rng(bw + 11 * n + d)
    c = heads * d
    qkv = _randn(rng, (bw, n, 3 * c), dt, cuda)
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    rh = _randn(rng, (bw, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (bw, n, heads, hw[1]), dt, cuda, 0.5)
    scale = d ** -0.5 if scale is None else scale
    for direction in ("forward", "backward"):
        assert attention_body(dt, d, n, n, True, hw, direction) == "f32_window"
    with torch.no_grad():
        runs = [attention_launch(q, k, v, scale, heads, rh, rw,
                                 return_lse=True, scale_scores=ss)
                for _ in range(2)]
        alone = attention_launch(q, k, v, scale, heads, rh, rw,
                                 scale_scores=ss)
        ref_out, ref_lse = attention_plain(q, k, v, scale, heads, rh, rw,
                                           return_lse=True, scale_scores=ss)
        tile_out, tile_lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                              return_lse=True,
                                              scale_scores=ss, body="mma")
        torch.cuda.synchronize()
    out, lse = runs[0]
    torch.testing.assert_close(out, ref_out, **TOL[dt])
    torch.testing.assert_close(lse, ref_lse, **TOL[dt])
    torch.testing.assert_close(out, tile_out, **TOL[dt])
    torch.testing.assert_close(lse, tile_lse, **TOL[dt])
    assert torch.equal(out, runs[1][0]) and torch.equal(lse, runs[1][1])
    assert torch.equal(out, alone)


# batch (windows), heads, grid, scale (None: d ** -0.5), head dim: the
# resident bodies' 16-row tiles and 144- / 208-row instantiations, odd table
# widths (2-byte table loads), one window-head, more window-heads than SMs,
# a scale that is no power of two (it enters where each family rounds it);
# at d = 80 ViT-H's window of 14 at 16 heads (the five-slot backward with
# its refills), a ragged window and the 144-row instantiation
RESIDENT = [(100, 2, (14, 14), None, 64), (37, 3, (12, 12), None, 64),
            (3, 3, (7, 7), None, 64), (5, 2, (10, 10), None, 64),
            (1, 1, (14, 14), None, 64), (1, 1, (12, 12), None, 64),
            (2, 2, (13, 16), None, 64), (2, 1, (10, 15), None, 64),
            (3, 1, (2, 3), None, 64),
            (141, 1, (12, 12), 0.3, 64), (23, 6, (14, 14), 0.3, 64),
            (25, 16, (14, 14), None, 80), (1, 1, (14, 14), None, 80),
            (3, 3, (7, 7), None, 80), (141, 1, (12, 12), 0.3, 80)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("bw,heads,hw,scale,d", RESIDENT)
def test_resident_bodies_agree_and_repeat(cuda, family, bw, heads, hw, scale,
                                          d):
    """bf16 at the launcher: the resident body against the plain version
    and the mma.sync body, forward with and without the lse, the one-kernel
    backward with every gradient (dq, dk, dv written by stride into one
    packed tensor) and with the activations' alone, and the backward twice:
    no atomics, so bit-identical."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_launch)

    ss = family == "grouped"
    dt = torch.bfloat16
    n, c = hw[0] * hw[1], heads * d
    scale = d ** -0.5 if scale is None else scale
    rng = np.random.default_rng(bw + n + heads)
    qkv = _randn(rng, (bw, n, 3 * c), dt, cuda)
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    dout = _randn(rng, (bw, n, c), dt, cuda)
    rh = _randn(rng, (bw, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (bw, n, heads, hw[1]), dt, cuda, 0.5)
    for direction in ("forward", "backward"):
        assert attention_body(dt, d, n, n, True, hw, direction) == "resident"
    with torch.no_grad():
        ref, lse_ref = attention_plain(q, k, v, scale, heads, rh, rw,
                                       return_lse=True, scale_scores=ss)
        outs = {body: attention_launch(q, k, v, scale, heads, rh, rw,
                                       return_lse=True, scale_scores=ss,
                                       body=body)
                for body in ("mma", "resident")}
        without_lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                       scale_scores=ss)
        torch.cuda.synchronize()
        assert torch.equal(without_lse, outs["resident"][0])
        for out, lse in outs.values():
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dt])
            torch.testing.assert_close(lse, lse_ref, atol=2e-2 if d == 80
                                       else 1e-3, rtol=2e-2 if d == 80
                                       else 1e-3)
        out, lse = outs["resident"]
        want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                        heads, rh, rw, scale_scores=ss)
        dqkv = torch.full_like(qkv, float("nan"))
        packed = tuple(dqkv[..., i * c:(i + 1) * c] for i in range(3))
        runs = [attention_backward_launch(q, k, v, out, lse, dout, scale,
                                          heads, rh, rw, scale_scores=ss,
                                          grads=g, body=body)
                for g, body in ((packed, None), (None, "resident"),
                                (None, "mma"))]
        frozen = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                           heads, rh, rw, scale_scores=ss,
                                           want_drel=False)
        torch.cuda.synchronize()
    names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for got in runs:
        _close_grads(got, want, dt, names)
    assert torch.isfinite(dqkv).all()          # every element was written
    for g1, g2 in zip(runs[0], runs[1]):
        assert torch.equal(g1, g2)
    assert frozen[3] is None and frozen[4] is None
    for g1, g2 in zip(frozen[:3], runs[0]):
        assert torch.equal(g1, g2)


# batch (B, BW or BH), heads, grid, scale (None: d ** -0.5) at d = 80: the
# Hopper forward (at least 512 keys: grids no multiple of 8, the 64-grid's
# two-grid-row tiles, no tables with N != M) and the resident forward
# (windows of 49 with odd table widths, 100, 196, 208, a scale that is no
# power of two), each in both families
D80 = [(2, 2, (25, 40), None), (1, 1, (20, 50), None), (1, 2, (24, 24), None),
       (1, 1, (64, 64), None), (3, 3, (7, 7), None), (5, 2, (10, 10), None),
       (2, 2, (14, 14), None), (2, 1, (13, 16), None), (141, 1, (12, 12), 0.3)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("b,heads,hw,scale", D80)
def test_d80_forward_bodies_agree_and_repeat(cuda, family, b, heads, hw,
                                             scale):
    """bf16 at d = 80 at the launcher: the Hopper or the resident forward
    against the tile body and the plain version, with and without the lse,
    twice (bit-identical); the backward of the same body on its lse against
    the plain backward, twice (bit-identical)."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_launch)

    ss = family == "grouped"
    dt, d = torch.bfloat16, 80
    n, c = hw[0] * hw[1], heads * d
    scale = d ** -0.5 if scale is None else scale
    rng = np.random.default_rng(b + n + heads)
    qkv = _randn(rng, (b, n, 3 * c), dt, cuda)
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    dout = _randn(rng, (b, n, c), dt, cuda)
    rh = _randn(rng, (b, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (b, n, heads, hw[1]), dt, cuda, 0.5)
    body = attention_body(dt, d, n, n, True, hw)
    assert body == ("sm90" if n >= 512 else "resident")
    assert attention_body(dt, d, n, n, True, hw, "backward") == body
    with torch.no_grad():
        ref, lse_ref = attention_plain(q, k, v, scale, heads, rh, rw,
                                       return_lse=True, scale_scores=ss)
        outs = {which: attention_launch(q, k, v, scale, heads, rh, rw,
                                        return_lse=True, scale_scores=ss,
                                        body=which)
                for which in ("mma", body)}
        again = attention_launch(q, k, v, scale, heads, rh, rw,
                                 return_lse=True, scale_scores=ss)
        without_lse = attention_launch(q, k, v, scale, heads, rh, rw,
                                       scale_scores=ss)
        torch.cuda.synchronize()
        assert torch.equal(without_lse, outs[body][0])
        assert all(torch.equal(a, b_) for a, b_ in zip(again, outs[body]))
        for out, lse in outs.values():
            torch.testing.assert_close(out.float(), ref.float(), **TOL[dt])
            torch.testing.assert_close(lse, lse_ref, atol=2e-2, rtol=2e-2)
        out, lse = outs[body]
        want = attention_backward_plain(q, k, v, out, lse, dout, scale,
                                        heads, rh, rw, scale_scores=ss)
        got, again = (attention_backward_launch(
            q, k, v, out, lse, dout, scale, heads, rh, rw, scale_scores=ss)
            for _ in range(2))
        torch.cuda.synchronize()
    _close_grads(got, want, dt, ("dq", "dk", "dv", "drel_h", "drel_w"))
    assert all(torch.equal(g1, g2) for g1, g2 in zip(got, again))


def test_d80_no_tables_and_ragged_rows(cuda):
    """The Hopper forward at d = 80 without tables (N != M, a last tile of
    six keys) against the plain version, twice."""
    from wildlifemapper_tpu_torch.ops._attention import (attention_body,
                                                         attention_launch)

    rng = np.random.default_rng(80)
    dt = torch.bfloat16
    q = _randn(rng, (2, 300, 160), dt, cuda)
    k, v = (_randn(rng, (2, 1030, 160), dt, cuda) for _ in range(2))
    assert attention_body(dt, 80, 300, 1030, False) == "sm90"
    with torch.no_grad():
        first = attention_launch(q, k, v, 80 ** -0.5, 2, return_lse=True)
        second = attention_launch(q, k, v, 80 ** -0.5, 2, return_lse=True)
        ref, lse_ref = attention_plain(q, k, v, 80 ** -0.5, 2,
                                       return_lse=True)
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    torch.testing.assert_close(first[0].float(), ref.float(), **TOL[dt])
    torch.testing.assert_close(first[1], lse_ref, atol=2e-2, rtol=2e-2)


def test_d80_windowed_backward_is_one_launch(cuda):
    """At d = 80 the windowed wrappers' backward is one launch with no
    plain delta pass: the resident body in bf16, the f32 window body in f32,
    as at d = 64, in both families."""
    from wildlifemapper_tpu_torch.ops import _attention

    calls = []
    real = _attention.attention_delta

    def counted(*args):
        calls.append(1)
        return real(*args)

    rng = np.random.default_rng(8)
    _attention.attention_delta = counted
    try:
        for dtype, delta_passes, moved in (
                (torch.bfloat16, 0, (1, 1, 0, 0)),
                (torch.float32, 0, (1, 1, 0, 0))):
            qkv = _randn(rng, (3, 196, 3 * 2 * 80), dtype,
                         cuda).requires_grad_()
            rh = _randn(rng, (3, 196, 2, 14), dtype, cuda, 0.5)
            rw = _randn(rng, (3, 196, 2, 14), dtype, cuda, 0.5)
            before = _counts(windowed_attention_packed)
            out = windowed_attention_packed(qkv, rh, rw, 80 ** -0.5, 2,
                                            (14, 14))
            out.float().sum().backward()
            torch.cuda.synchronize()
            assert len(calls) == delta_passes
            assert _counts(windowed_attention_packed) == tuple(
                a + b for a, b in zip(before, moved))
            del calls[:]
            q, k, v = (_randn(rng, (6, 196, 80), dtype,
                              cuda).requires_grad_() for _ in range(3))
            gh, gw = (_randn(rng, (6, 196, 14), dtype, cuda, 0.5)
                      for _ in range(2))
            before = _counts(windowed_attention_rel_pos)
            out = windowed_attention_rel_pos(q, k, v, gh, gw, 80 ** -0.5,
                                             (14, 14))
            out.float().sum().backward()
            torch.cuda.synchronize()
            assert len(calls) == delta_passes
            assert _counts(windowed_attention_rel_pos) == tuple(
                a + b for a, b in zip(before, moved))
            del calls[:]
    finally:
        _attention.attention_delta = real


def test_resident_backward_counts_one_launch(cuda):
    """The windowed wrappers' backward is one kernel and runs no delta
    pass: the resident body in bf16, the f32 window body in f32."""
    from wildlifemapper_tpu_torch.ops import _attention

    calls = []
    real = _attention.attention_delta

    def counted(*args):
        calls.append(1)
        return real(*args)

    rng = np.random.default_rng(9)
    _attention.attention_delta = counted
    try:
        for dtype, delta_passes, moved in (
                (torch.bfloat16, 0, (1, 1, 0, 0)),
                (torch.float32, 0, (1, 1, 0, 0))):
            qkv = _randn(rng, (3, 196, 3 * 2 * 64), dtype,
                         cuda).requires_grad_()
            rh = _randn(rng, (3, 196, 2, 14), dtype, cuda, 0.5)
            rw = _randn(rng, (3, 196, 2, 14), dtype, cuda, 0.5)
            before = _counts(windowed_attention_packed)
            out = windowed_attention_packed(qkv, rh, rw, 0.125, 2, (14, 14))
            out.float().sum().backward()
            torch.cuda.synchronize()
            assert len(calls) == delta_passes
            assert _counts(windowed_attention_packed) == tuple(
                a + b for a, b in zip(before, moved))
            del calls[:]
    finally:
        _attention.attention_delta = real


def test_resident_body_refuses_what_it_does_not_hold(cuda):
    """A body that does not take a launch raises, forward and backward:
    nothing falls back."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_launch)

    def launch(dtype, n, d, hw):
        q = torch.zeros(1, n, d, device=cuda, dtype=dtype)
        rh = torch.zeros(1, n, 1, hw[0], device=cuda, dtype=dtype)
        rw = torch.zeros(1, n, 1, hw[1], device=cuda, dtype=dtype)
        return attention_launch(q, q, q, 0.125, 1, rh, rw, body="resident")

    def launch_backward(dtype, n, d, hw):
        q = torch.zeros(1, n, d, device=cuda, dtype=dtype)
        rh = torch.zeros(1, n, 1, hw[0], device=cuda, dtype=dtype)
        rw = torch.zeros(1, n, 1, hw[1], device=cuda, dtype=dtype)
        lse = torch.zeros(1, n, 1, device=cuda)
        return attention_backward_launch(q, q, q, q, lse, q, 0.125, 1, rh,
                                         rw, body="resident")

    for d in (64, 80):
        launch(torch.bfloat16, 196, d, (14, 14))
        launch_backward(torch.bfloat16, 196, d, (14, 14))
    for args in ((torch.float32, 196, 64, (14, 14)),
                 (torch.float32, 196, 80, (14, 14)),
                 (torch.bfloat16, 196, 128, (14, 14)),
                 (torch.bfloat16, 196, 32, (14, 14)),
                 (torch.bfloat16, 256, 64, (16, 16)),
                 (torch.bfloat16, 256, 80, (16, 16)),
                 (torch.bfloat16, 102, 64, (6, 17))):
        for entry in (launch, launch_backward):
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                entry(*args)
    q = torch.zeros(1, 196, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        attention_launch(q, q, q, 0.125, 1, body="resident")   # no tables


def test_unknown_body_raises(cuda):
    from wildlifemapper_tpu_torch.ops._attention import attention_launch

    q = torch.zeros(1, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="expected one of"):
        attention_launch(q, q, q, 0.125, 1, body="plain")


def test_hopper_body_refuses_float32(cuda):
    """A body that does not take a launch raises: nothing falls back."""
    from wildlifemapper_tpu_torch.ops._attention import attention_launch

    q = torch.zeros(1, 512, 64, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        attention_launch(q, q, q, 0.125, 1, body="sm90")


def test_grouped_forward_lse_matches_plain(cuda):
    """The grouped family's lse, with its scale on the f32 scores: the tile
    bodies (70 keys, d = 32) and, in bf16, the Hopper body (a 16x48 grid:
    96-key tiles of two grid rows, whose rel_w is read once; a 25x40 grid,
    tables written by the consumers)."""
    from wildlifemapper_tpu_torch.ops._attention import (attention_body,
                                                         attention_launch)

    rng = np.random.default_rng(13)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for hw, d in (((7, 10), 32), ((16, 48), 64), ((25, 40), 64)):
            q, k, v, rh, rw = _grouped_inputs(rng, 3, hw, d, dtype, cuda)
            _, lse = attention_launch(q, k, v, 0.2, 1, rh[:, :, None],
                                      rw[:, :, None], return_lse=True,
                                      scale_scores=True)
            _, ref = grouped_attention_plain(q, k, v, rh, rw, 0.2, hw,
                                             return_lse=True)
            torch.testing.assert_close(lse[..., 0], ref, atol=tol, rtol=tol)
            n = hw[0] * hw[1]
            if attention_body(dtype, d, n, n, True, hw) == "sm90":
                _, again = attention_launch(q, k, v, 0.2, 1, rh[:, :, None],
                                            rw[:, :, None], return_lse=True,
                                            scale_scores=True)
                assert torch.equal(lse, again)


def test_grouped_batch_beyond_grid_limit_raises(cuda):
    q = torch.zeros(65536, 1, 32, device=cuda)
    rel = torch.zeros(65536, 1, 1, device=cuda)
    with pytest.raises(ValueError, match="at most 65535"):
        windowed_attention_rel_pos(q, q, q, rel, rel, 1.0, (1, 1))


def test_bad_dtype_raises(cuda):
    qkv = torch.randn(1, 16, 3 * 64, device=cuda)
    rel = torch.zeros(1, 16, 2, 4, device=cuda)
    with pytest.raises(TypeError):
        windowed_attention_packed(qkv.half(), rel.half(), rel.half(), 0.125,
                                  2, (4, 4))


def test_remat_step_on_the_card(cuda):
    """A bf16 fine-tune step at ViT-H's head dim (D 160 in 2 heads of 80, a
    global block of 1024 tokens through the Hopper bodies both ways,
    windows of 14 through the resident bodies both ways) with remat_blocks
    against the same step without it: the recompute launches each block's
    attention forward again and not the MLP's forward, and the step's losses
    and gradients agree at rtol 1e-6."""
    import dataclasses

    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.train.synthetic import synthetic_batch

    model = dataclasses.replace(
        tcfg.model_config("vit_b", dtype="bfloat16",
                          use_flash_attention=True),
        img_size=512,
        vit=tcfg.ViTConfig(embed_dim=160, depth=2, num_heads=2,
                           global_attn_indexes=(1,), window_size=14,
                           out_chans=32),
        hfc=tcfg.HFCConfig(embed_dim=32, proj_dim=128, num_heads=1,
                           ffn_dim=128, dropout=0.0),
        decoder=tcfg.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                   num_queries=7, num_heads=2))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in synthetic_batch(
        2, seed=0, canvas=512, content=384, max_targets=8, min_boxes=1,
        max_boxes=5).items()}
    wrappers = (flash_attention_packed, windowed_attention_packed)
    runs = {}
    for remat in (False, True):
        cfg = tcfg.Config(
            model=dataclasses.replace(model, remat_blocks=remat),
            train=tcfg.TrainConfig(freeze_encoder=True, clip_max_norm=1e9))
        sb = StepBuilder(cfg, generator=torch.Generator().manual_seed(0))
        state = sb.init_state(steps_per_epoch=10)
        before = [_counts(w) for w in wrappers] + [fused_mlp.launches]
        _, metrics = sb.train_step(state, batch)
        torch.cuda.synchronize()
        after = [_counts(w) for w in wrappers] + [fused_mlp.launches]
        moved = [tuple(b - a for a, b in zip(x, y)) if isinstance(x, tuple)
                 else y - x for x, y in zip(before, after)]
        runs[remat] = (moved, {k: v.item() for k, v in metrics.items()},
                       {n: p.grad for n, p in sb.model.named_parameters()
                        if p.grad is not None})
    # (launches, backward_launches, dq, dk/dv) of K2 and K1, K3 launches:
    # K2's backward on the Hopper body, K1's on the resident body
    assert runs[False][0] == [(1, 0, 1, 1), (1, 1, 0, 0), 2]
    assert runs[True][0] == [(2, 0, 1, 1), (2, 1, 0, 0), 2]
    for k, v in runs[False][1].items():
        np.testing.assert_allclose(runs[True][1][k], v, rtol=1e-6, err_msg=k)
    grads0, grads1 = runs[False][2], runs[True][2]
    assert set(grads0) == set(grads1) and grads0
    for n, g in grads0.items():
        torch.testing.assert_close(grads1[n], g, rtol=1e-6, atol=0, msg=n)


# ---- the compat surface: the wm:: operators, export, the predictor ------------

def _op_args_cuda(name, dtype, dev, batch=2):
    """Small inputs of each `wm::` operator that its kernels take: 2 heads
    of 64 on a 4x4 grid (the resident body in bf16), K4 2 heads of 128 with
    24 keys, K3 64 -> 128."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, dt=dtype, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev)
                * scale).to(dt)

    if name in ("windowed_attention_packed", "flash_attention_packed"):
        return (r(batch, 16, 3 * 128), r(batch, 16, 2, 4, scale=0.5),
                r(batch, 16, 2, 4, scale=0.5), 0.125, 2)
    if name == "cross_attention_packed":
        return (r(batch, 16, 256), r(batch, 24, 256), r(batch, 24, 256),
                128 ** -0.5, 2)
    if name in ("flash_attention_rel_pos", "windowed_attention_rel_pos"):
        return (r(2 * batch, 16, 64), r(2 * batch, 16, 64),
                r(2 * batch, 16, 64), r(2 * batch, 16, 1, 4, scale=0.5),
                r(2 * batch, 16, 1, 4, scale=0.5), 0.125)
    return (r(16 * batch, 64), r(128, 64, scale=0.125),
            r(128, dt=torch.float32, scale=0.1),
            r(64, 128, scale=128 ** -0.5), r(64, dt=torch.float32, scale=0.1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", [
    "windowed_attention_packed", "windowed_attention_packed.lse",
    "flash_attention_packed", "flash_attention_packed.lse", "fused_mlp",
    "cross_attention_packed", "cross_attention_packed.lse",
    "flash_attention_rel_pos", "flash_attention_rel_pos.lse",
    "windowed_attention_rel_pos", "windowed_attention_rel_pos.lse"])
def test_operator_on_the_card(cuda, name, dtype):
    """Each overload under torch.library.opcheck through its CUDA
    implementation, its output against the CPU implementation (the plain
    version) at the kernels' tolerance, one launch counted a call."""
    packet, _, overload = name.partition(".")
    op = getattr(getattr(torch.ops.wm, packet), overload or "default")
    args = _op_args_cuda(packet, dtype, cuda)
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result
    wrapper = _library.WRAPPERS[packet]
    before = wrapper.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = op(*[a.cpu().float() if torch.is_tensor(a) else a for a in args])
    for g, w in zip(*(((got,), (want,)) if torch.is_tensor(got)
                      else (got, want))):
        assert g.device.type == "cuda" and g.shape == w.shape
        torch.testing.assert_close(g.float().cpu(), w.float(), **TOL[dtype])


def _tiny_model_config(dtype, layout):
    """A tiny model whose every attention the kernels take: ViT 2 heads of
    32 on an 8x8 grid (windows of 16 tokens, one global block of 64), the
    adaptor one head of 32."""
    import dataclasses

    from wildlifemapper_tpu_torch import config as tcfg

    return dataclasses.replace(
        tcfg.model_config("vit_b", dtype=dtype, use_flash_attention=True,
                          attn_impl=layout),
        img_size=128,
        vit=tcfg.ViTConfig(embed_dim=64, depth=2, num_heads=2,
                           global_attn_indexes=(1,), window_size=4,
                           out_chans=32),
        hfc=tcfg.HFCConfig(embed_dim=32, proj_dim=32, num_heads=1,
                           ffn_dim=32),
        decoder=tcfg.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                   num_queries=7, num_heads=2))


TINY_PER_FORWARD = {
    "packed": {"windowed_attention_packed": 1, "flash_attention_packed": 1,
               "fused_mlp": 2, "cross_attention_packed": 1},
    "grouped": {"windowed_attention_rel_pos": 1,
                "flash_attention_rel_pos": 1, "cross_attention_packed": 1},
}


@pytest.mark.parametrize("layout", ["packed", "grouped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_through_the_operators_on_the_card(cuda, monkeypatch, tmp_path,
                                                  layout, dtype):
    """The tiny model exported with a symbolic batch on the card: one `wm::`
    node a kernel launch, no library attention, nothing launched while
    tracing; saved, loaded and run at batch 1 and 3, bit for bit the eager
    model, with eager's launches counted as the program runs."""
    import collections

    from wildlifemapper_tpu_torch.compat.export import (load_exported,
                                                        save_exported)
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.models import vit as tvit

    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 64)
    model = WildlifeMapper(_tiny_model_config(dtype, layout),
                           generator=torch.Generator(
                               device=cuda).manual_seed(0)).eval()

    def launches():
        return {n: w.launches for n, w in _library.WRAPPERS.items()}

    before = launches()
    path = save_exported(model, tmp_path / "m.pt2", batch_size=None)
    assert launches() == before
    program = torch.export.load(str(path))
    nodes = collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if str(n.target).startswith("wm."))
    assert nodes == TINY_PER_FORWARD[layout]
    assert not [n for n in program.graph.nodes
                if "scaled_dot_product" in str(n.target)]
    forward = load_exported(path)
    for b in (1, 3):
        x = torch.randn(b, 128, 128, 3, device=cuda)
        with torch.no_grad():
            start = launches()
            got = forward(x)
            torch.cuda.synchronize()
            ran = {n: v - start[n] for n, v in launches().items() if v
                   - start[n]}
            want = model(x)
        assert ran == TINY_PER_FORWARD[layout]
        for k in ("pred_logits", "pred_boxes"):
            assert torch.equal(got[k], want[k]), (b, k)


@pytest.mark.parametrize("layout", ["packed", "grouped"])
def test_f32_export_reaches_the_f32_forward(cuda, tmp_path, layout):
    """A small f32 model whose global block is a streaming shape (2 heads
    of 64 on a 32 x 32 grid, 1024 tokens) exported with a symbolic batch:
    the global block is a `wm::` node whose CUDA implementation takes the
    register-tiled f32 forward; the loaded program runs it, launches
    counted, bit for bit the eager model."""
    import collections
    import dataclasses

    from wildlifemapper_tpu_torch.compat.export import (load_exported,
                                                        save_exported)
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.ops._attention import attention_body

    cfg = _tiny_model_config("float32", layout)
    cfg = dataclasses.replace(cfg, img_size=512, vit=dataclasses.replace(
        cfg.vit, embed_dim=128))
    assert attention_body(torch.float32, 64, 1024, 1024, True,
                          (32, 32)) == "f32"
    model = WildlifeMapper(cfg, generator=torch.Generator(
        device=cuda).manual_seed(2)).eval()
    glob = ("flash_attention_rel_pos" if layout == "grouped"
            else "flash_attention_packed")
    path = save_exported(model, tmp_path / "m.pt2", batch_size=None)
    program = torch.export.load(str(path))
    nodes = collections.Counter(
        str(n.target).split(".")[1] for n in program.graph.nodes
        if str(n.target).startswith("wm."))
    assert nodes[glob] == 1
    forward = load_exported(path)
    x = torch.randn(2, 512, 512, 3, device=cuda)
    with torch.no_grad():
        start = _library.WRAPPERS[glob].launches
        got = forward(x)
        torch.cuda.synchronize()
        assert _library.WRAPPERS[glob].launches == start + 1
        want = model(x)
    for k in ("pred_logits", "pred_boxes"):
        assert torch.isfinite(got[k]).all()
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("content_size", [None, 96])
def test_predictor_is_the_forward_on_the_card(cuda, content_size):
    """set_image launches the forward's kernels and predict none; the
    detections bit for bit those of the forward + postprocess + NMS."""
    import dataclasses

    from wildlifemapper_tpu_torch.compat.predictor import \
        WildlifeMapperPredictor
    from wildlifemapper_tpu_torch.eval.postprocess import (batched_nms,
                                                           postprocess)
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    cfg = dataclasses.replace(_tiny_model_config("bfloat16", "packed"),
                              content_size=content_size)
    model = WildlifeMapper(cfg, generator=torch.Generator(
        device=cuda).manual_seed(1)).eval()
    pred = WildlifeMapperPredictor(model)
    img = np.random.default_rng(0).integers(0, 256, (150, 200, 3),
                                            dtype=np.uint8)
    before = {n: w.launches for n, w in _library.WRAPPERS.items()}
    pred.set_image(img)
    mid = {n: w.launches for n, w in _library.WRAPPERS.items()}
    got = pred.predict(score_threshold=0.0)
    after = {n: w.launches for n, w in _library.WRAPPERS.items()}
    assert mid != before and after == mid
    canvas = pred.preprocess(img)
    with torch.inference_mode():
        out = model(canvas)
        dets = postprocess(out, torch.tensor([[150, 200]], device=cuda), 0.0,
                           hw_swap_compat=False)
        keep = batched_nms(dets["boxes"], dets["scores"], dets["labels"],
                           dets["keep"], 0.4, class_aware=False)[0]
    for k in ("boxes", "scores", "labels"):
        np.testing.assert_array_equal(got[k], dets[k][0][keep].cpu().numpy())
