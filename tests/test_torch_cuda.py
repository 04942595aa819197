"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes (tile edges, odd token counts, every head dim: 32, 64,
80 for ViT-H, 128). They
need CUDA and skip elsewhere with the reason "needs CUDA (H100)".

From 512 keys on, bf16 at d = 64 or 128 (and the forward at d = 80) runs
the Hopper bodies (wgmma and a TMA-fed ring, csrc/attention_fwd_sm90.cuh
and attention_bwd_sm90.cuh): the
STREAMING cases below are ragged against their 128-row blocks and their
64- and 128-key tiles (grids that are no multiple of 8, N != M, a last tile
of one or six keys, d = 128 with rel tables); their backward also with
and without the table gradients, twice, and the delta its dq kernel
writes.

Below 512 keys, bf16 at d = 64 (and the forward at d = 80) with rel tables
and N == M <= 208 runs the resident bodies (one block a window-head, csrc/attention_fwd_resident.cuh and
attention_bwd_resident.cuh, whose backward is one kernel): the RESIDENT cases
are the main paths' windows (196 = 14x14, 144 = 12x12) and ragged ones (49 =
7x7 with odd table widths, 100 = 10x10, 208 = 13x16, a window of six tokens,
one window-head, more window-heads than the card has SMs; a window of one
token has gradients that are zero but for rounding, so nothing to compare).

At d = 80 (ViT-H) the D80 cases hold the Hopper and the resident forward
against the tile body and the plain version, twice, with the tile backward
after them.

This file imports neither JAX nor the JAX package's tests. On a machine
without JAX run it as

    python -m pytest tests/test_torch_cuda.py -m requires_cuda --noconftest
"""

import numpy as np
import pytest
import torch

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
# or 256 columns; csrc/mlp_gemm_sm90.cuh): rows ragged against the tile (1,
# 127, 129, 1000), F that is no multiple of the column tile (320), and
# ViT-B / L / H widths with F = 4D; f32 the fused scalar bodies, which take
# D up to 1024.
MLP_SHAPES = [(50, 64, 128), (33, 768, 3072), (70, 1024, 256),
              (1, 768, 3072), (127, 64, 256), (129, 128, 512),
              (1000, 256, 320)]
MLP_CASES = ([(dt, *shape) for dt in DTYPES for shape in MLP_SHAPES]
             + [(torch.bfloat16, *shape) for shape in
                [(300, 768, 3072), (200, 1024, 4096), (130, 1280, 5120),
                 (257, 1280, 320)]])


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
    # one wrapper call; bf16 runs the GEMM body twice (fc1 + GELU, fc2)
    assert (fused_mlp.launches, fused_mlp.kernel_launches) == (
        before[0] + 1, before[1] + (2 if dtype == torch.bfloat16 else 1))
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


@pytest.mark.parametrize("r,dim,hidden", [(1000, 768, 3072),
                                          (130, 1280, 5120)])
def test_fused_mlp_gemm_repeats(cuda, r, dim, hidden):
    """Every output element of the GEMM body has one owner and a fixed order
    of sums: two runs of the forward and of dh are bit-identical."""
    rng = np.random.default_rng(r)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, r, dim, hidden, torch.bfloat16,
                                    cuda)
    da = _randn(rng, (r, hidden), torch.bfloat16, cuda)
    with torch.inference_mode():
        first = [fused_mlp(x, w1, b1, w2, b2), *fused_mlp_dh(x, w1, b1, da)]
        second = [fused_mlp(x, w1, b1, w2, b2), *fused_mlp_dh(x, w1, b1, da)]
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_mlp_f32_refuses_what_it_does_not_hold(cuda):
    """The f32 scalar bodies take D up to 1024: ViT-H's 1280 is refused by
    the wrapper with the reason, never sent elsewhere."""
    rng = np.random.default_rng(0)
    args = _mlp_inputs(rng, 4, 1280, 5120, torch.float32, cuda)
    with pytest.raises(ValueError, match="the f32 kernels take D"):
        fused_mlp(*args)


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
    backward is one kernel, the others' a dq and a dk/dv kernel."""
    from wildlifemapper_tpu_torch.ops._attention import attention_body

    if attention_body(dtype, d, n, n, True, hw, "backward") == "resident":
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
                 (700, 1024, 2, 64, (32, 32), 0.3)]


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
                                         (1000, 1000, 3, 64)])
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


# batch (windows), heads, grid, scale (None: d ** -0.5) at d = 64: the
# resident bodies' 16-row tiles and 144- / 208-row instantiations, odd table
# widths (2-byte table loads), one window-head, more window-heads than SMs,
# a scale that is no power of two (it enters where each family rounds it)
RESIDENT = [(100, 2, (14, 14), None), (37, 3, (12, 12), None),
            (3, 3, (7, 7), None), (5, 2, (10, 10), None),
            (1, 1, (14, 14), None), (1, 1, (12, 12), None),
            (2, 2, (13, 16), None), (2, 1, (10, 15), None),
            (3, 1, (2, 3), None),
            (141, 1, (12, 12), 0.3), (23, 6, (14, 14), 0.3)]


@pytest.mark.parametrize("family", ["packed", "grouped"])
@pytest.mark.parametrize("bw,heads,hw,scale", RESIDENT)
def test_resident_bodies_agree_and_repeat(cuda, family, bw, heads, hw, scale):
    """bf16 at the launcher: the resident body against the plain version
    and the mma.sync body, forward with and without the lse, the one-kernel
    backward with every gradient (dq, dk, dv written by stride into one
    packed tensor) and with the activations' alone, and the backward twice:
    no atomics, so bit-identical."""
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_launch)

    ss = family == "grouped"
    dt, d = torch.bfloat16, 64
    n, c = hw[0] * hw[1], heads * d
    scale = d ** -0.5 if scale is None else scale
    rng = np.random.default_rng(bw + n + heads)
    qkv = _randn(rng, (bw, n, 3 * c), dt, cuda)
    q, k, v = (qkv[..., i * c:(i + 1) * c] for i in range(3))
    dout = _randn(rng, (bw, n, c), dt, cuda)
    rh = _randn(rng, (bw, n, heads, hw[0]), dt, cuda, 0.5)
    rw = _randn(rng, (bw, n, heads, hw[1]), dt, cuda, 0.5)
    assert attention_body(dt, d, n, n, True, hw) == "resident"
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
            torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-3)
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
    twice (bit-identical); the backward (the tile bodies) on its lse
    against the plain backward."""
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
    assert attention_body(dt, d, n, n, True, hw, "backward") == "mma"
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
        got = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                        heads, rh, rw, scale_scores=ss)
        torch.cuda.synchronize()
    _close_grads(got, want, dt, ("dq", "dk", "dv", "drel_h", "drel_w"))


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


def test_d80_backward_is_the_tile_bodies(cuda):
    """At d = 80 the windowed wrapper's bf16 forward is the resident body
    and its backward the delta pass and the two tile kernels; the resident
    backward refuses d = 80: nothing falls back."""
    from wildlifemapper_tpu_torch.ops import _attention

    calls = []
    real = _attention.attention_delta

    def counted(*args):
        calls.append(1)
        return real(*args)

    rng = np.random.default_rng(8)
    dt = torch.bfloat16
    qkv = _randn(rng, (3, 196, 3 * 2 * 80), dt, cuda).requires_grad_()
    rh = _randn(rng, (3, 196, 2, 14), dt, cuda, 0.5)
    rw = _randn(rng, (3, 196, 2, 14), dt, cuda, 0.5)
    _attention.attention_delta = counted
    try:
        before = _counts(windowed_attention_packed)
        out = windowed_attention_packed(qkv, rh, rw, 80 ** -0.5, 2, (14, 14))
        out.float().sum().backward()
        torch.cuda.synchronize()
    finally:
        _attention.attention_delta = real
    assert len(calls) == 1
    assert _counts(windowed_attention_packed) == tuple(
        a + b for a, b in zip(before, (1, 0, 1, 1)))
    q, k, v = (qkv.detach()[..., i * 160:(i + 1) * 160] for i in range(3))
    o, lse = _attention.attention_launch(q, k, v, 80 ** -0.5, 2, rh, rw,
                                         return_lse=True)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _attention.attention_backward_launch(q, k, v, o, lse, o, 80 ** -0.5,
                                             2, rh, rw, body="resident")


def test_resident_backward_counts_one_launch(cuda):
    """The windowed wrappers' bf16 backward is one kernel and runs no delta
    pass; their f32 backward is still the delta pass and the two tile
    kernels."""
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
                (torch.float32, 1, (1, 0, 1, 1))):
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
    """A body that does not take a launch raises: nothing falls back."""
    from wildlifemapper_tpu_torch.ops._attention import attention_launch

    def launch(dtype, n, d, hw):
        q = torch.zeros(1, n, d, device=cuda, dtype=dtype)
        rh = torch.zeros(1, n, 1, hw[0], device=cuda, dtype=dtype)
        rw = torch.zeros(1, n, 1, hw[1], device=cuda, dtype=dtype)
        return attention_launch(q, q, q, 0.125, 1, rh, rw, body="resident")

    launch(torch.bfloat16, 196, 64, (14, 14))
    for args in ((torch.float32, 196, 64, (14, 14)),
                 (torch.bfloat16, 196, 128, (14, 14)),
                 (torch.bfloat16, 256, 64, (16, 16)),
                 (torch.bfloat16, 102, 64, (6, 17))):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            launch(*args)
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
