"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes (tile edges, odd token counts, every head dim). They
need CUDA and skip elsewhere with the reason "needs CUDA (H100)".

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
    fused_mlp, fused_mlp_backward_plain, fused_mlp_plain)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bw,hw,heads,d", [(5, (4, 4), 2, 32),
                                           (3, (7, 7), 3, 64),
                                           (2, (14, 14), 2, 64),
                                           (2, (12, 12), 2, 64)])
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
                                          (1, (32, 32), 2, 64)])
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
                                           (2, 33, 65, 2, 32)])
def test_cross_kernel(cuda, dtype, b, n, m, heads, d):
    rng = np.random.default_rng(n + m + d)
    args = (_randn(rng, (b, n, heads * d), dtype, cuda),
            _randn(rng, (b, m, heads * d), dtype, cuda),
            _randn(rng, (b, m, heads * d), dtype, cuda), d ** -0.5, heads)
    _compare(cross_attention_packed, cross_attention_packed_plain, args,
             dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,dim,hidden", [(50, 64, 128), (33, 768, 3072),
                                          (70, 1024, 256)])
def test_fused_mlp_kernel(cuda, dtype, r, dim, hidden):
    rng = np.random.default_rng(r + dim)
    x = _randn(rng, (r, dim), dtype, cuda)
    w1 = _randn(rng, (hidden, dim), dtype, cuda, dim ** -0.5)
    b1 = _randn(rng, (hidden,), torch.float32, cuda, 0.1)
    w2 = _randn(rng, (dim, hidden), dtype, cuda, hidden ** -0.5)
    b2 = _randn(rng, (dim,), torch.float32, cuda, 0.1)
    before = fused_mlp.launches
    with torch.inference_mode():
        got = fused_mlp(x, w1, b1, w2, b2)
        torch.cuda.synchronize()
        ref = fused_mlp_plain(x, w1, b1, w2, b2)   # same rounding points
    assert fused_mlp.launches == before + 1
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


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
    before = (wrapper.launches, wrapper.backward_dq_launches,
              wrapper.backward_dkv_launches)
    out = wrapper(qkv, rh, rw, d ** -0.5, heads, hw)
    inputs = (qkv, rh, rw) if rel_grad else (qkv,)
    got = torch.autograd.grad(out, inputs, dout)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.backward_dq_launches,
            wrapper.backward_dkv_launches) == tuple(n + 1 for n in before)
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
                                           (2, (12, 12), 2, 64)])
def test_windowed_backward_kernels(cuda, dtype, bw, hw, heads, d):
    _packed_backward(windowed_attention_packed, cuda, dtype, bw, hw, heads,
                     d, seed=bw * 10 + d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,heads,d", [(2, (12, 12), 2, 64),
                                          (1, (8, 24), 3, 64),
                                          (1, (32, 32), 2, 64)])
def test_flash_backward_kernels(cuda, dtype, b, hw, heads, d):
    _packed_backward(flash_attention_packed, cuda, dtype, b, hw, heads, d,
                     seed=b * 100 + hw[1])


def test_packed_backward_without_rel_gradients(cuda):
    """Frozen rel tables: the dq kernel skips the drel reduction."""
    _packed_backward(flash_attention_packed, cuda, torch.bfloat16, 1,
                     (12, 12), 2, 64, seed=5, rel_grad=False)


def test_forward_lse_matches_plain(cuda):
    """The lse the forward writes for the backward, against the plain one."""
    from wildlifemapper_tpu_torch.ops._attention import attention_launch

    rng = np.random.default_rng(11)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (_randn(rng, (2, 70, 128), dtype, cuda) for _ in range(3))
        _, lse = attention_launch(q, k, v, 0.125, 2, return_lse=True)
        _, ref = attention_plain(q, k, v, 0.125, 2, return_lse=True)
        torch.testing.assert_close(lse, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,heads,d", [(2, 100, 70, 2, 128),
                                           (1, 64, 130, 4, 64),
                                           (2, 33, 65, 2, 32)])
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("r,dim,hidden", [(50, 64, 128), (33, 768, 3072),
                                          (70, 1024, 256)])
def test_fused_mlp_backward_kernel(cuda, dtype, r, dim, hidden):
    rng = np.random.default_rng(r + dim)
    x = _randn(rng, (r, dim), dtype, cuda).requires_grad_()
    w1 = _randn(rng, (hidden, dim), dtype, cuda, dim ** -0.5).requires_grad_()
    b1 = _randn(rng, (hidden,), torch.float32, cuda, 0.1).requires_grad_()
    w2 = _randn(rng, (dim, hidden), dtype, cuda,
                hidden ** -0.5).requires_grad_()
    b2 = _randn(rng, (dim,), torch.float32, cuda, 0.1).requires_grad_()
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
               (2, (9, 9), 128)]),
    "windowed": (windowed_attention_rel_pos,
                 [(19, (4, 4), 32), (7, (7, 7), 64), (5, (14, 14), 64),
                  (5, (12, 12), 64), (3, (3, 5), 128)]),
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
    before = (wrapper.launches, wrapper.backward_dq_launches,
              wrapper.backward_dkv_launches)
    out = wrapper(q, k, v, rh, rw, scale, hw)
    got = torch.autograd.grad(out, inputs, dout)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.backward_dq_launches,
            wrapper.backward_dkv_launches) == tuple(n + 1 for n in before)
    with torch.no_grad():
        _, lse = grouped_attention_plain(q, k, v, rh, rw, scale, hw,
                                         return_lse=True)
        ref = grouped_attention_backward_plain(q, k, v, rh, rw, out, lse,
                                               dout, scale, hw)
    _close_grads(got, ref, dtype,
                 ("dq", "dk", "dv", "drel_h", "drel_w")[:len(inputs)])


def test_grouped_forward_lse_matches_plain(cuda):
    from wildlifemapper_tpu_torch.ops._attention import attention_launch

    rng = np.random.default_rng(13)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        q, k, v, rh, rw = _grouped_inputs(rng, 3, (7, 10), 32, dtype, cuda)
        _, lse = attention_launch(q, k, v, 0.2, 1, rh[:, :, None],
                                  rw[:, :, None], return_lse=True,
                                  scale_scores=True)
        _, ref = grouped_attention_plain(q, k, v, rh, rw, 0.2, (7, 10),
                                         return_lse=True)
        torch.testing.assert_close(lse[..., 0], ref, atol=tol, rtol=tol)


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
