"""Gradients of the port's four kernels against the JAX package's Pallas
backward kernels (interpret mode on the CPU), on the same seeded inputs.

For each of K1 (windowed), K2 (global), K4 (cross attention) and K3 (fused
MLP): the `*_backward_plain` version, which follows the CUDA backward
kernels' rounding points, and autograd through the public wrapper (on the CPU
that differentiates the plain forward) are held to `jax.vjp` of the Pallas
function in float32 at atol 5e-4 / rtol 1e-3, the JAX gradient tests' own
tolerance (tests/test_flash_attention_v2.py:116). Ragged token counts (no
multiple of the kernels' 64-wide tiles) are among the cases. The forward's
lse is held to the JAX residual at atol 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wildlifemapper_tpu.ops import cross_attention as j_cross_mod
from wildlifemapper_tpu.ops import flash_attention_v2 as j_flash_mod
from wildlifemapper_tpu.ops.cross_attention import \
    cross_attention_packed as j_cross
from wildlifemapper_tpu.ops.flash_attention_v2 import \
    flash_attention_packed as j_flash
from wildlifemapper_tpu.ops.flash_attention_v2 import pack_rel_global
from wildlifemapper_tpu.ops.fused_mlp import fused_mlp as j_mlp
from wildlifemapper_tpu.ops.windowed_attention_v2 import (
    SUBLANE_H, pack_rel_tables, windowed_attention_packed as j_windowed)
from wildlifemapper_tpu_torch.ops._attention import attention_plain
from wildlifemapper_tpu_torch.ops.cross_attention import (
    cross_attention_packed, cross_attention_packed_backward_plain)
from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
    flash_attention_packed, flash_attention_packed_backward_plain)
from wildlifemapper_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_backward_plain, fused_mlp_dh_plain)
from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
    windowed_attention_packed, windowed_attention_packed_backward_plain)

from tests.torch_common import to_numpy, to_torch

GRAD_TOL = dict(atol=5e-4, rtol=1e-3)


def _attn_inputs(seed, b, hw, heads, d):
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    qkv = rng.normal(size=(b, n, 3 * heads * d)).astype(np.float32)
    rel_h = (rng.normal(size=(b, heads, n, hw[0])) * 0.5).astype(np.float32)
    rel_w = (rng.normal(size=(b, heads, n, hw[1])) * 0.5).astype(np.float32)
    dout = rng.normal(size=(b, n, heads * d)).astype(np.float32)
    return qkv, rel_h, rel_w, dout


def _port_rel(rel):
    # (B, H, N, g) per-head tables -> the port's (B, N, H, g)
    return to_torch(rel.transpose(0, 2, 1, 3)).contiguous()


def _split(qkv):
    c = qkv.shape[-1] // 3
    return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]


def _packed_port_grads(wrapper, backward_plain, qkv, rel_h, rel_w, dout,
                       scale, heads, hw):
    """(autograd through the wrapper, the plain backward) on the port's
    layouts, each as (dqkv, drel_h, drel_w) numpy arrays."""
    tq = to_torch(qkv).requires_grad_()
    th, tw = _port_rel(rel_h).requires_grad_(), _port_rel(rel_w).requires_grad_()
    tdo = to_torch(dout)
    auto = torch.autograd.grad(wrapper(tq, th, tw, scale, heads, hw),
                               (tq, th, tw), tdo)
    with torch.no_grad():
        out, lse = attention_plain(*_split(tq), scale, heads, th, tw,
                                   return_lse=True)
        plain = backward_plain(tq, th, tw, out, lse, tdo, scale, heads)
    return [to_numpy(g) for g in auto], [to_numpy(g) for g in plain]


@pytest.mark.parametrize("bw,hw,heads,d", [
    (5, (4, 4), 2, 32),      # window 4, odd count of windows
    (3, (7, 7), 2, 16),      # 49 tokens: ragged against 64-wide tiles
    (2, (3, 5), 2, 32),      # rectangular
    (1, (14, 14), 2, 16),    # the 196-token window of the full canvas
    (2, (4, 4), 2, 80),      # ViT-H's head dim
    # the windows the f32 window body takes on the card: 14 x 14 and 12 x
    # 12 at head dim 64 and 80
    (2, (14, 14), 2, 64), (2, (12, 12), 2, 64),
    (2, (14, 14), 2, 80), (2, (12, 12), 2, 80),
])
def test_windowed_backward_matches_pallas(bw, hw, heads, d):
    qkv, rel_h, rel_w, dout = _attn_inputs(bw + d, bw, hw, heads, d)
    scale = d ** -0.5
    hp, wp = pack_rel_tables(jnp.asarray(rel_h), jnp.asarray(rel_w), heads, hw)
    _, vjp = jax.vjp(lambda a, b_, c: j_windowed(a, b_, c, scale, heads, hw),
                     jnp.asarray(qkv), hp, wp)
    jdqkv, jdh, jdw = (np.asarray(g) for g in vjp(jnp.asarray(dout)))
    n = hw[0] * hw[1]
    # packed (BW, N, H*16) gradient tables -> (BW, N, H, gh / gw)
    want = [jdqkv,
            jdh.reshape(bw, n, heads, SUBLANE_H)[..., :hw[0]],
            jdw.reshape(bw, n, heads, SUBLANE_H)[..., :hw[1]]]
    auto, plain = _packed_port_grads(
        windowed_attention_packed, windowed_attention_packed_backward_plain,
        qkv, rel_h, rel_w, dout, scale, heads, hw)
    for name, w, a, p in zip(("dqkv", "drel_h", "drel_w"), want, auto, plain):
        np.testing.assert_allclose(a, w, err_msg=f"autograd {name}", **GRAD_TOL)
        np.testing.assert_allclose(p, w, err_msg=f"plain {name}", **GRAD_TOL)


@pytest.mark.parametrize("b,hw,heads,d", [
    (2, (8, 8), 2, 32), (1, (4, 8), 4, 16), (1, (12, 12), 2, 16),
    (1, (9, 10), 2, 16)])    # 144 and 90 tokens: ragged
def test_flash_backward_matches_pallas(b, hw, heads, d):
    qkv, rel_h, rel_w, dout = _attn_inputs(7 + b + hw[1], b, hw, heads, d)
    scale = d ** -0.5
    rh, rw = pack_rel_global(jnp.asarray(rel_h), jnp.asarray(rel_w), heads, hw)
    _, vjp = jax.vjp(lambda a, b_, c: j_flash(a, b_, c, scale, heads, hw),
                     jnp.asarray(qkv), rh, rw)
    jdqkv, jdh, jdw = (np.asarray(g) for g in vjp(jnp.asarray(dout)))
    n = hw[0] * hw[1]
    want = [jdqkv, jdh.reshape(b, n, heads, hw[0]),
            jdw.reshape(b, n, heads, hw[1])]
    auto, plain = _packed_port_grads(
        flash_attention_packed, flash_attention_packed_backward_plain,
        qkv, rel_h, rel_w, dout, scale, heads, hw)
    for name, w, a, p in zip(("dqkv", "drel_h", "drel_w"), want, auto, plain):
        np.testing.assert_allclose(a, w, err_msg=f"autograd {name}", **GRAD_TOL)
        np.testing.assert_allclose(p, w, err_msg=f"plain {name}", **GRAD_TOL)


@pytest.mark.parametrize("b,n,m,heads,d", [(2, 48, 80, 2, 32),
                                           (1, 64, 64, 4, 16),
                                           (2, 36, 20, 2, 64),
                                           # K4's head dim in f32, N != M
                                           # both ways, a rank's 4 heads
                                           (1, 40, 72, 2, 128),
                                           (2, 56, 24, 4, 128)])
def test_cross_backward_matches_pallas(b, n, m, heads, d):
    rng = np.random.default_rng(n + m)
    q, k, v = (rng.normal(size=(b, r, heads * d)).astype(np.float32)
               for r in (n, m, m))
    dout = rng.normal(size=(b, n, heads * d)).astype(np.float32)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c: j_cross(a, b_, c, scale, heads),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tq, tk, tv = (to_torch(t).requires_grad_() for t in (q, k, v))
    tdo = to_torch(dout)
    auto = torch.autograd.grad(cross_attention_packed(tq, tk, tv, scale, heads),
                               (tq, tk, tv), tdo)
    with torch.no_grad():
        out, lse = attention_plain(tq, tk, tv, scale, heads, return_lse=True)
        plain = cross_attention_packed_backward_plain(tq, tk, tv, out, lse,
                                                      tdo, scale, heads)
    for name, w, a, p in zip(("dq", "dk", "dv"), want, auto, plain):
        np.testing.assert_allclose(to_numpy(a), w, err_msg=f"autograd {name}",
                                   **GRAD_TOL)
        np.testing.assert_allclose(to_numpy(p), w, err_msg=f"plain {name}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("kernel", ["flash", "cross"])
def test_lse_matches_jax_residual(kernel):
    """The (B, N, H) lse the port's forward hands its backward, against the
    residual the Pallas forward saves (atol 2e-5)."""
    heads, d, hw = 2, 16, (6, 8)
    qkv, rel_h, rel_w, _ = _attn_inputs(3, 2, hw, heads, d)
    scale = d ** -0.5
    tq, tk, tv = _split(to_torch(qkv))
    if kernel == "flash":
        rh, rw = pack_rel_global(jnp.asarray(rel_h), jnp.asarray(rel_w),
                                 heads, hw)
        _, res = j_flash_mod._v2g_fwd(jnp.asarray(qkv), rh, rw, scale, heads,
                                      hw)
        _, lse = attention_plain(tq, tk, tv, scale, heads, _port_rel(rel_h),
                                 _port_rel(rel_w), return_lse=True)
    else:
        jq, jk, jv = (jnp.asarray(to_numpy(t)) for t in (tq, tk, tv))
        _, res = j_cross_mod._fwd(jq, jk, jv, scale, heads)
        _, lse = attention_plain(tq, tk, tv, scale, heads, return_lse=True)
    np.testing.assert_allclose(to_numpy(lse), np.asarray(res[-1]), atol=2e-5)


def _mlp_inputs(r, dim, hidden):
    rng = np.random.default_rng(r + dim)
    x = rng.normal(size=(r, dim)).astype(np.float32)
    w1 = (rng.normal(size=(dim, hidden)) * dim ** -0.5).astype(np.float32)
    b1 = rng.normal(size=(hidden,)).astype(np.float32) * 0.1
    w2 = (rng.normal(size=(hidden, dim)) * hidden ** -0.5).astype(np.float32)
    b2 = rng.normal(size=(dim,)).astype(np.float32) * 0.1
    g = rng.normal(size=(r, dim)).astype(np.float32)
    return x, w1, b1, w2, b2, g


@pytest.mark.parametrize("r,dim,hidden", [(64, 64, 256), (96, 32, 128),
                                          (8, 1280, 5120),      # ViT-H
                                          (100, 1280, 2560)])   # a TP rank
def test_fused_mlp_backward_matches_pallas(r, dim, hidden):
    x, w1, b1, w2, b2, g = _mlp_inputs(r, dim, hidden)
    _, vjp = jax.vjp(j_mlp, *(jnp.asarray(t) for t in (x, w1, b1, w2, b2)))
    jdx, jdw1, jdb1, jdw2, jdb2 = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    # the port takes the weights in the torch Linear layout (out, in)
    want = [jdx, jdw1.T, jdb1, jdw2.T, jdb2]
    args = [to_torch(t).requires_grad_() for t in (x, w1.T, b1, w2.T, b2)]
    auto = torch.autograd.grad(fused_mlp(*args), args, to_torch(g))
    with torch.no_grad():
        plain = fused_mlp_backward_plain(*args, to_torch(g))
    for name, w, a, p in zip(("dx", "dw1", "db1", "dw2", "db2"), want, auto,
                             plain):
        np.testing.assert_allclose(to_numpy(a), w, err_msg=f"autograd {name}",
                                   **GRAD_TOL)
        np.testing.assert_allclose(to_numpy(p), w, err_msg=f"plain {name}",
                                   **GRAD_TOL)


def test_fused_mlp_dh_plain_rounds_to_bf16():
    """The backward kernel's plain version in bf16: a and dh come back in
    x's dtype, within bf16 rounding (2e-2) of the f32 result."""
    x, w1, b1, _, _, _ = _mlp_inputs(32, 64, 128)
    da = np.random.default_rng(0).normal(size=(32, 128)).astype(np.float32)
    a32, dh32 = fused_mlp_dh_plain(to_torch(x), to_torch(w1.T), to_torch(b1),
                                   to_torch(da))
    a16, dh16 = fused_mlp_dh_plain(
        to_torch(x, torch.bfloat16), to_torch(w1.T, torch.bfloat16),
        to_torch(b1), to_torch(da, torch.bfloat16))
    assert a16.dtype == dh16.dtype == torch.bfloat16
    torch.testing.assert_close(a16.float(), a32, atol=5e-2, rtol=5e-2)
    torch.testing.assert_close(dh16.float(), dh32, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_bf16_close_to_f32(dtype):
    """The attention backward's plain version returns every gradient in the
    input dtype; in bf16 it stays within 3e-2 of each output's largest
    element of the f32 result (its rounding points: q*scale, ds and p)."""
    heads, d, hw = 2, 32, (5, 6)
    qkv, rel_h, rel_w, dout = _attn_inputs(9, 2, hw, heads, d)
    scale = d ** -0.5

    def run(dt):
        tq, tdo = to_torch(qkv, dt), to_torch(dout, dt)
        th, tw = _port_rel(rel_h).to(dt), _port_rel(rel_w).to(dt)
        out, lse = attention_plain(*_split(tq), scale, heads, th, tw,
                                   return_lse=True)
        return flash_attention_packed_backward_plain(tq, th, tw, out, lse,
                                                     tdo, scale, heads)

    ref = run(torch.float32)
    got = run(dtype)
    for g, r in zip(got, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert (g.float() - r).abs().max() <= 3e-2 * r.abs().max() + 1e-6
