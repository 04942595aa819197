"""The plain versions of the port's four kernels against the JAX package's
Pallas kernels (interpret mode on the CPU), on the same seeded inputs:
float32 at atol 2e-5 / rtol 1e-4, bfloat16 at 2e-2. Also the wrappers'
dispatch: the plain version only for CPU tensors, a raise elsewhere."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wildlifemapper_tpu.ops.cross_attention import \
    cross_attention_packed as j_cross
from wildlifemapper_tpu.ops.flash_attention_v2 import \
    flash_attention_packed as j_flash
from wildlifemapper_tpu.ops.flash_attention_v2 import pack_rel_global
from wildlifemapper_tpu.ops.fused_mlp import fused_mlp as j_mlp
from wildlifemapper_tpu.ops.windowed_attention_v2 import (
    pack_rel_tables, windowed_attention_packed as j_windowed)
from wildlifemapper_tpu_torch.ops import _build
from wildlifemapper_tpu_torch.ops._attention import attention_body
from wildlifemapper_tpu_torch.ops.cross_attention import (
    cross_attention_packed, cross_attention_packed_plain)
from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
    flash_attention_packed, flash_attention_packed_plain)
from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
    windowed_attention_packed, windowed_attention_packed_plain)

from tests.torch_common import to_numpy, to_torch

TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _attn_inputs(seed, b, hw, heads, d):
    rng = np.random.default_rng(seed)
    n = hw[0] * hw[1]
    qkv = rng.normal(size=(b, n, 3 * heads * d)).astype(np.float32)
    rel_h = (rng.normal(size=(b, heads, n, hw[0])) * 0.5).astype(np.float32)
    rel_w = (rng.normal(size=(b, heads, n, hw[1])) * 0.5).astype(np.float32)
    return qkv, rel_h, rel_w


def _port_rel(rel, dt):
    # (B, H, N, g) per-head tables -> the port's (B, N, H, g)
    return to_torch(rel.transpose(0, 2, 1, 3), dt).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bw,hw,heads,d", [
    (9, (4, 4), 4, 32),      # window 4, several windows
    (6, (3, 3), 2, 32),      # window 3
    (3, (2, 4), 2, 32),      # rectangular
    (2, (8, 8), 2, 32),      # a global block below GLOBAL_N_THRESHOLD
    (3, (4, 4), 2, 80),      # ViT-H's head dim
])
def test_windowed_plain_matches_pallas(dtype, bw, hw, heads, d):
    jdt, tdt = DTYPES[dtype]
    qkv, rel_h, rel_w = _attn_inputs(bw, bw, hw, heads, d)
    hp, wp = pack_rel_tables(jnp.asarray(rel_h, jdt), jnp.asarray(rel_w, jdt),
                             heads, hw)
    want = j_windowed(jnp.asarray(qkv, jdt), hp, wp, 0.25, heads, hw)
    got = windowed_attention_packed_plain(
        to_torch(qkv, tdt), _port_rel(rel_h, tdt), _port_rel(rel_w, tdt),
        0.25, heads, hw)
    assert got.dtype == tdt and got.shape == (bw, hw[0] * hw[1], heads * d)
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hw,heads,d", [
    (2, (8, 8), 4, 32), (2, (4, 8), 4, 32), (1, (12, 12), 2, 16)])
def test_flash_plain_matches_pallas(dtype, b, hw, heads, d):
    jdt, tdt = DTYPES[dtype]
    qkv, rel_h, rel_w = _attn_inputs(7 + b, b, hw, heads, d)
    rh, rw = pack_rel_global(jnp.asarray(rel_h, jdt), jnp.asarray(rel_w, jdt),
                             heads, hw)
    want = j_flash(jnp.asarray(qkv, jdt), rh, rw, 0.25, heads, hw)
    got = flash_attention_packed_plain(
        to_torch(qkv, tdt), _port_rel(rel_h, tdt), _port_rel(rel_w, tdt),
        0.25, heads, hw)
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,m,heads,d", [(2, 48, 80, 2, 32),
                                           (1, 64, 64, 4, 16),
                                           (2, 36, 20, 2, 64),
                                           (1, 40, 24, 2, 80)])
def test_cross_plain_matches_pallas(dtype, b, n, m, heads, d):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n + m)
    q, k, v = (rng.normal(size=(b, r, heads * d)).astype(np.float32)
               for r in (n, m, m))
    scale = d ** -0.5
    want = j_cross(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                   jnp.asarray(v, jdt), scale, heads)
    got = cross_attention_packed_plain(to_torch(q, tdt), to_torch(k, tdt),
                                       to_torch(v, tdt), scale, heads)
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,dim,hidden", [(64, 64, 256), (96, 32, 128),
                                          (8, 1280, 5120)])     # ViT-H
def test_fused_mlp_plain_matches_pallas(dtype, r, dim, hidden):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(r + dim)
    x = rng.normal(size=(r, dim)).astype(np.float32)
    w1 = (rng.normal(size=(dim, hidden)) * dim ** -0.5).astype(np.float32)
    b1 = rng.normal(size=(hidden,)).astype(np.float32) * 0.1
    w2 = (rng.normal(size=(hidden, dim)) * hidden ** -0.5).astype(np.float32)
    b2 = rng.normal(size=(dim,)).astype(np.float32) * 0.1
    want = j_mlp(jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(b1),
                 jnp.asarray(w2, jdt), jnp.asarray(b2))
    # the port takes the weights in the torch Linear layout (out, in)
    got = fused_mlp_plain(to_torch(x, tdt), to_torch(w1.T, tdt),
                          to_torch(b1), to_torch(w2.T, tdt), to_torch(b2))
    assert got.dtype == tdt
    np.testing.assert_allclose(to_numpy(got),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def _kernel_cases():
    qkv, rel_h, rel_w = _attn_inputs(0, 2, (4, 4), 2, 32)
    qkv, rh, rw = to_torch(qkv), _port_rel(rel_h, torch.float32), \
        _port_rel(rel_w, torch.float32)
    x = to_torch(np.random.default_rng(1).normal(size=(8, 64)))
    w1, w2 = torch.ones(128, 64) * 0.01, torch.ones(64, 128) * 0.01
    b1, b2 = torch.zeros(128), torch.zeros(64)
    q = qkv[..., :64]
    return [
        (windowed_attention_packed, windowed_attention_packed_plain,
         (qkv, rh, rw, 0.25, 2, (4, 4))),
        (flash_attention_packed, flash_attention_packed_plain,
         (qkv, rh, rw, 0.25, 2, (4, 4))),
        (cross_attention_packed, cross_attention_packed_plain,
         (q, q, q, 0.25, 2)),
        (fused_mlp, fused_mlp_plain, (x, w1, b1, w2, b2)),
    ]


@pytest.mark.parametrize("case", range(4))
def test_wrapper_dispatch(case):
    """CPU tensors take the plain version and launch nothing; a tensor on
    another device is refused rather than sent to the plain version."""
    wrapper, plain, args = _kernel_cases()[case]
    before = wrapper.launches
    torch.testing.assert_close(wrapper(*args), plain(*args), rtol=0, atol=0)
    assert wrapper.launches == before
    meta = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(ValueError, match="no kernel for device"):
        wrapper(*meta)


def test_find_nvcc(monkeypatch, tmp_path):
    """nvcc comes from CUDA_HOME first; with none anywhere the build
    raises instead of falling back."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    (tmp_path / "bin").mkdir()
    (tmp_path / "bin" / "nvcc").write_text("")
    assert _build.find_nvcc() == str(tmp_path / "bin" / "nvcc")


def test_attention_body_head_dims():
    """ViT-H's head dim 80: the bf16 forward takes the Hopper body at 4096
    keys on the 64-grid and the resident body on a window of 14; f32 and
    every backward take the mma.sync / f32 tile bodies; a head dim no body
    takes is refused with the reason."""
    bf16 = torch.bfloat16
    assert attention_body(bf16, 80, 4096, 4096, True, (64, 64)) == "sm90"
    assert attention_body(bf16, 80, 100, 4096, False, None) == "sm90"
    assert attention_body(bf16, 80, 196, 196, True, (14, 14)) == "resident"
    for nq, nk, rel, hw in ((196, 196, True, (14, 14)),
                            (4096, 4096, True, (64, 64)),
                            (100, 4096, False, None)):
        assert attention_body(torch.float32, 80, nq, nk, rel, hw) == "mma"
        for dt in (bf16, torch.float32):
            assert attention_body(dt, 80, nq, nk, rel, hw,
                                  direction="backward") == "mma"
    for d in (16, 96, 256):
        with pytest.raises(ValueError, match=f"head dim {d} not supported"):
            attention_body(bf16, d, 196, 196, True, (14, 14))


def test_sources_and_hash():
    """The build covers every CUDA source of the package."""
    names = {p.name for p in _build.sources()}
    assert {"attention.cu", "attention_bwd.cu", "grouped_attention.cu",
            "grouped_attention_bwd.cu", "fused_mlp.cu", "fused_mlp_bwd.cu",
            "mlp_gemm_sm90.cu", "mlp_gemm_sm90.cuh",
            "attention_fwd.cuh", "attention_bwd.cuh", "common.cuh",
            "sm90.cuh", "attention_sm90_common.cuh",
            "attention_fwd_sm90.cuh", "attention_bwd_sm90.cuh",
            "attention_sm90.cu", "grouped_attention_sm90.cu",
            "attention_bwd_dq_sm90.cu", "attention_bwd_dkv_sm90.cu",
            "grouped_attention_bwd_dq_sm90.cu",
            "grouped_attention_bwd_dkv_sm90.cu"} <= names
    assert len(_build.source_hash()) == 16
