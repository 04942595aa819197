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

from wildlifemapper_tpu_torch.ops.cross_attention import (
    cross_attention_packed, cross_attention_packed_plain)
from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
    flash_attention_packed, flash_attention_packed_plain)
from wildlifemapper_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_plain
from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
    windowed_attention_packed, windowed_attention_packed_plain)

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


def test_backward_and_bad_dtype_raise(cuda):
    qkv = torch.randn(1, 16, 3 * 64, device=cuda, requires_grad=True)
    rel = torch.zeros(1, 16, 2, 4, device=cuda)
    out = windowed_attention_packed(qkv, rel, rel, 0.125, 2, (4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        out.sum().backward()
    with pytest.raises(TypeError):
        windowed_attention_packed(qkv.detach().half(), rel.half(),
                                  rel.half(), 0.125, 2, (4, 4))
