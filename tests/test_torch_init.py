"""The port's from-scratch initialisation against the JAX package's, parameter
by parameter, at a tiny configuration: `WildlifeMapper(cfg, generator)`
against `wildlifemapper_tpu.models.WildlifeMapper.init`, matched through the
weight conversion (`state_dict_from_jax`). The generators differ (a
torch.Generator against a JAX key), so the numbers differ; the distributions
must not.

Tolerance: a parameter the JAX package initialises to a constant (zeros,
LayerNorm ones) must be that constant exactly. Every other one is compared
by its mean and standard deviation: for n draws of a distribution with
standard deviation s, a sample mean spreads by s / sqrt(n) and a sample
standard deviation by at most s / sqrt(2n) (the normal's; truncation
narrows it), so two independent samples differ by at most 7 s / sqrt(n) in
mean and 5 s / sqrt(n) in standard deviation at five standard errors. The
weights of these configurations hold 32 to 16384 values, so the bounds are
loose for the smallest; an N(0, 0.02) draw where flax's lecun_normal gives
std 1 / sqrt(fan_in) (0.125 to 0.25 here) is outside them everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import state_dict_from_jax

from tests.torch_common import flat_numpy, tiny_config

# flax's lecun_normal divides a unit normal truncated to [-2, 2] by its
# standard deviation, this constant
LECUN_TRUNCATED_STD = 0.87962566103423978

CONFIGS = {
    "full_canvas": dict(),
    "from_scratch": dict(content_size=96, crop_prologue=True,
                         no_scramble=True, window_size=3),
}


def _both(name, seed=0):
    jc = tiny_config(jcfg, **dict(CONFIGS[name]))
    tc = tiny_config(tcfg, **dict(CONFIGS[name]))
    x = jnp.zeros((1, jc.img_size, jc.img_size, 3), jnp.float32)
    params = jax.jit(JaxWildlifeMapper(jc).init)(jax.random.PRNGKey(seed), x)
    want = state_dict_from_jax(flat_numpy(params), depth=jc.vit.depth)
    model = WildlifeMapper(tc, generator=torch.Generator().manual_seed(seed),
                           device="cpu")
    # the PE gaussian matrix is a buffer of the port, a parameter in JAX
    return want, {**dict(model.named_parameters()),
                  **dict(model.named_buffers())}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_init_matches_jax_distributions(name):
    want, got = _both(name)
    assert set(got) == set(want)
    for pname, p in got.items():
        g = p.detach().double()
        w = want[pname].double()
        assert g.shape == w.shape, pname
        if w.numel() == 1 or float(w.std()) == 0.0:
            # a constant in the JAX package: zeros, LayerNorm ones
            assert torch.equal(g, w), f"{pname}: want the constant of JAX"
            continue
        n, s = w.numel(), float(w.std())
        assert abs(float(g.mean()) - float(w.mean())) <= 7 * s / n ** 0.5, \
            f"{pname}: mean {float(g.mean())} against {float(w.mean())}"
        assert abs(float(g.std()) - s) <= 5 * s / n ** 0.5, \
            f"{pname}: std {float(g.std())} against {s}"


def test_lecun_weights_are_truncated_as_flax_draws_them():
    """Every Linear and Conv weight lies within flax's truncation, two
    standard deviations of the underlying normal (std 1 / sqrt(fan_in)
    divided by LECUN_TRUNCATED_STD), and flax's own draw of the largest one
    does too."""
    _, got = _both("full_canvas", seed=3)
    weights = {n: p.detach() for n, p in got.items()
               if p.dim() >= 2 and not any(
                   k in n for k in ("rel_pos", "pos_embed", "mask_tokens",
                                    "gaussian_matrix"))}
    assert weights
    for pname, p in weights.items():
        limit = 2 * p[0].numel() ** -0.5 / LECUN_TRUNCATED_STD
        assert float(p.abs().max()) <= limit * (1 + 1e-6), pname
    big = max((p for p in weights.values() if p.dim() == 2),
              key=lambda t: t.numel())
    flax = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(1), tuple(big.shape[::-1])))
    limit = 2 * big.shape[1] ** -0.5 / LECUN_TRUNCATED_STD
    assert np.abs(flax).max() <= limit * (1 + 1e-6)
    assert abs(float(big.std()) - float(flax.std())) <= \
        5 * float(flax.std()) / big.numel() ** 0.5


def test_init_is_seeded():
    """One seed gives one model; another seed another."""
    tc = tiny_config(tcfg)
    a, b, c = (dict(WildlifeMapper(
        tc, generator=torch.Generator().manual_seed(s), device="cpu")
        .named_parameters()) for s in (5, 5, 6))
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["image_encoder.blocks.0.attn.qkv.weight"],
                           c["image_encoder.blocks.0.attn.qkv.weight"])
