"""Shared helpers for the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py): tiny configurations built the same way in
both packages, seeded parameters moved across with `state_dict_from_jax`."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from wildlifemapper_tpu_torch.weights import state_dict_from_jax


def tiny_config(cfgmod, **overrides):
    """tests/test_model.py's tiny config at img_size 128 (grid 8): windows
    of 4 tile it, a 96-px content crop gives a 6-grid that pads to 8."""
    vit = cfgmod.ViTConfig(embed_dim=64, depth=2, num_heads=2,
                           global_attn_indexes=(1,), window_size=4,
                           out_chans=32)
    hfc = cfgmod.HFCConfig(embed_dim=32, proj_dim=32, num_heads=2, ffn_dim=32)
    if overrides.pop("no_scramble", False):
        hfc = dataclasses.replace(hfc, compat_scrambled_reshape=False)
    if "window_size" in overrides:
        vit = dataclasses.replace(vit, window_size=overrides.pop("window_size"))
    return dataclasses.replace(
        cfgmod.model_config("vit_b"), vit=vit, img_size=128, patch_size=16,
        hfc=hfc,
        decoder=cfgmod.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                     num_queries=7, num_heads=2),
        **overrides)


def perturbed(params, rng, scale=0.05):
    """Every parameter plus seeded noise, so zero-initialised tables and
    biases carry signal."""
    return jax.tree.map(
        lambda p: jnp.asarray(np.asarray(p) + scale * rng.normal(
            size=p.shape).astype(np.float32)), params)


def flat_numpy(params, prefix: str = "") -> dict:
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    return {prefix + k: np.asarray(v) for k, v in flat.items()}


def port_state_dict(params, jax_prefix: str, torch_prefix: str,
                    depth: int = 1) -> dict:
    """The port's state dict for a JAX sub-module's params: prefix them to
    their place in the full model, convert, strip the torch prefix."""
    sd = state_dict_from_jax(flat_numpy(params, jax_prefix), depth=depth)
    return {k[len(torch_prefix):]: v for k, v in sd.items()
            if k.startswith(torch_prefix)}


def to_torch(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()
