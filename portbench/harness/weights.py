"""Seeded random weights, made on the device in a few large draws, under
the state-dict names that both the program and the reference load.

Every tensor is float32 (the program keeps its parameters in float32 and
casts them to the compute dtype). Matrices and convolution kernels are
lecun-normal (a unit normal truncated at +-2, scaled to variance 1 /
fan-in); biases, LayerNorm offsets, positional tables and the relative
position tables get small normal values (zeros would leave those paths
untested); LayerNorm scales are 1 plus a small normal; the query tokens and
the dense PE's gaussian matrix are N(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

LECUN_TRUNCATED_STD = 0.87962566103423978
SMALL = {"bias": 0.02, "rel_pos": 0.05, "pos_embed": 0.02, "norm": 0.02}


def kind(name: str, shape) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("positional_encoding_gaussian_matrix") or \
            name.endswith("mask_tokens.weight"):
        return "unit"
    if leaf.startswith("rel_pos"):
        return "rel_pos"
    if leaf == "pos_embed":
        return "pos_embed"
    if len(shape) == 1:
        return "norm" if ".norm" in name or ".neck.1" in name or \
            ".neck.3" in name else "bias"
    return "lecun"


def make(shapes: Dict[str, tuple], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on `device`, the same for the same seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    groups: Dict[str, list] = {}
    for name, shape in shapes.items():
        groups.setdefault(kind(name, shape), []).append(name)
    out: Dict[str, torch.Tensor] = {}
    for k in ("lecun", "unit", "rel_pos", "pos_embed", "norm", "bias"):
        names = groups.get(k, [])
        if not names:
            continue
        total = sum(math.prod(shapes[n]) for n in names)
        flat = torch.empty(total, device=device)
        if k == "lecun":
            torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
        else:
            flat.normal_(0.0, 1.0, generator=gen)
        at = 0
        for n in names:
            shape = shapes[n]
            t = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
            if k == "lecun":
                fan_in = math.prod(shape[1:])
                t.mul_(fan_in ** -0.5 / LECUN_TRUNCATED_STD)
            elif k != "unit":
                t.mul_(SMALL[k])
                if k == "norm" and n.endswith("weight"):
                    t.add_(1.0)
            out[n] = t
    return out
