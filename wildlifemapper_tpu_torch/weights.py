"""Weights across the two packages and from reference-named state dicts.

The port's parameters carry the PyTorch reference's state-dict names in
torch layouts, so a reference state dict loads as it is (minus the
vestigial `mask_decoder.iou_token.weight`, dropped as the JAX converter
drops it). `state_dict_from_jax` is the exact inverse of
`wildlifemapper_tpu/compat/torch_convert.py::map_torch_keys`: it turns the
JAX package's flat parameters ("a/b/kernel" -> numpy array) into the port's
state dict. Pure numpy plus torch.

The map is linear (transposes and renames), so the same function carries a
gradient tree or Adam's first and second moments across; `load_adam_state`
puts such moments into a torch AdamW.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

DROPPED_KEYS = ("mask_decoder.iou_token.weight",)


def _t(k):          # flax Dense kernel (in, out) -> torch Linear (out, in)
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k):       # flax Conv (kh, kw, in, out) -> torch (out, in, kh, kw)
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _dense_to_conv1x1(k):   # (in, out) -> (out, in, 1, 1)
    return np.ascontiguousarray(np.asarray(k).T[:, :, None, None])


def state_dict_from_jax(flat: Mapping[str, np.ndarray], depth: int = 12
                        ) -> Dict[str, torch.Tensor]:
    """JAX flat params ('image_encoder/blocks_0/attn/qkv/kernel', ...) ->
    the port's state dict ('image_encoder.blocks.0.attn.qkv.weight', ...)."""
    sd: Dict[str, np.ndarray] = {}

    def dense(src: str, dst: str, conv1x1: bool = False):
        if f"{src}/kernel" in flat:
            k = flat[f"{src}/kernel"]
            sd[f"{dst}.weight"] = _dense_to_conv1x1(k) if conv1x1 else _t(k)
            if f"{src}/bias" in flat:
                sd[f"{dst}.bias"] = np.asarray(flat[f"{src}/bias"])

    def ln(src: str, dst: str):
        if f"{src}/scale" in flat:
            sd[f"{dst}.weight"] = np.asarray(flat[f"{src}/scale"])
        if f"{src}/bias" in flat:
            sd[f"{dst}.bias"] = np.asarray(flat[f"{src}/bias"])

    def copy(src: str, dst: str, fn=np.asarray):
        if src in flat:
            sd[dst] = fn(flat[src])

    enc = tenc = "image_encoder"
    for pe in ("patch_embed", "hfc_embed"):
        copy(f"{enc}/{pe}/proj/kernel", f"{tenc}.{pe}.proj.weight", _conv)
        copy(f"{enc}/{pe}/proj/bias", f"{tenc}.{pe}.proj.bias")
    copy(f"{enc}/pos_embed", f"{tenc}.pos_embed")

    ad, tad = f"{enc}/hfc_attn", f"{tenc}.hfc_attn"
    for name in ("proj_hfc", "proj_patch", "proj_back"):
        dense(f"{ad}/{name}", f"{tad}.{name}", conv1x1=True)
    mha = f"{ad}/cross_attn"
    if f"{mha}/q_proj/kernel" in flat:
        parts = ("q_proj", "k_proj", "v_proj")
        sd[f"{tad}.cross_attn.in_proj_weight"] = np.concatenate(
            [_t(flat[f"{mha}/{p}/kernel"]) for p in parts], axis=0)
        sd[f"{tad}.cross_attn.in_proj_bias"] = np.concatenate(
            [np.asarray(flat[f"{mha}/{p}/bias"]) for p in parts], axis=0)
    dense(f"{mha}/out_proj", f"{tad}.cross_attn.out_proj")
    dense(f"{ad}/linear1", f"{tad}.linear1")
    dense(f"{ad}/linear2", f"{tad}.linear2")
    ln(f"{ad}/norm1", f"{tad}.norm1")
    ln(f"{ad}/norm2", f"{tad}.norm2")
    copy(f"{ad}/pos_embed", f"{tad}.pos_embed",
         lambda a: np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))

    for i in range(depth):
        d, s = f"{enc}/blocks_{i}", f"{tenc}.blocks.{i}"
        ln(f"{d}/norm1", f"{s}.norm1")
        ln(f"{d}/norm2", f"{s}.norm2")
        dense(f"{d}/attn/qkv", f"{s}.attn.qkv")
        dense(f"{d}/attn/proj", f"{s}.attn.proj")
        for rp in ("rel_pos_h", "rel_pos_w"):
            copy(f"{d}/attn/{rp}", f"{s}.attn.{rp}")
        dense(f"{d}/mlp/lin1", f"{s}.mlp.lin1")
        dense(f"{d}/mlp/lin2", f"{s}.mlp.lin2")

    copy(f"{enc}/neck/conv1/kernel", f"{tenc}.neck.0.weight", _conv)
    copy(f"{enc}/neck/conv2/kernel", f"{tenc}.neck.2.weight", _conv)
    for j, name in ((1, "ln1"), (3, "ln2")):
        ln(f"{enc}/neck/{name}/LayerNorm_0", f"{tenc}.neck.{j}")

    copy("pos_encoder/gaussian_matrix",
         "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix")

    dec, mdec = "box_decoder", "mask_decoder"
    copy(f"{dec}/query_tokens", f"{mdec}.mask_tokens.weight")
    attn_parts = ("q_proj", "k_proj", "v_proj", "out_proj")
    i = 0
    while f"{dec}/transformer/layers_{i}/norm1/scale" in flat:
        d, s = f"{dec}/transformer/layers_{i}", f"{mdec}.transformer.layers.{i}"
        for a in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            for p in attn_parts:
                dense(f"{d}/{a}/{p}", f"{s}.{a}.{p}")
        for n in ("norm1", "norm2", "norm3", "norm4"):
            ln(f"{d}/{n}", f"{s}.{n}")
        dense(f"{d}/mlp/lin1", f"{s}.mlp.lin1")
        dense(f"{d}/mlp/lin2", f"{s}.mlp.lin2")
        i += 1
    for p in attn_parts:
        dense(f"{dec}/transformer/final_attn_token_to_image/{p}",
              f"{mdec}.transformer.final_attn_token_to_image.{p}")
    ln(f"{dec}/transformer/norm_final_attn",
       f"{mdec}.transformer.norm_final_attn")
    for head in ("class_embed", "bbox_embed"):
        j = 0
        while f"{dec}/{head}/layers_{j}/kernel" in flat:
            dense(f"{dec}/{head}/layers_{j}", f"{mdec}.{head}.layers.{j}")
            j += 1

    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}


def prompt_encoder_state_dict_from_jax(flat: Mapping[str, np.ndarray]
                                       ) -> Dict[str, torch.Tensor]:
    """The JAX package's compat PromptEncoder parameters, flat ('pe_gaussian',
    'mask_conv1/kernel', 'mask_ln1/LayerNorm_0/scale', ...), -> the state
    dict of compat/prompt_encoder.py in SAM's names: convs HWIO -> OIHW,
    LayerNorm scale -> weight, the (4, C) point embeddings split into four
    (1, C) embeddings. The inverse of the JAX package's
    `convert_torch_prompt_encoder`."""
    sd = {"pe_layer.positional_encoding_gaussian_matrix": flat["pe_gaussian"],
          "not_a_point_embed.weight": flat["not_a_point_embed"],
          "no_mask_embed.weight": flat["no_mask_embed"]}
    for i, row in enumerate(np.asarray(flat["point_embeddings"])):
        sd[f"point_embeddings.{i}.weight"] = row[None]
    for j, conv in ((0, "mask_conv1"), (3, "mask_conv2"), (6, "mask_conv3")):
        sd[f"mask_downscaling.{j}.weight"] = _conv(flat[f"{conv}/kernel"])
        sd[f"mask_downscaling.{j}.bias"] = flat[f"{conv}/bias"]
    for j, ln in ((1, "mask_ln1"), (4, "mask_ln2")):
        sd[f"mask_downscaling.{j}.weight"] = flat[f"{ln}/LayerNorm_0/scale"]
        sd[f"mask_downscaling.{j}.bias"] = flat[f"{ln}/LayerNorm_0/bias"]
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in sd.items()}


def merge_state_dict(model: nn.Module, state_dict: Mapping[str, object],
                     strict: bool = False) -> Dict[str, List[str]]:
    """Load a reference-named state dict (tensors or numpy arrays) into the
    port's model, and report {"loaded", "missing", "unexpected"} in the
    port's names. Drops `mask_decoder.iou_token.weight`; centre-slices
    rel-pos tables for a smaller window (27 rows into a window-12 model's
    23, as the JAX converter does); raises on any other shape mismatch.
    With `strict=False` (the JAX converter's `merge_into_params`) an entry
    the model has and the dict lacks keeps its value; with `strict=True`
    one missing entry raises a KeyError before anything is loaded."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    if strict and missing:
        raise KeyError(f"state dict lacks {len(missing)} model entries, "
                       f"e.g. {missing[:5]}")
    unexpected = [k for k in state_dict
                  if k not in own and k not in DROPPED_KEYS]
    loaded = {}
    for k, target in own.items():
        if k not in state_dict:
            continue
        v = state_dict[k]
        v = (v.detach().cpu() if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.asarray(v)))
        if (v.shape != target.shape and k.endswith(("rel_pos_h", "rel_pos_w"))
                and v.dim() == 2 and v.shape[0] > target.shape[0]
                and (v.shape[0] - target.shape[0]) % 2 == 0
                and v.shape[1] == target.shape[1]):
            # relative distances of a smaller window are the table's centre
            off = (v.shape[0] - target.shape[0]) // 2
            v = v[off:off + target.shape[0]]
        if v.shape != target.shape:
            raise ValueError(f"shape mismatch for {k}: {tuple(v.shape)} vs "
                             f"model {tuple(target.shape)}")
        loaded[k] = v.to(target.dtype)
    model.load_state_dict(loaded, strict=not missing)
    return {"loaded": list(loaded), "missing": missing,
            "unexpected": unexpected}


def load_reference_state_dict(model: nn.Module,
                              state_dict: Mapping[str, object]) -> List[str]:
    """`merge_state_dict` with `strict=True`: every parameter and buffer of
    the model must be in the dict. Returns the keys the model does not
    have."""
    return merge_state_dict(model, state_dict, strict=True)["unexpected"]


def load_adam_state(optimizer: torch.optim.Optimizer,
                    named_parameters: Iterable[Tuple[str, nn.Parameter]],
                    mu: Mapping[str, torch.Tensor],
                    nu: Mapping[str, torch.Tensor], count: int) -> None:
    """Put Adam moments (state dicts in the port's names, for example
    `state_dict_from_jax` of optax's mu and nu) and the update count into a
    torch Adam/AdamW for every parameter the optimizer holds."""
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    for name, p in named_parameters:
        if id(p) not in held:
            continue
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": nu[name].to(p.device, p.dtype).clone(),
        }
