"""The program under test, as the harness builds it: every import of the
PyTorch port (`wildlifemapper_tpu_torch`) that the traffic kinds use goes
through here, and nothing of the port is imported at module level.

A configuration file's numbers are the truth: the program's model config
takes its widths, depth, heads, global blocks, adaptor and decoder from the
file, and a recipe (a serving set-up, or the training launcher's arguments
through the CLI's own `config_from_args`) adds the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


def _file_fields(cfg: dict):
    from wildlifemapper_tpu_torch.config import DecoderConfig, HFCConfig

    vit = dict(embed_dim=cfg["encoder_embed_dim"],
               depth=cfg["encoder_depth"],
               num_heads=cfg["encoder_num_heads"],
               global_attn_indexes=tuple(cfg["encoder_global_attn_indexes"]),
               mlp_ratio=cfg["mlp_ratio"], out_chans=cfg["prompt_embed_dim"])
    hfc = HFCConfig(**cfg["hfc"])
    dec = DecoderConfig(**cfg["decoder"])
    return vit, hfc, dec


def serving_config(cfg: dict, dtype: str = "bfloat16", kernels: bool = True):
    """The served model: the file's numbers, full canvas, its window."""
    from wildlifemapper_tpu_torch.config import ModelConfig, ViTConfig

    vit, hfc, dec = _file_fields(cfg)
    return ModelConfig(vit=ViTConfig(window_size=cfg["window_size"], **vit),
                       hfc=hfc, decoder=dec, img_size=cfg["image_size"],
                       patch_size=cfg["patch_size"],
                       num_classes=cfg["num_classes"], dtype=dtype,
                       use_flash_attention=kernels)


def training_config(cfg: dict, launcher_args: Sequence[str]):
    """The CLI's Config for the launcher's arguments (cli/train.py::
    config_from_args, --model_type from the file), with the file's widths
    laid over the registry's (the same numbers for a published encoder)."""
    import argparse

    from wildlifemapper_tpu_torch.cli.train import (add_config_args,
                                                    config_from_args)

    parser = add_config_args(argparse.ArgumentParser())
    args = parser.parse_args(["--model_type", cfg["model_type"],
                              *launcher_args])
    conf = config_from_args(args)
    vit, _, dec = _file_fields(cfg)
    model = conf.model
    hfc = dataclasses.replace(model.hfc, **{
        k: v for k, v in cfg["hfc"].items()})
    model = dataclasses.replace(
        model, vit=dataclasses.replace(model.vit, **vit), hfc=hfc,
        decoder=dataclasses.replace(dec, aux_loss=model.decoder.aux_loss),
        patch_size=cfg["patch_size"], num_classes=cfg["num_classes"])
    return dataclasses.replace(conf, model=model)
