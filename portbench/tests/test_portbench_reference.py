"""The plain reference against the port's plain path at tiny widths on the
CPU (the test imports the port; the reference does not), its assignment
solver against scipy's, its NMS against the port's."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import env, program, weights
from portbench.reference import criterion as ref_crit
from portbench.reference import model as ref
from portbench.reference import postprocess as ref_post

TINY = json.loads((Path(__file__).parent / "data" / "tiny_vit.json")
                  .read_text())


def _port(mcfg, P):
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    model = WildlifeMapper(mcfg, device="cpu")
    model.load_state_dict(P, strict=True)
    return model.eval()


@pytest.mark.parametrize("recipe", ["serve", "crop_prologue"])
def test_forward_matches_the_port(recipe):
    import dataclasses

    mcfg = program.serving_config(TINY, dtype="float32", kernels=False)
    spec = ref.model_spec(TINY)
    if recipe == "crop_prologue":
        mcfg = dataclasses.replace(
            mcfg, content_size=96, crop_prologue=True,
            vit=dataclasses.replace(mcfg.vit, window_size=4),
            hfc=dataclasses.replace(mcfg.hfc, compat_scrambled_reshape=False))
        spec = ref.model_spec(TINY, window_size=4, content_size=96,
                              crop_prologue=True, scrambled_reshape=False)
    P = weights.make(ref.param_shapes(spec), 7, "cpu")
    model = _port(mcfg, P)
    g = torch.Generator().manual_seed(3)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    x = ref.normalize(tiles)
    with torch.no_grad():
        want = ref.forward(x, P, spec)
        got = model(x)
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[k], want[k], atol=2e-5, rtol=1e-4)


def test_fp8_control_departs_more_than_bf16():
    spec = ref.model_spec(TINY)
    P = weights.make(ref.param_shapes(spec), 11, "cpu")
    tiles = torch.randint(0, 256, (2, 128, 128, 3),
                          generator=torch.Generator().manual_seed(4),
                          dtype=torch.uint8)
    x = ref.normalize(tiles)
    with torch.no_grad():
        exact = ref.forward(x, P, spec)
        fp8 = ref.forward(x, P, spec, ref.Arith(fp8=True))
        bf16 = _port(program.serving_config(TINY, dtype="bfloat16",
                                            kernels=False), P)(x)
    d_fp8 = (fp8["pred_boxes"] - exact["pred_boxes"]).abs().max()
    d_bf16 = (bf16["pred_boxes"] - exact["pred_boxes"]).abs().max()
    assert d_fp8 > 2 * d_bf16 > 0


@pytest.mark.parametrize("shape", [(5, 5), (4, 9), (6, 128), (51, 118)])
def test_lsap_matches_scipy(shape):
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    cost = rng.normal(size=shape)
    cols = ref_crit.lsap(cost)
    rows, want = linear_sum_assignment(cost)
    assert len(set(cols)) == shape[0]
    assert np.isclose(cost[np.arange(shape[0]), cols].sum(),
                      cost[rows, want].sum())


def test_nms_matches_the_port():
    from wildlifemapper_tpu_torch.eval.postprocess import batched_nms

    g = torch.Generator().manual_seed(5)
    xy = torch.rand(3, 40, 2, generator=g) * 100
    wh = torch.rand(3, 40, 2, generator=g) * 30 + 1
    boxes = torch.cat([xy, xy + wh], -1)
    scores = torch.rand(3, 40, generator=g)
    keep = scores > 0.2
    labels = torch.zeros(3, 40, dtype=torch.int32)
    want = batched_nms(boxes, scores, labels, keep, 0.4)
    assert torch.equal(ref_post.nms(boxes, scores, keep, 0.4), want)


def test_freeze_policy_matches_the_port():
    from wildlifemapper_tpu_torch.train.optimizer import param_group

    for name in ref.param_shapes(ref.model_spec(TINY)):
        for freeze in (True, False):
            assert ref_crit.trains(name, freeze) == \
                (param_group(name, freeze) != "frozen")


def test_weights_are_the_seeds():
    shapes = ref.param_shapes(ref.model_spec(TINY))
    a = weights.make(shapes, env.seed_for(2 ** 33 + 1, "weights"), "cpu")
    b = weights.make(shapes, env.seed_for(2 ** 33 + 1, "weights"), "cpu")
    c = weights.make(shapes, env.seed_for(2 ** 33 + 2, "weights"), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in shapes)
    assert not torch.equal(a["image_encoder.blocks.0.attn.qkv.weight"],
                           c["image_encoder.blocks.0.attn.qkv.weight"])
    assert all(torch.isfinite(v).all() for v in a.values())
