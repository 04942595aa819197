"""Operation and byte counts against hand counts, one shape per kernel."""

import json
from pathlib import Path

import pytest

from portbench.harness import counts
from portbench.reference import model as ref

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def spec(name, **kw):
    return ref.model_spec(json.loads((CONFIGS / f"{name}.json").read_text()),
                          **kw)


def test_global_attention_forward():
    # K2, ViT-B full canvas, batch 4: 48 heads-rows of 4096 tokens, d 64
    call = (4, 12, 4096, 64, 128)
    products = 4 * 48 * 4096 ** 2 * 64 / 989e12
    adds = 2 * 48 * 4096 ** 2 / 67e12
    assert counts.attention_bound(call) == pytest.approx(products + adds)


def test_global_attention_backward():
    call = (4, 12, 4096, 64, 128)
    want = 10 * 48 * 4096 ** 2 * 64 / 989e12 + 4 * 48 * 4096 ** 2 / 67e12
    assert counts.attention_bound(call, backward=True) == pytest.approx(want)
    assert want * 1e3 == pytest.approx(0.569, abs=1e-3)


def test_window_attention_is_bound_by_bytes():
    # K1, ViT-B full canvas, batch 4: 100 windows of 196 tokens, 12 heads
    call = (100, 12, 196, 64, 28)
    nbytes = 4 * 1200 * 196 * 64 * 2 + 1200 * 196 * 28 * 2
    assert counts.attention_bound(call) == pytest.approx(nbytes / 3.35e12)
    assert counts.attention_bound(call) * 1e3 == pytest.approx(0.040,
                                                               abs=1e-3)


def test_mlp_forward_and_backward():
    call = (16384, 768, 3072)
    assert counts.mlp_bound(call) == pytest.approx(
        4 * 16384 * 768 * 3072 / 989e12)
    assert counts.mlp_bound(call, backward=True) == pytest.approx(
        4 * 16384 * 768 * 3072 / 989e12)
    assert counts.mlp_bound(call, backward=True, weights_train=True) == \
        pytest.approx(8 * 16384 * 768 * 3072 / 989e12)


def test_calls_of_a_forward():
    s = spec("sam_vit_b")
    calls = counts.attention_calls(s, 4)
    assert calls.count((4, 12, 4096, 64, 128)) == 4
    assert calls.count((100, 12, 196, 64, 28)) == 8
    s = spec("sam_vit_b", window_size=12, content_size=768,
             crop_prologue=True, scrambled_reshape=False)
    calls = counts.attention_calls(s, 8)
    assert calls.count((8, 12, 2304, 64, 96)) == 4
    assert calls.count((128, 12, 144, 64, 24)) == 8
    assert counts.mlp_calls(s, 8) == [(8 * 2304, 768, 3072)] * 12


def test_products_of_a_tile():
    s = spec("sam_vit_b")
    ops = counts.products(s, 1)
    hfc = [o for o in ops if o["layer"] == "hfc"]
    assert hfc[0]["flops"] == 8 * 1024 ** 3 and hfc[0]["dtype"] == "f32"
    blocks = sum(o["flops"] for o in ops if o["layer"] == "blocks")
    qkv_proj_mlp = 12 * (2 * 4096 * 768 * (3 * 768 + 768) +
                         4 * 4096 * 768 * 3072)
    attention = 4 * 4 * 12 * 4096 ** 2 * 64 + 8 * 4 * 25 * 12 * 196 ** 2 * 64
    tables = 4 * 2 * 12 * 4096 * 128 * 64 + 8 * 2 * 25 * 12 * 196 * 28 * 64
    assert blocks == qkv_proj_mlp + attention + tables
    assert counts.per_tile_tflop(s) == pytest.approx(1.0978, abs=1e-3)
    assert counts.per_tile_tflop(spec("sam_vit_h")) == pytest.approx(
        5.8306, abs=1e-3)


def test_training_counts_input_gradients_and_trained_weights():
    s = spec("sam_vit_b", window_size=12, content_size=768,
             crop_prologue=True, scrambled_reshape=False)
    fwd = counts.products(s, 8)
    step = counts.products(s, 8, train=True)
    back = [o for o in step if o["layer"].endswith("backward")]
    by = {}
    for o in back:
        by[o["layer"]] = by.get(o["layer"], 0) + o["flops"]
    f = {}
    for o in fwd:
        f[o["layer"]] = f.get(o["layer"], 0) + o["flops"]
    # frozen blocks: input gradients only, the same operations as the
    # forward, and the attention's two products twice (dq, dk; dp, dv)
    attention = (4 * 4 * 8 * 12 * 2304 ** 2 * 64
                 + 8 * 4 * 128 * 12 * 144 ** 2 * 64)
    assert by["blocks backward"] == f["blocks"] + attention
    # the patch embedding trains but its input is the image: dW only
    assert by["patch_embed backward"] == f["patch_embed"]
    assert "hfc backward" not in by
    # the adaptor's scores are f32 products when dropout sends it plain
    assert any(o["layer"] == "adaptor" and o["dtype"] == "f32" for o in step)


def test_training_counts_the_encoders_weight_gradients_where_it_trains():
    s = spec("sam_vit_b", window_size=12, content_size=768,
             crop_prologue=True, scrambled_reshape=False)
    f, by = {}, {}
    for o in counts.products(s, 8):
        f[o["layer"]] = f.get(o["layer"], 0) + o["flops"]
    for o in counts.products(s, 8, train=True, encoder_trains=True):
        if o["layer"].endswith("backward"):
            by[o["layer"]] = by.get(o["layer"], 0) + o["flops"]
    # every product of the blocks and the neck twice: dX and dW, and the
    # attention's dq, dk and dp, dv
    assert by["blocks backward"] == 2 * f["blocks"]
    assert by["neck backward"] == 2 * f["neck"]
    frozen = {}
    for o in counts.products(s, 8, train=True):
        if o["layer"].endswith("backward"):
            frozen[o["layer"]] = frozen.get(o["layer"], 0) + o["flops"]
    assert frozen["neck backward"] == f["neck"]
    for layer in ("adaptor backward", "decoder backward",
                  "patch_embed backward"):
        assert frozen[layer] == by[layer]
