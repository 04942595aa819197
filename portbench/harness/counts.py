"""Operations and bytes that a batch or a training step needs, from the
shapes alone, and the least time they take on the card.

`products(spec, batch, train)` lists every matrix product of the step (the
forward; in training also the input gradients everywhere a gradient flows
and the weight gradients of the layers that train) with its dtype. The
least time of a product is its operations at its dtype's dense peak: the
tensor cores' bf16 rate for bf16 products, the CUDA cores' f32 rate for f32
ones (the HFC filter's DFT products, the attention scores that the program
forms in f32). Elementwise work, softmax and normalisation are not counted,
and a recompute (remat, or a kernel that recomputes what it did not keep)
is not counted either: what is counted is the least the step needs.

`attention_calls` / `attention_bound` and `mlp_calls` / `mlp_bound` give
what each call of the ViT blocks' attention and MLP needs: max(products at
the bf16 peak + the relative-position tables' f32 adds at the f32 peak,
bytes at the HBM rate), each input read once and each output written once.
A forward that records for a backward also writes its log-sum-exp; the
attention backward is five products of the scores' size and four adds a
score (the tables' gradients), the MLP's backward the two products of its
input gradient.

Peaks: one H100 SXM at 700 W (NVIDIA's data sheet, dense): 989 TFLOP/s
bf16, 67 TFLOP/s f32 without the tensor cores, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
BF16, F32 = 2, 4


def _geometry(spec: dict) -> dict:
    """Token grids of the prologue (p) and of the blocks (c), the image side
    the HFC filter sees, and the windows' padded grid."""
    img, patch = spec["img"], spec["patch"]
    side = spec["content"] if (spec["crop_prologue"] and spec["content"]) \
        else img
    p = side // patch
    c = spec["content"] // patch if spec["content"] else p
    ws = spec["window"]
    cp = -(-c // ws) * ws
    return {"side": side, "p": p, "c": c, "ws": ws,
            "windows": (cp // ws) ** 2}


def products(spec: dict, batch: int, train: bool = False,
             encoder_trains: bool = False) -> List[dict]:
    """Every product of a batch's forward (and, with `train`, of the
    step's backward) as dicts of layer, dtype and flops; the blocks' and
    the neck's weight gradients count where `encoder_trains`."""
    g = _geometry(spec)
    d, heads, depth = spec["dim"], spec["heads"], spec["depth"]
    hd = d // heads
    hf, dec = spec["hfc"], spec["dec"]
    side, p, c = g["side"], g["p"], g["c"]
    out: List[dict] = []

    def add(layer, dtype, flops, x_grad, w_trains, kind="linear"):
        out.append({"layer": layer, "dtype": dtype, "flops": flops,
                    "x_grad": x_grad, "w_trains": w_trains, "kind": kind})

    # HFC filter: grey -> low band by two DFT products per axis, real and
    # imaginary parts (4 products of side^3), f32
    add("hfc", "f32", batch * 4 * 2 * side ** 3, False, False, "fixed")
    tok_p = batch * p * p
    add("patch_embed", "bf16", 2 * tok_p * 3 * spec["patch"] ** 2 * d,
        False, True)
    add("hfc_embed", "bf16", 2 * tok_p * spec["patch"] ** 2
        * hf["embed_dim"], False, True)
    e, f = hf["proj_dim"], hf["ffn_dim"]
    add("adaptor", "bf16", 2 * tok_p * hf["embed_dim"] * e, True, True)
    add("adaptor", "bf16", 2 * tok_p * d * e, True, True)
    add("adaptor", "bf16", 3 * 2 * tok_p * e * e, True, True)
    n = p * p
    # the adaptor's scores: the kernel's bf16 in serving, the plain f32
    # path (dropout on the weights) in training
    add("adaptor", "f32" if train and hf["dropout"] > 0 else "bf16",
        2 * batch * n * n * e, True, False, "attention")
    add("adaptor", "bf16", 2 * batch * n * n * e, True, False, "attention")
    add("adaptor", "bf16", 2 * tok_p * e * e, True, True)        # out_proj
    add("adaptor", "bf16", 2 * tok_p * e * f + 2 * tok_p * f * f, True, True)
    add("adaptor", "bf16", 2 * tok_p * f * d, True, True)        # proj_back
    tok = batch * c * c
    for i in range(depth):
        if i in spec["global"]:
            bw, nt, side_t = batch, c * c, c
        else:
            bw, nt, side_t = batch * g["windows"], g["ws"] ** 2, g["ws"]
        add("blocks", "bf16", 2 * tok * d * 3 * d, True, encoder_trains)
        # the decomposed tables: q . R over the rows and the columns
        add("blocks", "bf16", 2 * bw * heads * nt * 2 * side_t * hd, True,
            encoder_trains)
        add("blocks", "bf16", 4 * bw * heads * nt * nt * hd, True, False,
            "attention")
        add("blocks", "bf16", 2 * tok * d * d, True, encoder_trains)
        hidden = int(d * spec["mlp_ratio"])
        add("blocks", "bf16", 4 * tok * d * hidden, True, encoder_trains)
    nk = spec["neck"]
    add("neck", "bf16", 2 * tok * d * nk + 2 * tok * nk * nk * 9, True,
        encoder_trains)
    # the decoder: 51 queries against the c x c image tokens
    cd, q = dec["transformer_dim"], dec["num_queries"]
    inner = cd // dec["attention_downsample_rate"]

    def down_attn(nq, nk_, width):
        add("decoder", "bf16", 2 * batch * (nq * cd * width
                                            + 2 * nk_ * cd * width
                                            + nq * width * cd), True, True)
        add("decoder", "f32", 2 * batch * nq * nk_ * width, True, False,
            "attention")
        add("decoder", "bf16", 2 * batch * nq * nk_ * width, True, False,
            "attention")

    for _ in range(dec["depth"]):
        down_attn(q, q, cd)
        down_attn(q, c * c, inner)
        add("decoder", "bf16", 4 * batch * q * cd * dec["mlp_dim"], True,
            True)
        down_attn(c * c, q, inner)
    down_attn(q, c * c, inner)
    hh = dec["head_hidden_dim"]
    for width in (spec["num_logits"], 4):
        dims = [cd] + [hh] * (dec["head_depth"] - 1) + [width]
        add("decoder", "bf16", sum(2 * batch * q * dims[i] * dims[i + 1]
                                   for i in range(dec["head_depth"])),
            True, True)
    if not train:
        return out
    backward = []
    for op in out:
        if op["kind"] == "fixed":
            continue
        if op["kind"] == "attention":
            if op["x_grad"]:
                backward.append(dict(op, layer=op["layer"] + " backward",
                                     flops=2 * op["flops"]))
            continue
        grad = op["flops"] * (int(op["x_grad"]) + int(op["w_trains"]))
        if grad:
            backward.append(dict(op, layer=op["layer"] + " backward",
                                 flops=grad))
    return out + backward


def least_seconds(ops: List[dict]) -> float:
    """The least time of a list of products, each at its dtype's peak."""
    return sum(o["flops"] / PEAK[o["dtype"]] for o in ops)


def flops_by_dtype(ops: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for o in ops:
        out[o["dtype"]] = out.get(o["dtype"], 0.0) + o["flops"]
    return out


# ---- per-call bounds of the ViT blocks' kernels ---------------------------

def attention_calls(spec: dict, batch: int) -> List[Tuple[int, ...]]:
    """One (rows, heads, tokens, head dim, table width) tuple per call of
    the blocks' attention in a forward: windows of the padded grid, or the
    whole grid in a global block; table width = gh + gw."""
    g = _geometry(spec)
    d, heads = spec["dim"], spec["heads"]
    calls = []
    for i in range(spec["depth"]):
        if i in spec["global"]:
            calls.append((batch, heads, g["c"] ** 2, d // heads,
                          2 * g["c"]))
        else:
            calls.append((batch * g["windows"], heads, g["ws"] ** 2,
                          d // heads, 2 * g["ws"]))
    return calls


def attention_bound(call, backward: bool = False, lse: bool = False) -> float:
    """Least seconds of one attention call (forward, or backward)."""
    rows, heads, n, hd, tw = call
    bh = rows * heads
    scores = bh * n * n
    if backward:
        flops, adds = 10 * scores * hd, 4 * scores
        nbytes = (8 * bh * n * hd * BF16 + bh * n * F32
                  + 2 * bh * n * tw * BF16)
    else:
        flops, adds = 4 * scores * hd, 2 * scores
        nbytes = 4 * bh * n * hd * BF16 + bh * n * tw * BF16 + \
            (bh * n * F32 if lse else 0)
    return max(flops / PEAK["bf16"] + adds / PEAK["f32"],
               nbytes / HBM_BYTES_PER_S)


def mlp_calls(spec: dict, batch: int) -> List[Tuple[int, int, int]]:
    """One (rows, width, hidden) tuple per call of the blocks' MLP."""
    c = _geometry(spec)["c"]
    return [(batch * c * c, spec["dim"], int(spec["dim"] * spec["mlp_ratio"]))
            for _ in range(spec["depth"])]


def mlp_bound(call, backward: bool = False, weights_train: bool = False
              ) -> float:
    """Least seconds of one MLP call: the forward's two products, or the
    backward's input gradient (two products; two more for the weights
    where they train)."""
    r, d, f = call
    weights = 2 * d * f * BF16
    if backward:
        flops = (4 + (4 if weights_train else 0)) * r * d * f
        nbytes = 3 * r * d * BF16 + weights + \
            (weights + f * F32 if weights_train else 0)
    else:
        flops = 4 * r * d * f
        nbytes = 2 * r * d * BF16 + weights + (f + d) * F32
    return max(flops / PEAK["bf16"], nbytes / HBM_BYTES_PER_S)


def per_tile_tflop(spec: dict) -> float:
    return sum(o["flops"] for o in products(spec, 1)) / 1e12

