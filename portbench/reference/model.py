"""The plain reference of WildlifeMapper's forward pass: float32 PyTorch ops
on a dict of named tensors, with no kernel, cache or batching of its own.

It follows SAM's image encoder (segment_anything/modeling/image_encoder.py:
patch embedding, absolute and decomposed relative positions, windowed and
global blocks, neck), WildlifeMapper's HFC adaptor (a centred band-stop
filter of the grey image by FFT, its patch embedding, one cross-attention
layer from patch to HFC tokens with a post-norm FFN) and its 51-query box
decoder (SAM's two-way transformer, class and box heads). Parameters carry
the state-dict names that both this file and the program load; `param_shapes`
lists them. LayerNorm's eps is 1e-6.

`Arith` fixes where values are rounded: `Arith()` computes in float32
throughout; `Arith(fp8=True)` computes in float8 e4m3 with a per-tensor
scale where the program computes in bfloat16: every operand and result of a
product (weights and activations), every softmax, norm and residual sum is
rounded, and so is the gradient that flows back through each of those
points (the HFC filter, norms' statistics and softmax's arithmetic stay
float32, as the program keeps them). That is the precision below the
program's, which the control of the comparison runs. Nothing here
imports the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
GRAY_WEIGHTS = (0.2989, 0.587, 0.114)
LN_EPS = 1e-6
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 (matmuls and cuDNN convolutions)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (amax to 448)."""
    scale = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """The rounding both ways: the value forward, its gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad)


class Arith:
    """Where values are rounded (see the module docstring)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        return self.r(F.linear(self.r(x), self.r(w), b))

    def matmul(self, a, b):
        return self.r(torch.matmul(self.r(a), self.r(b)))

    def softmax(self, x):
        return self.r(torch.softmax(x, -1))


def model_spec(cfg: dict, window_size: Optional[int] = None,
               content_size: Optional[int] = None,
               crop_prologue: bool = False,
               scrambled_reshape: bool = True) -> dict:
    """The forward's settings from a configuration file's numbers and a
    recipe's (window, content crop, prologue crop, the adaptor's reshape)."""
    dec = cfg["decoder"]
    return {
        "dim": cfg["encoder_embed_dim"], "depth": cfg["encoder_depth"],
        "heads": cfg["encoder_num_heads"],
        "global": tuple(cfg["encoder_global_attn_indexes"]),
        "window": window_size or cfg["window_size"],
        "patch": cfg["patch_size"], "img": cfg["image_size"],
        "mlp_ratio": cfg["mlp_ratio"], "neck": cfg["prompt_embed_dim"],
        "hfc": dict(cfg["hfc"]), "dec": dict(dec),
        "num_logits": cfg["num_classes"] + 1,
        "content": content_size, "crop_prologue": crop_prologue,
        "scrambled": scrambled_reshape and not crop_prologue,
    }


def param_shapes(s: dict) -> Dict[str, tuple]:
    """name -> shape of every tensor the model loads, in load order."""
    d, g, hf, dec = s["dim"], s["img"] // s["patch"], s["hfc"], s["dec"]
    p, hd = s["patch"], s["dim"] // s["heads"]
    out = {"image_encoder.pos_embed": (1, g, g, d),
           "image_encoder.patch_embed.proj.weight": (d, 3, p, p),
           "image_encoder.patch_embed.proj.bias": (d,),
           "image_encoder.hfc_embed.proj.weight": (hf["embed_dim"], 1, p, p),
           "image_encoder.hfc_embed.proj.bias": (hf["embed_dim"],)}
    a, e, f = "image_encoder.hfc_attn.", hf["proj_dim"], hf["ffn_dim"]
    out.update({a + "pos_embed": (1, e, g, g),
                a + "proj_hfc.weight": (e, hf["embed_dim"], 1, 1),
                a + "proj_hfc.bias": (e,),
                a + "proj_patch.weight": (e, d, 1, 1),
                a + "proj_patch.bias": (e,),
                a + "cross_attn.in_proj_weight": (3 * e, e),
                a + "cross_attn.in_proj_bias": (3 * e,),
                a + "cross_attn.out_proj.weight": (e, e),
                a + "cross_attn.out_proj.bias": (e,),
                a + "norm1.weight": (e,), a + "norm1.bias": (e,),
                a + "linear1.weight": (f, e), a + "linear1.bias": (f,),
                a + "linear2.weight": (f, f), a + "linear2.bias": (f,),
                a + "norm2.weight": (f,), a + "norm2.bias": (f,),
                a + "proj_back.weight": (d, f, 1, 1),
                a + "proj_back.bias": (d,)})
    hidden = int(d * s["mlp_ratio"])
    for i in range(s["depth"]):
        b = f"image_encoder.blocks.{i}."
        t = g if i in s["global"] else s["window"]
        out.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                    b + "attn.rel_pos_h": (2 * t - 1, hd),
                    b + "attn.rel_pos_w": (2 * t - 1, hd),
                    b + "attn.qkv.weight": (3 * d, d),
                    b + "attn.qkv.bias": (3 * d,),
                    b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                    b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                    b + "mlp.lin1.weight": (hidden, d),
                    b + "mlp.lin1.bias": (hidden,),
                    b + "mlp.lin2.weight": (d, hidden),
                    b + "mlp.lin2.bias": (d,)})
    n = s["neck"]
    out.update({"image_encoder.neck.0.weight": (n, d, 1, 1),
                "image_encoder.neck.1.weight": (n,),
                "image_encoder.neck.1.bias": (n,),
                "image_encoder.neck.2.weight": (n, n, 3, 3),
                "image_encoder.neck.3.weight": (n,),
                "image_encoder.neck.3.bias": (n,),
                "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
                    (2, n // 2)})
    c, inner = dec["transformer_dim"], dec["transformer_dim"] // \
        dec["attention_downsample_rate"]

    def attn(prefix, internal):
        for nm in ("q_proj", "k_proj", "v_proj"):
            out[f"{prefix}.{nm}.weight"] = (internal, c)
            out[f"{prefix}.{nm}.bias"] = (internal,)
        out[f"{prefix}.out_proj.weight"] = (c, internal)
        out[f"{prefix}.out_proj.bias"] = (c,)

    t = "mask_decoder.transformer."
    for i in range(dec["depth"]):
        lay = f"{t}layers.{i}"
        attn(f"{lay}.self_attn", c)
        out[f"{lay}.norm1.weight"], out[f"{lay}.norm1.bias"] = (c,), (c,)
        attn(f"{lay}.cross_attn_token_to_image", inner)
        out[f"{lay}.norm2.weight"], out[f"{lay}.norm2.bias"] = (c,), (c,)
        out[f"{lay}.mlp.lin1.weight"] = (dec["mlp_dim"], c)
        out[f"{lay}.mlp.lin1.bias"] = (dec["mlp_dim"],)
        out[f"{lay}.mlp.lin2.weight"] = (c, dec["mlp_dim"])
        out[f"{lay}.mlp.lin2.bias"] = (c,)
        for nm in ("norm3", "norm4"):
            out[f"{lay}.{nm}.weight"], out[f"{lay}.{nm}.bias"] = (c,), (c,)
        attn(f"{lay}.cross_attn_image_to_token", inner)
    attn(f"{t}final_attn_token_to_image", inner)
    out[f"{t}norm_final_attn.weight"] = (c,)
    out[f"{t}norm_final_attn.bias"] = (c,)
    out["mask_decoder.mask_tokens.weight"] = (dec["num_queries"], c)
    hh = dec["head_hidden_dim"]
    for head, width in (("class_embed", s["num_logits"]), ("bbox_embed", 4)):
        dims = [c] + [hh] * (dec["head_depth"] - 1) + [width]
        for i in range(dec["head_depth"]):
            out[f"mask_decoder.{head}.layers.{i}.weight"] = (dims[i + 1],
                                                            dims[i])
            out[f"mask_decoder.{head}.layers.{i}.bias"] = (dims[i + 1],)
    return out


# ---- layers -----------------------------------------------------------------

def layer_norm(x, P, name, ar: Arith):
    return ar.r(F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                             P[name + ".bias"], LN_EPS))


def normalize(tiles_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalised float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=tiles_u8.device)
    std = torch.tensor(IMAGENET_STD, device=tiles_u8.device)
    return (tiles_u8.float() / 255.0 - mean) / std


def hfc_map(images: torch.Tensor, rate: float) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1): |ifft2(fft2(grey) * band-stop)|, the
    stop band the centred square of side 2 * line of the shifted spectrum."""
    w = torch.tensor(GRAY_WEIGHTS, device=images.device)
    grey = (images * w).sum(-1)
    h, wd = grey.shape[-2:]
    line = int((wd * h * rate) ** 0.5 // 2)
    mask = np.ones((h, wd), np.float32)
    mask[h // 2 - line:h // 2 + line, wd // 2 - line:wd // 2 + line] = 0.0
    mask = torch.from_numpy(np.fft.ifftshift(mask)).to(images.device)
    spec = torch.fft.fft2(grey, norm="forward") * mask
    return torch.fft.ifft2(spec, norm="forward").real.abs()[..., None]


def patch_embed(x, P, name, ar: Arith, patch: int):
    """NHWC -> (B, H/p, W/p, C) by a stride-p convolution."""
    y = F.conv2d(ar.r(x.permute(0, 3, 1, 2)), ar.r(P[name + ".weight"]),
                 P[name + ".bias"], stride=patch)
    return ar.r(y.permute(0, 2, 3, 1))


def conv1x1(x, P, name, ar: Arith):
    w = P[name + ".weight"]
    return ar.linear(x, w[:, :, 0, 0], P.get(name + ".bias"))


def dropout(x, rate, gen):
    """Inverted dropout whose keep mask is torch.rand(x.shape) >= rate drawn
    from `gen`, as the program draws it."""
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def adaptor(hfc_emb, patch_emb, P, s, ar: Arith, gen):
    """The HFC -> patch cross-attention adaptor's output (added by the
    caller); dropout (the adaptor's rate) only with a generator."""
    a, hf = "image_encoder.hfc_attn.", s["hfc"]
    b, g = hfc_emb.shape[:2]
    e, heads, rate = hf["proj_dim"], hf["num_heads"], hf["dropout"]
    pos = P[a + "pos_embed"][:, :, :g, :g].permute(0, 2, 3, 1)
    hfc = (conv1x1(hfc_emb, P, a + "proj_hfc", ar) + pos).reshape(b, g * g, e)
    patch = conv1x1(patch_emb, P, a + "proj_patch", ar).reshape(b, g * g, e)
    w = P[a + "cross_attn.in_proj_weight"]
    bias = P[a + "cross_attn.in_proj_bias"]
    hd, n = e // heads, g * g
    q = ar.linear(patch, w[:e], bias[:e]).reshape(b, n, heads, hd)
    q = q.transpose(1, 2)
    k = ar.linear(hfc, w[e:2 * e], bias[e:2 * e]).reshape(b, n, heads, hd)
    v = ar.linear(hfc, w[2 * e:], bias[2 * e:]).reshape(b, n, heads, hd)
    att = ar.softmax(ar.matmul(q * hd ** -0.5, k.permute(0, 2, 3, 1)))
    att = dropout(att, rate, gen)
    o = ar.matmul(att, v.transpose(1, 2)).transpose(1, 2).reshape(b, n, e)
    src2 = ar.linear(o, P[a + "cross_attn.out_proj.weight"],
                     P[a + "cross_attn.out_proj.bias"])
    patch = layer_norm(patch + dropout(src2, rate, gen), P, a + "norm1", ar)
    h = torch.relu(ar.linear(patch, P[a + "linear1.weight"],
                             P[a + "linear1.bias"]))
    h = dropout(h, rate, gen)
    y = ar.linear(h, P[a + "linear2.weight"], P[a + "linear2.bias"])
    out = layer_norm(y + dropout(patch, rate, gen), P, a + "norm2", ar)
    f = hf["ffn_dim"]
    if s["scrambled"]:
        # the released weights read the (B, HW, F) tokens as (B, F, H, W)
        out = out.reshape(b, f, g, g).permute(0, 2, 3, 1)
    else:
        out = out.reshape(b, g, g, f)
    return conv1x1(out, P, a + "proj_back", ar)


def rel_table(table: torch.Tensor, size: int) -> torch.Tensor:
    """(size, size, C) relative-position rows R[q - k + size - 1] from a
    (2L - 1, C) table, centre-sliced when L > size."""
    if table.shape[0] > 2 * size - 1:
        off = (table.shape[0] + 1) // 2 - size
        table = table[off:off + 2 * size - 1]
    idx = (torch.arange(size)[:, None] - torch.arange(size)[None, :]
           + size - 1).to(table.device)
    return table[idx]


def attention(x, P, name, heads, ar: Arith):
    """x (B', h, w, C) -> multi-head attention with the decomposed rel-pos
    bias of SAM's Attention, projected back to C."""
    b, h, w, c = x.shape
    hd, n = c // heads, h * w
    qkv = ar.linear(x.reshape(b, n, c), P[name + ".qkv.weight"],
                    P[name + ".qkv.bias"])
    qkv = qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                       # (B', H, N, hd)
    rh = rel_table(P[name + ".rel_pos_h"], h)              # (h, h, hd)
    rw = rel_table(P[name + ".rel_pos_w"], w)
    rq = q.reshape(b, heads, h, w, hd)
    bias_h = torch.einsum("bnhwc,hkc->bnhwk", ar.r(rq), ar.r(rh))
    bias_w = torch.einsum("bnhwc,wkc->bnhwk", ar.r(rq), ar.r(rw))
    s = ar.matmul(q * hd ** -0.5, k.transpose(-1, -2)).reshape(
        b, heads, h, w, h, w)
    s = s + bias_h[..., :, None] + bias_w[..., None, :]
    p = ar.softmax(s.reshape(b, heads, n, n))
    o = ar.matmul(p, v).transpose(1, 2).reshape(b, h, w, c)
    return ar.linear(o, P[name + ".proj.weight"], P[name + ".proj.bias"])


def block(x, P, i, s, ar: Arith):
    name = f"image_encoder.blocks.{i}."
    shortcut = x
    x = layer_norm(x, P, name + "norm1", ar)
    if i not in s["global"]:
        ws = s["window"]
        b, h, w, c = x.shape
        ph, pw = (-h) % ws, (-w) % ws
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, w + pw
        x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
        x = attention(x, P, name + "attn", s["heads"], ar)
        x = x.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
    else:
        x = attention(x, P, name + "attn", s["heads"], ar)
    x = ar.r(shortcut + x)
    hmid = F.gelu(ar.linear(layer_norm(x, P, name + "norm2", ar),
                            P[name + "mlp.lin1.weight"],
                            P[name + "mlp.lin1.bias"]))
    return ar.r(x + ar.linear(hmid, P[name + "mlp.lin2.weight"],
                              P[name + "mlp.lin2.bias"]))


def neck(x, P, ar: Arith):
    n = "image_encoder.neck."
    x = ar.linear(x, P[n + "0.weight"][:, :, 0, 0])
    x = layer_norm(x, P, n + "1", ar)
    x = F.conv2d(ar.r(x.permute(0, 3, 1, 2)), ar.r(P[n + "2.weight"]),
                 padding=1).permute(0, 2, 3, 1)
    return layer_norm(x, P, n + "3", ar)


def encoder(images, P, s, ar: Arith, gen=None, remat: bool = False):
    """Normalised NHWC images -> the image embedding (B, g, g, neck)."""
    if s["crop_prologue"] and s["content"]:
        images = images[:, :s["content"], :s["content"]]
    hfc = hfc_map(images, s["hfc"]["rate"])
    g = images.shape[1] // s["patch"]
    x = patch_embed(images, P, "image_encoder.patch_embed.proj", ar,
                    s["patch"])
    x = x + P["image_encoder.pos_embed"][:, :g, :g]
    h = patch_embed(hfc, P, "image_encoder.hfc_embed.proj", ar, s["patch"])
    x = ar.r(adaptor(h, x, P, s, ar, gen) + x)
    cg = s["content"] // s["patch"] if s["content"] else g
    x = x[:, :cg, :cg]
    for i in range(s["depth"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, P, i, s, ar, use_reentrant=False)
        else:
            x = block(x, P, i, s, ar)
    return neck(x, P, ar)


def dense_pe(P, grid: int) -> torch.Tensor:
    gauss = P["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    c = (torch.arange(grid, dtype=torch.float32, device=gauss.device)
         + 0.5) / grid
    y, x = torch.meshgrid(c, c, indexing="ij")
    coords = 2.0 * torch.stack([x, y], -1) - 1.0
    proj = 2.0 * math.pi * (coords @ gauss)
    return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


def down_attention(q, k, v, P, name, heads, ar: Arith):
    q = ar.linear(q, P[name + ".q_proj.weight"], P[name + ".q_proj.bias"])
    k = ar.linear(k, P[name + ".k_proj.weight"], P[name + ".k_proj.bias"])
    v = ar.linear(v, P[name + ".v_proj.weight"], P[name + ".v_proj.bias"])
    b, nq, internal = q.shape
    hd = internal // heads

    def split(t):
        return t.reshape(b, -1, heads, hd).transpose(1, 2)

    att = ar.softmax(ar.matmul(split(q), split(k).transpose(-1, -2))
                     / hd ** 0.5)
    o = ar.matmul(att, split(v)).transpose(1, 2).reshape(b, nq, internal)
    return ar.linear(o, P[name + ".out_proj.weight"],
                     P[name + ".out_proj.bias"])


def decoder(emb, P, s, ar: Arith):
    """Image embedding (B, g, g, C) -> pred_logits (B, Q, L), pred_boxes
    (B, Q, 4) cxcywh in [0, 1]."""
    dec = s["dec"]
    b, g, _, c = emb.shape
    heads = dec["num_heads"]
    pe = dense_pe(P, s["img"] // s["patch"])[:g, :g].reshape(1, g * g, c)
    pe = pe.expand(b, -1, -1)
    tokens = P["mask_decoder.mask_tokens.weight"][None].expand(b, -1, -1)
    queries, keys = tokens, emb.reshape(b, g * g, c)
    t = "mask_decoder.transformer."
    for i in range(dec["depth"]):
        lay = f"{t}layers.{i}"
        if i == 0:
            queries = down_attention(queries, queries, queries, P,
                                     lay + ".self_attn", heads, ar)
        else:
            q = queries + tokens
            queries = queries + down_attention(q, q, queries, P,
                                               lay + ".self_attn", heads, ar)
        queries = layer_norm(queries, P, lay + ".norm1", ar)
        q, k = queries + tokens, keys + pe
        queries = layer_norm(queries + down_attention(
            q, k, keys, P, lay + ".cross_attn_token_to_image", heads, ar),
            P, lay + ".norm2", ar)
        m = ar.linear(torch.relu(ar.linear(queries, P[lay + ".mlp.lin1.weight"],
                                           P[lay + ".mlp.lin1.bias"])),
                      P[lay + ".mlp.lin2.weight"], P[lay + ".mlp.lin2.bias"])
        queries = layer_norm(queries + m, P, lay + ".norm3", ar)
        q, k = queries + tokens, keys + pe
        keys = layer_norm(keys + down_attention(
            k, q, queries, P, lay + ".cross_attn_image_to_token", heads, ar),
            P, lay + ".norm4", ar)
    q, k = queries + tokens, keys + pe
    queries = layer_norm(queries + down_attention(
        q, k, keys, P, t + "final_attn_token_to_image", heads, ar),
        P, t + "norm_final_attn", ar)

    def head(x, name, depth):
        for i in range(depth):
            x = ar.linear(x, P[f"{name}.layers.{i}.weight"],
                          P[f"{name}.layers.{i}.bias"])
            if i < depth - 1:
                x = torch.relu(x)
        return x

    return {"pred_logits": head(queries, "mask_decoder.class_embed",
                                dec["head_depth"]),
            "pred_boxes": torch.sigmoid(head(queries, "mask_decoder.bbox_embed",
                                             dec["head_depth"]))}


def forward(images, P, s, ar: Arith = Arith(), gen=None, remat=False):
    """Normalised NHWC images -> {pred_logits, pred_boxes}, float32."""
    return decoder(encoder(images, P, s, ar, gen, remat), P, s, ar)
