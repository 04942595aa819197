"""The six forward kernels as PyTorch operators, namespace `wm`.

    wm::windowed_attention_packed   K1   csrc/attention_resident.cu, ...
    wm::flash_attention_packed      K2   csrc/attention_sm90.cu, ...
    wm::fused_mlp                   K3   csrc/mlp_gemm_sm90.cu, fused_mlp.cu
    wm::cross_attention_packed      K4   csrc/attention_sm90.cu, ...
    wm::flash_attention_rel_pos     K5   csrc/grouped_attention_sm90.cu, ...
    wm::windowed_attention_rel_pos  K6   csrc/grouped_attention_resident.cu

On a CUDA tensor each wrapper of ops/ enters its forward kernel through its
operator, and only there; the backward kernels are launched by the
wrappers' autograd functions as before. The attention operators have two
overloads: `default` returns the output, `lse` also the (B, N, H) float32
log-sum-exp the backward needs (H is 1 for the grouped K5 and K6).

Each operator has
  * a CUDA implementation, the launcher (`_attention.attention_launch`,
    `fused_mlp._fused_mlp_launch`) and the launch count: everything that
    reads a real tensor (pointers and their alignment, K3's hidden scratch,
    the TMA tensor maps the C entries encode, the counters) is here, so an
    exported program launches and counts when it runs, not when it is
    traced;
  * a CPU implementation, the plain version, so that `torch.library.opcheck`
    and an export of the operators run without a card (the wrappers
    themselves still call the plain version directly for a CPU tensor);
  * a fake implementation: the outputs' shapes and dtypes only, so that
    torch.export traces through the operator with a symbolic batch
    (`compat/export.py`).

The operators are registered when the package `wildlifemapper_tpu_torch.ops`
is imported, which is what a process that loads an exported program needs.
"""

from __future__ import annotations

import torch

from . import _attention
from .cross_attention import cross_attention_packed
from .flash_attention import flash_attention_rel_pos
from .flash_attention_v2 import flash_attention_packed
from .fused_mlp import _fused_mlp_launch, fused_mlp, fused_mlp_plain
from .windowed_attention import windowed_attention_rel_pos
from .windowed_attention_v2 import _split, windowed_attention_packed

NAMESPACE = "wm"
PACKED = ("windowed_attention_packed", "flash_attention_packed")
GROUPED = ("flash_attention_rel_pos", "windowed_attention_rel_pos")
OPS = (*PACKED, "fused_mlp", "cross_attention_packed", *GROUPED)
WRAPPERS = {f.__name__: f for f in (
    windowed_attention_packed, flash_attention_packed, fused_mlp,
    cross_attention_packed, flash_attention_rel_pos,
    windowed_attention_rel_pos)}

_SCHEMAS = {
    # qkv (B, N, 3C) packed; tables (B, N, H, gh) and (B, N, H, gw)
    "packed": "(Tensor qkv, Tensor rel_h, Tensor rel_w, float scale, "
              "int num_heads)",
    # q (B, N, C); k, v (B, M, C)
    "cross": "(Tensor q, Tensor k, Tensor v, float scale, int num_heads)",
    # q, k, v (BH, N, d); tables (BH, N, 1, gh) and (BH, N, 1, gw) in q's
    # dtype
    "grouped": "(Tensor q, Tensor k, Tensor v, Tensor rel_h, Tensor rel_w, "
               "float scale)",
}
_FAMILY = {"windowed_attention_packed": "packed",
           "flash_attention_packed": "packed",
           "cross_attention_packed": "cross",
           "flash_attention_rel_pos": "grouped",
           "windowed_attention_rel_pos": "grouped"}

_lib = torch.library.Library(NAMESPACE, "DEF")


def _operands(family: str, args):
    """(q, k, v, scale, heads, rel_h, rel_w, scale_scores) of an attention
    operator's arguments."""
    if family == "packed":
        qkv, rel_h, rel_w, scale, heads = args
        return (*_split(qkv), scale, heads, rel_h, rel_w, False)
    if family == "cross":
        q, k, v, scale, heads = args
        return q, k, v, scale, heads, None, None, False
    q, k, v, rel_h, rel_w, scale = args
    return q, k, v, scale, 1, rel_h, rel_w, True


def _attention_impls(name: str):
    family = _FAMILY[name]
    wrapper = WRAPPERS[name]

    def cuda(return_lse):
        def impl(*args):
            q, k, v, scale, heads, rh, rw, scores = _operands(family, args)
            res = _attention.attention_launch(
                q, k, v, scale, heads, rh, rw, return_lse=return_lse,
                scale_scores=scores)
            wrapper.launches += 1
            return res
        return impl

    def cpu(return_lse):
        def impl(*args):
            q, k, v, scale, heads, rh, rw, scores = _operands(family, args)
            res = _attention.attention_plain(
                q, k, v, scale, heads, rh, rw, return_lse=return_lse,
                scale_scores=scores)
            return (res[0], res[1].contiguous()) if return_lse else res
        return impl

    def fake(return_lse):
        def impl(*args):
            q, _, _, _, heads, _, _, _ = _operands(family, args)
            out = q.new_empty(q.shape)
            if not return_lse:
                return out
            return out, q.new_empty((q.shape[0], q.shape[1], heads),
                                    dtype=torch.float32)
        return impl

    return cuda, cpu, fake


def _fused_mlp_cuda(x, w1, b1, w2, b2):
    out = _fused_mlp_launch(x, w1, b1, w2, b2)
    fused_mlp.launches += 1
    return out


def _fused_mlp_fake(x, w1, b1, w2, b2):
    return x.new_empty(x.shape)


# overload -> (schema, CUDA, CPU and fake implementations)
IMPLS = {"fused_mlp": (
    # x (R, D), w1 (F, D), b1 (F,) f32, w2 (D, F), b2 (D,) f32
    "(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) -> Tensor",
    _fused_mlp_cuda, fused_mlp_plain, _fused_mlp_fake)}
for _name in (*PACKED, "cross_attention_packed", *GROUPED):
    _cuda, _cpu, _fake = _attention_impls(_name)
    _schema = _SCHEMAS[_FAMILY[_name]]
    IMPLS[_name] = (_schema + " -> Tensor", _cuda(False), _cpu(False),
                    _fake(False))
    IMPLS[_name + ".lse"] = (_schema + " -> (Tensor, Tensor)", _cuda(True),
                             _cpu(True), _fake(True))
for _overload, (_schema, _cuda, _cpu, _fake) in IMPLS.items():
    _lib.define(_overload + _schema)
    _lib.impl(_overload, _cuda, "CUDA")
    _lib.impl(_overload, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_overload}", _fake,
                                lib=_lib)
