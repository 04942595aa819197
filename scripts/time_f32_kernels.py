"""Every f32 kernel body of the port, timed on one NVIDIA GPU (written for the
H100) beside its library call and its bound: K3's forward and dh at the
shapes `chip_smoke.py` phase 9 times in bf16, and the f32 attention bodies
(K1, K2, K4, K5, K6) forward and backward at the main paths' shapes and at
ViT-H's head dim 80 (K2, K5 on the 64-grid, batch 1; K1 on windows of 14 at
batch 1 and 4, K6 at batch 1). For PERF.md's f32 rows, and for comparing
two checkouts in turns.

    python3 scripts/time_f32_kernels.py [--root CHECKOUT] [--label L]
        [--k3 | --attention | --windows | --k4 | --streaming] [--iters N]
        [--plain]

`--root` is the checkout whose `wildlifemapper_tpu_torch` is imported (this
script's own by default), so that one call can time an older tree with the
same script: run it as parent / change / change / parent. Only what every
tree of the port has is called (the `fused_mlp` and `fused_mlp_dh` wrappers,
`attention_launch`, `attention_backward_launch`), so each body is whatever
that tree runs in f32: from 512 keys at d 64 and 80 the backward of K2 and
K5 is the register-tiled f32 body (csrc/attention_bwd_f32.cuh) where the
tree has one, and so is their forward (csrc/attention_fwd_f32.cuh, on every
grid of gh + gw <= 128) where the tree has it, and the windows' backward
(K1, K6 at d 64 and 80, up to 208 tokens) the f32 window body
(csrc/attention_bwd_f32_window.cuh), and so is their forward
(csrc/attention_fwd_f32_window.cuh) where the tree has it, and K4 (d 128 without tables, from 512
keys) the register-tiled f32 body both ways (csrc/attention_fwd_f32.cuh,
attention_bwd_f32_d128.cuh); the tile body before. `--windows` times the
windows' rows alone (forward and backward), `--k4` K4's (B 4, N = M 4096 and the from-scratch
2304), `--streaming` the streaming rows (K2, K4, K5: ViT-B's at batch 4,
ViT-H's d 80 at batch 1). Every shape is first checked
against its plain version (f32 2e-5 / 1e-4 for the forward outputs, 5e-4 /
1e-3 for a, dh and the attention gradients, the tolerances of record) and
run twice, K3 and the attention backward bit for bit. Then, by CUDA events
over `--iters` launches after a warm-up, each kernel in turns with its
library call (library, kernel, kernel, library):

- K3 forward: `F.linear -> F.gelu -> F.linear` in f32 (cuBLAS SGEMM; TF32
  is off); dh: `F.linear` and the GELU-gradient product. K3's plain
  versions are timed too, after the pairs.
- attention: one `F.scaled_dot_product_attention` with the rel-pos bias as
  `attn_mask`, and autograd through it for dq, dk, dv. Where a tree runs
  the f32 body or the f32 window body, the tile body's backward at the same
  inputs is timed after the pair (`backward_tile_ms`), and where its
  forward runs the f32 body, the tile body's forward (`forward_tile_ms`).
  `--plain` times the plain versions after
  the pairs here too (`forward_plain_ms`, `backward_plain_ms`), which
  `chip_smoke.py` does for its first K2 and K5 shapes (`plain_for`).

The bound is the larger of the f32 operations over 67 TFLOP/s (no tensor
core runs f32 without TF32) and the bytes over 3.35 TB/s, each input read
once and each output written once: K3 forward 4*R*D*F operations, dh
2*R*D*F; attention forward 4*B*H*N*M*d plus the two table adds a score,
backward the five products (10*B*H*N*M*d) plus two adds and two table-
gradient sums a score. One JSON line a shape, the card's name and power
limit first. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PEAK_F32 = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
ITERS = 5

# rows, D, F: ViT-B at batch 4 on the full canvas and the 48-grid, ViT-L the
# same, ViT-H at batch 1 on the full canvas and at batch 4 on the 48-grid
K3_SHAPES = [(16384, 768, 3072), (9216, 768, 3072), (16384, 1024, 4096),
             (9216, 1024, 4096), (4096, 1280, 5120), (9216, 1280, 5120)]
# kernel, shape, batch (B, BW, BH or BWH), heads, head dim, queries, keys,
# rel grid: ViT-B's at batch 4 on the full canvas and the 48-grid (K5 and K6
# one head a row, the scale on the scores)
ATTENTION_SHAPES = [
    ("K1", "BW=4*25 N=196", 100, 12, 64, 196, 196, (14, 14)),
    ("K1", "BW=4*16 N=144", 64, 12, 64, 144, 144, (12, 12)),
    ("K2", "B=4 N=4096", 4, 12, 64, 4096, 4096, (64, 64)),
    ("K2", "B=4 N=2304", 4, 12, 64, 2304, 2304, (48, 48)),
    ("K4", "B=4 N=M=4096", 4, 8, 128, 4096, 4096, None),
    ("K4", "B=4 N=M=2304", 4, 8, 128, 2304, 2304, None),
    ("K5", "BH=4*12 N=4096", 48, 1, 64, 4096, 4096, (64, 64)),
    ("K5", "BH=4*12 N=2304", 48, 1, 64, 2304, 2304, (48, 48)),
    ("K6", "BWH=4*25*12 N=196", 1200, 1, 64, 196, 196, (14, 14)),
    ("K6", "BWH=4*16*12 N=144", 768, 1, 64, 144, 144, (12, 12)),
    # ViT-H's global blocks (head dim 80, 16 heads) at batch 1
    ("K2", "B=1 H=16 N=4096 d=80", 1, 16, 80, 4096, 4096, (64, 64)),
    ("K5", "BH=16 N=4096 d=80", 16, 1, 80, 4096, 4096, (64, 64)),
    # ViT-H's windows (head dim 80, 16 heads) at batch 1 and 4
    ("K1", "BW=25 H=16 N=196 d=80", 25, 16, 80, 196, 196, (14, 14)),
    ("K1", "BW=4*25 H=16 N=196 d=80", 100, 16, 80, 196, 196, (14, 14)),
    ("K6", "BWH=25*16 N=196 d=80", 400, 1, 80, 196, 196, (14, 14)),
]
WINDOW_SHAPES = [s for s in ATTENTION_SHAPES if s[0] in ("K1", "K6")]
K4_SHAPES = [s for s in ATTENTION_SHAPES if s[0] == "K4"]
STREAMING_SHAPES = [s for s in ATTENTION_SHAPES if s[0] in ("K2", "K4", "K5")]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms, from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(library, kernel, iters: int):
    """(library ms, kernel ms), timed library, kernel, kernel, library."""
    a1, b1 = time_ms(library, iters), time_ms(kernel, iters)
    b2, a2 = time_ms(kernel, iters), time_ms(library, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bound(f32_ops: float, nbytes: float):
    """(ms, 'operations' | 'bytes'): the least time the card could take."""
    t_ops = f32_ops / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _check(what, got, want, atol, rtol):
    err = (got - want).abs().max().item()
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: kernel off its plain version by {err}")
    return err


def dh_library(x, w1, b1, da):
    """K3's dh as library calls: F.linear, then the GELU-gradient product."""
    h = F.linear(x, w1, b1)
    cdf = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
    return da * (cdf + h * torch.exp(-0.5 * h * h) * (2.0 * math.pi) ** -0.5)


def k3_rows(dev, iters: int = ITERS, shapes=K3_SHAPES, seed: int = 0,
            plain_for=K3_SHAPES):
    """One dict a shape: K3's f32 forward and dh beside their library calls
    and bounds, after the checks; the plain versions' times too for the
    shapes in `plain_for`."""
    from wildlifemapper_tpu_torch.ops.fused_mlp import (fused_mlp,
                                                         fused_mlp_dh,
                                                         fused_mlp_dh_plain,
                                                         fused_mlp_plain)

    rng = np.random.default_rng(seed)

    def randn(shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(size=shape,
                                                    dtype=np.float32) * s
                                ).to(dev)

    for r, d, f in shapes:
        x, w1, b1 = randn((r, d)), randn((f, d), d ** -0.5), randn((f,), 0.1)
        w2, b2 = randn((d, f), f ** -0.5), randn((d,), 0.1)
        da = randn((r, f))
        with torch.no_grad():
            out = fused_mlp(x, w1, b1, w2, b2)
            act, dh = fused_mlp_dh(x, w1, b1, da)
            again = [fused_mlp(x, w1, b1, w2, b2), *fused_mlp_dh(x, w1, b1,
                                                                 da)]
            torch.cuda.synchronize()
            errs = dict(
                max_abs_err=_check(f"K3 {r} {d} {f}", out,
                                   fused_mlp_plain(x, w1, b1, w2, b2),
                                   2e-5, 1e-4),
                dh_max_abs_err=max(
                    _check(f"K3 dh {r} {d} {f}", g, w, 5e-4, 1e-3)
                    for g, w in zip((act, dh),
                                    fused_mlp_dh_plain(x, w1, b1, da))))
            repeat = all(torch.equal(a, b) for a, b in
                         zip((out, act, dh), again))
            if not repeat:
                raise AssertionError(f"K3 {r} {d} {f}: two runs differ")
            del out, act, dh, again
            chain_ms, fwd_ms = paired_ms(
                lambda: F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2),
                lambda: fused_mlp(x, w1, b1, w2, b2), iters)
            lib_dh_ms, dh_ms = paired_ms(
                lambda: dh_library(x, w1, b1, da),
                lambda: fused_mlp_dh(x, w1, b1, da), iters)
            plain_ms = dh_plain_ms = None
            if (r, d, f) in plain_for:
                plain_ms = time_ms(
                    lambda: fused_mlp_plain(x, w1, b1, w2, b2), iters)
                dh_plain_ms = time_ms(
                    lambda: fused_mlp_dh_plain(x, w1, b1, da), iters)
        fb = bound(4 * r * d * f, nbytes(x, x, w1, b1, w2, b2))
        db = bound(2 * r * d * f, nbytes(x, w1, b1, da, da, da))
        yield dict(kernel="K3", shape=f"R={r} D={d} F={f}", dtype="float32",
                   forward_ms=fwd_ms, library_chain_ms=chain_ms,
                   forward_plain_ms=plain_ms, dh_plain_ms=dh_plain_ms,
                   forward_bound_ms=fb[0], forward_bound_by=fb[1],
                   dh_ms=dh_ms, dh_library_ms=lib_dh_ms, dh_bound_ms=db[0],
                   dh_bound_by=db[1], forward_over_library=fwd_ms / chain_ms,
                   forward_over_bound=fwd_ms / fb[0],
                   dh_over_library=dh_ms / lib_dh_ms,
                   dh_over_bound=dh_ms / db[0], bit_identical=repeat,
                   iters=iters, **errs)
        del x, w1, b1, w2, b2, da
        torch.cuda.empty_cache()


def attention_rows(dev, iters: int = ITERS, shapes=ATTENTION_SHAPES,
                   seed: int = 0, plain_for=()):
    """One dict a shape: an f32 attention body forward and backward (the
    whole backward at the launcher, the rel tables' gradients included)
    beside one SDPA call and autograd through it, and their bounds; where
    the tree runs the f32 body, the tile body's backward too; for the
    (kernel, shape) pairs in `plain_for` the plain versions' times."""
    from wildlifemapper_tpu_torch.ops import _attention
    from wildlifemapper_tpu_torch.ops._attention import (
        attention_backward_launch, attention_backward_plain,
        attention_launch, attention_plain)

    rng = np.random.default_rng(seed)

    def randn(shape, s=1.0):
        return torch.from_numpy(rng.standard_normal(size=shape,
                                                    dtype=np.float32) * s
                                ).to(dev)

    for kid, shape, b, h, d, nq, nk, hw in shapes:
        ss = kid in ("K5", "K6")       # the scale goes on the f32 scores
        c, scale = h * d, d ** -0.5
        q, dout = randn((b, nq, c)), randn((b, nq, c))
        k, v = randn((b, nk, c)), randn((b, nk, c))
        rh = rw = None
        if hw:
            rh, rw = randn((b, nq, h, hw[0]), 0.5), randn((b, nq, h, hw[1]),
                                                          0.5)
        with torch.no_grad():
            out, lse = attention_launch(q, k, v, scale, h, rh, rw,
                                        return_lse=True, scale_scores=ss)
            grads = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                              h, rh, rw, scale_scores=ss)
            again = attention_backward_launch(q, k, v, out, lse, dout, scale,
                                              h, rh, rw, scale_scores=ss)
            torch.cuda.synchronize()
            repeat = all(torch.equal(a, b) for a, b in zip(grads, again)
                         if a is not None)
            if not repeat:
                raise AssertionError(f"{kid} {shape}: two backward runs "
                                     "differ")
            del again
            fwd_repeat = torch.equal(out, attention_launch(
                q, k, v, scale, h, rh, rw, scale_scores=ss))
            if not fwd_repeat:
                raise AssertionError(f"{kid} {shape}: two forward runs differ")
            err = _check(f"{kid} {shape}", out, attention_plain(
                q, k, v, scale, h, rh, rw, scale_scores=ss), 2e-5, 1e-4)
            ref = attention_backward_plain(q, k, v, out, lse, dout, scale, h,
                                           rh, rw, scale_scores=ss)
            bwd_err = max(_check(f"{kid} {shape} backward", g, w, 5e-4, 1e-3)
                          for g, w in zip(grads, ref) if w is not None)
            del ref

        def heads_view(t):
            return t.view(b, t.shape[1], h, d).transpose(1, 2)

        qh, kh, vh = (heads_view(t).detach().requires_grad_()
                      for t in (q, k, v))
        bias = None
        if hw:
            bias = (rh.permute(0, 2, 1, 3)[..., :, None]
                    + rw.permute(0, 2, 1, 3)[..., None, :]
                    ).reshape(b, h, nq, nk).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  scale=scale)

        lib_out = sdpa()
        lib_dout = heads_view(dout)
        with torch.no_grad():
            lib_fwd_ms, fwd_ms = paired_ms(
                sdpa, lambda: attention_launch(q, k, v, scale, h, rh, rw,
                                               scale_scores=ss), iters)
        lib_bwd_ms, bwd_ms = paired_ms(
            lambda: torch.autograd.grad(lib_out, (qh, kh, vh), lib_dout,
                                        retain_graph=True),
            lambda: attention_backward_launch(q, k, v, out, lse, dout, scale,
                                              h, rh, rw, scale_scores=ss),
            iters)
        body, fwd_body = ((_attention.attention_body(
            torch.float32, d, nq, nk, hw is not None, hw, way)
            if "f32" in getattr(_attention, "BODIES", ()) else "mma")
            for way in ("backward", "forward"))
        tile_ms = fwd_tile_ms = plain_ms = fwd_plain_ms = None
        with torch.no_grad():
            if body in ("f32", "f32_window"):
                tile_ms = time_ms(lambda: attention_backward_launch(
                    q, k, v, out, lse, dout, scale, h, rh, rw,
                    scale_scores=ss, body="mma"), max(1, iters // 3))
            if fwd_body != "mma":
                fwd_tile_ms = time_ms(lambda: attention_launch(
                    q, k, v, scale, h, rh, rw, scale_scores=ss, body="mma"),
                    iters)
            if (kid, shape) in plain_for:
                fwd_plain_ms = time_ms(lambda: attention_plain(
                    q, k, v, scale, h, rh, rw, scale_scores=ss), iters)
                plain_ms = time_ms(lambda: attention_backward_plain(
                    q, k, v, out, lse, dout, scale, h, rh, rw,
                    scale_scores=ss), iters)
        mac = b * h * nq * nk * d
        scores = b * h * nq * nk * bool(hw)
        fb = bound(4 * mac + 2 * scores, nbytes(q, k, v, rh, rw, out))
        bb = bound(10 * mac + 4 * scores,
                   nbytes(q, k, v, out, lse, dout, rh, rw, *grads))
        yield dict(kernel=kid, shape=shape, dtype="float32", forward_ms=fwd_ms,
                   forward_library_ms=lib_fwd_ms, forward_bound_ms=fb[0],
                   forward_bound_by=fb[1], backward_ms=bwd_ms,
                   backward_library_ms=lib_bwd_ms, backward_bound_ms=bb[0],
                   backward_bound_by=bb[1],
                   forward_over_library=fwd_ms / lib_fwd_ms,
                   backward_over_library=bwd_ms / lib_bwd_ms,
                   forward_over_bound=fwd_ms / fb[0],
                   backward_over_bound=bwd_ms / bb[0], max_abs_err=err,
                   backward_max_abs_err=bwd_err, backward_body=body,
                   forward_body=fwd_body, backward_bit_identical=repeat,
                   forward_bit_identical=fwd_repeat,
                   backward_tile_ms=tile_ms, forward_tile_ms=fwd_tile_ms,
                   forward_plain_ms=fwd_plain_ms,
                   backward_plain_ms=plain_ms,
                   iters=iters,
                   library="F.scaled_dot_product_attention"
                   + (" with the bias as attn_mask" if hw else ""))
        del q, k, v, dout, rh, rw, out, lse, grads, qh, kh, vh, bias, lib_out
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="checkout whose package is timed")
    ap.add_argument("--label", default="", help="names the run in the output")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--k3", action="store_true", help="K3 alone")
    which.add_argument("--attention", action="store_true",
                       help="the attention bodies alone")
    which.add_argument("--windows", action="store_true",
                       help="the windows' attention rows alone (K1, K6)")
    which.add_argument("--k4", action="store_true",
                       help="K4's attention rows alone (d 128, no tables)")
    which.add_argument("--streaming", action="store_true",
                       help="the streaming attention rows alone (K2, K4, K5)")
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="launches a timing")
    ap.add_argument("--plain", action="store_true",
                    help="also time the attention shapes' plain versions")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    import wildlifemapper_tpu_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(gpu=gpu, label=args.label, root=args.root,
                          package=wildlifemapper_tpu_torch.__file__)),
          flush=True)
    dev = torch.device("cuda")
    rows = []
    if not (args.attention or args.windows or args.k4 or args.streaming):
        rows.append(k3_rows(dev, args.iters))
    if not args.k3:
        shapes = (WINDOW_SHAPES if args.windows else
                  K4_SHAPES if args.k4 else
                  STREAMING_SHAPES if args.streaming else ATTENTION_SHAPES)
        rows.append(attention_rows(dev, args.iters, shapes, plain_for=[
            (s[0], s[1]) for s in shapes] if args.plain else ()))
    for gen in rows:
        for row in gen:
            print(json.dumps(dict(row, label=args.label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
