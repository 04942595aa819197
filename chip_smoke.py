"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port's two paths at the full ViT-B width, through its
hand-written CUDA kernels, and checks them: serving (wildlifemapper_tpu_torch:
HFC -> ViT-B -> box decoder -> postprocess + NMS) and training (train/step.py:
forward, set criterion with the Hungarian match, backward through the
backward kernels, clip, AdamW), each in both layouts of the attention
kernels: attn_impl="packed" (K1 windowed, K2 global, K3 MLP, K4 adaptor) and
attn_impl="grouped" (K6 windowed, K5 global, K4; plain MLP). Also serves
ViT-L and ViT-H through the packed kernels (ViT-H also in f32), and trains
the ViT-H fine-tune with remat_blocks at its full width and depth (the path
of the head-dim-80 Hopper and resident backward) in both layouts.
Phases, one JSON line each; any failure raises and exits non-zero:

  1. device: the card's name and power limit; build the kernels from
     wildlifemapper_tpu_torch/csrc (timed), registers and spills of every
     instantiation, the Hopper (wgmma + TMA) and the resident (windowed)
     bodies included, the latter, the Hopper forward and backward, the K3
     GEMM body, the f32 K3 bodies at D 1280 and every head-dim-80
     instantiation (the tile bodies, the Hopper forward and backward, the
     resident forward and backward) held to no spill, and no line of
     ptxas saying it serialized the wgmma products of a kernel (C7515);
     TF32 off.
  2. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it, f32 at atol 2e-5 / rtol 1e-4 and
     bf16 (against the plain version in f32 on the same bf16-rounded
     inputs) at 2e-2, and the bf16 forward of the Hopper body (K2, K4, K5)
     and of the resident body (K1, K6) twice at the launcher at every shape
     it takes, O and the lse bit-identical; K5 and K6 also at d = 128 and 32, where their scale
     on the f32 scores rounds differently from a scaled q; K2, K4 and K5
     also at shapes that are ragged against the Hopper bodies' 128-row
     blocks and 64- or 128-key tiles (N = 1000 on 25x40 and 20x50 grids,
     N != M, a last tile of 6 keys, d = 128 with tables); K1 and K6 also at
     windows that are ragged against the resident bodies' 16-row tiles (49 =
     7x7 with odd table widths, 100 = 10x10, one window-head, a window count
     that is a multiple of nothing); K3 at R = 16384 and 9216 and at rows
     ragged against the GEMM body's 128-row tiles (1, 129, 1000), ViT-L and
     ViT-H widths (f32 at D = 1280 on 16-row tiles); K1,
     K2, K5 and K6 at head dim 80 at ViT-H's shapes (25 windows of 196 and
     4096 tokens, 16 heads, batch 1; bf16 through the Hopper and the
     resident bodies) and ragged against them (K2 on a 25x40 grid, K5 on
     20x50, K1 on windows of 7x7, K6 on 10x10).
  3. end to end: the f32 forward with kernels, in each layout, against the
     PyTorch reference's logits and boxes in tests/goldens/full_model.npz
     (weights regenerated from their names), at atol 1e-4 / rtol 1e-3, and
     the launch counts of one forward (packed: K1 8, K2 4, K3 12, K4 1;
     grouped: K6 8, K5 4, K4 1 and none of the others).
  4. serving: bf16, batch 4, three batches of 768-px content in a 1024
     canvas through forward + postprocess + NMS in each of the three
     configurations (packed) and in full_canvas and from_scratch (grouped),
     each layout a run of its own with the counts set to 0 before and read
     after; finite detections, boxes in range, launch counts; the
     bf16-kernel against f32-plain drift, and grouped against packed.
  5. times: each configuration with kernels and with the plain path, the
     grouped layout beside the packed one, and each kernel against its
     plain version, with CUDA events.
 4b. large models: ViT-B, ViT-L and ViT-H (head dim 80, D 1280) in bf16 at
     batch 1 through the packed kernels (seeded random weights) against the
     plain path with the same weights: finite detections, the image
     embedding's relative error, class-probability and box drift and label
     agreement, ViT-L's and ViT-H's held to limits scaled from ViT-B's; the
     launch counts of each run (ViT-H's d = 80 attention runs the Hopper
     body in its global blocks and the resident body in its windows, K3 the
     GEMM body), the forward's time beside the card's name and power limit.
     Then ViT-B and ViT-H in f32 at batch 1 through the packed kernels (K3's
     scalar body, at D 1280 for ViT-H; the tile attention bodies) against the
     plain path with the same weights, logits and boxes at the full model's
     atol 1e-4 / rtol 1e-3, with their launch counts.
  6. kernels, backward: the forward's lse, and the gradients that autograd
     takes through each public wrapper on the card, against the plain
     backward at the training shapes of both configurations (K1 and K6
     N = 196 and 144; K2, K4 and K5 N = 4096 and 2304; K3 R = 16384 and
     9216, ragged at R = 1000 and at ViT-H's widths; all five attention
     kernels also ragged as in phase 2, K1, K2, K5 and K6 also at head dim
     80 at ViT-H's shapes, K2 and K5 there through the Hopper body both ways
     at N = 4096 and 2304 and ragged (25x40, 20x50), K1 and K6 through the
     resident body both ways at N = 196 and ragged (7x7 with odd tables,
     10x10); K3 in f32 also at ViT-H's widths): once with
     every input requiring a gradient (dqkv written by stride into one
     packed tensor, drel, the MLP's weight gradients; K5 with 4-D and with
     3-D tables) and once with the activations alone
     (the frozen encoder), f32 at atol 5e-4 / rtol 1e-3 and bf16 at 2e-2 of
     each output's largest element; K3's bf16 weight gradients also against
     the f32 product of the same operands. The bf16 backward of the
     resident bodies (K1, K6: one kernel) and of the Hopper body (K2, K4,
     K5: the dq kernel with delta inside, then dk/dv) twice at the launcher
     at every shape they take, every gradient bit-identical.
  7. train step, parity: f32, one step with kernels against the same step on
     the plain path (same weights, batch and dropout seed) in each training
     configuration and each layout: losses, grad_norm and every trainable
     gradient at atol 5e-4 / rtol 1e-3 and within 1e-3 of its own norm;
     launch counts (f32: every attention backward is a dq and a dk/dv
     kernel).
  8. training: bf16, batch 4, three steps on a synthetic uint8 batch in each
     of the two training configurations (train/synthetic.py), once for each
     layout: finite losses, trainable parameters moved and frozen ones
     bit-identical, launch counts forward and backward (bf16: the windowed
     backward of K1 / K6 is one kernel a launch, 8 a step, and no dq or dk/dv
     kernel of theirs runs), peak memory, the loss falling, and one wait for
     the device per step (the matcher's copy).
 8b. the ViT-H fine-tune (train/synthetic.py, variant vit_h: frozen D 1280
     encoder, 32 blocks, 16 heads of 80, seeded weights) with remat_blocks,
     bf16, batch 4, three steps in each layout: finite, falling loss, frozen
     parameters bit-identical, launch counts with the recomputed attention
     forwards counted (K2 / K5 backward on the Hopper body at d = 80, K1 /
     K6 one resident launch a block and no plain delta pass), one wait a
     step, peak memory; the same first
     step without remat_blocks (losses and gradients against it, whether
     bit-identical, its peak memory) and both steps' times in turns.
  9. times, training: ms per step with kernels and on the plain path
     (packed) or beside the packed layout (grouped), the matcher's share,
     each backward kernel against its plain version and against one PyTorch
     library call where there is one (a yardstick here only), the kernels
     that run a Hopper body (K2, K4, K5, forward and backward) or a resident
     body (K1, K6: forward, and the whole backward with the tile bodies'
     delta pass counted in) beside the mma.sync body on the same inputs in
     turns, at the full-canvas shape and, for K1 / K6, at the N = 144 shape
     too, for K2 / K4 / K5 at the N = 2304 shape (the whole backward, dq
     with and without the table gradients, dk/dv), the Hopper forward of
     K2 / K4 / K5 at both shapes over 20 launches a turn with one library
     call over 20 launches and the card's name and power limit beside it
     (`forward_time`), ViT-H's K1, K2, K5 and K6 (head dim 80) at batch 1
     and 4 the same way in turns with the tile body, the whole backward of
     K2 and K5 (the Hopper body) and of K1 and K6 (the resident body) in
     turns with the tile bodies' at batch 1 and 4, beside the plain version
     (batch 1) and the library call; every kernel beside its
     bound (the larger of its FLOPs over 989
     TFLOP/s and its bytes over 3.35 TB/s); K3 forward and dh at R = 16384
     and 9216 (ViT-B) and at ViT-L's and ViT-H's widths over 20 launches in
     turns with their library yardsticks (bf16 F.linear -> F.gelu ->
     F.linear; F.linear and the GELU-gradient product), the forward's two
     passes alone, and the host time of one wrapper call of each.

The last line is {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 4
N_BATCHES = 3
TRAIN_STEPS = 3
PEAK_FLOPS = 989e12   # H100 SXM, bf16 dense
PEAK_BYTES = 3.35e12  # H100 SXM, HBM3
PEAK_F32 = 67e12      # H100 SXM, float32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_query() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


SM90_FLAGS = {"attn_fwd_sm90_kernel": ("scale_scores", "rel"),
              "attn_bwd_dq_sm90_kernel": ("scale_scores", "rel", "drel"),
              "attn_bwd_dkv_sm90_kernel": ("scale_scores", "rel")}


def ptxas_summary(log: str) -> list:
    """'kernel<type,width,...>: registers, spill bytes' for each kernel that
    nvcc's -Xptxas -v compiled. The Hopper bodies are <d, tile, stages> with
    the flags that are set; their register count is the one at entry, before
    setmaxnreg moves the producer's registers to the consumers."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"\d((?:attn|fused_mlp|mlp_dh)[a-z_0-9]*kernel)I(.*?)EEv",
                      line)
        if m and "entry function" in line:
            args = re.findall(r"Li(\d+)", m.group(2))
            flags = re.findall(r"Lb([01])", m.group(2))
            if m.group(2).startswith("f"):
                args.insert(0, "float")
            if m.group(1) in SM90_FLAGS:
                args += [n for n, f in zip(SM90_FLAGS[m.group(1)], flags)
                         if f == "1"]
            elif "1" in flags:             # the grouped family's bodies
                args.append("scale_scores")
            name = f"{m.group(1)}<{','.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return out


def serialized_wgmma(log: str) -> list:
    """The lines of nvcc's -Xptxas -v output that say wgmma products were
    serialized (C7515, or any 'wgmma ... serialized' line), each with the
    kernel it names."""
    return [line.strip() for line in log.splitlines()
            if "C7515" in line or re.search(r"wgmma.*serializ", line)]


def time_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of fn() in ms, from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
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


def paired_ms(fn_a, fn_b, iters: int = 5):
    """Time two versions in turns (a, b, b, a) and average each."""
    a1 = time_ms(fn_a, iters)
    b1 = time_ms(fn_b, iters)
    b2 = time_ms(fn_b, iters)
    a2 = time_ms(fn_a, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call of fn() in microseconds: the wall clock around
    `calls` calls that only queue work for an idle card (no wait between
    them; the queue does not fill), after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bound_ms(flops: float, nbytes: float, f32_flops: float = 0.0):
    """The least time the card could take: (ms, 'operations' | 'bytes').
    `flops` run on the tensor cores in bf16, `f32_flops` outside them."""
    t_ops = (flops / PEAK_FLOPS + f32_flops / PEAK_F32) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_backward_bound(products: int, mac: float, scores: float,
                             tables: bool, table_grads: bool, nbytes: float):
    """bound_ms of an attention backward (or of one of its kernels) that
    needs `products` products of `mac` multiply-adds each (the whole
    backward five: S, dP, dV, dK, dQ; a design that computes S and dP in
    two kernels does more, which is not counted) and, with rel tables, the
    two table entries added to each of its `scores` scores and, with their
    gradients, each score's dS summed into the two tables' gradients, in
    f32 outside the tensor cores."""
    f32 = scores * (2 * tables + 2 * table_grads)
    return bound_ms(2 * products * mac, nbytes, f32)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2

    # by path: an installed package named "tests" may shadow the repo's
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from golden_common import meta_to_state_dict, padded_canvas
    from wildlifemapper_tpu_torch.config import model_config
    from wildlifemapper_tpu_torch.eval.postprocess import (batched_nms,
                                                           postprocess)
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.ops import _attention, _build
    from wildlifemapper_tpu_torch.ops._attention import (
        _backward_kernel_launch, _sm90_backward_launch,
        attention_backward_launch, attention_backward_plain, attention_body,
        attention_delta, attention_launch, attention_plain, sm90_scratch)
    from wildlifemapper_tpu_torch.ops.cross_attention import (
        cross_attention_packed, cross_attention_packed_plain)
    from wildlifemapper_tpu_torch.ops.flash_attention import (
        flash_attention_rel_pos, grouped_attention_backward_plain,
        grouped_attention_plain)
    from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
        flash_attention_packed, flash_attention_packed_plain)
    from wildlifemapper_tpu_torch.ops.fused_mlp import (
        _BIAS, _BIAS_GELU, _gemm, fused_mlp, fused_mlp_backward_plain,
        fused_mlp_dh, fused_mlp_dh_plain, fused_mlp_plain)
    from wildlifemapper_tpu_torch.ops.windowed_attention import \
        windowed_attention_rel_pos
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
        windowed_attention_packed, windowed_attention_packed_plain)
    from wildlifemapper_tpu_torch.train.criterion import hungarian_match
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.train.synthetic import (synthetic_batch,
                                                          training_config)
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    gpu = gpu_query()

    # ---- 1. device ---------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    build_log = (lib_path.parent / "build.log").read_text()
    ptxas = ptxas_summary(build_log)
    emit("device", kind=kind, gpu=gpu, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(build_s, 2), ptxas=ptxas)
    # the resident forward and backward at d = 64 and 80, two instantiations
    # (key tiles) each in each family
    resident_ptxas = [line for line in ptxas if "resident_kernel" in line]
    spilling = [line for line in resident_ptxas if ", 0 B spilled" not in line]
    if len(resident_ptxas) < 16 or spilling:
        raise AssertionError(f"resident bodies: {len(resident_ptxas)} ptxas "
                             f"lines, spilling: {spilling}")
    # the K3 GEMM body's instantiations and the f32 K3 bodies at D 1280 (the
    # forward on 16-row tiles, dh); head dim 80: the tile bodies (the
    # f32 forward, the bf16 and f32 backward), the Hopper forward (with and
    # without tables), the Hopper backward (the dq kernel with tables and
    # table gradients, with tables, without; the dk/dv kernel with and
    # without tables) and the resident forward and backward (two key-tile
    # counts each), each in both families; the Hopper forward's seven a
    # family and the Hopper backward's fifteen
    gemm_ptxas = [line for line in ptxas if "fused_mlp_gemm_sm90" in line]
    k3_f32_d1280 = [line for line in ptxas if line.startswith(
        ("fused_mlp_kernel<float,40,16>", "mlp_dh_kernel<1280>"))]
    d80 = {"tile": [], "hopper": [], "resident": []}
    for line in ptxas:
        if re.search(r"kernel<(float,)?80[,>]", line):
            d80["hopper" if "_sm90_" in line else
                "resident" if "resident" in line else "tile"].append(line)
    fwd_ptxas = [line for line in ptxas
                 if line.startswith("attn_fwd_sm90")]
    bwd_ptxas = [line for line in ptxas
                 if line.startswith(("attn_bwd_dq_sm90", "attn_bwd_dkv_sm90"))]
    spilling = [line for line in gemm_ptxas + k3_f32_d1280
                + sum(d80.values(), []) + fwd_ptxas + bwd_ptxas
                if ", 0 B spilled" not in line]
    emit("ptxas_held_to_no_spill", gemm=gemm_ptxas,
         k3_f32_d1280=k3_f32_d1280, head_dim_80=d80,
         hopper_forward=fwd_ptxas, hopper_backward=bwd_ptxas)
    if (len(gemm_ptxas) < 3 or len(k3_f32_d1280) < 2
            or len(d80["tile"]) < 12
            or len(d80["hopper"]) < 14 or len(d80["resident"]) < 8
            or len(fwd_ptxas) < 14 or len(bwd_ptxas) < 30 or spilling):
        raise AssertionError(f"K3 GEMM body: {len(gemm_ptxas)} ptxas lines, "
                             f"f32 K3 at D 1280: {len(k3_f32_d1280)}, "
                             f"d = 80 bodies: "
                             f"{ {k: len(v) for k, v in d80.items()} }, "
                             f"Hopper forward: {len(fwd_ptxas)}, backward: "
                             f"{len(bwd_ptxas)}, spilling: {spilling}")
    # ptxas says only in an info line (C7515) that it serialized every wgmma
    # of a kernel, which undoes what the Hopper bodies stand on
    serialized = serialized_wgmma(build_log)
    emit("ptxas_serialized_wgmma", lines=serialized)
    if serialized:
        raise AssertionError("ptxas serialized the wgmma products: "
                             + " | ".join(serialized))

    kernels = {
        "windowed_attention_packed": dict(
            wrapper=windowed_attention_packed,
            plain=windowed_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention_resident.cu",
            replaces="wildlifemapper_tpu/ops/windowed_attention_v2.py:200"),
        "flash_attention_packed": dict(
            wrapper=flash_attention_packed,
            plain=flash_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/flash_attention_v2.py:183"),
        "fused_mlp": dict(
            wrapper=fused_mlp, plain=fused_mlp_plain,
            source="wildlifemapper_tpu_torch/csrc/mlp_gemm_sm90.cu",
            replaces="wildlifemapper_tpu/ops/fused_mlp.py:97"),
        "cross_attention_packed": dict(
            wrapper=cross_attention_packed,
            plain=cross_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/cross_attention.py:150"),
        "flash_attention_rel_pos": dict(
            wrapper=flash_attention_rel_pos, plain=grouped_attention_plain,
            source="wildlifemapper_tpu_torch/csrc/grouped_attention.cu",
            replaces="wildlifemapper_tpu/ops/flash_attention.py:207"),
        "windowed_attention_rel_pos": dict(
            wrapper=windowed_attention_rel_pos, plain=grouped_attention_plain,
            source="wildlifemapper_tpu_torch/csrc/"
                   "grouped_attention_resident.cu",
            replaces="wildlifemapper_tpu/ops/windowed_attention.py:111"),
    }

    # ---- 2. kernels against their plain versions ---------------------------
    rng = np.random.default_rng(0)

    def randn(shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(size=shape, dtype=np.float32) * scale)
        ).to(dev)

    def attn_args(bw, hw, heads=12, d=64):
        n = hw[0] * hw[1]
        return [randn((bw, n, 3 * heads * d)),
                randn((bw, n, heads, hw[0]), 0.5),
                randn((bw, n, heads, hw[1]), 0.5), d ** -0.5, heads, hw]

    def grouped_args(bh, hw, d=64):
        """q, k, v (BH, N, d) per head and the (BH, N, g) tables, as the
        grouped layout hands them to K5 and K6."""
        n = hw[0] * hw[1]
        return [randn((bh, n, d)), randn((bh, n, d)), randn((bh, n, d)),
                randn((bh, n, hw[0]), 0.5), randn((bh, n, hw[1]), 0.5),
                d ** -0.5, hw]

    def mlp_args(r, d=768, f=3072):
        return [randn((r, d)), randn((f, d), d ** -0.5), randn((f,), 0.1),
                randn((d, f), f ** -0.5), randn((d,), 0.1)]

    def launcher_args(name, args):
        """An attention wrapper's arguments as the launcher takes them: q, k,
        v, scale, heads, the tables (the grouped family's as (BH, N, 1, g))
        and where the scale enters; None for K3."""
        if name in ("flash_attention_packed", "windowed_attention_packed"):
            qkv, rh, rw, scale, heads, _ = args
            q, k, v = qkv.chunk(3, dim=-1)
            return (q, k, v, scale, heads, rh, rw), {}
        if name == "cross_attention_packed":
            q, k, v, scale, heads = args
            return (q, k, v, scale, heads, None, None), {}
        if name in ("flash_attention_rel_pos", "windowed_attention_rel_pos"):
            q, k, v, rh, rw, scale, _ = args
            return ((q, k, v, scale, 1, rh[:, :, None], rw[:, :, None]),
                    dict(scale_scores=True))
        return None

    def forward_repeat(name, shape, args):
        """The Hopper or the resident forward twice on the same operands,
        with the lse: every output element has one owner and a fixed order
        of sums, so O and the lse are bit-identical."""
        la = launcher_args(name, args)
        if la is None:
            return
        (q, k, v, scale, heads, rh, rw), kw = la
        body = attention_body(q.dtype, q.shape[-1] // heads, q.shape[1],
                              k.shape[1], rh is not None,
                              None if rh is None else (rh.shape[-1],
                                                       rw.shape[-1]))
        if body == "mma":
            return
        first = attention_launch(*la[0], return_lse=True, **kw)
        second = attention_launch(*la[0], return_lse=True, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        emit("forward_repeat", kernel=name, shape=shape, body=body,
             bit_identical=same, outputs=["out", "lse"])
        if not same:
            raise AssertionError(f"{name} {shape}: two forward runs differ")

    c, hd = 1024, 128
    cases = [
        ("windowed_attention_packed", "BW=4*25 N=196",
         lambda: attn_args(4 * 25, (14, 14))),
        ("windowed_attention_packed", "BW=4*16 N=144",
         lambda: attn_args(4 * 16, (12, 12))),
        ("flash_attention_packed", "B=4 N=4096", lambda: attn_args(4, (64, 64))),
        ("flash_attention_packed", "B=4 N=2304", lambda: attn_args(4, (48, 48))),
        ("fused_mlp", "R=4*4096", lambda: mlp_args(4 * 4096)),
        ("fused_mlp", "R=4*2304", lambda: mlp_args(4 * 2304)),
        ("cross_attention_packed", "B=4 N=M=4096",
         lambda: [randn((4, 4096, c)), randn((4, 4096, c)),
                  randn((4, 4096, c)), hd ** -0.5, c // hd]),
        ("cross_attention_packed", "B=4 N=M=2304",
         lambda: [randn((4, 2304, c)), randn((4, 2304, c)),
                  randn((4, 2304, c)), hd ** -0.5, c // hd]),
        ("windowed_attention_rel_pos", "BWH=4*25*12 N=196",
         lambda: grouped_args(4 * 25 * 12, (14, 14))),
        ("windowed_attention_rel_pos", "BWH=4*16*12 N=144",
         lambda: grouped_args(4 * 16 * 12, (12, 12))),
        ("flash_attention_rel_pos", "BH=4*12 N=4096",
         lambda: grouped_args(4 * 12, (64, 64))),
        ("flash_attention_rel_pos", "BH=4*12 N=2304",
         lambda: grouped_args(4 * 12, (48, 48))),
        # d = 128 and 32: scaling the f32 scores and scaling q before the
        # product round differently in bf16 (they agree at d = 64)
        ("flash_attention_rel_pos", "BH=8 N=2304 d=128",
         lambda: grouped_args(8, (48, 48), d=128)),
        ("windowed_attention_rel_pos", "BWH=96 N=196 d=32",
         lambda: grouped_args(96, (14, 14), d=32)),
        # ragged against the 128-row blocks and the 64- and 128-key tiles of
        # the Hopper bodies: grids that are no multiple of 8, N != M, a last
        # tile that is nearly empty, d = 128 with rel tables
        ("flash_attention_packed", "B=2 H=3 N=1000 (25x40)",
         lambda: attn_args(2, (25, 40), heads=3)),
        ("flash_attention_rel_pos", "BH=6 N=1000 (20x50)",
         lambda: grouped_args(6, (20, 50))),
        ("flash_attention_rel_pos", "BH=4 N=513 (27x19) d=128",
         lambda: grouped_args(4, (27, 19), d=128)),
        ("cross_attention_packed", "B=2 N=200 M=1000",
         lambda: [randn((2, 200, c)), randn((2, 1000, c)),
                  randn((2, 1000, c)), hd ** -0.5, c // hd]),
        ("cross_attention_packed", "B=1 N=300 M=1030",
         lambda: [randn((1, 300, c)), randn((1, 1030, c)),
                  randn((1, 1030, c)), hd ** -0.5, c // hd]),
        # ragged against the 16-row tiles of the resident bodies: odd table
        # widths, a window of 100, one window-head, 37 windows of 3 heads
        ("windowed_attention_packed", "BW=3 H=3 N=49 (7x7)",
         lambda: attn_args(3, (7, 7), heads=3)),
        ("windowed_attention_packed", "BW=37 H=3 N=100 (10x10)",
         lambda: attn_args(37, (10, 10), heads=3)),
        ("windowed_attention_packed", "BW=1 H=1 N=196",
         lambda: attn_args(1, (14, 14), heads=1)),
        ("windowed_attention_rel_pos", "BWH=7 N=49 (7x7)",
         lambda: grouped_args(7, (7, 7))),
        ("windowed_attention_rel_pos", "BWH=111 N=100 (10x10)",
         lambda: grouped_args(111, (10, 10))),
        ("windowed_attention_rel_pos", "BWH=1 N=144",
         lambda: grouped_args(1, (12, 12))),
        # ragged against the K3 GEMM body's 128-row tiles and 256-column
        # tiles; ViT-L and ViT-H widths (f32: 16-row tiles at D = 1280)
        ("fused_mlp", "R=1000", lambda: mlp_args(1000)),
        ("fused_mlp", "R=129 D=1024 F=4096", lambda: mlp_args(129, 1024, 4096)),
        ("fused_mlp", "R=1 D=1280 F=5120", lambda: mlp_args(1, 1280, 5120)),
        ("fused_mlp", "R=1000 D=1280 F=5120",
         lambda: mlp_args(1000, 1280, 5120)),
        # head dim 80 (ViT-H: D 1280, 16 heads) at ViT-H's serving shapes
        # at batch 1: bf16 through the Hopper and the resident bodies, f32
        # through the tile bodies; then ragged against the Hopper body's
        # blocks and tiles (grids no multiple of 8) and the resident body's
        # 16-row tiles (odd table widths, a window of 100)
        ("windowed_attention_packed", "BW=25 H=16 N=196 d=80 (ViT-H)",
         lambda: attn_args(25, (14, 14), heads=16, d=80)),
        ("flash_attention_packed", "B=1 H=16 N=4096 d=80 (ViT-H)",
         lambda: attn_args(1, (64, 64), heads=16, d=80)),
        ("windowed_attention_rel_pos", "BWH=25*16 N=196 d=80",
         lambda: grouped_args(25 * 16, (14, 14), d=80)),
        ("flash_attention_rel_pos", "BH=16 N=4096 d=80",
         lambda: grouped_args(16, (64, 64), d=80)),
        ("flash_attention_packed", "B=2 H=3 N=1000 (25x40) d=80",
         lambda: attn_args(2, (25, 40), heads=3, d=80)),
        ("flash_attention_rel_pos", "BH=6 N=1000 (20x50) d=80",
         lambda: grouped_args(6, (20, 50), d=80)),
        ("windowed_attention_packed", "BW=3 H=3 N=49 (7x7) d=80",
         lambda: attn_args(3, (7, 7), heads=3, d=80)),
        ("windowed_attention_rel_pos", "BWH=10 N=100 (10x10) d=80",
         lambda: grouped_args(10, (10, 10), d=80)),
    ]
    # fused_mlp keeps its biases in f32 whatever the compute dtype
    f32_positions = {"fused_mlp": (2, 4)}
    tol = {torch.float32: dict(atol=2e-5, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
    errors = {name: 0.0 for name in kernels}
    kernel_inputs = {}
    with torch.inference_mode():
        for name, shape, make in cases:
            base = make()
            for dt in (torch.float32, torch.bfloat16):
                keep32 = f32_positions.get(name, ())
                args = [a.to(dt) if torch.is_tensor(a) and i not in keep32
                        else a for i, a in enumerate(base)]
                got = kernels[name]["wrapper"](*args)
                torch.cuda.synchronize()
                ref = kernels[name]["plain"](*[
                    a.float() if torch.is_tensor(a) else a for a in args])
                err = (got.float() - ref).abs().max().item()
                bad = ~torch.isclose(got.float(), ref, **tol[dt])
                emit("kernel_check", kernel=name, shape=shape,
                     dtype=str(dt).replace("torch.", ""), max_abs_err=err,
                     atol=tol[dt]["atol"], rtol=tol[dt]["rtol"],
                     mismatched=int(bad.sum().item()))
                if bad.any() or not torch.isfinite(got).all():
                    raise AssertionError(f"{name} {shape} {dt}: kernel "
                                         f"disagrees with its plain version "
                                         f"(max abs err {err})")
                errors[name] = max(errors[name], err)
                if dt == torch.bfloat16:
                    forward_repeat(name, shape, args)
                if dt == torch.bfloat16 and name not in kernel_inputs:
                    kernel_inputs[name] = (shape, args)
            del base, args, got, ref
            torch.cuda.empty_cache()

    count_names = ("launches", "backward_launches", "backward_dq_launches",
                   "backward_dkv_launches")

    def counts(attr="launches"):
        return {n: getattr(k["wrapper"], attr) for n, k in kernels.items()
                if hasattr(k["wrapper"], attr)}

    def reset_counts():
        for k in kernels.values():
            for attr in count_names:
                if hasattr(k["wrapper"], attr):
                    setattr(k["wrapper"], attr, 0)
        fused_mlp.kernel_launches = 0

    def check_mlp_kernels(what, per_call):
        """K3's kernel launches of a run: per_call for each wrapper call
        (bf16: the GEMM body's two passes; f32: the fused scalar body)."""
        got, calls = fused_mlp.kernel_launches, fused_mlp.launches
        emit("mlp_kernel_launches", path=what, wrapper_calls=calls,
             kernel_launches=got, want=per_call * calls)
        if got != per_call * calls:
            raise AssertionError(f"{what}: {got} K3 kernel launches for "
                                 f"{calls} calls, want {per_call} a call")

    # launches of one forward: the packed layout (K1, K2, K3, K4) and the
    # grouped one (K6, K5, K4; its MLP is the plain one)
    per_forward = {
        "packed": {"windowed_attention_packed": 8,
                   "flash_attention_packed": 4, "fused_mlp": 12,
                   "cross_attention_packed": 1, "flash_attention_rel_pos": 0,
                   "windowed_attention_rel_pos": 0},
        "grouped": {"windowed_attention_packed": 0,
                    "flash_attention_packed": 0, "fused_mlp": 0,
                    "cross_attention_packed": 1, "flash_attention_rel_pos": 4,
                    "windowed_attention_rel_pos": 8}}

    def check_launches(what, got, want):
        """The counts of one run of a path: exactly `want`, and every kernel
        of the path launched."""
        emit("path_launches", path=what, launches=got, want=want)
        if got != want or not any(want.values()):
            raise AssertionError(f"{what}: launches {got}, want {want}")

    # ---- 3. end to end against the PyTorch reference -----------------------
    npz = np.load(Path(__file__).resolve().parent / "tests" / "goldens"
                  / "full_model.npz")
    golden_sd = meta_to_state_dict(npz["meta"])
    x = torch.from_numpy(padded_canvas(seed=107)).to(dev)
    for layout in ("packed", "grouped"):
        model = WildlifeMapper(model_config(
            "vit_b", use_flash_attention=True, attn_impl=layout))
        load_reference_state_dict(model, golden_sd)
        model.eval()
        reset_counts()
        with torch.inference_mode():
            out = model(x)
            torch.cuda.synchronize()
        e2e_counts = counts()
        d_logits = float(np.abs(out["pred_logits"].cpu().numpy()
                                - npz["logits"]).max())
        d_boxes = float(np.abs(out["pred_boxes"].cpu().numpy()
                               - npz["boxes"]).max())
        emit("end_to_end", config=f"vit_b f32 full canvas, {layout} kernels",
             max_abs_diff_logits=d_logits, max_abs_diff_boxes=d_boxes,
             atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(out["pred_logits"].cpu().numpy(),
                                   npz["logits"], atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(out["pred_boxes"].cpu().numpy(),
                                   npz["boxes"], atol=1e-4, rtol=1e-3)
        check_launches(f"one f32 forward, {layout}", e2e_counts,
                       per_forward[layout])
        check_mlp_kernels(f"one f32 forward, {layout}", 1)
        del model, out
        torch.cuda.empty_cache()

    # ---- 4. serving in bf16: the main path ---------------------------------
    base_cfg = model_config("vit_b", dtype="bfloat16",
                            use_flash_attention=True)
    scratch = dataclasses.replace(
        base_cfg, content_size=768, crop_prologue=True,
        vit=dataclasses.replace(base_cfg.vit, window_size=12),
        hfc=dataclasses.replace(base_cfg.hfc, compat_scrambled_reshape=False))
    configs = {
        "full_canvas": base_cfg,
        "compat_crop": dataclasses.replace(base_cfg, content_size=768),
        "from_scratch": scratch,
    }

    def make_batch(seed):
        xb = np.zeros((BATCH, 1024, 1024, 3), np.float32)
        xb[:, :768, :768, :] = np.random.default_rng(seed).standard_normal(
            size=(BATCH, 768, 768, 3), dtype=np.float32)
        return torch.from_numpy(xb).to(dev)

    batches = [make_batch(100 + i) for i in range(N_BATCHES)]
    sizes = torch.full((BATCH, 2), 1024, dtype=torch.int32, device=dev)

    def build(cfg):
        m = WildlifeMapper(cfg)
        load_reference_state_dict(m, golden_sd)
        return m.eval()

    def serve(m, images):
        out = m(images)
        dets = postprocess(out, sizes, confidence_threshold=0.05)
        dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                   dets["labels"], dets["keep"], 0.4,
                                   class_aware=False)
        return out, dets

    def serve_all(ms):
        """One run of a serving path: the counts set to 0 just before it and
        read just after."""
        reset_counts()
        outs = {}
        with torch.inference_mode():
            for name, m in ms.items():
                outs[name] = [serve(m, xb) for xb in batches]
                torch.cuda.synchronize()
        return outs, counts()

    # the grouped layout serves the two configurations whose shapes differ:
    # N = 196 / 4096 and N = 144 / 2304
    grouped_configs = {
        name: dataclasses.replace(configs[name], attn_impl="grouped")
        for name in ("full_canvas", "from_scratch")}
    models = {name: build(cfg) for name, cfg in configs.items()}
    grouped_models = {name: build(cfg)
                      for name, cfg in grouped_configs.items()}
    served, main_counts = serve_all(models)
    check_mlp_kernels("serving, packed", 2)
    serving_mlp_kernel_launches = fused_mlp.kernel_launches
    grouped_served, grouped_counts = serve_all(grouped_models)
    for name, outs in list(served.items()) + [
            (f"{n} grouped", o) for n, o in grouped_served.items()]:
        for out, dets in outs:
            pb, bx = out["pred_boxes"], dets["boxes"]
            ok = (torch.isfinite(out["pred_logits"]).all()
                  and torch.isfinite(bx).all()
                  and pb.min() >= 0 and pb.max() <= 1
                  and bx.min() >= -512 and bx.max() <= 1536)
            if not ok:
                raise AssertionError(f"{name}: non-finite or out-of-range "
                                     "detections")
        keep = sum(int(d["keep"].sum()) for _, d in outs)
        emit("serving", config=name, batch=BATCH, batches=len(outs),
             detections_kept=keep,
             pred_shape=list(outs[0][0]["pred_logits"].shape))
    check_launches("serving, packed", main_counts, {
        n: v * N_BATCHES * len(configs)
        for n, v in per_forward["packed"].items()})
    check_launches("serving, grouped", grouped_counts, {
        n: v * N_BATCHES * len(grouped_configs)
        for n, v in per_forward["grouped"].items()})

    def drift(out, ref):
        p_a = torch.softmax(out["pred_logits"].float(), -1)[..., :-1]
        p_b = torch.softmax(ref["pred_logits"].float(), -1)[..., :-1]
        return dict(
            max_class_prob_diff=(p_a - p_b).abs().max().item(),
            max_box_diff_px=((out["pred_boxes"].float()
                              - ref["pred_boxes"].float())
                             .abs().max().item() * 1024),
            label_agreement=(p_a.argmax(-1) == p_b.argmax(-1))
            .float().mean().item())

    # the two layouts are one function: same weights, same batch, bf16
    for name, outs in grouped_served.items():
        emit("grouped_against_packed", config=name, dtype="bfloat16",
             **drift(outs[0][0], served[name][0][0]))

    # bf16 with kernels against f32 on the plain path, same weights/input
    with torch.inference_mode():
        for name, cfg in configs.items():
            ref_m = build(dataclasses.replace(cfg, dtype="float32",
                                              use_flash_attention=False))
            ref = ref_m(batches[0])
            emit("bf16_drift", config=name,
                 **drift(served[name][0][0], ref))
            if name in grouped_served:
                emit("bf16_drift", config=f"{name} grouped",
                     **drift(grouped_served[name][0][0], ref))
            del ref_m, ref
            torch.cuda.empty_cache()

    import torch.nn.functional as F

    def heads_view(t, heads):
        b, n, cw = t.shape
        return t.view(b, n, heads, cw // heads).transpose(1, 2)

    def sdpa_pair(q, k, v, rh, rw, heads, scale):
        """(forward fn, backward fn) of one scaled_dot_product_attention
        call on the same inputs, the decomposed bias built beforehand and
        passed as attn_mask: the library's yardstick, used nowhere in the
        port. The backward is autograd through that call for dq, dk, dv."""
        qh, kh, vh = (heads_view(t, heads).detach().requires_grad_()
                      for t in (q, k, v))
        bias = None
        if rh is not None:
            b, n = q.shape[:2]
            bias = (rh.permute(0, 2, 1, 3)[..., :, None]
                    + rw.permute(0, 2, 1, 3)[..., None, :]
                    ).reshape(b, heads, n, -1).contiguous()

        def fwd():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                  scale=scale)

        out = fwd()
        dout = torch.randn_like(out)
        return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), dout,
                                                retain_graph=True)

    # ---- 4b. large models: ViT-L and ViT-H through the packed kernels ------
    # Seeded random weights (no checkpoint is at hand); the plain path gets
    # the same weights. ViT-H's head dim 80 runs the Hopper body in its
    # global blocks and the resident body in its windows, its D 1280 the K3
    # GEMM body.
    sizes1 = sizes[:1]

    def serve1(m, images):
        out = m(images)
        dets = postprocess(out, sizes1, confidence_threshold=0.05)
        dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                   dets["labels"], dets["keep"], 0.4,
                                   class_aware=False)
        return out, dets

    x1 = batches[0][:1]
    drift_b = None          # ViT-B's, in the same setting: the limits' scale
    for variant in ("vit_b", "vit_l", "vit_h"):
        cfg = model_config(variant, dtype="bfloat16", use_flash_attention=True)
        kern_m = WildlifeMapper(
            cfg, generator=torch.Generator(device=dev).manual_seed(0)).eval()
        plain_m = WildlifeMapper(dataclasses.replace(
            cfg, use_flash_attention=False)).eval()
        plain_m.load_state_dict(kern_m.state_dict())
        v = cfg.vit
        d = v.embed_dim // v.num_heads
        glob = len(v.global_attn_indexes)
        # the encoder's output (the image embedding) of each path
        emb = {}
        hooks = [m.image_encoder.register_forward_hook(
            lambda mod, args, out, key=key: emb.__setitem__(key, out.float()))
            for key, m in (("kernels", kern_m), ("plain", plain_m))]
        reset_counts()                 # the large model's run starts here
        with torch.inference_mode():
            out, dets = serve1(kern_m, x1)
            torch.cuda.synchronize()
        check_launches(f"{variant} bf16 serving, batch 1", counts(),
                       {"windowed_attention_packed": v.depth - glob,
                        "flash_attention_packed": glob,
                        "fused_mlp": v.depth, "cross_attention_packed": 1,
                        "flash_attention_rel_pos": 0,
                        "windowed_attention_rel_pos": 0})
        check_mlp_kernels(f"{variant} bf16 serving, batch 1", 2)
        n_win, n_glob = v.window_size ** 2, cfg.grid_size ** 2
        bodies = {
            "windowed": attention_body(torch.bfloat16, d, n_win, n_win, True,
                                       (v.window_size, v.window_size)),
            "global": attention_body(torch.bfloat16, d, n_glob, n_glob, True,
                                     (cfg.grid_size, cfg.grid_size))}
        if bodies != {"windowed": "resident", "global": "sm90"}:
            raise AssertionError(f"{variant}: bf16 forward bodies {bodies}")
        with torch.inference_mode():
            ref, _ = serve1(plain_m, x1)
            for h in hooks:
                h.remove()
            ms_plain, ms_kern = paired_ms(lambda: serve1(plain_m, x1),
                                          lambda: serve1(kern_m, x1), iters=3)
        pb, bx = out["pred_boxes"], dets["boxes"]
        if not (torch.isfinite(out["pred_logits"]).all()
                and torch.isfinite(bx).all() and pb.min() >= 0
                and pb.max() <= 1):
            raise AssertionError(f"{variant}: non-finite or out-of-range "
                                 "detections")
        got = dict(drift(out, ref), embedding_rel_err=(
            (emb["kernels"] - emb["plain"]).norm()
            / emb["plain"].norm()).item())
        # ViT-B sets the scale: the same bf16 rounding through 24 / 32
        # blocks in place of 12 grows the embedding's error by sqrt(depth)
        # to depth times (1.4-2.7x), so 4x; a box may move by two bf16
        # steps of a coordinate (4 px each at 1024 px); the labels may flip
        # on 5 % more of the queries (near ties of random weights)
        limits = None if drift_b is None else dict(
            embedding_rel_err=4 * drift_b["embedding_rel_err"],
            max_class_prob_diff=4 * drift_b["max_class_prob_diff"],
            max_box_diff_px=max(2 * drift_b["max_box_diff_px"], 8.0),
            min_label_agreement=drift_b["label_agreement"] - 0.05)
        emit("large_model", config=f"{variant} bf16 full canvas", batch=1,
             head_dim=d, embed_dim=v.embed_dim, depth=v.depth,
             attention_bodies=bodies, detections_kept=int(dets["keep"].sum()),
             kernels_against_plain=got, limits_from_vit_b=limits, gpu=gpu,
             ms_per_tile_kernels=ms_kern, ms_per_tile_plain=ms_plain)
        if limits is None:
            drift_b = got
        elif not (got["embedding_rel_err"] <= limits["embedding_rel_err"]
                  and got["max_class_prob_diff"]
                  <= limits["max_class_prob_diff"]
                  and got["max_box_diff_px"] <= limits["max_box_diff_px"]
                  and got["label_agreement"]
                  >= limits["min_label_agreement"]):
            raise AssertionError(f"{variant}: kernels drift from the plain "
                                 f"path {got} beyond {limits}")
        del kern_m, plain_m, out, ref, dets, emb
        torch.cuda.empty_cache()

    # f32 through the packed kernels (K3's scalar body, at D 1280 for ViT-H,
    # and the tile attention bodies) against the plain path with the same
    # seeded weights, at the full model's tolerance of record; ViT-B's error
    # from the same check beside ViT-H's
    f32_err = {}
    for variant in ("vit_b", "vit_h"):
        cfg = model_config(variant, dtype="float32", use_flash_attention=True)
        kern_m = WildlifeMapper(
            cfg, generator=torch.Generator(device=dev).manual_seed(0)).eval()
        plain_m = WildlifeMapper(dataclasses.replace(
            cfg, use_flash_attention=False)).eval()
        plain_m.load_state_dict(kern_m.state_dict())
        v = cfg.vit
        glob = len(v.global_attn_indexes)
        reset_counts()
        with torch.inference_mode():
            out = kern_m(x1)
            torch.cuda.synchronize()
        check_launches(f"{variant} f32 forward, batch 1", counts(),
                       {"windowed_attention_packed": v.depth - glob,
                        "flash_attention_packed": glob,
                        "fused_mlp": v.depth, "cross_attention_packed": 1,
                        "flash_attention_rel_pos": 0,
                        "windowed_attention_rel_pos": 0})
        check_mlp_kernels(f"{variant} f32 forward, batch 1", 1)
        with torch.inference_mode():
            ref = plain_m(x1)
        keys = ("pred_logits", "pred_boxes")
        f32_err[variant] = dict(
            {f"max_abs_diff_{k[5:]}": (out[k] - ref[k]).abs().max().item()
             for k in keys},
            within=all(bool(torch.allclose(out[k], ref[k], atol=1e-4,
                                           rtol=1e-3)) for k in keys))
        emit("large_model_f32", config=f"{variant} f32 full canvas", batch=1,
             embed_dim=v.embed_dim, depth=v.depth, atol=1e-4, rtol=1e-3,
             kernels_against_plain=f32_err[variant],
             vit_b_same_check=f32_err["vit_b"])
        del kern_m, plain_m, out, ref
        torch.cuda.empty_cache()
    if not all(e["within"] for e in f32_err.values()):
        raise AssertionError(f"f32 forward with kernels against the plain "
                             f"path beyond atol 1e-4 / rtol 1e-3: {f32_err}")

    # ---- 5. times ------------------------------------------------------------
    del served, grouped_served
    with torch.inference_mode():
        for name, cfg in configs.items():
            plain_m = build(dataclasses.replace(cfg,
                                                use_flash_attention=False))
            kern_m = models[name]
            ms_plain, ms_kern = paired_ms(
                lambda: serve(plain_m, batches[0]),
                lambda: serve(kern_m, batches[0]), iters=3)
            emit("serving_time", config=name, dtype="bfloat16", batch=BATCH,
                 gpu=gpu, ms_per_batch_kernels=ms_kern,
                 ms_per_batch_plain=ms_plain,
                 tiles_per_s_kernels=BATCH * 1000 / ms_kern,
                 tiles_per_s_plain=BATCH * 1000 / ms_plain)
            del plain_m
            torch.cuda.empty_cache()
        for name, grouped_m in grouped_models.items():
            kern_m = models[name]
            ms_packed, ms_grouped = paired_ms(
                lambda: serve(kern_m, batches[0]),
                lambda: serve(grouped_m, batches[0]), iters=3)
            emit("serving_time", config=f"{name} grouped", dtype="bfloat16",
                 batch=BATCH, gpu=gpu, ms_per_batch_grouped=ms_grouped,
                 ms_per_batch_packed=ms_packed,
                 tiles_per_s_grouped=BATCH * 1000 / ms_grouped,
                 tiles_per_s_packed=BATCH * 1000 / ms_packed)

        kernel_ms = {}
        for name, (shape, args) in kernel_inputs.items():
            k = kernels[name]
            ms_plain, ms_kern = paired_ms(lambda: k["plain"](*args),
                                          lambda: k["wrapper"](*args))
            kernel_ms[name] = (ms_kern, ms_plain)
            emit("kernel_time", kernel=name, shape=shape, dtype="bfloat16",
                 gpu=gpu, ms=ms_kern, plain_ms=ms_plain)
    serving_counts = {n: main_counts[n] + grouped_counts[n]
                      for n in main_counts}
    del models, grouped_models
    torch.cuda.empty_cache()

    # ---- 6. backward kernels against their plain versions -------------------
    # name -> entry of the final "kernels" line
    report = {}

    def entry(name, source, replaces, **fields):
        report[name] = dict(name=name, route="cuda", source=source,
                            replaces=replaces, **fields)

    attn_cu = "wildlifemapper_tpu_torch/csrc/attention.cu"
    bwd_cu = "wildlifemapper_tpu_torch/csrc/attention_bwd.cu"
    mlp_cu = "wildlifemapper_tpu_torch/csrc/mlp_gemm_sm90.cu"
    jax_ops = "wildlifemapper_tpu/ops/"

    def grads_close(what, got, ref, dt, names):
        """f32: atol 5e-4 / rtol 1e-3; bf16: 2e-2 of the largest element."""
        worst = 0.0
        for nm, g, r in zip(names, got, ref):
            g, r = g.float(), r.float()
            err = (g - r).abs().max().item()
            worst = max(worst, err)
            if dt == torch.float32:
                ok = bool(torch.isclose(g, r, atol=5e-4, rtol=1e-3).all())
                bound = "atol 5e-4 rtol 1e-3"
            else:
                lim = 2e-2 * max(r.abs().max().item(), 1e-6)
                ok, bound = err <= lim, f"{lim:.3e}"
            emit("backward_check", kernel=what, output=nm,
                 dtype=str(dt).replace("torch.", ""), max_abs_err=err,
                 bound=bound)
            if not ok or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{what} {nm} {dt}: backward kernel "
                                     f"disagrees with its plain version "
                                     f"(max abs err {err}, bound {bound})")
        return worst

    def leaves(tensors, dt, frozen, keep32=()):
        """Fresh leaves in dtype dt; with `frozen` only the first (the
        activations) requires a gradient, as under a frozen encoder."""
        return [t.to(torch.float32 if i in keep32 else dt).detach()
                .requires_grad_(i == 0 or not frozen)
                for i, t in enumerate(tensors)]

    def through_wrapper(wrapper, tensors, rest, dout, counters):
        """Gradients of the public wrapper on the card by autograd, for the
        inputs that require one; each of `counters` must go up by one and
        the wrapper's other counters not at all."""
        own = [c for c in count_names if hasattr(wrapper, c)]
        before = [getattr(wrapper, c) for c in own]
        out = wrapper(*tensors, *rest)
        got = torch.autograd.grad(
            out, [t for t in tensors if t.requires_grad], dout)
        torch.cuda.synchronize()
        after = [getattr(wrapper, c) for c in own]
        if after != [n + (c in counters) for c, n in zip(own, before)]:
            raise AssertionError(f"{wrapper.__name__}: counters {own} went "
                                 f"{before} -> {after} in one backward, "
                                 f"want one more of each of {counters}")
        return got

    bwd_err = {}
    bwd_inputs = {}
    attn_counters = ("launches", "backward_dq_launches",
                     "backward_dkv_launches")

    def backward_counters(dt, d, n, m, hw):
        """The counters one forward and backward of an attention wrapper
        move: the resident body's backward is one kernel, the others' two."""
        if attention_body(dt, d, n, m, hw is not None, hw,
                          "backward") == "resident":
            return ("launches", "backward_launches")
        return attn_counters

    def repeat_check(kid, shape, launch, body):
        """The backward of the resident or the Hopper body twice on the same
        operands: every element of dq, dk, dv and the table gradients has
        one owner and a fixed order of sums, so bit-identical."""
        with torch.no_grad():
            first, second = launch(), launch()
            torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second)
                   if a is not None)
        emit("backward_repeat", kernel=kid, shape=shape, body=body,
             bit_identical=same,
             outputs=sum(a is not None for a in first))
        if not same:
            raise AssertionError(f"{kid} {shape}: two backward runs differ")

    def timing_key(kid, shape):
        """Which of phase 9's timings a shape feeds: the first shape of each
        kernel, and the second main-path shape of the windowed (N = 144)
        and the streaming kernels (N = 2304)."""
        if kid not in bwd_inputs:
            return kid
        for n in ("144", "2304"):
            key = f"{kid} N={n}"
            if (re.search(rf"\bN=(M=)?{n}\b", shape)
                    and not shape.startswith("BWH=1 ")
                    and key not in bwd_inputs):
                return key
        return None
    # (id, shape, heads, head dim, grid, inputs): K1 and K2 take the packed
    # qkv and the rel tables, K4 separate q, k, v as the adaptor's
    # projections give them
    attn_cases = [
        ("K1", "BW=4*25 N=196", 12, 64, (14, 14),
         lambda: attn_args(4 * 25, (14, 14))[:3]),
        ("K1", "BW=4*16 N=144", 12, 64, (12, 12),
         lambda: attn_args(4 * 16, (12, 12))[:3]),
        ("K2", "B=4 N=4096", 12, 64, (64, 64),
         lambda: attn_args(4, (64, 64))[:3]),
        ("K2", "B=4 N=2304", 12, 64, (48, 48),
         lambda: attn_args(4, (48, 48))[:3]),
        ("K4", "B=4 N=M=4096", 8, 128, None,
         lambda: [randn((4, 4096, c)) for _ in range(3)]),
        ("K4", "B=4 N=M=2304", 8, 128, None,
         lambda: [randn((4, 2304, c)) for _ in range(3)]),
        # ragged against the Hopper bodies' blocks and tiles
        ("K2", "B=2 H=3 N=1000 (25x40)", 3, 64, (25, 40),
         lambda: attn_args(2, (25, 40), heads=3)[:3]),
        ("K4", "B=2 N=200 M=1000", 8, 128, None,
         lambda: [randn((2, 200, c)), randn((2, 1000, c)),
                  randn((2, 1000, c))]),
        ("K4", "B=1 N=1030 M=577", 8, 128, None,
         lambda: [randn((1, 1030, c)), randn((1, 577, c)),
                  randn((1, 577, c))]),
        # ragged against the resident bodies' 16-row tiles
        ("K1", "BW=3 H=3 N=49 (7x7)", 3, 64, (7, 7),
         lambda: attn_args(3, (7, 7), heads=3)[:3]),
        ("K1", "BW=37 H=3 N=100 (10x10)", 3, 64, (10, 10),
         lambda: attn_args(37, (10, 10), heads=3)[:3]),
        ("K1", "BW=1 H=1 N=196", 1, 64, (14, 14),
         lambda: attn_args(1, (14, 14), heads=1)[:3]),
        # head dim 80 at ViT-H's shapes, batch 1: the resident body both
        # ways (K1), also on windows ragged against its 16-row tiles (odd
        # table widths, a window of 100), the Hopper bodies both ways (K2),
        # also on the 48-grid and ragged against their blocks and tiles
        ("K1", "BW=25 H=16 N=196 d=80 (ViT-H)", 16, 80, (14, 14),
         lambda: attn_args(25, (14, 14), heads=16, d=80)[:3]),
        ("K1", "BW=3 H=3 N=49 (7x7) d=80", 3, 80, (7, 7),
         lambda: attn_args(3, (7, 7), heads=3, d=80)[:3]),
        ("K1", "BW=10 H=2 N=100 (10x10) d=80", 2, 80, (10, 10),
         lambda: attn_args(10, (10, 10), heads=2, d=80)[:3]),
        ("K2", "B=1 H=16 N=4096 d=80 (ViT-H)", 16, 80, (64, 64),
         lambda: attn_args(1, (64, 64), heads=16, d=80)[:3]),
        ("K2", "B=1 H=16 N=2304 d=80 (48-grid)", 16, 80, (48, 48),
         lambda: attn_args(1, (48, 48), heads=16, d=80)[:3]),
        ("K2", "B=2 H=3 N=1000 d=80 (25x40)", 3, 80, (25, 40),
         lambda: attn_args(2, (25, 40), heads=3, d=80)[:3]),
    ]
    wrappers = {"K1": windowed_attention_packed,
                "K2": flash_attention_packed, "K4": cross_attention_packed}
    for kid, shape, heads, d, hw, make in attn_cases:
        base = make()
        cw, scale = heads * d, d ** -0.5
        dout32 = randn(base[0].shape[:2] + (cw,))
        rest = (scale, heads) + ((hw,) if hw else ())
        for dt in (torch.float32, torch.bfloat16):
            dout = dout32.to(dt)
            ref = None
            for frozen in (False, True):
                tensors = leaves(base, dt, frozen)
                got = through_wrapper(
                    wrappers[kid], tensors, rest, dout,
                    backward_counters(dt, d, base[0].shape[1],
                                      base[1].shape[1], hw))
                if ref is None:
                    with torch.no_grad():
                        if hw:
                            qkv, rh, rw = (t.detach() for t in tensors)
                            q, k, v = (qkv[..., i * cw:(i + 1) * cw]
                                       for i in range(3))
                        else:
                            q, k, v = (t.detach() for t in tensors)
                            rh = rw = None
                        # the (out, lse) the wrapper's forward saved
                        out, lse = attention_launch(q, k, v, scale, heads,
                                                    rh, rw, return_lse=True)
                        _, lse_ref = attention_plain(q, k, v, scale, heads,
                                                     rh, rw, return_lse=True)
                        lse_tol = 2e-5 if dt == torch.float32 else 2e-2
                        lse_err = (lse - lse_ref).abs().max().item()
                        emit("backward_check", kernel=f"{kid} forward",
                             output="lse", shape=shape,
                             dtype=str(dt).replace("torch.", ""),
                             max_abs_err=lse_err,
                             bound=f"atol=rtol={lse_tol}")
                        if not torch.allclose(lse, lse_ref, atol=lse_tol,
                                              rtol=lse_tol):
                            raise AssertionError(
                                f"{kid} {shape} {dt}: lse disagrees (max "
                                f"abs err {lse_err})")
                        ref = attention_backward_plain(
                            q, k, v, out, lse, dout, scale, heads, rh, rw)
                        del lse_ref
                if hw:      # packed dqkv: its three column blocks
                    parts = [got[0][..., i * cw:(i + 1) * cw]
                             for i in range(3)] + list(got[1:])
                else:
                    parts = list(got)
                names = ("dq", "dk", "dv", "drel_h", "drel_w")[:len(parts)]
                if len(parts) != (1 if frozen and not hw else
                                  3 if frozen or not hw else 5):
                    raise AssertionError(f"{kid}: {len(parts)} gradients")
                what = (f"{kid} {shape} through the wrapper, "
                        + ("activations only" if frozen else "every input"))
                errs = {nm: grads_close(what, (g,), (r,), dt, (nm,))
                        for nm, g, r in zip(names, parts, ref)}
                dq_err = max(e for n, e in errs.items()
                             if n not in ("dk", "dv"))
                dkv = [errs[n] for n in ("dk", "dv") if n in errs]
                bwd_err[f"{kid}_dq"] = max(bwd_err.get(f"{kid}_dq", 0.0),
                                           dq_err)
                if dkv:
                    bwd_err[f"{kid}_dkv"] = max(
                        bwd_err.get(f"{kid}_dkv", 0.0), *dkv)
                if d == 80 and dt == torch.bfloat16:
                    bwd_err[f"{kid}_d80"] = max(bwd_err.get(f"{kid}_d80", 0.0),
                                                *errs.values())
                del got, parts, tensors
            if dt == torch.bfloat16:
                body = attention_body(dt, d, q.shape[1], k.shape[1],
                                      rh is not None, hw, "backward")
                if body in ("resident", "sm90"):
                    repeat_check(kid, shape, lambda: attention_backward_launch(
                        q, k, v, out, lse, dout, scale, heads, rh, rw), body)
                key = timing_key(kid, shape)
                if key:
                    bwd_inputs[key] = (shape, heads, d, scale,
                                       (q, k, v, out, lse, dout, rh, rw))
            del ref, out, lse, q, k, v, rh, rw
        del base, dout32, dout
        torch.cuda.empty_cache()

    # K5 and K6: q, k, v per head and the tables; K5 once with the encoder's
    # 4-D tables (BH, qh, qw, W), whose gradients must come back 4-D, and
    # once with 3-D ones. "Activations only" here is q, k and v: without a
    # table gradient the dq kernel skips the drel reduction.
    grouped_cases = [
        ("K6", "BWH=4*25*12 N=196", (14, 14), 4 * 25 * 12, 3, 64),
        ("K6", "BWH=4*16*12 N=144", (12, 12), 4 * 16 * 12, 3, 64),
        ("K5", "BH=4*12 N=4096", (64, 64), 4 * 12, 4, 64),
        ("K5", "BH=4*12 N=2304", (48, 48), 4 * 12, 3, 64),
        ("K5", "BH=6 N=1000 (20x50)", (20, 50), 6, 3, 64),
        ("K6", "BWH=7 N=49 (7x7)", (7, 7), 7, 3, 64),
        ("K6", "BWH=111 N=100 (10x10)", (10, 10), 111, 3, 64),
        ("K6", "BWH=1 N=144", (12, 12), 1, 3, 64),
        # head dim 80 at ViT-H's shapes, batch 1: the resident body both
        # ways (K6), also ragged, the Hopper bodies both ways (K5), also on
        # the 48-grid and ragged
        ("K6", "BWH=25*16 N=196 d=80", (14, 14), 25 * 16, 3, 80),
        ("K6", "BWH=7 N=49 (7x7) d=80", (7, 7), 7, 3, 80),
        ("K6", "BWH=20 N=100 (10x10) d=80", (10, 10), 20, 3, 80),
        ("K5", "BH=16 N=4096 d=80", (64, 64), 16, 4, 80),
        ("K5", "BH=16 N=2304 d=80 (48-grid)", (48, 48), 16, 3, 80),
        ("K5", "BH=6 N=1000 d=80 (20x50)", (20, 50), 6, 3, 80),
    ]
    wrappers.update(K5=flash_attention_rel_pos, K6=windowed_attention_rel_pos)
    grad_names = ("dq", "dk", "dv", "drel_h", "drel_w")
    for kid, shape, hw, bh, table_dims, d in grouped_cases:
        base = grouped_args(bh, hw, d)[:5]
        if table_dims == 4:
            base[3] = base[3].reshape(bh, *hw, hw[0])
            base[4] = base[4].reshape(bh, *hw, hw[1])
        scale, n = d ** -0.5, hw[0] * hw[1]
        dout32 = randn(base[0].shape)
        for dt in (torch.float32, torch.bfloat16):
            dout = dout32.to(dt)
            ref = None
            for frozen in (False, True):
                tensors = [t.to(dt).detach().requires_grad_(
                    i < 3 or not frozen) for i, t in enumerate(base)]
                got = through_wrapper(wrappers[kid], tensors, (scale, hw),
                                      dout,
                                      backward_counters(dt, d, n, n, hw))
                if ref is None:
                    with torch.no_grad():
                        q, k, v, rh, rw = (t.detach() for t in tensors)
                        # the kernels' own operands: one head, BH batches
                        rh4 = rh.reshape(bh, n, 1, hw[0])
                        rw4 = rw.reshape(bh, n, 1, hw[1])
                        out, lse = attention_launch(
                            q, k, v, scale, 1, rh4, rw4, return_lse=True,
                            scale_scores=True)
                        _, lse_ref = grouped_attention_plain(
                            q, k, v, rh, rw, scale, hw, return_lse=True)
                        lse_tol = 2e-5 if dt == torch.float32 else 2e-2
                        lse_err = (lse[..., 0] - lse_ref).abs().max().item()
                        emit("backward_check", kernel=f"{kid} forward",
                             output="lse", shape=shape,
                             dtype=str(dt).replace("torch.", ""),
                             max_abs_err=lse_err,
                             bound=f"atol=rtol={lse_tol}")
                        if not torch.allclose(lse[..., 0], lse_ref,
                                              atol=lse_tol, rtol=lse_tol):
                            raise AssertionError(
                                f"{kid} {shape} {dt}: lse disagrees (max "
                                f"abs err {lse_err})")
                        ref = grouped_attention_backward_plain(
                            q, k, v, rh, rw, out, lse[..., 0], dout, scale,
                            hw)
                        del lse_ref
                if len(got) != (3 if frozen else 5):
                    raise AssertionError(f"{kid}: {len(got)} gradients")
                for g, t in zip(got, tensors):
                    if g.shape != t.shape or g.dtype != t.dtype:
                        raise AssertionError(
                            f"{kid} {shape}: gradient {tuple(g.shape)} "
                            f"{g.dtype} for input {tuple(t.shape)} {t.dtype}")
                what = (f"{kid} {shape} through the wrapper, {table_dims}-D "
                        "tables, " + ("q, k, v only" if frozen
                                      else "every input"))
                errs = {nm: grads_close(what, (g,), (r,), dt, (nm,))
                        for nm, g, r in zip(grad_names, got, ref)}
                bwd_err[f"{kid}_dq"] = max(
                    bwd_err.get(f"{kid}_dq", 0.0),
                    *(e for nm, e in errs.items() if nm not in ("dk", "dv")))
                bwd_err[f"{kid}_dkv"] = max(bwd_err.get(f"{kid}_dkv", 0.0),
                                            errs["dk"], errs["dv"])
                if d == 80 and dt == torch.bfloat16:
                    bwd_err[f"{kid}_d80"] = max(bwd_err.get(f"{kid}_d80", 0.0),
                                                *errs.values())
                del got, tensors
            if dt == torch.bfloat16:
                body = attention_body(dt, d, n, n, True, hw, "backward")
                if body in ("resident", "sm90"):
                    repeat_check(kid, shape, lambda: attention_backward_launch(
                        q, k, v, out, lse, dout, scale, 1, rh4, rw4,
                        scale_scores=True), body)
                key = timing_key(kid, shape)
                if key:
                    bwd_inputs[key] = (shape, 1, d, scale,
                                       (q, k, v, out, lse, dout, rh4, rw4))
            del ref, out, lse, q, k, v, rh, rw, rh4, rw4
        del base, dout32, dout
        torch.cuda.empty_cache()

    mlp_names = ("dx", "dw1", "db1", "dw2", "db2")
    mlp_counters = ("launches", "backward_launches")
    # the training shapes, rows ragged against the GEMM body's tiles, and
    # ViT-H's widths (f32: the forward on 16-row tiles)
    for shape, rows, dmod in (("R=4*4096", 4 * 4096, 768),
                              ("R=4*2304", 4 * 2304, 768),
                              ("R=1000", 1000, 768),
                              ("R=130 D=1280 F=5120", 130, 1280)):
        base = mlp_args(rows, dmod, 4 * dmod)
        g32, da32 = randn((rows, dmod)), randn((rows, 4 * dmod))
        for dt in (torch.float32, torch.bfloat16):
            g, da = g32.to(dt), da32.to(dt)
            with torch.no_grad():
                xx, ww, bb = base[0].to(dt), base[1].to(dt), base[2]
                got = fused_mlp_dh(xx, ww, bb, da)
                torch.cuda.synchronize()
                ref = fused_mlp_dh_plain(xx, ww, bb, da)
                bwd_err["K3_dh"] = max(
                    bwd_err.get("K3_dh", 0.0),
                    grads_close(f"K3 {shape}", got, ref, dt, ("a", "dh")))
                # without a: the same dh; the forward twice: bit-identical
                # in bf16, where every element of the GEMM body has one
                # owner and a fixed order of sums (the f32 bodies' are
                # printed)
                no_act, dh_again = fused_mlp_dh(xx, ww, bb, da, False)
                out1 = fused_mlp(xx, ww, bb, base[3].to(dt), base[4])
                out2 = fused_mlp(xx, ww, bb, base[3].to(dt), base[4])
                same = {"dh_without_a": (dh_again - got[1]).abs().max().item(),
                        "second_forward": (out1 - out2).abs().max().item()}
                emit("mlp_repeat", shape=shape,
                     dtype=str(dt).replace("torch.", ""), a_left_out=no_act
                     is None, max_abs_diff=same)
                if no_act is not None or (dt == torch.bfloat16
                                          and any(same.values())):
                    raise AssertionError(f"K3 {shape} {dt}: dh without a or "
                                         f"a second forward differs {same}")
                del no_act, dh_again, out1, out2
                if dt == torch.bfloat16 and "K3" not in bwd_inputs:
                    bwd_inputs["K3"] = (shape, (xx, ww, bb, da))
                ref = fused_mlp_backward_plain(
                    *leaves(base, dt, True, keep32=(2, 4)), g)
            for frozen in (False, True):
                tensors = leaves(base, dt, frozen, keep32=(2, 4))
                got = through_wrapper(fused_mlp, tensors, (), g,
                                      mlp_counters)
                what = (f"K3 {shape} through the wrapper, "
                        + ("activations only" if frozen else "every input"))
                bwd_err["K3_wrapper"] = max(
                    bwd_err.get("K3_wrapper", 0.0),
                    grads_close(what, got, ref, dt, mlp_names[:len(got)]))
                if len(got) != (1 if frozen else 5):
                    raise AssertionError(f"K3: {len(got)} gradients")
                if dt == torch.bfloat16 and not frozen:
                    # the weight gradients against the products of the
                    # same operands raised to f32 first
                    with torch.no_grad():
                        act, dh = fused_mlp_dh_plain(xx, ww, bb, torch.matmul(
                            g, tensors[3].detach()))
                        exact = (torch.matmul(dh.float().t(), xx.float()),
                                 torch.matmul(g.float().t(), act.float()))
                    grads_close(f"K3 {shape} bf16 GEMM against the f32 "
                                "product", (got[1], got[3]), exact, dt,
                                ("dw1", "dw2"))
                    del act, dh, exact
                del got, tensors
            del ref
        del base, g32, da32, g, da
        torch.cuda.empty_cache()

    # ---- 7. one f32 train step: kernels against the plain path --------------
    def train_batch(batch_size, seed):
        return {k: torch.from_numpy(v).to(dev) for k, v in
                synthetic_batch(batch_size, seed).items()}

    def build_trainer(name, dtype, use_kernels, batch_size, clip=None,
                      layout="packed"):
        cfg = training_config(name, dtype=dtype, use_kernels=use_kernels,
                              batch_size=batch_size)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attn_impl=layout))
        if clip is not None:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, clip_max_norm=clip))
        sb = StepBuilder(cfg)
        load_reference_state_dict(sb.model, golden_sd)
        return sb, sb.init_state(steps_per_epoch=100)

    # kernel launches of one train step, by counter: each attention
    # backward launches its dq kernel and its dk/dv kernel, K3's its one;
    # in bf16 (`resident`) the windowed backward of K1 / K6 is one kernel
    # and none of their dq or dk/dv kernels runs
    windowed = ("windowed_attention_packed", "windowed_attention_rel_pos")

    def per_step(with_k4, layout="packed", resident=False, forward=None):
        fwd = dict(forward or per_forward[layout],
                   cross_attention_packed=int(with_k4))
        attn = {n: v for n, v in fwd.items() if n != "fused_mlp"}
        one_kernel = {n: (v if resident and n in windowed else 0)
                      for n, v in attn.items()
                      if n != "cross_attention_packed"}
        two_kernels = {n: (0 if resident and n in windowed else v)
                       for n, v in attn.items()}
        return {"launches": fwd,
                "backward_launches": {"fused_mlp": fwd["fused_mlp"],
                                      **one_kernel},
                "backward_dq_launches": two_kernels,
                "backward_dkv_launches": two_kernels}

    def all_counts():
        return {attr: counts(attr) for attr in count_names}

    def step_parity(name, batch_size, with_k4, layout="packed"):
        """One f32 step with kernels against the same step on the plain
        path: same weights, batch and dropout seed, no clipping (so that
        the raw gradients stay in .grad)."""
        batch = train_batch(batch_size, seed=7)
        parity = {}
        for path, use_kernels in (("kernels", True), ("plain", False)):
            sb, state = build_trainer(name, "float32", use_kernels,
                                      batch_size, clip=1e9, layout=layout)
            reset_counts()
            _, metrics = sb.train_step(
                state, batch, torch.Generator(device=dev).manual_seed(5))
            torch.cuda.synchronize()
            if use_kernels:
                got_counts = all_counts()
                if got_counts != per_step(with_k4, layout):
                    raise AssertionError(f"{name} {layout}: f32 step "
                                         f"launches {got_counts}, want "
                                         f"{per_step(with_k4, layout)}")
            parity[path] = (
                {k: v.item() for k, v in metrics.items()},
                {n: p.grad.clone() for n, p in sb.model.named_parameters()
                 if p.grad is not None})
            del sb, state
            torch.cuda.empty_cache()
        (m_k, g_k), (m_p, g_p) = parity["kernels"], parity["plain"]
        # Each gradient elementwise at the stated tolerance and, since many
        # are far smaller than the atol at these random weights, also by its
        # own norm: |g_k - g_p| <= 1e-3 |g_p| for every parameter whose
        # gradient is more than rounding noise (a key bias's is zero but
        # for that).
        worst, worst_name, worst_rel, worst_rel_name = 0.0, "", 0.0, ""
        smallest_checked = float("inf")
        for pname, gp in g_p.items():
            err = (g_k[pname] - gp).abs().max().item()
            rel_p = 0.0
            if gp.norm().item() > 1e-10 * m_p["grad_norm"]:
                rel_p = ((g_k[pname] - gp).norm() / gp.norm()).item()
                smallest_checked = min(smallest_checked, gp.norm().item())
            if err > worst:
                worst, worst_name = err, pname
            if rel_p > worst_rel:
                worst_rel, worst_rel_name = rel_p, pname
            if (not torch.allclose(g_k[pname], gp, atol=5e-4, rtol=1e-3)
                    or rel_p > 1e-3):
                raise AssertionError(
                    f"{name}: f32 train step: gradient of {pname} with "
                    f"kernels differs from the plain path's (max abs err "
                    f"{err}, relative {rel_p})")
        num = sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p).sqrt().item()
        rel = num / max(m_p["grad_norm"], 1e-12)
        emit("train_step_parity",
             config=f"{name} {layout} f32 batch {batch_size}",
             metrics_kernels=m_k, metrics_plain=m_p, gradients=len(g_p),
             max_abs_grad_err=worst, worst_gradient=worst_name,
             max_relative_err_of_one_gradient=worst_rel,
             worst_relative_gradient=worst_rel_name,
             smallest_gradient_norm_checked=smallest_checked,
             relative_grad_err=rel, atol=5e-4, rtol=1e-3)
        for key in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
            if not np.isclose(m_k[key], m_p[key], atol=5e-4, rtol=1e-3):
                raise AssertionError(f"{name}: f32 train step: {key} "
                                     f"{m_k[key]} with kernels, {m_p[key]} "
                                     "on the plain path")
        if set(g_k) != set(g_p) or rel > 1e-3:
            raise AssertionError(f"{name}: f32 train step: relative "
                                 f"gradient error {rel}")

    # every gradient, rel tables and MLP weights included; then the frozen
    # encoder, where the backward kernels write activation gradients only
    for layout in ("packed", "grouped"):
        step_parity("from_scratch", 2, with_k4=True, layout=layout)
        step_parity("fine_tune", 1, with_k4=False, layout=layout)
    torch.cuda.empty_cache()

    # ---- 8. training in bf16: the second main path, once for each layout -----
    # ---- 9. times: train steps and the matcher -------------------------------
    import warnings

    batch4 = train_batch(BATCH, seed=11)
    gen = torch.Generator(device=dev).manual_seed(3)

    def one_wait(name, layout, sb, state):
        """One more step under PyTorch's sync debug mode, which warns at
        every call that waits for the device: the copy of the matching cost
        to the host (ops/lsap.py) must be the only one."""
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sb.train_step(state, batch4, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        waits = [str(w.message)[:200] for w in caught
                 if "synchroniz" in str(w.message).lower()]
        emit("train_step_host_waits", config=name, layout=layout,
             waits=len(waits), want=1, messages=waits)
        if len(waits) != 1:
            raise AssertionError(f"{name}: a train step waited for the "
                                 f"device {len(waits)} times, want 1: "
                                 f"{waits}")

    def training_path(layout):
        """Three bf16 steps at batch 4 in both training configurations with
        the kernels of `layout`: the counts set to 0 just before the run and
        read just after, the checks of what came out, one more step under
        the sync debug mode, and the step's time beside the other path's
        (the plain path for the packed layout, the packed layout for the
        grouped one). Returns the run's counts."""
        trainers, train_metrics, train_mem, snapshots = {}, {}, {}, {}
        # what the earlier phases still hold (kernel inputs kept for the
        # timings): part of every peak below
        resident = torch.cuda.memory_allocated()
        for name in ("fine_tune", "from_scratch"):
            trainers[name] = build_trainer(name, "bfloat16", True, BATCH,
                                           layout=layout)
            snapshots[name] = {n: p.detach().clone() for n, p in
                               trainers[name][0].model.named_parameters()}
        reset_counts()             # the training path's run starts here
        for name, (sb, state) in trainers.items():
            torch.cuda.reset_peak_memory_stats()
            steps = []
            for _ in range(TRAIN_STEPS):
                _, metrics = sb.train_step(state, batch4, gen)
                steps.append(metrics)
            torch.cuda.synchronize()
            train_metrics[name] = [{k: v.item() for k, v in m.items()}
                                   for m in steps]
            train_mem[name] = torch.cuda.max_memory_allocated()
        train_counts = all_counts()
        # ... and ends here
        want_counts = {}
        for with_k4 in (False, True):          # fine_tune, from_scratch
            for attr, per in per_step(with_k4, layout,
                                      resident=True).items():
                tot = want_counts.setdefault(attr, {})
                for n, v in per.items():
                    tot[n] = tot.get(n, 0) + v * TRAIN_STEPS
        emit("training_path_launches", layout=layout, launches=train_counts,
             want=want_counts)
        if train_counts != want_counts:
            raise AssertionError(f"training path, {layout}: launches "
                                 f"{train_counts}, want {want_counts}")
        for name, (sb, state) in trainers.items():
            ms = train_metrics[name]
            moved = frozen_same = 0
            for n, p in sb.model.named_parameters():
                same = torch.equal(p.detach(), snapshots[name][n])
                if p.requires_grad and same:
                    raise AssertionError(f"{name}: trainable {n} did not "
                                         "move")
                if not p.requires_grad and not same:
                    raise AssertionError(f"{name}: frozen {n} changed")
                moved += p.requires_grad
                frozen_same += not p.requires_grad
            finite = all(np.isfinite(v) for m in ms for v in m.values())
            emit("training", config=name, layout=layout, dtype="bfloat16",
                 batch=BATCH, steps=TRAIN_STEPS, gpu=gpu,
                 loss=[m["loss"] for m in ms],
                 grad_norm=[m["grad_norm"] for m in ms],
                 num_boxes=ms[0]["num_boxes"], parameters_moved=moved,
                 parameters_frozen_identical=frozen_same,
                 peak_memory_bytes=train_mem[name],
                 allocated_before_the_trainers_bytes=resident)
            if not finite:
                raise AssertionError(f"{name}: non-finite training metrics "
                                     f"{ms}")
            if name == "from_scratch" and not ms[-1]["loss"] < ms[0]["loss"]:
                raise AssertionError(f"from_scratch: loss did not fall over "
                                     f"{TRAIN_STEPS} steps on one batch: "
                                     f"{[m['loss'] for m in ms]}")
        del snapshots

        for name, (sb, state) in trainers.items():
            one_wait(name, layout, sb, state)

        other = "plain" if layout == "packed" else "packed"
        for name, (sb, state) in trainers.items():
            other_sb, other_state = build_trainer(
                name, "bfloat16", other == "packed", BATCH)
            torch.cuda.reset_peak_memory_stats()
            ms_other, ms_kern = paired_ms(
                lambda: other_sb.train_step(other_state, batch4, gen),
                lambda: sb.train_step(state, batch4, gen), iters=2)
            with torch.no_grad():
                out = sb.model(sb.images(batch4))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    hungarian_match(out, batch4, sb.cfg.criterion)
                torch.cuda.synchronize()
                matcher_ms = (time.perf_counter() - t0) * 1000 / 5
            emit("train_step_time", config=name, layout=layout,
                 dtype="bfloat16", batch=BATCH, gpu=gpu,
                 ms_per_step_kernels=ms_kern,
                 tiles_per_s_kernels=BATCH * 1000 / ms_kern,
                 matcher_host_ms=matcher_ms,
                 matcher_share=matcher_ms / ms_kern,
                 peak_memory_bytes_kernels=train_mem[name],
                 peak_memory_bytes_both_paths=torch.cuda
                 .max_memory_allocated(),
                 **{f"ms_per_step_{other}": ms_other,
                    f"tiles_per_s_{other}": BATCH * 1000 / ms_other})
            del other_sb, other_state, out
            torch.cuda.empty_cache()
        return train_counts

    path_counts = {layout: training_path(layout)
                   for layout in ("packed", "grouped")}
    torch.cuda.empty_cache()
    train_counts = {
        attr: {n: path_counts["packed"][attr][n]
               + path_counts["grouped"][attr][n] for n in per}
        for attr, per in path_counts["packed"].items()}

    # ---- 8b. ViT-H fine-tune with remat_blocks: the d-80 backward's path ----
    # The frozen ViT-H encoder (D 1280, 32 blocks, 16 heads of 80; seeded
    # random weights, no checkpoint is at hand) under the trainable adaptor
    # and decoder, bf16, batch 4, in each layout. Each block keeps its input
    # and its attention output and recomputes the rest in the backward: its
    # attention forward is launched again (counted), the MLP's forward is
    # not. The global blocks' backward is the Hopper body at d = 80 (K2 or
    # K5), the windows' the resident body (K1 or K6): one launch a block and
    # no plain delta pass, counted where the tile bodies would run one.
    def vit_h_trainer(layout, remat):
        cfg = training_config("fine_tune", "bfloat16", True, BATCH,
                              variant="vit_h", remat_blocks=remat)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, attn_impl=layout))
        sb = StepBuilder(cfg, generator=torch.Generator().manual_seed(0))
        return sb, sb.init_state(steps_per_epoch=100)

    def vit_h_want(layout):
        """The counts of TRAIN_STEPS remat steps: per_step's at ViT-H's depth
        (4 global blocks, 28 windowed, 32 MLPs, no K4; a d-80 window's
        backward is one resident kernel), every attention forward twice."""
        glob, win = (("flash_attention_packed", "windowed_attention_packed")
                     if layout == "packed" else
                     ("flash_attention_rel_pos", "windowed_attention_rel_pos"))
        fwd = dict({n: 0 for n in per_forward[layout]}, **{
            glob: 4, win: 28, "fused_mlp": 32 if layout == "packed" else 0})
        per = per_step(False, layout, resident=True, forward=fwd)
        per["launches"] = {n: v * (1 if n == "fused_mlp" else 2)
                           for n, v in per["launches"].items()}
        return {attr: {n: v * TRAIN_STEPS for n, v in d.items()}
                for attr, d in per.items()}

    def trainable_grads(sb):
        return {n: p.grad.detach().clone()
                for n, p in sb.model.named_parameters() if p.grad is not None}

    def counted_delta(*args):
        delta_passes[0] += 1
        return real_delta(*args)

    vit_h_counts, delta_passes, real_delta = {}, [0], _attention.attention_delta
    for layout in ("packed", "grouped"):
        sb_r, state_r = vit_h_trainer(layout, remat=True)
        frozen = {n: p.detach().clone()
                  for n, p in sb_r.model.named_parameters()
                  if not p.requires_grad}
        start_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gen_h = torch.Generator(device=dev).manual_seed(13)
        steps = []
        reset_counts()             # the ViT-H path's run starts here
        delta_passes[0] = 0
        _attention.attention_delta = counted_delta
        try:
            for i in range(TRAIN_STEPS):
                _, metrics = sb_r.train_step(state_r, batch4, gen_h)
                steps.append(metrics)
                if i == 0 and layout == "packed":
                    first_grads = trainable_grads(sb_r)
            torch.cuda.synchronize()
        finally:
            _attention.attention_delta = real_delta
        vit_h_counts[layout] = all_counts()
        # ... and ends here
        peak_remat = torch.cuda.max_memory_allocated()
        want = vit_h_want(layout)
        emit("vit_h_training_launches", layout=layout,
             launches=vit_h_counts[layout], want=want,
             plain_delta_passes=delta_passes[0])
        if vit_h_counts[layout] != want or delta_passes[0]:
            raise AssertionError(f"ViT-H fine-tune, {layout}: launches "
                                 f"{vit_h_counts[layout]}, want {want}; "
                                 f"{delta_passes[0]} plain delta passes")
        ms = [{k: v.item() for k, v in m.items()} for m in steps]
        changed = [n for n, p in sb_r.model.named_parameters()
                   if not p.requires_grad and not torch.equal(p, frozen[n])]
        finite = all(np.isfinite(v) for m in ms for v in m.values())
        emit("vit_h_training", config="fine_tune", variant="vit_h",
             layout=layout, remat_blocks=True, dtype="bfloat16", batch=BATCH,
             steps=TRAIN_STEPS, gpu=gpu, loss=[m["loss"] for m in ms],
             grad_norm=[m["grad_norm"] for m in ms],
             parameters_frozen_identical=len(frozen) - len(changed),
             parameters_trainable=sum(p.requires_grad for p in
                                      sb_r.model.parameters()),
             peak_memory_bytes=peak_remat,
             allocated_at_start_bytes=start_bytes)
        if not finite or changed or not ms[-1]["loss"] < ms[0]["loss"]:
            raise AssertionError(f"ViT-H fine-tune, {layout}: losses "
                                 f"{[m['loss'] for m in ms]}, frozen "
                                 f"parameters changed: {changed[:5]}")
        del frozen
        if layout == "grouped":
            del sb_r, state_r
            torch.cuda.empty_cache()
            continue
        one_wait("fine_tune vit_h remat", layout, sb_r, state_r)
        vit_h_remat = (sb_r, state_r, ms[0], peak_remat - start_bytes)

    # the same first step without remat_blocks (same weights, batch and
    # dropout seed): the same function, and the memory remat saves
    sb_r, state_r, first_remat, above_remat = vit_h_remat
    sb_n, state_n = vit_h_trainer("packed", remat=False)
    start_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, metrics = sb_n.train_step(state_n, batch4,
                                 torch.Generator(device=dev).manual_seed(13))
    torch.cuda.synchronize()
    above_none = torch.cuda.max_memory_allocated() - start_bytes
    first_none = {k: v.item() for k, v in metrics.items()}
    grads_none = trainable_grads(sb_n)
    same = (set(grads_none) == set(first_grads) and all(
        torch.equal(first_grads[n], g) for n, g in grads_none.items()))
    worst_rel = max(((first_grads[n] - g).norm() / g.norm().clamp_min(1e-30))
                    .item() for n, g in grads_none.items())
    emit("vit_h_remat_against_none", config="fine_tune", variant="vit_h",
         dtype="bfloat16", batch=BATCH, gpu=gpu,
         loss_remat=first_remat["loss"], loss_without=first_none["loss"],
         grad_norm_remat=first_remat["grad_norm"],
         grad_norm_without=first_none["grad_norm"],
         gradients=len(grads_none), bit_identical=same,
         max_relative_grad_err=worst_rel,
         peak_memory_above_start_bytes_remat=above_remat,
         peak_memory_above_start_bytes_without=above_none,
         saved_by_remat_bytes=above_none - above_remat)
    if (worst_rel > 1e-3 or not np.isclose(first_remat["loss"],
                                           first_none["loss"], rtol=1e-4)):
        raise AssertionError(f"ViT-H: remat_blocks changed the step (loss "
                             f"{first_remat['loss']} against "
                             f"{first_none['loss']}, relative gradient "
                             f"error {worst_rel})")
    del first_grads, grads_none
    # the step's time with remat_blocks and without, in turns
    ms_none, ms_remat = paired_ms(
        lambda: sb_n.train_step(state_n, batch4, gen),
        lambda: sb_r.train_step(state_r, batch4, gen), iters=2)
    emit("train_step_time", config="fine_tune", variant="vit_h",
         layout="packed", dtype="bfloat16", batch=BATCH, gpu=gpu,
         ms_per_step_remat=ms_remat, ms_per_step_without_remat=ms_none,
         tiles_per_s_remat=BATCH * 1000 / ms_remat)
    del sb_r, state_r, sb_n, state_n, vit_h_remat
    torch.cuda.empty_cache()

    ids = {"K1": "windowed_attention_packed", "K2": "flash_attention_packed",
           "K4": "cross_attention_packed", "K5": "flash_attention_rel_pos",
           "K6": "windowed_attention_rel_pos"}
    replaces_fwd = {"K1": "windowed_attention_v2.py:227",
                    "K2": "flash_attention_v2.py:199",
                    "K4": "cross_attention.py:160",
                    "K5": "flash_attention.py:230",
                    "K6": "windowed_attention.py:144"}
    # K5's one Pallas backward kernel became the two kernels here; K1's and
    # K6's are one kernel again (the resident bodies)
    replaces_bwd = {"K1": ("windowed_attention_v2.py:260",) * 2,
                    "K2": ("flash_attention_v2.py:364",
                           "flash_attention_v2.py:392"),
                    "K4": ("cross_attention.py:208", "cross_attention.py:227"),
                    "K5": ("flash_attention.py:268",) * 2,
                    "K6": ("windowed_attention.py:173",) * 2}
    grouped_cu = "wildlifemapper_tpu_torch/csrc/grouped_attention.cu"
    grouped_bwd_cu = "wildlifemapper_tpu_torch/csrc/grouped_attention_bwd.cu"
    timed = [(kid, kid) for kid in ("K1", "K2", "K4", "K5", "K6")] + [
        ("K1", "K1 N=144"), ("K6", "K6 N=144"), ("K2", "K2 N=2304"),
        ("K4", "K4 N=2304"), ("K5", "K5 N=2304")]
    for kid, key in timed:
        # K5 and K6 arrive as their kernels take them: (BH, N, d) is the
        # family's layout with one head, tables (BH, N, 1, g), lse (BH, N, 1).
        # The first shape of a kernel makes its entries of the "kernels"
        # line; the windowed kernels' second shape a line of its own.
        primary = key == kid
        shape, heads, d, scale, tensors = bwd_inputs.pop(key)
        q, k, v, out, lse, dout, rh, rw = tensors
        b, n, m = q.shape[0], q.shape[1], k.shape[1]
        wname = ids[kid]
        ss = kid in ("K5", "K6")       # the scale goes on the f32 scores
        fwd_cu, back_cu = ((grouped_cu, grouped_bwd_cu) if ss
                           else (attn_cu, bwd_cu))
        lib_fwd, lib_bwd = sdpa_pair(q, k, v, rh, rw, heads, scale)
        with torch.no_grad():
            lib_fwd_ms = time_ms(lib_fwd, iters=20)
        lib_bwd_ms = time_ms(lib_bwd)
        del lib_fwd, lib_bwd
        torch.cuda.empty_cache()
        mac = b * heads * n * m * d
        stats = [lse, lse]             # lse and delta, (B, N, H) f32 each
        fb, fby = bound_ms(4 * mac, nbytes(q, k, v, out, rh, rw))
        # The body these shapes take, and, where it is a Hopper or a
        # resident body, the time of the mma.sync body that ran them before,
        # on the same inputs in this run, in turns (old, new, new, old), at
        # the launcher.
        hw = (rh.shape[-1], rw.shape[-1]) if rh is not None else None
        body = attention_body(q.dtype, d, n, m, rh is not None, hw)
        redesigned = body != "mma"
        if body == "sm90":
            fwd_cu, back_cu = (fwd_cu.replace(".cu", "_sm90.cu"),
                               back_cu.replace(".cu", "_{}_sm90.cu"))
        elif body == "resident":
            fwd_cu, back_cu = (fwd_cu.replace(".cu", "_resident.cu"),
                               back_cu.replace(".cu", "_resident.cu"))

        def forward(which_body):
            return lambda: attention_launch(q, k, v, scale, heads, rh, rw,
                                            scale_scores=ss, body=which_body)

        old_fwd_ms = new_fwd_ms = None
        with torch.no_grad():
            if redesigned:
                # the Hopper forward takes 0.2-0.6 ms: 20 launches a turn
                old_fwd_ms, new_fwd_ms = paired_ms(
                    forward("mma"), forward(body),
                    iters=20 if body == "sm90" else 5)
            if not primary:
                plain_fwd_ms = time_ms(lambda: attention_plain(
                    q, k, v, scale, heads, rh, rw, scale_scores=ss))
        if body == "sm90":
            emit("forward_time", kernel=kid, shape=shape, dtype="bfloat16",
                 gpu=gpu, body=body, launches_timed=20, ms=new_fwd_ms,
                 earlier_body="mma", earlier_body_ms=old_fwd_ms,
                 bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
                 over_bound=new_fwd_ms / fb, over_library=new_fwd_ms
                 / lib_fwd_ms)
        if primary:
            entry(wname, fwd_cu, jax_ops + replaces_fwd[kid], body=body,
                  earlier_body_ms=old_fwd_ms, launcher_ms=new_fwd_ms,
                  launches=serving_counts[wname]
                  + train_counts["launches"][wname],
                  launches_serving=serving_counts[wname],
                  launches_training=train_counts["launches"][wname],
                  shape=shape, max_abs_err=errors[wname],
                  ms=kernel_ms[wname][0], plain_ms=kernel_ms[wname][1],
                  bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms,
                  library="F.scaled_dot_product_attention"
                  + (" with the bias as attn_mask" if rh is not None
                     else ""))
        else:
            emit("kernel_time", kernel=wname, shape=shape, dtype="bfloat16",
                 gpu=gpu, body=body, ms=new_fwd_ms,
                 earlier_body_ms=old_fwd_ms, plain_ms=plain_fwd_ms,
                 bound_ms=fb, bound_by=fby, library_ms=lib_fwd_ms)

        def whole(which_body=None, want_drel=True):
            """The whole backward at the launcher: one kernel for the
            resident body, two for the Hopper body (delta inside the dq
            kernel), the delta pass and two kernels for the tile bodies."""
            return lambda: attention_backward_launch(
                q, k, v, out, lse, dout, scale, heads, rh, rw,
                want_drel=want_drel, scale_scores=ss, body=which_body)

        def one(kernel, want_drel=True, which_body=None):
            """One kernel of a two-kernel backward alone, on buffers made
            beforehand: the tile bodies' kernels with the plain delta pass's
            delta, the Hopper dk/dv kernel with what its dq kernel left
            (run once here, untimed)."""
            grads = [torch.empty_like(t) for t in (q, k, v)]
            drel = ([torch.empty_like(t) for t in (rh, rw)]
                    if rh is not None and want_drel else [None, None])
            grid = hw if hw else (0, 0)
            which = which_body or (body if body != "resident" else "mma")
            if which == "sm90":
                scratch = sm90_scratch(q, heads, scale, ss, rh is not None)

                def launch(kern):
                    _sm90_backward_launch(kern, q, k, v, dout, out, lse,
                                          scratch, rh, rw, *grads, *drel,
                                          scale, heads, d, *grid,
                                          scale_scores=ss)
                if kernel == 1:
                    launch(0)
                return lambda: launch(kernel)
            delta = attention_delta(dout, out, heads).contiguous()
            return lambda: _backward_kernel_launch(
                kernel, q, k, v, dout, lse, delta, rh, rw, *grads, *drel,
                scale, heads, d, *grid, scale_scores=ss)

        def plain():
            return attention_backward_plain(q, k, v, out, lse, dout, scale,
                                            heads, rh, rw, scale_scores=ss)

        with torch.no_grad():
            ms_plain, ms_both = paired_ms(plain, whole())
            delta_ms = time_ms(lambda: attention_delta(dout, out, heads)
                               .contiguous())
            old_dq = old_dkv = old_both = ms_nodrel = None
            if body == "resident":
                # the earlier bodies' whole backward, delta pass included,
                # and its pieces
                old_both, ms_both = paired_ms(whole("mma"), whole())
                ms_nodrel = time_ms(whole(want_drel=False))
                old_dq, old_dkv = time_ms(one(0)), time_ms(one(1))
                ms_dq = ms_dkv = ms_dq_nodrel = None
            else:
                if redesigned:
                    old_dq, ms_dq = paired_ms(one(0, which_body="mma"),
                                              one(0))
                    old_dkv, ms_dkv = paired_ms(one(1, which_body="mma"),
                                                one(1))
                else:
                    ms_dq, ms_dkv = time_ms(one(0)), time_ms(one(1))
                ms_dq_nodrel = (time_ms(one(0, False)) if rh is not None
                                else None)
        # the dq kernel: 3 products (S, dP, dQ); reads q, k, v, do, lse,
        # the tables and (the Hopper body, delta inside) o, writes dq, delta
        # and the tables' gradients. The dk/dv kernel: 4 products (S, dP,
        # dK, dV); reads q, k, v, do, the tables, lse and delta, writes dk
        # and dv.
        tabs = rh is not None
        scores = b * heads * n * m
        dq_b = attention_backward_bound(
            3, mac, scores, tabs, tabs,
            nbytes(q, k, v, dout, q, rh, rw, rh, rw, *stats)
            + (nbytes(out) if body == "sm90" else 0))
        dkv_b = attention_backward_bound(
            4, mac, scores, tabs, False,
            nbytes(q, k, v, dout, k, v, rh, rw, *stats))
        # the whole backward reads q, k, v, do, o, lse and the tables and
        # writes dq, dk, dv and the tables' gradients: 5 products (S, dP,
        # dq, dk, dv), whichever body
        both_b = attention_backward_bound(
            5, mac, scores, tabs, tabs,
            nbytes(q, k, v, dout, out, lse, q, k, v, rh, rw, rh, rw))
        emit("backward_kernel_time", kernel=kid, shape=shape, dtype="bfloat16",
             gpu=gpu, body=body, dq_ms=ms_dq,
             dq_without_drel_ms=ms_dq_nodrel, dkv_ms=ms_dkv,
             earlier_body_dq_ms=old_dq, earlier_body_dkv_ms=old_dkv,
             earlier_body_whole_ms=old_both, delta_pass_ms=delta_ms,
             both_ms=ms_both, without_drel_ms=ms_nodrel, plain_ms=ms_plain,
             bound_ms=both_b[0], bound_by=both_b[1], dq_bound_ms=dq_b[0],
             dkv_bound_ms=dkv_b[0], over_bound=ms_both / both_b[0],
             library_forward_ms=lib_fwd_ms, library_backward_ms=lib_bwd_ms)
        tc = train_counts
        if not primary:
            pass
        elif kid in ("K1", "K6"):
            if body != "resident":
                raise AssertionError(f"{kid} {shape}: body {body}, want "
                                     "the resident one")
            entry(wname + "_backward", back_cu,
                  jax_ops + replaces_bwd[kid][0], body=body,
                  earlier_body_ms=old_both,
                  earlier_body_delta_ms=delta_ms,
                  earlier_body_dq_ms=old_dq, earlier_body_dkv_ms=old_dkv,
                  launches=tc["backward_launches"][wname], shape=shape,
                  max_abs_err=max(bwd_err[f"{kid}_dq"],
                                  bwd_err[f"{kid}_dkv"]),
                  ms=ms_both, without_drel_ms=ms_nodrel, plain_ms=ms_plain,
                  bound_ms=both_b[0], bound_by=both_b[1],
                  library_ms=lib_bwd_ms,
                  library="autograd through scaled_dot_product_attention "
                          "(dq, dk, dv; no rel-table gradient)",
                  kernels_per_backward=1)
        else:
            entry(wname + "_backward_dq", back_cu.format("dq"),
                  jax_ops + replaces_bwd[kid][0], body=body,
                  earlier_body_ms=old_dq,
                  launches=tc["backward_dq_launches"][wname], shape=shape,
                  max_abs_err=bwd_err[f"{kid}_dq"], ms=ms_dq,
                  delta_pass_ms=delta_ms,
                  plain_ms=ms_plain, plain_covers="dq + dk/dv",
                  bound_ms=dq_b[0], bound_by=dq_b[1], library_ms=lib_bwd_ms,
                  library="autograd through scaled_dot_product_attention",
                  library_covers="dq + dk/dv (one call)")
            entry(wname + "_backward_dkv", back_cu.format("dkv"),
                  jax_ops + replaces_bwd[kid][1], body=body,
                  earlier_body_ms=old_dkv,
                  launches=tc["backward_dkv_launches"][wname], shape=shape,
                  max_abs_err=bwd_err[f"{kid}_dkv"], ms=ms_dkv,
                  plain_ms=ms_plain, plain_covers="dq + dk/dv",
                  bound_ms=dkv_b[0], bound_by=dkv_b[1], library_ms=None,
                  library_covers="see the dq entry")
        del tensors, q, k, v, out, lse, dout, rh, rw
        torch.cuda.empty_cache()

    # ViT-H's attention (head dim 80, 16 heads) at batch 1 and 4: the bf16
    # forward of the Hopper body (K2, K5 on the 64-grid) and of the resident
    # body (K1, K6 on 25 windows of 14 an image) in turns with the tile body
    # over 20 launches a turn, beside one library call and the bound; the
    # whole backward of K2 and K5 (the Hopper body: the dq kernel with delta
    # inside, then dk/dv) and of K1 and K6 (the resident body: one kernel) in
    # turns with the tile bodies' (the delta pass and two kernels) at batch 1
    # and 4, beside autograd through the library call.
    vit_h = {}
    for batch in (1, 4):
        for kid in ("K2", "K5", "K1", "K6"):
            hw = (14, 14) if kid in ("K1", "K6") else (64, 64)
            n, ss = hw[0] * hw[1], kid in ("K5", "K6")
            nb = batch * (25 if kid in ("K1", "K6") else 1)
            heads, scale = (1 if ss else 16), 80 ** -0.5
            if ss:      # the grouped operands: one head, BH batches
                q, k, v = (randn((nb * 16, n, 80)).to(torch.bfloat16)
                           for _ in range(3))
                rh, rw = (randn((nb * 16, n, 1, g), 0.5).to(torch.bfloat16)
                          for g in hw)
            else:
                qkv = randn((nb, n, 3 * 1280)).to(torch.bfloat16)
                q, k, v = qkv.split(1280, dim=-1)
                rh, rw = (randn((nb, n, 16, g), 0.5).to(torch.bfloat16)
                          for g in hw)
            shape = {"K1": f"BW={nb} H=16", "K6": f"BWH={nb * 16}",
                     "K2": f"B={nb} H=16", "K5": f"BH={nb * 16}"}[kid]
            shape += f" N={n} d=80"
            body = attention_body(torch.bfloat16, 80, n, n, True, hw)

            def forward(which_body, lse=False):
                return lambda: attention_launch(
                    q, k, v, scale, heads, rh, rw, return_lse=lse,
                    scale_scores=ss, body=which_body)

            mac = nb * 16 * n * n * 80
            fb, fby = bound_ms(4 * mac, nbytes(q, k, v, q, rh, rw))
            lib_fwd, lib_bwd = sdpa_pair(q, k, v, rh, rw, heads, scale)
            with torch.no_grad():
                old_ms, new_ms = paired_ms(forward("mma"), forward(body),
                                           iters=20)
                lib_ms = time_ms(lib_fwd, iters=20)
                plain_ms = (time_ms(lambda: attention_plain(
                    q, k, v, scale, heads, rh, rw, scale_scores=ss))
                    if batch == 1 else None)
            emit("forward_time", kernel=kid, shape=shape, dtype="bfloat16",
                 gpu=gpu, body=body, launches_timed=20, ms=new_ms,
                 earlier_body="mma", earlier_body_ms=old_ms, bound_ms=fb,
                 bound_by=fby, library_ms=lib_ms, plain_ms=plain_ms,
                 over_bound=new_ms / fb, over_library=new_ms / lib_ms)
            row = dict(shape=shape, body=body, ms=new_ms,
                       earlier_body_ms=old_ms, library_ms=lib_ms,
                       plain_ms=plain_ms, bound_ms=fb, bound_by=fby)
            bwd_body = attention_body(torch.bfloat16, 80, n, n, True, hw,
                                      "backward")
            with torch.no_grad():
                out, lse = forward(body, lse=True)()
                dout = torch.randn_like(out)

                def backward(which_body):
                    return lambda: attention_backward_launch(
                        q, k, v, out, lse, dout, scale, heads, rh, rw,
                        scale_scores=ss, body=which_body)
                # in turns with the tile bodies
                tile_bwd_ms, bwd_ms = paired_ms(backward("mma"),
                                                backward(bwd_body))
                bwd_plain_ms = (time_ms(lambda: attention_backward_plain(
                    q, k, v, out, lse, dout, scale, heads, rh, rw,
                    scale_scores=ss)) if batch == 1 else None)
            lib_bwd_ms = time_ms(lib_bwd)
            bb = attention_backward_bound(
                5, mac, nb * 16 * n * n, True, True,
                nbytes(q, k, v, dout, out, lse, q, k, v, rh, rw, rh, rw))
            emit("backward_kernel_time", kernel=kid, shape=shape,
                 dtype="bfloat16", gpu=gpu, body=bwd_body,
                 both_ms=bwd_ms, earlier_body="mma",
                 earlier_body_ms=tile_bwd_ms, plain_ms=bwd_plain_ms,
                 bound_ms=bb[0], bound_by=bb[1],
                 library_backward_ms=lib_bwd_ms,
                 over_library=bwd_ms / lib_bwd_ms,
                 over_bound=bwd_ms / bb[0])
            vit_h.setdefault(kid, {})[f"backward_batch_{batch}"] = dict(
                shape=shape, body=bwd_body, ms=bwd_ms,
                earlier_body_ms=tile_bwd_ms, plain_ms=bwd_plain_ms,
                library_ms=lib_bwd_ms, bound_ms=bb[0], bound_by=bb[1])
            del out, lse, dout
            vit_h.setdefault(kid, {})[f"forward_batch_{batch}"] = row
            del q, k, v, rh, rw, lib_fwd, lib_bwd
            torch.cuda.empty_cache()
    for kid, rows in vit_h.items():
        report[ids[kid]]["vit_h_d80"] = {
            "batch_1": rows["forward_batch_1"],
            "batch_4": rows["forward_batch_4"]}
        # the d-80 backward, launched by the ViT-H fine-tune (phase 8b; K5 and
        # K6 in its grouped run): the whole backward at batch 1, batch 4
        # beside it; the Hopper body's two kernels (K2, K5), the resident
        # body's one (K1, K6)
        layout = "grouped" if kid in ("K5", "K6") else "packed"
        wname = ids[kid]
        one = rows["backward_batch_1"]
        cu = ("wildlifemapper_tpu_torch/csrc/"
              + ("grouped_" if kid in ("K5", "K6") else ""))
        counts_h = vit_h_counts[layout]
        if kid in ("K1", "K6"):
            kernel_fields = dict(
                body="resident", source=cu + "attention_bwd_resident.cu",
                launches=counts_h["backward_launches"][wname],
                covers="delta, dq, dk, dv and the table gradients in one "
                       "kernel", kernels_per_backward=1)
        else:
            kernel_fields = dict(
                body="sm90", source=cu + "attention_bwd_dq_sm90.cu",
                source_dkv=cu + "attention_bwd_dkv_sm90.cu",
                replaces_dkv=jax_ops + replaces_bwd[kid][1],
                launches=counts_h["backward_dq_launches"][wname],
                launches_dkv=counts_h["backward_dkv_launches"][wname],
                covers="dq + delta, then dk/dv")
        source = kernel_fields.pop("source")
        entry(wname + "_backward_d80", source,
              jax_ops + replaces_bwd[kid][0], head_dim=80,
              launches_from="ViT-H fine-tune, remat_blocks, " + layout,
              shape=one["shape"], max_abs_err=bwd_err[f"{kid}_d80"],
              ms=one["ms"], earlier_body="mma",
              earlier_body_ms=one["earlier_body_ms"],
              plain_ms=one["plain_ms"], bound_ms=one["bound_ms"],
              bound_by=one["bound_by"], library_ms=one["library_ms"],
              library="autograd through scaled_dot_product_attention "
                      "(dq, dk, dv)",
              batch_4=rows["backward_batch_4"], **kernel_fields)

    # K3 in bf16 at the main paths' two row counts and at ViT-L's and
    # ViT-H's widths: the forward in turns with the library chain, dh in
    # turns with F.linear and the GELU-gradient product (yardsticks only),
    # 20 launches a turn since the kernels take 0.1-0.3 ms; the forward's
    # two passes alone; the host time of a wrapper call (its tensor maps and
    # launches); at R = 16384 the plain versions as for the other kernels.
    shape, (xx, ww, bb, dd) = bwd_inputs.pop("K3")

    def dh_library(x_, w1_, b1_, da_):
        h = F.linear(x_, w1_, b1_)
        cdf = 0.5 * (1.0 + torch.erf(h * 2.0 ** -0.5))
        return da_ * (cdf + h * torch.exp(-0.5 * h * h)
                      * (2.0 * math.pi) ** -0.5)

    k3 = {}
    for rows, dmod, fdim in ((4 * 4096, 768, 3072), (4 * 2304, 768, 3072),
                             (4 * 4096, 1024, 4096), (4096, 1280, 5120)):
        if (rows, dmod) == tuple(xx.shape):
            x_, w1, b1, da_ = xx, ww, bb, dd
        else:
            x_ = randn((rows, dmod)).to(torch.bfloat16)
            w1 = randn((fdim, dmod), dmod ** -0.5).to(torch.bfloat16)
            b1 = randn((fdim,), 0.1)
            da_ = randn((rows, fdim)).to(torch.bfloat16)
        w2 = randn((dmod, fdim), fdim ** -0.5).to(torch.bfloat16)
        b2 = randn((dmod,), 0.1)
        b1h, b2h = b1.to(torch.bfloat16), b2.to(torch.bfloat16)
        hidden = torch.empty_like(da_)
        out2 = torch.empty_like(x_)
        with torch.no_grad():
            chain_ms, fwd_ms = paired_ms(
                lambda: F.linear(F.gelu(F.linear(x_, w1, b1h)), w2, b2h),
                lambda: fused_mlp(x_, w1, b1, w2, b2), iters=20)
            lib_dh_ms, dh_ms = paired_ms(
                lambda: dh_library(x_, w1, b1h, da_),
                lambda: fused_mlp_dh(x_, w1, b1, da_), iters=20)
            fc1_ms = time_ms(lambda: _gemm(_BIAS_GELU, x_, w1, b1, hidden),
                             iters=20)
            fc2_ms = time_ms(lambda: _gemm(_BIAS, hidden, w2, b2, out2),
                             iters=20)
            fwd_host = host_us(lambda: fused_mlp(x_, w1, b1, w2, b2))
            dh_host = host_us(lambda: fused_mlp_dh(x_, w1, b1, da_))
            dh_plain_ms = (paired_ms(
                lambda: fused_mlp_dh_plain(x_, w1, b1, da_),
                lambda: fused_mlp_dh(x_, w1, b1, da_))[0]
                if x_ is xx else None)
        fb = bound_ms(4 * rows * dmod * fdim, nbytes(x_, x_, w1, w2, b1, b2))
        db = bound_ms(2 * rows * dmod * fdim,
                      nbytes(x_, w1, b1, da_, da_, da_))
        k3[rows, dmod] = dict(
            fwd=fwd_ms, chain=chain_ms, dh=dh_ms, lib_dh=lib_dh_ms,
            dh_plain=dh_plain_ms, fb=fb, db=db,
            dh_bytes_ms=nbytes(x_, w1, b1, da_, da_, da_) / PEAK_BYTES * 1e3)
        emit("kernel_time", kernel="fused_mlp and its dh",
             shape=f"R={rows} D={dmod} F={fdim}", dtype="bfloat16", gpu=gpu,
             forward_ms=fwd_ms, fc1_gelu_ms=fc1_ms, fc2_ms=fc2_ms,
             library_chain_ms=chain_ms, forward_bound_ms=fb[0],
             forward_host_us=fwd_host, dh_ms=dh_ms, dh_library_ms=lib_dh_ms,
             dh_bound_ms=db[0], dh_bound_by=db[1], dh_host_us=dh_host)
        del x_, w1, b1, da_, w2, b2, hidden, out2
        torch.cuda.empty_cache()
    dmod, fdim = xx.shape[1], ww.shape[0]
    big, small = k3[4 * 4096, 768], k3[4 * 2304, 768]
    entry("fused_mlp", mlp_cu, jax_ops + "fused_mlp.py:103",
          launches=serving_counts["fused_mlp"]
          + train_counts["launches"]["fused_mlp"],
          launches_serving=serving_counts["fused_mlp"],
          launches_training=train_counts["launches"]["fused_mlp"],
          kernel_launches_serving_packed=serving_mlp_kernel_launches,
          shape=shape, max_abs_err=errors["fused_mlp"],
          ms=big["fwd"], plain_ms=kernel_ms["fused_mlp"][1],
          bound_ms=big["fb"][0], bound_by=big["fb"][1],
          library_ms=big["chain"],
          library="bf16 F.linear -> F.gelu -> F.linear (three calls)",
          ms_r9216=small["fwd"], library_ms_r9216=small["chain"],
          bound_ms_r9216=small["fb"][0],
          r9216_over_r16384=small["fwd"] / big["fwd"],
          ms_phase5=kernel_ms["fused_mlp"][0])
    entry("fused_mlp_backward_dh", mlp_cu, jax_ops + "fused_mlp.py:148",
          launches=train_counts["backward_launches"]["fused_mlp"],
          shape=shape, max_abs_err=bwd_err["K3_dh"], ms=big["dh"],
          max_abs_err_of="a, dh",
          max_abs_err_wrapper_gradients=bwd_err["K3_wrapper"],
          plain_ms=big["dh_plain"], bound_ms=big["db"][0],
          bound_by=big["db"][1], library_ms=None,
          note_linear_gelu_grad_bf16_ms=big["lib_dh"],
          bound_operations_ms=2 * 4 * 4096 * dmod * fdim / PEAK_FLOPS * 1e3,
          bound_bytes_ms=big["dh_bytes_ms"],
          ms_r9216=small["dh"], note_linear_gelu_grad_bf16_ms_r9216=small[
              "lib_dh"], bound_ms_r9216=small["db"][0],
          r9216_over_r16384=small["dh"] / big["dh"])

    order = ["windowed_attention_packed", "windowed_attention_packed_backward",
             "windowed_attention_packed_backward_d80",
             "flash_attention_packed", "flash_attention_packed_backward_dq",
             "flash_attention_packed_backward_dkv",
             "flash_attention_packed_backward_d80", "fused_mlp",
             "fused_mlp_backward_dh", "cross_attention_packed",
             "cross_attention_packed_backward_dq",
             "cross_attention_packed_backward_dkv",
             "flash_attention_rel_pos", "flash_attention_rel_pos_backward_dq",
             "flash_attention_rel_pos_backward_dkv",
             "flash_attention_rel_pos_backward_d80",
             "windowed_attention_rel_pos",
             "windowed_attention_rel_pos_backward",
             "windowed_attention_rel_pos_backward_d80"]
    for e in report.values():
        if e["launches"] <= 0:
            raise AssertionError(f"{e['name']}: not launched on the main path")
    print(json.dumps({"kernels": [report[n] for n in order], "gpu": gpu}),
          flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
