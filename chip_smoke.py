"""Smoke test of the PyTorch port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Drives the port's serving path (wildlifemapper_tpu_torch: HFC -> ViT-B ->
box decoder -> postprocess + NMS) at the full ViT-B width, through its
hand-written CUDA kernels, and checks it. Phases, one JSON line each; any
failure raises and exits non-zero:

  1. device: the card's name and power limit; build the kernels from
     wildlifemapper_tpu_torch/csrc (timed); TF32 off.
  2. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it, f32 at atol 2e-5 / rtol 1e-4 and
     bf16 (against the plain version in f32 on the same bf16-rounded
     inputs) at 2e-2.
  3. end to end: the f32 forward with kernels against the PyTorch
     reference's logits and boxes in tests/goldens/full_model.npz (weights
     regenerated from their names), at atol 1e-4 / rtol 1e-3, and the launch
     counts of one forward (K1 8, K2 4, K3 12, K4 1).
  4. serving: bf16, batch 4, three batches of 768-px content in a 1024
     canvas through forward + postprocess + NMS in each of the three
     configurations; finite detections, boxes in range, launch counts; the
     bf16-kernel against f32-plain drift.
  5. times: each configuration with kernels and with the plain path, and
     each kernel against its plain version, with CUDA events.

The last line is {"ok": true, "device": {...}}. Without CUDA, or without the
rest of the repository beside it, the script fails before any result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BATCH = 4
N_BATCHES = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def gpu_query() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """'kernel<type,width>: registers, spill bytes' for each kernel that
    nvcc's -Xptxas -v compiled."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(attn_tc_kernel|attn_fwd_kernel|fused_mlp_tc_kernel"
                      r"|fused_mlp_kernel)I\d*(\w*?)Li(\d+)E", line)
        if m and "entry function" in line:
            dtype = {"f": "float,", "": ""}.get(m.group(2),
                                                m.group(2).strip("_") + ",")
            name = f"{m.group(1)}<{dtype}{m.group(3)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return out


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
    from wildlifemapper_tpu_torch.ops import _build
    from wildlifemapper_tpu_torch.ops.cross_attention import (
        cross_attention_packed, cross_attention_packed_plain)
    from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
        flash_attention_packed, flash_attention_packed_plain)
    from wildlifemapper_tpu_torch.ops.fused_mlp import (fused_mlp,
                                                        fused_mlp_plain)
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
        windowed_attention_packed, windowed_attention_packed_plain)
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
    ptxas = ptxas_summary((lib_path.parent / "build.log").read_text())
    emit("device", kind=kind, gpu=gpu, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(build_s, 2), ptxas=ptxas)

    kernels = {
        "windowed_attention_packed": dict(
            wrapper=windowed_attention_packed,
            plain=windowed_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/windowed_attention_v2.py:200"),
        "flash_attention_packed": dict(
            wrapper=flash_attention_packed,
            plain=flash_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/flash_attention_v2.py:183"),
        "fused_mlp": dict(
            wrapper=fused_mlp, plain=fused_mlp_plain,
            source="wildlifemapper_tpu_torch/csrc/fused_mlp.cu",
            replaces="wildlifemapper_tpu/ops/fused_mlp.py:97"),
        "cross_attention_packed": dict(
            wrapper=cross_attention_packed,
            plain=cross_attention_packed_plain,
            source="wildlifemapper_tpu_torch/csrc/attention.cu",
            replaces="wildlifemapper_tpu/ops/cross_attention.py:150"),
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

    def mlp_args(r, d=768, f=3072):
        return [randn((r, d)), randn((f, d), d ** -0.5), randn((f,), 0.1),
                randn((d, f), f ** -0.5), randn((d,), 0.1)]

    c, hd = 1024, 128
    cases = [
        ("windowed_attention_packed", "BW=4*25 N=196",
         lambda: attn_args(4 * 25, (14, 14))),
        ("windowed_attention_packed", "BW=4*16 N=144",
         lambda: attn_args(4 * 16, (12, 12))),
        ("flash_attention_packed", "B=4 N=4096", lambda: attn_args(4, (64, 64))),
        ("flash_attention_packed", "B=4 N=2304", lambda: attn_args(4, (48, 48))),
        ("fused_mlp", "R=4*4096", lambda: mlp_args(4 * 4096)),
        ("cross_attention_packed", "B=4 N=M=4096",
         lambda: [randn((4, 4096, c)), randn((4, 4096, c)),
                  randn((4, 4096, c)), hd ** -0.5, c // hd]),
        ("cross_attention_packed", "B=4 N=M=2304",
         lambda: [randn((4, 2304, c)), randn((4, 2304, c)),
                  randn((4, 2304, c)), hd ** -0.5, c // hd]),
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
                if dt == torch.bfloat16 and name not in kernel_inputs:
                    kernel_inputs[name] = (shape, args)
            del base, args, got, ref
            torch.cuda.empty_cache()

    def counts():
        return {n: k["wrapper"].launches for n, k in kernels.items()}

    def reset_counts():
        for k in kernels.values():
            k["wrapper"].launches = 0

    per_forward = {"windowed_attention_packed": 8,
                   "flash_attention_packed": 4, "fused_mlp": 12,
                   "cross_attention_packed": 1}

    # ---- 3. end to end against the PyTorch reference -----------------------
    npz = np.load(Path(__file__).resolve().parent / "tests" / "goldens"
                  / "full_model.npz")
    golden_sd = meta_to_state_dict(npz["meta"])
    model = WildlifeMapper(model_config("vit_b", use_flash_attention=True))
    load_reference_state_dict(model, golden_sd)
    model = model.to(dev).eval()
    x = torch.from_numpy(padded_canvas(seed=107)).to(dev)
    reset_counts()
    with torch.inference_mode():
        out = model(x)
        torch.cuda.synchronize()
    e2e_counts = counts()
    d_logits = float(np.abs(out["pred_logits"].cpu().numpy()
                            - npz["logits"]).max())
    d_boxes = float(np.abs(out["pred_boxes"].cpu().numpy()
                           - npz["boxes"]).max())
    emit("end_to_end", config="vit_b f32 full canvas, kernels",
         max_abs_diff_logits=d_logits, max_abs_diff_boxes=d_boxes,
         atol=1e-4, rtol=1e-3, launches=e2e_counts)
    np.testing.assert_allclose(out["pred_logits"].cpu().numpy(),
                               npz["logits"], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(out["pred_boxes"].cpu().numpy(),
                               npz["boxes"], atol=1e-4, rtol=1e-3)
    if e2e_counts != per_forward:
        raise AssertionError(f"launches per forward {e2e_counts}, "
                             f"want {per_forward}")
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
        return m.to(dev).eval()

    def serve(m, images):
        out = m(images)
        dets = postprocess(out, sizes, confidence_threshold=0.05)
        dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                   dets["labels"], dets["keep"], 0.4,
                                   class_aware=False)
        return out, dets

    models = {name: build(cfg) for name, cfg in configs.items()}
    reset_counts()                 # the main path's run starts here
    served = {}
    with torch.inference_mode():
        for name, m in models.items():
            outs = [serve(m, xb) for xb in batches]
            torch.cuda.synchronize()
            served[name] = outs
    main_counts = counts()         # ... and ends here
    for name, outs in served.items():
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
    want = {n: v * N_BATCHES * len(configs) for n, v in per_forward.items()}
    emit("main_path_launches", launches=main_counts, want=want)
    if main_counts != want or min(main_counts.values()) == 0:
        raise AssertionError(f"main path launches {main_counts}, "
                             f"want {want}")

    # bf16 with kernels against f32 on the plain path, same weights/input
    with torch.inference_mode():
        for name, cfg in configs.items():
            ref_m = build(dataclasses.replace(cfg, dtype="float32",
                                              use_flash_attention=False))
            ref = ref_m(batches[0])
            out = served[name][0][0]
            p16 = torch.softmax(out["pred_logits"], -1)[..., :-1]
            p32 = torch.softmax(ref["pred_logits"], -1)[..., :-1]
            emit("bf16_drift", config=name,
                 max_class_prob_diff=(p16 - p32).abs().max().item(),
                 max_box_diff_px=((out["pred_boxes"] - ref["pred_boxes"])
                                  .abs().max().item() * 1024),
                 label_agreement=(p16.argmax(-1) == p32.argmax(-1))
                 .float().mean().item())
            del ref_m, ref
            torch.cuda.empty_cache()

    # ---- 5. times ------------------------------------------------------------
    del served
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

        kernel_ms = {}
        for name, (shape, args) in kernel_inputs.items():
            k = kernels[name]
            ms_plain, ms_kern = paired_ms(lambda: k["plain"](*args),
                                          lambda: k["wrapper"](*args))
            kernel_ms[name] = (ms_kern, ms_plain)
            emit("kernel_time", kernel=name, shape=shape, dtype="bfloat16",
                 gpu=gpu, ms=ms_kern, plain_ms=ms_plain)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": main_counts[name],
         "max_abs_err": errors[name], "ms": kernel_ms[name][0],
         "plain_ms": kernel_ms[name][1]}
        for name, k in kernels.items()]}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
