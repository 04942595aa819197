"""Variants of K3's f32 GEMM body, timed on one NVIDIA GPU (written for the
H100) beside F.linear in f32 (cuBLAS SGEMM, TF32 off), at ViT-B's K3 shapes:

    python3 scripts/sweep_f32_gemm.py [--variants JSON] [--turns N]

`scripts/sweep_f32_gemm.cu` holds the body (csrc/mlp_gemm_f32.cuh) with its
tile shape, k-slab depth, staging and unroll as macros; each variant is
built by its own nvcc (all started together) into
build/sweep_f32_gemm/<variant>/ and loaded with ctypes. `--variants` maps a
name to its macros, e.g. '{"base": {}, "bk8": {"BK": 8}}' (DEFAULT below
when left out). Each shape (fc1 + GELU at R 16384, D 768 -> F 3072; fc2 back
to 768; dh; fc2 at ViT-H's batch 1, R 4096, F 5120 -> D 1280) is run once
by every variant, checked bit for bit against the first, then timed in N
turns (forward order on even turns, backward on odd) by CUDA events over
20 launches, with F.linear in the same turns. One JSON line a variant
(ptxas registers and spills) and a shape (the best turn's ms and TFLOP/s
of each), the card's name and power limit first. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_suffix(".cu")
BUILD = ROOT / "build" / "sweep_f32_gemm"
DEFAULT = {
    "first": {},                                    # warps 2 x 4, lanes 8 x 4
    "lanes_4x8": {"LANES_M": 4, "WARPS_M": 4},      # the body's shape
    "minb1": {"MINB": 1},                           # no register cap
    "bk8": {"BK": 8},
    "t128_8x16": {"THREADS": 128, "TNQ": 4},        # 8 x 16 a thread
    "t128_16x8": {"THREADS": 128, "TMQ": 4, "LANES_M": 4},
    "t256_8x16": {"TNQ": 4, "MINB": 1},             # 128 x 256 tiles
    "lanes_4x8_unroll8": {"LANES_M": 4, "WARPS_M": 4, "KK_UNROLL": 8},
    "lanes_4x8_async3": {"LANES_M": 4, "WARPS_M": 4, "ASYNC": 1,
                         "STAGES": 3},
}
# name, epilogue (0 fc1 + GELU, 1 fc2, 2 dh), rows, columns, depth
SHAPES = [("fc1", 0, 16384, 3072, 768), ("fc2", 1, 16384, 768, 3072),
          ("dh", 2, 16384, 3072, 768),
          ("fc2 ViT-H batch 1", 1, 4096, 1280, 5120)]
ITERS = 20


def nvcc() -> str:
    sys.path.insert(0, str(ROOT))
    from wildlifemapper_tpu_torch.ops._build import find_nvcc
    return find_nvcc()


def build(variants: dict) -> dict:
    """name -> the loaded library, each variant by its own nvcc."""
    procs = {}
    for name, defs in variants.items():
        out = BUILD / name
        out.mkdir(parents=True, exist_ok=True)
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
               "-Xptxas", "-v", *[f"-D{k}={v}" for k, v in defs.items()],
               "-o", str(out / "libsweep.so"), str(SOURCE)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        print(json.dumps(dict(
            variant=name, macros=variants[name], rc=proc.returncode,
            registers=re.findall(r"Used (\d+) registers", log),
            spill_bytes=re.findall(r"(\d+) bytes spill stores", log))),
            flush=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(BUILD / name / "libsweep.so"))
        lib.sweep_gemm.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=None,
                    help="JSON: variant name -> its macros")
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(gpu=gpu)), flush=True)
    libs = build(json.loads(args.variants) if args.variants else DEFAULT)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for shape, epilogue, m, n, k in SHAPES:
        a = torch.randn(m, k, device=dev, generator=gen)
        b = torch.randn(n, k, device=dev, generator=gen) * k ** -0.5
        bias = torch.randn(n, device=dev, generator=gen) * 0.1
        da = torch.randn(m, n, device=dev, generator=gen)
        outs = {name: torch.empty(m, n, device=dev) for name in libs}
        act = torch.empty(m, n, device=dev) if epilogue == 2 else None

        def run(name):
            err = libs[name].sweep_gemm(
                epilogue, a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                da.data_ptr(), outs[name].data_ptr(),
                None if act is None else act.data_ptr(), m, n, k, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError_t {err}")

        for name in libs:
            run(name)
        torch.cuda.synchronize()
        first = next(iter(outs.values()))
        same = {name: torch.equal(out, first) for name, out in outs.items()}
        turns = {name: [] for name in [*libs, "F.linear"]}
        order = list(turns)
        for turn in range(args.turns):
            for name in order if turn % 2 == 0 else order[::-1]:
                turns[name].append(time_ms(
                    (lambda: F.linear(a, b, bias)) if name == "F.linear"
                    else (lambda: run(name))))
        flops = 2 * m * n * k
        print(json.dumps(dict(
            shape=shape, m=m, n=n, k=k, bit_identical=same,
            ms={name: min(t) for name, t in turns.items()},
            tflops={name: flops / min(t) / 1e9 for name, t in turns.items()})),
            flush=True)
        if not all(same.values()):
            raise AssertionError(f"{shape}: variants disagree {same}")
        del a, b, bias, da, outs, act
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
