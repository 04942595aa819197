"""Build and load the port's CUDA kernels.

`load_kernels()` compiles every `csrc/*.cu` into one shared library with a
plain C interface, the first time a kernel is launched, and loads it with
ctypes. Each source is compiled by an nvcc of its own, all started together,
and the objects are linked into the library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      (one per source)
    nvcc -shared -o libwm_kernels.so *.o

The library goes to `build/wildlifemapper_tpu_torch/<hash>/` at the root of
the checkout, keyed on a hash of the sources and the flags, so a changed
source is rebuilt and an unchanged one is loaded as it is. nvcc is found
through CUDA_HOME or PATH (see `find_nvcc`); without it the build raises,
and nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "wildlifemapper_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libwm_kernels.so"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ATTENTION_FWD = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I,
                  ctypes.c_float, _P]
_ATTENTION_BWD = ([_I, _I] + [_P] * 13 + [_I] * 5 + [_LL] * 14
                  + [_I, _I, ctypes.c_float, _P])
# the Hopper backward: `out` (with its strides) beside delta, which the dq
# kernel writes with round(q*scale) and the tables side by side for the
# dk/dv kernel
_ATTENTION_BWD_SM90 = ([_I] + [_P] * 16 + [_I] * 5 + [_LL] * 16
                       + [_I, _I, ctypes.c_float, _P])
# the one-kernel windowed backward: `out` (with its strides) in place of delta
_ATTENTION_BWD_RESIDENT = ([_I] + [_P] * 13 + [_I] * 5 + [_LL] * 16
                           + [_I, _I, ctypes.c_float, _P])
# the f32 streaming backward: `which`, then `out` (with its strides) beside
# the delta scratch the dq kernel writes for the dk/dv kernel; no dtype
_ATTENTION_BWD_F32 = ([_I] + [_P] * 14 + [_I] * 5 + [_LL] * 16
                      + [_I, _I, ctypes.c_float, _P])
# the f32 windowed backward: one kernel, `out` (with its strides) in place of
# delta, no `which` and no dtype
_ATTENTION_BWD_F32_WINDOW = ([_P] * 13 + [_I] * 5 + [_LL] * 16
                             + [_I, _I, ctypes.c_float, _P])
# the f32 backward at d 128 without tables: `which`, out beside delta, and the
# ds scratch the dk/dv kernel writes for the dq kernel with its row width;
# no tables, no dtype
_ATTENTION_BWD_F32_D128 = ([_I] + [_P] * 11 + [_I] * 6 + [_LL] * 16
                           + [ctypes.c_float, _P])
_SIGNATURES = {
    # the packed family (K1, K2, K4) and the grouped family (K5, K6) take
    # the same arguments
    "wm_attention_fwd": _ATTENTION_FWD,
    "wm_attention_bwd": _ATTENTION_BWD,
    "wm_grouped_attention_fwd": _ATTENTION_FWD,
    "wm_grouped_attention_bwd": _ATTENTION_BWD,
    # the Hopper bodies of the streaming shapes (K2, K4, K5), bf16
    "wm_attention_fwd_sm90": _ATTENTION_FWD,
    "wm_attention_bwd_dq_sm90": _ATTENTION_BWD_SM90,
    "wm_attention_bwd_dkv_sm90": _ATTENTION_BWD_SM90,
    "wm_grouped_attention_fwd_sm90": _ATTENTION_FWD,
    "wm_grouped_attention_bwd_dq_sm90": _ATTENTION_BWD_SM90,
    "wm_grouped_attention_bwd_dkv_sm90": _ATTENTION_BWD_SM90,
    # the register-tiled f32 bodies of the streaming shapes: both ways at
    # head dim 64 and 80 (K2, K5) and at 128 without tables (K4)
    "wm_attention_bwd_f32": _ATTENTION_BWD_F32,
    "wm_grouped_attention_bwd_f32": _ATTENTION_BWD_F32,
    "wm_attention_fwd_f32": _ATTENTION_FWD,
    "wm_grouped_attention_fwd_f32": _ATTENTION_FWD,
    "wm_attention_bwd_f32_d128": _ATTENTION_BWD_F32_D128,
    # the register-tiled f32 bodies of the windows (K1, K6), both ways
    "wm_attention_bwd_f32_window": _ATTENTION_BWD_F32_WINDOW,
    "wm_grouped_attention_bwd_f32_window": _ATTENTION_BWD_F32_WINDOW,
    "wm_attention_fwd_f32_window": _ATTENTION_FWD,
    "wm_grouped_attention_fwd_f32_window": _ATTENTION_FWD,
    # the resident bodies of the windowed shapes (K1, K6), bf16
    "wm_attention_fwd_resident": _ATTENTION_FWD,
    "wm_attention_bwd_resident": _ATTENTION_BWD_RESIDENT,
    "wm_grouped_attention_fwd_resident": _ATTENTION_FWD,
    "wm_grouped_attention_bwd_resident": _ATTENTION_BWD_RESIDENT,
    # K3: the f32 GEMM body (the forward's two passes, dh), and the bf16
    # Hopper GEMM body with its epilogues
    "wm_fused_mlp_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "wm_fused_mlp_dh": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "wm_mlp_gemm": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "wm_mlp_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME (or CUDA_PATH), else PATH, else the toolkit's
    default install directory; raises if there is none."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is not None:
        return nvcc
    if (Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has none yet; return its
    path. The compiler's output (ptxas register and spill counts) is kept
    beside it as build.log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [p for p in sources() if p.suffix == ".cu"]
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (p.stem + ".o") for p in cu]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                 str(p)] for p, o in zip(cu, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        log = []
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate()
            log.append(" ".join(cmd) + "\n" + out)
        link = [nvcc, "-shared", "-o", str(Path(tmp) / LIB_NAME),
                *map(str, objs)]
        failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed = [link]
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed ({' '.join(failed[0][-3:])}):\n"
                               + "\n".join(log)[-6000:])
        os.replace(Path(tmp) / LIB_NAME, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load_kernels() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry's
    argtypes set so that pointers pass as 64-bit values."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]
