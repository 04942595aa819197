"""Build and load the port's CUDA kernels.

`load_kernels()` compiles every `csrc/*.cu` into one shared library with a
plain C interface, the first time a kernel is launched, and loads it with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o libwm_kernels.so csrc/*.cu

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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libwm_kernels.so"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "wm_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _I, _I,
                         ctypes.c_float, _P],
    "wm_fused_mlp_fwd": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
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
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    with tempfile.NamedTemporaryFile(dir=out_dir, suffix=".so",
                                     delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
               str(tmp_path), *cu]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stderr[-4000:]}")
        os.replace(tmp_path, lib)
    finally:
        tmp_path.unlink(missing_ok=True)
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


def no_backward(kernel: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kernel}: the backward kernel is not ported yet (ROADMAP queue 2, "
        "training slice); run serving under torch.inference_mode()")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]
