"""The run's surroundings: where caches go, which card it runs on, and the
check that nothing of JAX was loaded.

Build and kernel caches live at fixed paths inside the checkout, so that
only a cell's first run in a checkout builds: the port's own kernel library
and native matcher under build/wildlifemapper_tpu_torch/ (the program fixes
that path), torch's extension builds and Triton's cache under
build/portbench/. Nothing is written elsewhere but the HOME, XDG_CACHE_HOME
and TMPDIR the run is given.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

CHECKOUT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "wildlifemapper_tpu")


def set_cache_dirs(checkout: Path = CHECKOUT) -> None:
    """Point every build and kernel cache at a fixed directory of the
    checkout, and keep the process to one CPU thread a pool (before torch
    is imported), as torchrun, the port's launcher across cards, sets each
    rank: the card's machine shares its cores, and a pool's idle threads
    spinning beside the thread that dispatches the step make the host-bound
    steps' times swing."""
    base = checkout / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    for pool in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[pool] = "1"


def forbidden_modules(modules=None) -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name begins with the JAX package's)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (weights, tiles, dropout),
    so that streams do not share numbers."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def card(chips: int):
    """(name, count, power limit in W or None) of the cards, or raise
    SystemExit with a message when CUDA or enough cards are missing."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is False; "
                         "the benchmark measures the card and has no CPU "
                         "fallback")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    return torch.cuda.get_device_name(0), chips, power_limit()


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
