"""ctypes bindings for the native host helpers (src/wm_native.cpp, a byte
copy of the JAX package's); counterpart of wildlifemapper_tpu/native.

The library is built at first use, not at import:

    g++ -O3 -shared -fPIC src/wm_native.cpp -o libwm_native.so

into `build/wildlifemapper_tpu_torch/native/<hash>/` at the root of the
checkout, keyed on a hash of the source and the flags, as ops/_build.py
builds the CUDA kernels. These are host helpers with the numpy paths'
results, not device kernels: every entry point keeps the JAX module's
fallback where no compiler is at hand, and `available()` says whether the
native path is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "wm_native.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "wildlifemapper_tpu_torch" / "native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIB_NAME = "libwm_native.so"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(src: Path = SRC, root: Path = BUILD_ROOT) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return root / h.hexdigest()[:16] / LIB_NAME


def build(src: Path = SRC, root: Path = BUILD_ROOT) -> Path:
    """Compile `src` if this hash has no library yet; return its path.
    Raises where g++ fails or is absent."""
    lib = library_path(src, root)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = Path(tmp) / LIB_NAME
        subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(out)],
                       check=True, capture_output=True, timeout=120)
        os.replace(out, lib)
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """Load the library at `path` with every entry's argument types set."""
    lib = ctypes.CDLL(str(path))
    lib.wm_lapjv.restype = ctypes.c_int
    lib.wm_lapjv.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    lib.wm_nms.restype = ctypes.c_int
    lib.wm_nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
    lib.wm_coco_match.restype = None
    lib.wm_coco_match.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64)]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        _lib = bind(build())
    except (OSError, subprocess.SubprocessError):
        return None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def lapjv(cost: np.ndarray) -> np.ndarray:
    """Square LSAP (minimize). cost (n, n) -> row_to_col (n,) int32."""
    lib = _load()
    n = cost.shape[0]
    if lib is None:
        from scipy.optimize import linear_sum_assignment
        r, c = linear_sum_assignment(cost)
        out = np.zeros(n, np.int32)
        out[r] = c
        return out
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    out = np.zeros(n, dtype=np.int32)
    rc = lib.wm_lapjv(_ptr(cost, ctypes.c_float), n, _ptr(out, ctypes.c_int))
    if rc != 0:
        raise RuntimeError("wm_lapjv infeasible")
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float) -> np.ndarray:
    """Greedy class-agnostic NMS -> kept indices (score-desc order not
    guaranteed; mask semantics)."""
    lib = _load()
    n = len(boxes)
    if n == 0:
        return np.zeros(0, np.int64)
    if lib is None:
        from ..eval.orthomosaic import _nms_numpy
        return _nms_numpy(np.asarray(boxes, np.float64),
                          np.asarray(scores, np.float64), iou_thr)
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros(n, np.int32)
    lib.wm_nms(_ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
               n, iou_thr, _ptr(keep, ctypes.c_int32))
    return np.nonzero(keep)[0].astype(np.int64)


def coco_match(ious: np.ndarray, iou_thrs: np.ndarray,
               g_ignore: np.ndarray, g_crowd: np.ndarray):
    """COCOeval greedy matching (see wm_coco_match). Returns dtm, dt_ig,
    gtm, or None without the library (the caller's numpy loop then)."""
    lib = _load()
    D, G = ious.shape
    T = len(iou_thrs)
    if lib is None:
        return None
    ious = np.ascontiguousarray(ious, np.float64)
    iou_thrs = np.ascontiguousarray(iou_thrs, np.float64)
    gi = np.ascontiguousarray(g_ignore, np.uint8)
    gc = np.ascontiguousarray(g_crowd, np.uint8)
    dtm = np.zeros((T, D), np.int64)
    dt_ig = np.zeros((T, D), np.uint8)
    gtm = np.zeros((T, G), np.int64)
    lib.wm_coco_match(
        _ptr(ious, ctypes.c_double), D, G, _ptr(iou_thrs, ctypes.c_double),
        T, _ptr(gi, ctypes.c_uint8), _ptr(gc, ctypes.c_uint8),
        _ptr(dtm, ctypes.c_int64), _ptr(dt_ig, ctypes.c_uint8),
        _ptr(gtm, ctypes.c_int64))
    return dtm, dt_ig.astype(bool), gtm
