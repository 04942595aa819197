"""Which kernel body an attention launch takes (ops/_attention.py::
attention_body, a pure function of dtype and shapes), and what the sources
of the Hopper bodies must say and define. Runs on the CPU: no kernel is
built or launched here (tests/test_torch_cuda.py holds the bodies against
each other on the card)."""

import re

import pytest
import torch

from wildlifemapper_tpu_torch.ops import _attention, _build
from wildlifemapper_tpu_torch.ops._attention import (STREAM_MIN_KEYS,
                                                     attention_body)

BF16, F32 = torch.bfloat16, torch.float32

# (kernel, dtype, d, nq, nk, has_rel) -> body, at the shapes of the main
# paths: the full canvas (64-grid, 14-windows), the 48-grid with windows of
# 12, and the adaptor's cross attention.
MAIN_PATH = [
    ("K2 full canvas", BF16, 64, 4096, 4096, True, "sm90"),
    ("K2 48-grid", BF16, 64, 2304, 2304, True, "sm90"),
    ("K5 full canvas", BF16, 64, 4096, 4096, True, "sm90"),
    ("K5 48-grid", BF16, 64, 2304, 2304, True, "sm90"),
    ("K4 full canvas", BF16, 128, 4096, 4096, False, "sm90"),
    ("K4 48-grid", BF16, 128, 2304, 2304, False, "sm90"),
    ("K1 window of 14", BF16, 64, 196, 196, True, "mma"),
    ("K1 window of 12", BF16, 64, 144, 144, True, "mma"),
    ("K6 window of 14", BF16, 64, 196, 196, True, "mma"),
    ("K6 window of 12", BF16, 64, 144, 144, True, "mma"),
    ("K2 parity", F32, 64, 4096, 4096, True, "mma"),
    ("K4 parity", F32, 128, 4096, 4096, False, "mma"),
    ("K5 parity", F32, 64, 2304, 2304, True, "mma"),
    ("K1 parity", F32, 64, 196, 196, True, "mma"),
]


@pytest.mark.parametrize("what,dtype,d,nq,nk,rel,body", MAIN_PATH,
                         ids=[c[0] for c in MAIN_PATH])
def test_main_path_shapes(what, dtype, d, nq, nk, rel, body):
    assert attention_body(dtype, d, nq, nk, rel) == body


@pytest.mark.parametrize("d,nq,nk,rel,body", [
    (64, 200, 1000, True, "sm90"),       # ragged rows and tiles
    (128, 1, STREAM_MIN_KEYS, False, "sm90"),
    (128, 4096, STREAM_MIN_KEYS - 1, False, "mma"),
    (64, 4096, 196, True, "mma"),        # many queries, one window of keys
    (32, 4096, 4096, True, "mma"),       # d = 32 is on no main path
    (32, 4096, 4096, False, "mma"),
    (128, 2304, 2304, True, "sm90"),     # d = 128 with tables
    (64, 1023, 1023, True, "sm90"),      # the largest N the JAX K6 takes
])
def test_other_bf16_shapes(d, nq, nk, rel, body):
    assert attention_body(BF16, d, nq, nk, rel) == body


@pytest.mark.parametrize("nq", [1, 100, 128, 129, 5000])
def test_body_does_not_depend_on_the_queries(nq):
    assert attention_body(BF16, 64, nq, 4096, True) == "sm90"
    assert attention_body(BF16, 64, nq, 144, True) == "mma"
    assert attention_body(F32, 64, nq, 4096, True) == "mma"


@pytest.mark.parametrize("dtype,d,nq,nk,error", [
    (torch.float16, 64, 128, 4096, TypeError),
    (torch.float64, 64, 128, 4096, TypeError),
    (BF16, 48, 128, 4096, ValueError),
    (BF16, 256, 128, 4096, ValueError),
    (F32, 16, 128, 128, ValueError),
    (BF16, 64, 0, 4096, ValueError),
    (BF16, 64, 128, 0, ValueError),
])
def test_unsupported_raises(dtype, d, nq, nk, error):
    with pytest.raises(error):
        attention_body(dtype, d, nq, nk, False)


def test_named_body_is_checked():
    q = torch.zeros(1, 8, 64, dtype=BF16)
    assert _attention._pick_body(None, q, 64, 4096, True) == "sm90"
    assert _attention._pick_body("mma", q, 64, 4096, True) == "mma"
    with pytest.raises(ValueError, match="expected one of"):
        _attention._pick_body("plain", q, 64, 4096, True)


def test_dispatch_reads_no_environment(monkeypatch):
    """The choice follows from dtype and shapes alone."""
    for name in ("WM_ATTENTION_BODY", "WM_BODY", "ATTENTION_BODY"):
        monkeypatch.setenv(name, "mma")
    assert attention_body(BF16, 128, 4096, 4096, False) == "sm90"
    assert "environ" not in (_build.CSRC.parent / "ops"
                             / "_attention.py").read_text()


SM90_HEADERS = {
    "attention_fwd_sm90.cuh": (
        "flash_attention_v2.py::flash_attention_packed",
        "cross_attention.py::cross_attention_packed",
        "flash_attention.py::flash_attention_rel_pos"),
    "attention_bwd_sm90.cuh": (
        "flash_attention_v2.py::_bwd_dq_kernel", "::_bwd_dkv_kernel",
        "cross_attention.py::_bwd_dq_kernel",
        "flash_attention.py::_bwd_kernel"),
}


@pytest.mark.parametrize("name", sorted(SM90_HEADERS))
def test_hopper_header_note(name):
    """Each body names the TPU kernels it replaces, its bound on the H100
    and what the design does about it."""
    text = (_build.CSRC / name).read_text()
    note = text[:text.index("#pragma once")]
    for replaced in SM90_HEADERS[name]:
        assert replaced in note, replaced
    assert "What bounds" in note and "operations" in note
    for word in ("wgmma", "TMA", "ring", "mbarrier", "MN-major",
                 "setmaxnreg"):
        assert word in note, word
    # the design is in the code, not only in the note
    text += (_build.CSRC / "attention_sm90_common.cuh").read_text()
    for word in ("wgmma_rs<", "tma_load_3d", "mbar_wait", "reg_alloc<",
                 "desc_mnmajor"):
        assert word in text, word
    assert "atomic" not in text.replace("no\n// atomics", "").replace(
        "no atomics", "")


@pytest.mark.parametrize("name,stays", [
    ("attention_fwd.cuh", "attention_fwd_sm90.cuh"),
    ("attention_bwd.cuh", "attention_bwd_sm90.cuh"),
])
def test_tile_headers_say_what_still_runs_there(name, stays):
    note = (_build.CSRC / name).read_text()
    note = note[:note.index("#pragma once")]
    assert stays in note
    assert "K1" in note and "K6" in note and "f32" in note


SM90_SOURCES = ["attention_sm90.cu", "grouped_attention_sm90.cu",
                "attention_bwd_dq_sm90.cu", "attention_bwd_dkv_sm90.cu",
                "grouped_attention_bwd_dq_sm90.cu",
                "grouped_attention_bwd_dkv_sm90.cu"]


@pytest.mark.parametrize("name", SM90_SOURCES)
def test_hopper_source(name):
    """One small source an instantiation set, so the nvcc runs stay side by
    side; each says which TPU kernels it stands for."""
    path = _build.CSRC / name
    assert path in _build.sources()
    text = path.read_text()
    assert "JAX package" in text and "_sm90.cuh" in text
    assert len(re.findall(r"^WM_DEFINE_ATTENTION_\w+_SM90\(", text,
                          re.M)) == 1
    assert len(text.splitlines()) < 30


def test_every_entry_has_a_signature():
    """The plain C entries the sources define are the ones ctypes binds."""
    defined = set()
    for path in _build.sources():
        if path.suffix != ".cu":
            continue
        text = path.read_text()
        defined |= set(re.findall(r"^WM_DEFINE_\w+\((wm_\w+)", text, re.M))
        defined |= set(re.findall(r'^extern "C" int (wm_\w+)\(', text, re.M))
    assert defined == set(_build._SIGNATURES)
    sm90 = {n for n in defined if n.endswith("_sm90")}
    assert len(sm90) == 6
    for n in sm90:                      # the families' own argument lists
        base = _build._SIGNATURES["wm_attention_fwd" if "_fwd_" in n
                                  else "wm_attention_bwd"]
        want = base if "_fwd_" in n else base[1:]   # no `which`
        assert _build._SIGNATURES[n] == want


def test_port_sources_import_no_jax():
    root = _build.CSRC.parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from) (jax|flax|optax|"
                             r"wildlifemapper_tpu)\b(?!_torch)", text,
                             re.M), path
