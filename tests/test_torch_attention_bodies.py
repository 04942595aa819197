"""Which kernel body an attention launch takes (ops/_attention.py::
attention_body, a pure function of dtype and shapes), and what the sources
of the Hopper and the resident bodies must say and define. Runs on the
CPU: no kernel is built or launched here (tests/test_torch_cuda.py holds
the bodies against each other on the card)."""

import re

import pytest
import torch

from wildlifemapper_tpu_torch.ops import _attention, _build
from wildlifemapper_tpu_torch.ops._attention import (RESIDENT_MAX_GRID,
                                                     RESIDENT_MAX_TOKENS,
                                                     STREAM_MIN_KEYS,
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
    ("K1 window of 14", BF16, 64, 196, 196, True, "resident"),
    ("K1 window of 12", BF16, 64, 144, 144, True, "resident"),
    ("K6 window of 14", BF16, 64, 196, 196, True, "resident"),
    ("K6 window of 12", BF16, 64, 144, 144, True, "resident"),
    ("K2 parity", F32, 64, 4096, 4096, True, "mma"),
    ("K4 parity", F32, 128, 4096, 4096, False, "mma"),
    ("K5 parity", F32, 64, 2304, 2304, True, "mma"),
    ("K1 parity", F32, 64, 196, 196, True, "mma"),
    ("K6 parity", F32, 64, 144, 144, True, "mma"),
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


# The resident body: bf16, d = 64, one window of at most RESIDENT_MAX_TOKENS
# tokens (N == M) with rel tables at most RESIDENT_MAX_GRID wide.
@pytest.mark.parametrize("dtype,d,nq,nk,rel,grid,body", [
    (BF16, 64, 196, 196, True, (14, 14), "resident"),
    (BF16, 64, 144, 144, True, (12, 12), "resident"),
    (BF16, 64, 49, 49, True, (7, 7), "resident"),       # ragged windows
    (BF16, 64, 100, 100, True, (10, 10), "resident"),
    (BF16, 64, 1, 1, True, (1, 1), "resident"),
    (BF16, 64, RESIDENT_MAX_TOKENS, RESIDENT_MAX_TOKENS, True, (13, 16),
     "resident"),
    (BF16, 64, 196, 196, True, None, "resident"),       # grid not given
    (F32, 64, 196, 196, True, (14, 14), "mma"),
    (BF16, 32, 196, 196, True, (14, 14), "mma"),
    (BF16, 128, 196, 196, True, (14, 14), "mma"),
    (BF16, 64, 196, 144, True, (12, 12), "mma"),        # N != M
    (BF16, 64, 144, 196, True, (14, 14), "mma"),
    (BF16, 64, 196, 196, False, None, "mma"),           # no tables
    (BF16, 64, RESIDENT_MAX_TOKENS + 1, RESIDENT_MAX_TOKENS + 1, True,
     (11, 19), "mma"),
    # a global block below GLOBAL_N_THRESHOLD tokens that lands in K1 / K6
    (BF16, 64, 256, 256, True, (16, 16), "mma"),
    (BF16, 64, 484, 484, True, (22, 22), "mma"),
    (BF16, 64, 1023, 1023, True, (31, 33), "sm90"),
    # tables wider than the body's one-hot expansion holds
    (BF16, 64, 102, 102, True, (6, RESIDENT_MAX_GRID + 1), "mma"),
    (BF16, 64, 102, 102, True, (RESIDENT_MAX_GRID + 1, 6), "mma"),
])
def test_resident_body_shapes(dtype, d, nq, nk, rel, grid, body):
    assert attention_body(dtype, d, nq, nk, rel, grid) == body


def test_resident_limit_holds_the_main_path_windows():
    assert RESIDENT_MAX_TOKENS >= 196 and RESIDENT_MAX_TOKENS % 16 == 0
    assert RESIDENT_MAX_TOKENS < STREAM_MIN_KEYS
    assert RESIDENT_MAX_GRID >= 14
    # the kernels' own limits are the same numbers
    text = (_build.CSRC / "attention_fwd_resident.cuh").read_text()
    assert f"kResMaxTokens = {RESIDENT_MAX_TOKENS};" in text
    assert f"kResMaxGrid = {RESIDENT_MAX_GRID};" in text


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
    rel = torch.zeros(1, 8, 1, 64, dtype=BF16)
    assert _attention._pick_body(None, q, 64, 4096, rel, rel) == "sm90"
    assert _attention._pick_body("mma", q, 64, 4096, rel, rel) == "mma"
    with pytest.raises(ValueError, match="expected one of"):
        _attention._pick_body("plain", q, 64, 4096, rel, rel)
    # the tables' widths decide between the resident and the tile body
    q = torch.zeros(1, 102, 64, dtype=BF16)
    narrow = (torch.zeros(1, 102, 1, 6, dtype=BF16),
              torch.zeros(1, 102, 1, 17, dtype=BF16))
    assert _attention._pick_body(None, q, 64, 102, *narrow) == "mma"
    assert _attention._pick_body("resident", q, 64, 102, *narrow) == "resident"
    square = (torch.zeros(1, 100, 1, 10, dtype=BF16),) * 2
    assert _attention._pick_body(None, q[:, :100], 64, 100,
                                 *square) == "resident"
    assert _attention._pick_body(None, q[:, :100], 64, 100, None,
                                 None) == "mma"


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
    assert stays.replace("_sm90", "_resident") in note
    assert "K1" in note and "K6" in note and "f32" in note


RESIDENT_HEADERS = {
    "attention_fwd_resident.cuh": (
        "windowed_attention_v2.py::windowed_attention_packed",
        "windowed_attention.py::windowed_attention_rel_pos"),
    "attention_bwd_resident.cuh": (
        "windowed_attention_v2.py::_bwd_kernel",
        "windowed_attention.py::_bwd_kernel"),
}


@pytest.mark.parametrize("name", sorted(RESIDENT_HEADERS))
def test_resident_header_note(name):
    """Each body names the TPU kernels it replaces, its bound on the H100
    and what the design does about it."""
    text = (_build.CSRC / name).read_text()
    note = text[:text.index("#pragma once")]
    for replaced in RESIDENT_HEADERS[name]:
        assert replaced in note, replaced
    assert "What bounds" in note and "bytes" in note
    for word in ("mma.sync", "ldmatrix", "resident", "shared memory",
                 "persistent", "one-hot", "232,448", "cp.async"):
        assert word in note, word
    # the design is in the code, not only in the note
    text += (_build.CSRC / "attention_fwd_resident.cuh").read_text()
    for word in ("ldsm_x4_trans", "res_ldbt<", "mma_16816(", "res_ex2(",
                 "res_cp16(", "res_wait<"):
        assert word in text, word
    assert "atomic" not in text.replace("no atomics", "")


def test_resident_backward_is_one_kernel_with_delta_inside():
    text = (_build.CSRC / "attention_bwd_resident.cuh").read_text()
    assert len(re.findall(r"^__global__", text, re.M)) == 1
    note = text[:text.index("#pragma once")]
    for word in ("delta", "bit-identical", "ldmatrix.trans", "pass 1",
                 "pass 2"):
        assert word in note, word
    # the launcher runs no delta pass for this body and counts one launch
    launch = (_build.CSRC.parent / "ops" / "_attention.py").read_text()
    launch = launch[launch.index("def attention_backward_launch"):]
    resident = launch[launch.index('if body == "resident"'):
                      launch.index("delta = attention_delta")]
    assert "backward_launches" in resident
    assert "attention_delta" not in resident


RESIDENT_SOURCES = ["attention_resident.cu", "grouped_attention_resident.cu",
                    "attention_bwd_resident.cu",
                    "grouped_attention_bwd_resident.cu"]


@pytest.mark.parametrize("name", RESIDENT_SOURCES)
def test_resident_source(name):
    """One small source an entry, so the nvcc runs stay side by side; each
    says which TPU kernel it stands for and where the other shapes run."""
    path = _build.CSRC / name
    assert path in _build.sources()
    text = path.read_text()
    assert "JAX package" in text and "_resident.cuh" in text
    assert ("K6" if name.startswith("grouped") else "K1") in text
    assert len(re.findall(r"^WM_DEFINE_ATTENTION_\w+_RESIDENT\(", text,
                          re.M)) == 1
    assert len(text.splitlines()) < 30


@pytest.mark.parametrize("wrapper", ["windowed_attention_v2."
                                     "windowed_attention_packed",
                                     "windowed_attention."
                                     "windowed_attention_rel_pos",
                                     "flash_attention_v2."
                                     "flash_attention_packed",
                                     "flash_attention."
                                     "flash_attention_rel_pos"])
def test_wrappers_that_can_take_the_resident_body_count_it(wrapper):
    """Every wrapper with rel tables can be handed one window: it carries
    the one-kernel backward's counter beside the two-kernel ones."""
    import importlib
    module, name = wrapper.split(".")
    fn = getattr(importlib.import_module(
        f"wildlifemapper_tpu_torch.ops.{module}"), name)
    for counter in ("launches", "backward_launches", "backward_dq_launches",
                    "backward_dkv_launches"):
        assert getattr(fn, counter) == 0, counter


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
    resident = {n for n in defined if n.endswith("_resident")}
    assert len(resident) == 4
    for n in resident:      # the forward's list; the backward's own, with out
        want = (_build._SIGNATURES["wm_attention_fwd"] if "_fwd_" in n
                else _build._ATTENTION_BWD_RESIDENT)
        assert _build._SIGNATURES[n] == want
    # out and its two strides in place of delta, and no `which`
    assert len(_build._ATTENTION_BWD_RESIDENT) == len(
        _build._ATTENTION_BWD) - 1 + 2
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
