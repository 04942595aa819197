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


# ViT-H (head dim 80, 16 heads) at its serving shapes: the bf16 forward on
# the Hopper body (global blocks, the 64-grid) and the resident body
# (windows of 14); every backward and f32 on the tile bodies.
VIT_H = [
    ("K2", "forward", BF16, 4096, (64, 64), "sm90"),
    ("K5", "forward", BF16, 4096, (64, 64), "sm90"),
    ("K1", "forward", BF16, 196, (14, 14), "resident"),
    ("K6", "forward", BF16, 196, (14, 14), "resident"),
    ("K2", "backward", BF16, 4096, (64, 64), "mma"),
    ("K5", "backward", BF16, 4096, (64, 64), "mma"),
    ("K1", "backward", BF16, 196, (14, 14), "mma"),
    ("K6", "backward", BF16, 196, (14, 14), "mma"),
    ("K2", "forward", F32, 4096, (64, 64), "mma"),
    ("K1", "forward", F32, 196, (14, 14), "mma"),
    ("K5", "backward", F32, 4096, (64, 64), "mma"),
    ("K6", "backward", F32, 196, (14, 14), "mma"),
]


@pytest.mark.parametrize("kernel,direction,dtype,n,grid,body", VIT_H,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}".replace("torch.", "")
                              for c in VIT_H])
def test_vit_h_shapes(kernel, direction, dtype, n, grid, body):
    assert attention_body(dtype, 80, n, n, True, grid, direction) == body


@pytest.mark.parametrize("d,nq,nk,grid", [
    (80, 1000, 1000, (25, 40)),          # ragged against the Hopper tiles
    (80, 300, 1030, None),               # N != M, no tables
    (80, 49, 49, (7, 7)),                # ragged against the resident rows
    (80, 100, 100, (10, 10)),
    (64, 4096, 4096, (64, 64)),
    (64, 196, 196, (14, 14)),
    (128, 4096, 4096, None),
])
def test_backward_body_is_the_forward_body_but_at_d80(d, nq, nk, grid):
    """Forward and backward take one body at d = 64 and 128; at d = 80 the
    bf16 forward runs a Hopper or resident body and the backward the tile
    bodies."""
    fwd = attention_body(BF16, d, nq, nk, grid is not None, grid)
    bwd = attention_body(BF16, d, nq, nk, grid is not None, grid,
                         direction="backward")
    assert bwd == (fwd if d != 80 else "mma")
    assert fwd != "mma"


def test_direction_is_checked():
    with pytest.raises(ValueError, match="direction"):
        attention_body(BF16, 64, 196, 196, True, (14, 14), "both")


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
    """The choice follows from direction, dtype and shapes alone."""
    for name in ("WM_ATTENTION_BODY", "WM_BODY", "ATTENTION_BODY"):
        monkeypatch.setenv(name, "mma")
    assert attention_body(BF16, 128, 4096, 4096, False) == "sm90"
    assert attention_body(BF16, 80, 196, 196, True, (14, 14)) == "resident"
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
    if name == "attention_fwd_sm90.cuh":
        # what bounds the forward at d = 64, its schedule, where the bias
        # and the prologue went
        flat = " ".join(note.replace("//", " ").split())
        for words in ("the exponentials weigh as much as the products",
                      "MUFU", "in turns", "wgmma_wait<1>",
                      "the scores' initial value", "the prologue is the "
                      "producer's", "read once", "exp2", "serialize"):
            assert words in flat, words
        code = text[text.index("#pragma once"):]
        for word in ("my_turn(wg)", "your_turn(wg)", "wgmma_wait<1>()",
                     "exp2_approx(fmaf(", "init_scores(kt * TK)",
                     "tma_load_3d(base + P::TAB", "periodic",
                     "wgmma_ss<0, TK>", "wgmma_rs<0, TK>"):
            assert word in code, word
        # gone: the per-score adds after the product, the consumers' staging
        # of Q, the scale on every K5 score, __expf
        for gone in ("add_rel_bias", "stage_rel_tables", "load_a_pair",
                     "__expf", "*= a.scale;"):
            assert gone not in code, gone
        # head dim 80 runs here forward only, 64 + 16 columns: a narrow
        # region by a second TMA box, a B32 k-step, P.V as n64 + n16
        for words in ("at d = 64, 80 or 128", "Head dim 80", "forward only",
                      "narrow region", "32-byte swizzle", "5 k-steps",
                      "an n64 and an n16 product", "four stages"):
            assert words in flat, words
        for word in ("desc_kmajor32(", "desc_mnmajor32(", "wgmma_rs<1, 16>",
                     "&map_qn", "launch_fwd_sm90<80, 128"):
            assert word in code, word


@pytest.mark.parametrize("name,stays,d80", [
    ("attention_fwd.cuh", "attention_fwd_sm90.cuh",
     "the backward of a bf16 d-80 attention still runs the tile bodies"),
    ("attention_bwd.cuh", "attention_bwd_sm90.cuh",
     "every bf16 backward at d = 80"),
])
def test_tile_headers_say_what_still_runs_there(name, stays, d80):
    note = (_build.CSRC / name).read_text()
    note = note[:note.index("#pragma once")]
    assert stays in note
    assert stays.replace("_sm90", "_resident") in note
    assert "K1" in note and "K6" in note and "f32" in note
    assert d80 in " ".join(note.replace("//", " ").split())


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
    flat = " ".join(note.replace("//", " ").split())
    if name == "attention_fwd_resident.cuh":
        # head dim 80 runs here forward only: ten chunks a row, one Q tile
        # refilled by each warp
        for words in ("d = 64 or 80", "Head dim 80", "forward only",
                      "ten 16-byte chunks", "206,336 bytes", "res_tile_off"):
            assert words in flat, words
        code = text[text.index("#pragma once"):]
        for word in ("launch_fwd_resident<80, 13, 7>",
                     "launch_fwd_resident<80, 9, 5>", "res_q_stages",
                     "res_copy_tile<D, ROWS>(qs"):
            assert word in code, word
    else:
        assert "d = 64 only" in flat or "d = 80" not in flat


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
    for n in sm90:      # the forward's list; the backward's own, with out
        want = (_build._SIGNATURES["wm_attention_fwd"] if "_fwd_" in n
                else _build._ATTENTION_BWD_SM90)
        assert _build._SIGNATURES[n] == want
    # no `which`; out and its two strides beside delta, and the scratch the
    # dq kernel leaves for the dk/dv kernel (round(q*scale), the tables)
    assert len(_build._ATTENTION_BWD_SM90) == len(
        _build._ATTENTION_BWD) - 1 + 3 + 2


def test_port_sources_import_no_jax():
    root = _build.CSRC.parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"^\s*(import|from) (jax|flax|optax|"
                             r"wildlifemapper_tpu)\b(?!_torch)", text,
                             re.M), path


def test_hopper_backward_note_and_design():
    """The Hopper backward's note says what held it back and what the design
    does about it; the design is in the code."""
    text = (_build.CSRC / "attention_bwd_sm90.cuh").read_text()
    note = text[:text.index("#pragma once")]
    for word in ("delta inside", "one-hot", "on the tensor cores", "in turns",
                 "serialize", "bit-identical", "48-query"):
        assert word in note, word
    code = text[text.index("#pragma once"):]
    # delta written by the dq kernel, E set by the producer, the table
    # product from the dS registers, the warpgroups' turns
    for word in ("a.delta[statA] =", "put_ones(", "one_hot_chunk(",
                 "wgmma_rs_k<kRelCols, TK>(dr, pa", "my_turn(wg)",
                 "your_turn(wg)", "exp2_approx("):
        assert word in code, word
    # no accumulator set outside the products: the first tile overwrites
    assert "kt > 0);" in code and "qt > 0);" in code
    for gone in ("__syncwarp();\n              }", "add_rel_bias",
                 "stage_rel_tables", "tma_load_4d"):
        assert gone not in code, gone


class _StandInLibrary:
    """A kernel library whose every entry records its name and arguments and
    returns 0 (cudaSuccess): the launcher's calls without a card."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


def _launch_with_stand_ins(monkeypatch, dtype, d, n, heads, scale, rel,
                           scale_scores=False, want_drel=True):
    lib = _StandInLibrary()
    passes = []
    real_delta = _attention.attention_delta

    def counted_delta(*args):
        passes.append(args)
        return real_delta(*args)

    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_attention, "attention_delta", counted_delta)
    gen = torch.Generator().manual_seed(0)
    c = heads * d
    q, k, v, out, dout = (torch.randn(1, n, c, generator=gen).to(dtype)
                          for _ in range(5))
    lse = torch.zeros(1, n, heads)
    rh = rw = None
    if rel:
        side = int(n ** 0.5)
        rh, rw = (torch.randn(1, n, heads, side, generator=gen).to(dtype)
                  for _ in range(2))

    def wrapper():
        pass
    wrapper.backward_launches = 0
    wrapper.backward_dq_launches = wrapper.backward_dkv_launches = 0
    grads = _attention.attention_backward_launch(
        q, k, v, out, lse, dout, scale, heads, rh, rw, wrapper=wrapper,
        scale_scores=scale_scores, want_drel=want_drel)
    counts = (wrapper.backward_launches, wrapper.backward_dq_launches,
              wrapper.backward_dkv_launches)
    return lib.calls, passes, counts, grads


@pytest.mark.parametrize("family,d,n,rel,want_drel", [
    ("packed", 64, 1024, True, True),       # K2: a power-of-two scale
    ("packed", 64, 1024, True, False),      # K2 under a frozen encoder
    ("packed", 128, 576, False, True),      # K4: the scale is no power of 2
    ("grouped", 64, 1024, True, True),      # K5
])
def test_sm90_backward_runs_no_delta_pass(monkeypatch, family, d, n, rel,
                                          want_drel):
    """The Hopper backward launches its dq kernel, which takes delta itself,
    and then its dk/dv kernel, and no plain delta pass; the dk/dv kernel gets
    the scratch the dq kernel writes: delta, round(q*scale) where the packed
    family's scale is no power of two, the tables side by side with rel
    tables."""
    grouped = family == "grouped"
    heads = 1 if grouped else 2
    calls, passes, counts, grads = _launch_with_stand_ins(
        monkeypatch, BF16, d, n, heads, d ** -0.5, rel, scale_scores=grouped,
        want_drel=want_drel)
    prefix = "wm_grouped_attention_bwd" if grouped else "wm_attention_bwd"
    assert [name for name, _ in calls] == [prefix + "_dq_sm90",
                                           prefix + "_dkv_sm90"]
    assert passes == [] and counts == (0, 1, 1)
    (_, dq_args), (_, dkv_args) = calls
    sig = _build._ATTENTION_BWD_SM90
    assert len(dq_args) == len(sig) == len(dkv_args)
    # dtype, q, k, v, dout, out, lse, delta, qs, tab, ...: the same scratch
    # for both kernels; out for the dq kernel's delta
    assert dq_args[1:10] == dkv_args[1:10]
    assert dq_args[5] is not None and dq_args[7] is not None
    assert (dq_args[8] is not None) == (not grouped and d == 128)
    assert (dq_args[9] is not None) == rel
    assert (grads[3] is not None) == (rel and want_drel)


def _forward_with_stand_ins(monkeypatch, d, n, heads, scale_scores):
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    gen = torch.Generator().manual_seed(0)
    side = int(n ** 0.5)
    q = torch.randn(1, n, heads * d, generator=gen).to(BF16)
    rh, rw = (torch.randn(1, n, heads, side, generator=gen).to(BF16)
              for _ in range(2))
    _attention.attention_launch(q, q, q, d ** -0.5, heads, rh, rw,
                                return_lse=True, scale_scores=scale_scores)
    return lib.calls


@pytest.mark.parametrize("kernel,n,entry", [
    ("K2", 4096, "wm_attention_fwd_sm90"),
    ("K5", 4096, "wm_grouped_attention_fwd_sm90"),
    ("K1", 196, "wm_attention_fwd_resident"),
    ("K6", 196, "wm_grouped_attention_fwd_resident"),
])
def test_d80_forward_and_backward_entries(monkeypatch, kernel, n, entry):
    """At ViT-H's head dim the bf16 forward reaches the Hopper or the
    resident C entry, with d = 80; its backward reaches the tile bodies'
    two kernels after the plain delta pass."""
    grouped = kernel in ("K5", "K6")
    heads = 1 if grouped else 2
    calls = _forward_with_stand_ins(monkeypatch, 80, n, heads, grouped)
    assert [name for name, _ in calls] == [entry]
    args = calls[0][1]
    assert len(args) == len(_build._SIGNATURES[entry])
    assert args[12] == 80 and args[7] is not None     # d, the lse buffer
    calls, passes, counts, _ = _launch_with_stand_ins(
        monkeypatch, BF16, 80, n, heads, 80 ** -0.5, True,
        scale_scores=grouped)
    prefix = "wm_grouped_attention_bwd" if grouped else "wm_attention_bwd"
    assert [name for name, _ in calls] == [prefix] * 2
    assert [args[0] for _, args in calls] == [0, 1]
    assert len(passes) == 1 and counts == (0, 1, 1)


def test_tile_backward_keeps_its_delta_pass(monkeypatch):
    """The f32 tile bodies still run the plain delta pass before their two
    kernels."""
    calls, passes, counts, _ = _launch_with_stand_ins(
        monkeypatch, F32, 64, 1024, 2, 0.125, True)
    assert [name for name, _ in calls] == ["wm_attention_bwd"] * 2
    assert len(passes) == 1 and counts == (0, 1, 1)
    assert [args[0] for _, args in calls] == [0, 1]


def test_sm90_forward_refuses_wide_grids():
    """The Hopper forward stages the two tables side by side in rows of
    SM90_REL_COLS columns; a wider grid is refused before any launch."""
    heads, d, gh, gw = 1, 64, 4, 130
    n = gh * gw
    q = torch.zeros(1, n, heads * d, dtype=BF16)
    rh = torch.zeros(1, n, heads, gh, dtype=BF16)
    rw = torch.zeros(1, n, heads, gw, dtype=BF16)
    assert attention_body(BF16, d, n, n, True, (gh, gw)) == "sm90"
    with pytest.raises(ValueError, match="gh \\+ gw"):
        _attention.attention_launch(q, q, q, 0.125, heads, rh, rw)


def test_sm90_backward_refuses_wide_grids():
    """The one-hot products take gh + gw up to SM90_REL_COLS columns; a
    wider grid is refused before any launch."""
    heads, d, gh, gw = 1, 64, 4, 130
    n = gh * gw
    q, k, v, out, dout = (torch.zeros(1, n, heads * d, dtype=BF16)
                          for _ in range(5))
    rh = torch.zeros(1, n, heads, gh, dtype=BF16)
    rw = torch.zeros(1, n, heads, gw, dtype=BF16)
    assert attention_body(BF16, d, n, n, True, (gh, gw)) == "sm90"
    with pytest.raises(ValueError, match="gh \\+ gw"):
        _attention.attention_backward_launch(
            q, k, v, out, torch.zeros(1, n, heads), dout, 0.125, heads, rh,
            rw)
