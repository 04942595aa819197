"""Which kernel body an attention launch takes (ops/_attention.py::
attention_body, a pure function of direction, dtype and shapes), and what
the sources of the Hopper, the resident and the f32 bodies must say and
define. Runs on the
CPU: no kernel is built or launched here (tests/test_torch_cuda.py holds
the bodies against each other on the card)."""

import contextlib
import re
import warnings

import pytest
import torch

from wildlifemapper_tpu_torch.ops import _attention, _build, _library
from wildlifemapper_tpu_torch.ops._attention import (F32_FORWARD_KEYS,
                                                     F32_FORWARD_REL_COLS,
                                                     F32_KEY_TILES,
                                                     F32_WINDOW_FORWARD_PAD,
                                                     F32_WINDOW_SLAB,
                                                     RESIDENT_MAX_GRID,
                                                     RESIDENT_MAX_TOKENS,
                                                     STREAM_MIN_KEYS,
                                                     attention_body,
                                                     f32_forward_smem_bytes,
                                                     f32_key_tile,
                                                     f32_window_forward_smem_bytes,
                                                     f32_window_smem_bytes)

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
    ("K2 parity", F32, 64, 4096, 4096, True, "f32"),
    ("K4 parity", F32, 128, 4096, 4096, False, "f32"),
    ("K5 parity", F32, 64, 2304, 2304, True, "f32"),
    ("K1 parity", F32, 64, 196, 196, True, "f32_window"),
    ("K6 parity", F32, 64, 144, 144, True, "f32_window"),
    ("K1 parity ViT-H window", F32, 80, 196, 196, True, "f32_window"),
]


@pytest.mark.parametrize("what,dtype,d,nq,nk,rel,body", MAIN_PATH,
                         ids=[c[0] for c in MAIN_PATH])
def test_main_path_shapes(what, dtype, d, nq, nk, rel, body):
    assert attention_body(dtype, d, nq, nk, rel) == body


# The backward at the main paths' shapes, with their grids: the f32 global
# blocks of K2 and K5 (d 64 at 4096 and 2304, ViT-H's d 80, a tensor-parallel
# rank's six heads of 64, which are the same shapes a head) take the
# register-tiled f32 body, and so does K4 (d 128, no tables), both ways; the
# f32 windows of K1 and K6 (d 64 and 80) the f32 window bodies both ways; d 32, a grid
# no key tile holds and a global block of 209 tokens stay on the tile body;
# every bf16 backward keeps its body.
MAIN_PATH_BACKWARD = [
    ("K2 f32 full canvas", F32, 64, 4096, (64, 64), "f32"),
    ("K2 f32 48-grid", F32, 64, 2304, (48, 48), "f32"),
    ("K5 f32 full canvas", F32, 64, 4096, (64, 64), "f32"),
    ("K5 f32 48-grid", F32, 64, 2304, (48, 48), "f32"),
    ("K2 f32 ViT-H", F32, 80, 4096, (64, 64), "f32"),
    ("K2 f32 ViT-H 48-grid", F32, 80, 2304, (48, 48), "f32"),
    ("K4 f32", F32, 128, 4096, None, "f32"),
    ("K4 f32 48-grid", F32, 128, 2304, None, "f32"),
    ("K1 f32 window of 14", F32, 64, 196, (14, 14), "f32_window"),
    ("K6 f32 window of 12", F32, 64, 144, (12, 12), "f32_window"),
    ("K1 f32 ViT-H window", F32, 80, 196, (14, 14), "f32_window"),
    ("K6 f32 ViT-H window of 12", F32, 80, 144, (12, 12), "f32_window"),
    ("d 32 f32 window of 14", F32, 32, 196, (14, 14), "mma"),
    ("K1 f32 global block of 209", F32, 64, 209, (11, 19), "mma"),
    ("K6 f32 window of 14, tables 17 wide", F32, 64, 204, (12, 17), "mma"),
    ("d 32 f32", F32, 32, 4096, (64, 64), "mma"),
    ("K2 f32 25x40 grid", F32, 64, 1000, (25, 40), "mma"),
    ("K2 bf16 full canvas", BF16, 64, 4096, (64, 64), "sm90"),
    ("K5 bf16 48-grid", BF16, 64, 2304, (48, 48), "sm90"),
    ("K4 bf16", BF16, 128, 4096, None, "sm90"),
    ("K2 bf16 ViT-H", BF16, 80, 4096, (64, 64), "sm90"),
    ("K1 bf16 window of 14", BF16, 64, 196, (14, 14), "resident"),
    ("K6 bf16 ViT-H window", BF16, 80, 196, (14, 14), "resident"),
    ("d 32 bf16", BF16, 32, 4096, (64, 64), "mma"),
]


@pytest.mark.parametrize("what,dtype,d,n,grid,body", MAIN_PATH_BACKWARD,
                         ids=[c[0] for c in MAIN_PATH_BACKWARD])
def test_main_path_backward_shapes(what, dtype, d, n, grid, body):
    """The backward's body, and the forward's: a bf16 shape and an f32
    window take one body both ways; in f32 the streaming shapes (from 512
    keys: K4 at d 128 without tables, K2 and K5 at d 64 and 80 with a grid
    of gh + gw <= 128, the 25 x 40 grid included, whose backward stays on
    the tile body) take the f32 forward, d 32 the tile body forward."""
    rel = grid is not None
    assert attention_body(dtype, d, n, n, rel, grid, "backward") == body
    forward = attention_body(dtype, d, n, n, rel, grid)
    f32_forward = n >= STREAM_MIN_KEYS and (
        (d == 128 and not rel)
        or (d in (64, 80) and (not rel or sum(grid) <= F32_FORWARD_REL_COLS)))
    assert forward == (body if dtype == BF16 or body == "f32_window" else
                       "f32" if f32_forward else "mma")


@pytest.mark.parametrize("gw,tile", [(64, 64), (32, 64), (16, 64),
                                     (48, 48), (24, 48), (None, 64),
                                     (40, None), (50, None), (8, None),
                                     (12, None), (96, None), (128, None)])
def test_f32_key_tile_is_whole_grid_rows(gw, tile):
    """The f32 body's key tile holds whole grid rows: 64 keys, or 48 where
    the width divides 48 and not 64; other widths (the ragged 25 x 40 grid
    of the card tests among them) stay on the tile body, backward too."""
    assert f32_key_tile(gw) == tile
    assert tile is None or tile in F32_KEY_TILES
    if gw is not None:
        grid = (4096 // gw if 4096 % gw == 0 else 1000 // gw, gw)
        n = grid[0] * gw
        if n >= STREAM_MIN_KEYS:
            want = "f32" if tile else "mma"
            assert attention_body(F32, 64, n, n, True, grid,
                                  "backward") == want
    text = (_build.CSRC / "attention_bwd_f32.cuh").read_text()
    assert "if (64 % gw == 0) return 64;" in text
    assert "if (48 % gw == 0) return 48;" in text
    assert "if (gw < 16 || gw % 8 != 0) return 0;" in text


# ViT-H (head dim 80, 16 heads) at its shapes: the bf16 global blocks (the
# 64-grid) on the Hopper bodies both ways, the windows of 14 on the resident
# bodies both ways; in f32 the global blocks on the f32 bodies both ways, the
# windows on the f32 window bodies both ways.
VIT_H = [
    ("K2", "forward", BF16, 4096, (64, 64), "sm90"),
    ("K5", "forward", BF16, 4096, (64, 64), "sm90"),
    ("K1", "forward", BF16, 196, (14, 14), "resident"),
    ("K6", "forward", BF16, 196, (14, 14), "resident"),
    ("K2", "backward", BF16, 4096, (64, 64), "sm90"),
    ("K5", "backward", BF16, 4096, (64, 64), "sm90"),
    ("K2", "backward", BF16, 2304, (48, 48), "sm90"),
    ("K1", "backward", BF16, 196, (14, 14), "resident"),
    ("K6", "backward", BF16, 196, (14, 14), "resident"),
    ("K2", "forward", F32, 4096, (64, 64), "f32"),
    ("K5", "forward", F32, 4096, (64, 64), "f32"),
    ("K2", "forward", F32, 2304, (48, 48), "f32"),
    ("K1", "forward", F32, 196, (14, 14), "f32_window"),
    ("K5", "backward", F32, 4096, (64, 64), "f32"),
    ("K6", "backward", F32, 196, (14, 14), "f32_window"),
    ("K2", "backward", F32, 4096, (64, 64), "f32"),
    ("K2", "backward", F32, 2304, (48, 48), "f32"),
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
    """Forward and backward take one body at every head dim: the Hopper
    bodies with many keys, the resident bodies on a window, d = 80 as 64."""
    fwd = attention_body(BF16, d, nq, nk, grid is not None, grid)
    bwd = attention_body(BF16, d, nq, nk, grid is not None, grid,
                         direction="backward")
    assert bwd == fwd
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
    assert attention_body(BF16, d, nq, nk, rel, direction="backward") == body


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
    # f32 takes the f32 window body
    pytest.param(F32, 64, 196, 196, True, (14, 14), "f32_window",
                 id="dtype7-64-196-196-True-grid7-mma"),
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
    assert attention_body(F32, 64, nq, 4096, True) == "f32"
    assert attention_body(F32, 80, nq, 4096, True, (64, 64)) == "f32"
    assert attention_body(F32, 64, nq, 4096, True, None, "backward") == "f32"
    assert attention_body(F32, 80, nq, 4096, False, None, "backward") == "f32"


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
    assert attention_body(F32, 64, 4096, 4096, True, (64, 64),
                          "backward") == "f32"
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
        # head dim 80 runs here, its backward on the Hopper backward body,
        # 64 + 16 columns: a narrow region by a second TMA box, a B32
        # k-step, P.V as n64 + n16
        for words in ("at d = 64, 80 or 128", "Head dim 80",
                      "its backward on the Hopper backward body",
                      "narrow region", "32-byte swizzle", "5 k-steps",
                      "an n64 and an n16 product", "four stages"):
            assert words in flat, words
        for word in ("desc_kmajor32(", "desc_mnmajor32(", "wgmma_rs<1, 16>",
                     "&map_qn", "launch_fwd_sm90<80, 128"):
            assert word in code, word


@pytest.mark.parametrize("name,stays,d80", [
    ("attention_fwd.cuh", "attention_fwd_sm90.cuh",
     "Each bf16 shape takes the same body backward"),
    ("attention_bwd.cuh", "attention_bwd_sm90.cuh",
     "in f32 d = 128 below 512 keys or with tables, d = 32, a grid whose "
     "width no f32 key tile holds (25 x 40) and a block of 209 to 511 tokens "
     "that lands in K1 or K6"),
])
def test_tile_headers_say_what_still_runs_there(name, stays, d80):
    """The tile bodies keep d = 32 and the launches no other body holds;
    K2, K4 and K5 in f32 run the f32 bodies both ways from 512 keys and the
    f32 windows of K1 and K6 the f32 window bodies both ways; no bf16 d-80
    window runs there either way."""
    note = (_build.CSRC / name).read_text()
    note = note[:note.index("#pragma once")]
    assert stays in note
    assert stays.replace("_sm90", "_resident") in note
    assert "attention_bwd_f32.cuh" in note
    assert "K1" in note and "K6" in note and "f32" in note
    if name == "attention_bwd.cuh":
        assert "attention_bwd_f32_window.cuh" in note
    assert "attention_bwd_f32_d128.cuh" in note
    flat = " ".join(note.replace("//", " ").split())
    assert d80 in flat
    assert "every f32 launch" not in flat
    assert "in f32 K4 (d = 128)" not in flat
    if name == "attention_fwd.cuh":
        assert "attention_fwd_f32.cuh" in note
        assert "attention_fwd_f32_window.cuh" in note
        assert "f32 launches of K1 and K6" not in flat
        assert "wider than gh + gw = 128" in flat
        assert "f32 launches of K1, K2, K5 and K6" not in flat
    assert "d = 64 or 80, N = M <= 208" in flat
    for gone in ("still runs the tile bodies", "backward of a d-80 window",
                 "d = 64 only", "in f32 the windows"):
        assert gone not in flat, gone


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
        # head dim 80 runs here (and backward in the resident backward):
        # ten chunks a row, one Q tile refilled by each warp
        for words in ("d = 64 or 80", "Head dim 80", "both ways",
                      "ten 16-byte chunks", "206,336 bytes", "res_tile_off"):
            assert words in flat, words
        assert "forward only" not in flat
        code = text[text.index("#pragma once"):]
        for word in ("launch_fwd_resident<80, 13, 7>",
                     "launch_fwd_resident<80, 9, 5>", "res_q_stages",
                     "res_copy_tile<D, ROWS>(qs"):
            assert word in code, word
    else:
        assert "d = 64 or 80" in flat and "d = 64 only" not in flat


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
    f32 = {n for n in defined if "_f32" in n}
    assert f32 == {"wm_attention_bwd_f32", "wm_grouped_attention_bwd_f32",
                   "wm_attention_bwd_f32_window",
                   "wm_grouped_attention_bwd_f32_window",
                   "wm_attention_fwd_f32", "wm_grouped_attention_fwd_f32",
                   "wm_attention_fwd_f32_window",
                   "wm_grouped_attention_fwd_f32_window",
                   "wm_attention_bwd_f32_d128"}
    for n in f32:
        assert _build._SIGNATURES[n] == (
            _build._ATTENTION_FWD if "_fwd_" in n
            else _build._ATTENTION_BWD_F32_WINDOW if n.endswith("_window")
            else _build._ATTENTION_BWD_F32_D128 if n.endswith("_d128")
            else _build._ATTENTION_BWD_F32)
    # the d-128 backward: no tables, their gradients or grid (four pointers,
    # two ints), the ds scratch and its row width beside delta
    assert len(_build._ATTENTION_BWD_F32_D128) == len(
        _build._ATTENTION_BWD_F32) - 6 + 2
    # `which` and no dtype; out and its two strides beside delta
    assert len(_build._ATTENTION_BWD_F32) == len(
        _build._ATTENTION_BWD) - 1 + 3
    # the window body: the resident backward's arguments without a dtype
    assert _build._ATTENTION_BWD_F32_WINDOW == \
        _build._ATTENTION_BWD_RESIDENT[1:]


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


def test_hopper_backward_head_dim_80_note_and_design():
    """The Hopper backward at ViT-H's head dim: the note says how a head of
    80 columns is laid out and multiplied; the code loads the narrow
    regions by maps of their own, takes their k-step and their n16
    products, and instantiates d = 80 for both kernels."""
    text = (_build.CSRC / "attention_bwd_sm90.cuh").read_text()
    note = " ".join(text[:text.index("#pragma once")].replace("//", " ")
                    .split())
    for words in ("at d = 64, 80 or 128", "Head dim 80", "narrow region",
                  "32-byte swizzle", "fifth k-step",
                  "an n64 and an n16 product", "do not depend on d"):
        assert words in note, words
    code = (text[text.index("#pragma once"):]
            + (_build.CSRC / "attention_sm90_common.cuh").read_text())
    for word in ("desc_kmajor32(", "desc_mnmajor32(", "wgmma_rs<1, 16>",
                 "wgmma_rs_head<D, TK>(dq", "wgmma_rs_head<D, TQ>(dk",
                 "wgmma_rs_head<D, TQ>(dv", "&map_qn", "&map_don", "&map_kn",
                 "&map_vn", "&map_qsn", "launch_dq_sm90<80, 64, 4",
                 "launch_dkv_sm90<80, 64, 3"):
        assert word in code, word


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


@contextlib.contextmanager
def cuda_impls_on_cpu(*overloads):
    """Within this context the named operators of ops/_library.py run their
    CUDA implementations for CPU tensors: a CPU test reaches the launchers
    (against a stand-in library) and the launch counts through the
    operators, as a CUDA tensor does."""
    with warnings.catch_warnings():
        # overriding a registered kernel warns
        warnings.simplefilter("ignore", UserWarning)
        with torch.library._scoped_library(_library.NAMESPACE, "IMPL") as lib:
            for name in overloads:
                lib.impl(name, _library.IMPLS[name][1], "CPU")
            yield


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
    ("packed", 80, 1024, True, True),       # ViT-H's K2: no power of 2
    ("packed", 80, 1024, True, False),      # ... under the frozen encoder
    ("grouped", 80, 1024, True, True),      # ViT-H's K5
    ("packed", 80, 576, False, True),       # d = 80 without tables
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
    assert (dq_args[8] is not None) == (not grouped and d != 64)
    assert dq_args[21] == d
    assert (dq_args[9] is not None) == rel
    assert (grads[3] is not None) == (rel and want_drel)


@pytest.mark.parametrize("family,d,n,rel,want_drel", [
    ("packed", 64, 4096, True, True),       # K2, the full canvas
    ("packed", 64, 2304, True, False),      # K2 on the 48-grid, frozen
    ("grouped", 64, 4096, True, True),      # K5
    ("grouped", 64, 2304, True, False),
    ("packed", 80, 4096, True, True),       # ViT-H's K2
    ("grouped", 80, 1024, True, True),      # ViT-H's K5 on a 32-grid
    ("packed", 64, 576, False, True),       # no tables
])
def test_f32_backward_runs_no_delta_pass(monkeypatch, family, d, n, rel,
                                         want_drel):
    """The f32 streaming backward launches its dq kernel, which takes delta
    itself, and then its dk/dv kernel, and no plain delta pass; both get
    the same delta scratch, (B, N, H) f32, and the forward's out for the dq
    kernel; the counters move as for the Hopper backward."""
    grouped = family == "grouped"
    heads = 1 if grouped else 2
    assert attention_body(F32, d, n, n, rel, None, "backward") == "f32"
    calls, passes, counts, grads = _launch_with_stand_ins(
        monkeypatch, F32, d, n, heads, d ** -0.5, rel, scale_scores=grouped,
        want_drel=want_drel)
    entry = ("wm_grouped_attention_bwd_f32" if grouped
             else "wm_attention_bwd_f32")
    assert [name for name, _ in calls] == [entry, entry]
    assert passes == [] and counts == (0, 1, 1)
    (_, dq_args), (_, dkv_args) = calls
    assert len(dq_args) == len(_build._ATTENTION_BWD_F32) == len(dkv_args)
    # which, q, k, v, dout, out, lse, delta, rel_h, rel_w, dq, dk, dv, ...
    assert (dq_args[0], dkv_args[0]) == (0, 1)
    assert dq_args[1:15] == dkv_args[1:15]
    assert dq_args[5] is not None and dq_args[7] is not None
    assert (dq_args[8] is not None) == rel
    assert (dq_args[13] is not None) == (rel and want_drel)
    assert dq_args[19] == d and dq_args[17:19] == (n, n)
    assert (grads[3] is not None) == (rel and want_drel)


def test_f32_body_refuses_what_it_does_not_hold(monkeypatch):
    """Named outright, the f32 body refuses before any launch what it does
    not take: bf16, d 128 with tables, a grid no key tile holds (backward),
    a grid of more than F32_FORWARD_REL_COLS columns (forward), d 32 either
    way; the forward at d 64 enters the f32 forward entry."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)

    def launch(dtype, d, gh, gw):
        n = gh * gw
        q = torch.zeros(1, n, d, dtype=dtype)
        rh = torch.zeros(1, n, 1, gh, dtype=dtype)
        rw = torch.zeros(1, n, 1, gw, dtype=dtype)
        return _attention.attention_backward_launch(
            q, q, q, q, torch.zeros(1, n, 1), q, 0.125, 1, rh, rw,
            body="f32")

    for args in ((BF16, 64, 32, 32), (F32, 128, 32, 32), (F32, 64, 25, 40),
                 (F32, 64, 64, 8)):
        with pytest.raises(ValueError, match="f32 body"):
            launch(*args)
    launch(F32, 64, 32, 32)
    assert [name for name, _ in lib.calls] == ["wm_attention_bwd_f32"] * 2

    def forward(d, gh, gw):
        n = gh * gw
        q = torch.zeros(1, n, d)
        rh, rw = torch.zeros(1, n, 1, gh), torch.zeros(1, n, 1, gw)
        return _attention.attention_launch(q, q, q, 0.125, 1, rh, rw,
                                           body="f32")

    for args in ((64, 130, 4), (64, 4, 130), (32, 32, 32)):
        with pytest.raises(ValueError, match="f32 body"):
            forward(*args)
    forward(64, 25, 40)
    assert [name for name, _ in lib.calls][2:] == ["wm_attention_fwd_f32"]


F32_SOURCES = ["attention_bwd_f32.cu", "grouped_attention_bwd_f32.cu"]


@pytest.mark.parametrize("name", F32_SOURCES)
def test_f32_backward_source(name):
    """One small source a family, so the nvcc runs stay side by side; each
    says which TPU kernel it stands for and where the other shapes run."""
    path = _build.CSRC / name
    assert path in _build.sources()
    text = path.read_text()
    assert "JAX package" in text and "attention_bwd_f32.cuh" in text
    assert ("K5" if name.startswith("grouped") else "K2") in text
    assert "tile body" in text
    assert len(re.findall(r"^WM_DEFINE_ATTENTION_BWD_F32\(", text,
                          re.M)) == 1
    assert len(text.splitlines()) < 30


def test_f32_backward_header_note():
    """The f32 body names the TPU kernels it replaces, its bound on the H100
    and what the design does about it; the design is in the code."""
    text = (_build.CSRC / "attention_bwd_f32.cuh").read_text()
    note = text[:text.index("#pragma once")]
    flat = " ".join(note.replace("//", " ").split())
    for replaced in ("flash_attention_v2.py::_bwd_dq_kernel (:229",
                     "pallas_call :364", "::_bwd_dkv_kernel (:276",
                     "pallas_call :392", "flash_attention.py::_bwd_kernel "
                     "(:133", "pallas_call :268"):
        assert replaced in flat, replaced
    for words in ("What bounds it on the H100", "operations", "67 TFLOP/s",
                  "721 GFLOP", "8 x 4 register tile", "128 bytes a clock",
                  "cp.async",
                  "double-buffered", "delta inside the dq kernel",
                  "whole grid rows", "No TF32", "no atomics",
                  "bit-identical", "d 64 and 80", "ptxas",
                  "__launch_bounds__(256, 1)"):
        assert words in flat, words
    code = text[text.index("#pragma once"):]
    for word in ("fb_scores<D, NJ>(s, qt", "fb_scores<D, NJ>(dp, dot",
                 "fb_scores<D, NI>(p, kt_", "fb_scores<D, NI>(ds, vt_",
                 "fb_grad<D, BK>(acc, xs", "fb_grad<D, BQT>(dvacc, xs",
                 "fb_grad<D, BQT>(dkacc, xs", "fb_cp16(", "fb_cp4(",
                 "fb_pair_sum(", "a.delta[stat] = sum", "relw[e][n]",
                 "drw[e][n] += p[e][n]", "fb_get<NJ>(xs", "float acc[8][NC]",
                 "launch_f32_dq<80, 48", "launch_f32_dkv<80"):
        assert word in code, word
    # 8 x 4 register tiles: 8 resident rows, two 128-bit loads a step
    assert "r0 + (e & 3) + 16 * (e >> 2)" in code
    assert "atomic" not in code
    assert len(re.findall(r"^__global__ void", code, re.M)) == 2


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
    resident C entry, with d = 80; the backward of K2 and K5 reaches the
    Hopper dq and dk/dv entries, that of K1 and K6 the one resident backward
    entry, with d = 80 and no delta pass either way."""
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
    if entry.endswith("_sm90"):
        assert [name for name, _ in calls] == [prefix + "_dq_sm90",
                                               prefix + "_dkv_sm90"]
        assert [args[21] for _, args in calls] == [80, 80]
        assert passes == [] and counts == (0, 1, 1)
        return
    assert [name for name, _ in calls] == [prefix + "_resident"]
    args = calls[0][1]
    assert len(args) == len(_build._ATTENTION_BWD_RESIDENT)
    assert args[18] == 80 and args[5] is not None     # d, the forward's out
    assert passes == [] and counts == (1, 0, 0)


def test_resident_backward_head_dim_80_note_and_design():
    """The resident backward at ViT-H's head dim: the note says how a row of
    80 columns is laid out, how many tile slots fit and which tensors come in
    when, and that no instantiation may spill; the code instantiates d = 80
    for both key-tile counts, the refills and the five-slot layout."""
    text = (_build.CSRC / "attention_bwd_resident.cuh").read_text()
    note = " ".join(text[:text.index("#pragma once")].replace("//", " ")
                    .split())
    for words in ("d = 64 or 80", "Head dim 80", "ten 16-byte chunks",
                  "33,280 B", "five slots", "208,000 B", "row by row",
                  "fifth k-step", "ldmatrix.trans", "0 bytes spilled",
                  "CHA = 4 and CHB = 2"):
        assert words in note, words
    code = text[text.index("#pragma once"):]
    for word in ("launch_bwd_resident<80, 13, 7, 4, 2>",
                 "launch_bwd_resident<80, 9, 5, 3, 3>",
                 "launch_bwd_resident<64, 13, 7, 5, 3>",
                 "launch_bwd_resident<64, 9, 5, 5, 4>",
                 "(D == 64 ? 7 : 5)", "constexpr bool REFILL",
                 "copy_tensor(1, nb, nh, ks, r0, r1, lane, 32)",
                 "res_ldbt<false, D, ROWS>", "(d != 64 && d != 80)"):
        assert word in code, word
    # the five slots of 33,280 bytes, the tables, E, lse and delta
    assert 5 * 208 * 160 + 3 * 208 * 64 + 2 * 208 * 4 == 208_000 <= 232_448


def test_tile_backward_keeps_its_delta_pass(monkeypatch):
    """The f32 tile bodies still run the plain delta pass before their two
    kernels: head dim 128 with tables stays there (K4, which has none, takes
    the f32 body)."""
    assert attention_body(F32, 128, 1024, 1024, True, (32, 32),
                          "backward") == "mma"
    calls, passes, counts, _ = _launch_with_stand_ins(
        monkeypatch, F32, 128, 1024, 2, 128 ** -0.5, True)
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


F32_WINDOW_SOURCES = ["attention_bwd_f32_window.cu",
                      "grouped_attention_bwd_f32_window.cu"]


@pytest.mark.parametrize("name", F32_WINDOW_SOURCES)
def test_f32_window_backward_source(name):
    """One small source a family, so the nvcc runs stay side by side; each
    says which TPU kernel it stands for and where the other shapes run."""
    path = _build.CSRC / name
    assert path in _build.sources()
    text = path.read_text()
    assert "JAX package" in text and "attention_bwd_f32_window.cuh" in text
    assert ("K6" if name.startswith("grouped") else "K1") in text
    assert "tile body" in text and "resident body" in text
    assert len(re.findall(r"^WM_DEFINE_ATTENTION_BWD_F32_WINDOW\(", text,
                          re.M)) == 1
    assert len(text.splitlines()) < 30


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("tokens", [1, 6, 100, 144, 160, 161, 196,
                                    RESIDENT_MAX_TOKENS])
def test_f32_window_shared_memory_fits(d, tokens):
    """The f32 window body's shared memory, one function of head dim and
    tokens for the kernel's launch and for its note, fits a block; 161 to
    208 tokens take the 7-warp instantiation, the rest the 5-warp one."""
    smem = f32_window_smem_bytes(d, tokens)
    assert smem <= 232_448
    rows = 224 if tokens > 160 else 160
    tables = max(RESIDENT_MAX_GRID * rows,
                 2 * F32_WINDOW_SLAB * (2 * RESIDENT_MAX_GRID + 1))
    assert smem == 4 * (2 * d * rows + 4 * F32_WINDOW_SLAB * (d + 4)
                        + F32_WINDOW_SLAB * (rows + 4) + 2 * rows + tables)
    text = (_build.CSRC / "attention_bwd_f32_window.cuh").read_text()
    assert f"kFwSlab = {F32_WINDOW_SLAB};" in text
    assert f"kFwMaxGrid = {RESIDENT_MAX_GRID};" in text


def test_f32_window_header_note():
    """The f32 window body names the Pallas call sites it replaces, says
    that it takes delta itself and has no atomics, and gives its shared
    memory at d 64 and d 80 (from f32_window_smem_bytes)."""
    text = (_build.CSRC / "attention_bwd_f32_window.cuh").read_text()
    note = text[:text.index("#pragma once")]
    flat = " ".join(note.replace("//", " ").split())
    for replaced in ("windowed_attention_v2.py::_bwd_kernel (:125",
                     "pallas_call :260",
                     "windowed_attention.py::_bwd_kernel (:64",
                     "pallas_call :173"):
        assert replaced in flat, replaced
    for d in (64, 80):
        smem = f32_window_smem_bytes(d, RESIDENT_MAX_TOKENS)
        assert smem < 232_448
        assert f"{smem:,} B at d {d}" in flat, smem
    for words in ("What bounds it on the H100: operations", "67 TFLOP/s",
                  "29.5 GFLOP", "delta inside", "no plain pass runs",
                  "no atomics", "bit-identical", "No TF32",
                  "two passes with the resident side swapped",
                  "two blocks a window-head", "Eight products",
                  "register tiles of 8 x 4", "whole grid rows",
                  "Nothing is added into shared memory lane by lane",
                  "cp.async", "double-buffered", "d 64 and 80",
                  "0 bytes spilled", "232,448"):
        assert words in flat, words
    code = text[text.index("#pragma once"):]
    assert "atomic" not in code
    assert len(re.findall(r"^__global__ void", code, re.M)) == 1


@pytest.mark.parametrize("family,d,hw,want_drel", [
    ("packed", 64, (14, 14), True),      # K1 on the full canvas
    ("packed", 64, (12, 12), False),     # K1 on the 48-grid, frozen
    ("grouped", 64, (14, 14), True),     # K6
    ("grouped", 64, (12, 12), True),
    ("packed", 80, (14, 14), True),      # ViT-H's K1
    ("packed", 80, (14, 14), False),
    ("grouped", 80, (12, 12), True),     # ViT-H's K6 from scratch
    ("packed", 64, (10, 10), True),      # a ragged window
])
def test_f32_window_backward_is_one_launch(monkeypatch, family, d, hw,
                                           want_drel):
    """The f32 window body is one launch a backward, counted on
    `backward_launches`, with no plain delta pass and no scratch: its entry
    gets the forward's out in delta's place, and the tables' gradients only
    when they are wanted."""
    grouped = family == "grouped"
    heads = 1 if grouped else 2
    n = hw[0] * hw[1]
    assert attention_body(F32, d, n, n, True, hw, "backward") == "f32_window"
    calls, passes, counts, grads = _launch_with_stand_ins(
        monkeypatch, F32, d, n, heads, d ** -0.5, True, scale_scores=grouped,
        want_drel=want_drel)
    entry = ("wm_grouped_attention_bwd_f32_window" if grouped
             else "wm_attention_bwd_f32_window")
    assert [name for name, _ in calls] == [entry]
    assert passes == [] and counts == (1, 0, 0)
    args = calls[0][1]
    assert len(args) == len(_build._ATTENTION_BWD_F32_WINDOW)
    # q, k, v, dout, out, lse, rel_h, rel_w, dq, dk, dv, drel_h, drel_w, ...
    assert args[4] is not None and args[6] is not None
    assert (args[11] is not None) == want_drel
    assert args[15:18] == (n, n, d) and args[34:36] == hw
    assert (grads[3] is not None) == want_drel


def test_f32_window_body_refuses_what_it_does_not_hold(monkeypatch):
    """Named outright, the f32 window bodies refuse before any launch what
    they do not take, both ways: bf16, d 32 or 128, N != M, more than
    RESIDENT_MAX_TOKENS tokens, tables wider than RESIDENT_MAX_GRID. The
    forward reaches its family's f32 window entry (the grouped one with
    `scale_scores`)."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)

    def launch(dtype, d, gh, gw, m=None, forward=False, grouped=False):
        n = gh * gw
        m = n if m is None else m
        q = torch.zeros(1, n, d, dtype=dtype)
        kv = torch.zeros(1, m, d, dtype=dtype)
        rh = torch.zeros(1, n, 1, gh, dtype=dtype)
        rw = torch.zeros(1, n, 1, m // gh, dtype=dtype)
        if forward:
            return _attention.attention_launch(
                q, kv, kv, 0.125, 1, rh, rw, return_lse=True,
                scale_scores=grouped, body="f32_window")
        return _attention.attention_backward_launch(
            q, kv, kv, q, torch.zeros(1, n, 1), q, 0.125, 1, rh, rw,
            body="f32_window")

    for args in ((BF16, 64, 14, 14), (F32, 32, 14, 14), (F32, 128, 14, 14),
                 (F32, 64, 11, 19), (F32, 64, 17, 12),
                 (F32, 64, 14, 14, 182)):
        for forward in (False, True):
            with pytest.raises(ValueError, match="f32_window body"):
                launch(*args, forward=forward)
    assert lib.calls == []
    launch(F32, 64, 14, 14)
    launch(F32, 80, RESIDENT_MAX_GRID, 13)
    launch(F32, 64, 14, 14, forward=True)
    out, lse = launch(F32, 80, 12, 12, forward=True, grouped=True)
    assert out.shape == (1, 144, 80) and lse.shape == (1, 144, 1)
    assert [name for name, _ in lib.calls] == [
        "wm_attention_bwd_f32_window", "wm_attention_bwd_f32_window",
        "wm_attention_fwd_f32_window", "wm_grouped_attention_fwd_f32_window"]
    fwd = lib.calls[3][1]
    assert len(fwd) == len(_build._ATTENTION_FWD)
    assert fwd[0] == _build.DTYPE_CODES[F32] and None not in fwd[5:8]
    assert fwd[9:13] == (1, 144, 144, 80) and fwd[21:23] == (12, 12)


# K4 in f32 (d 128, no tables) on the register-tiled f32 body both ways: the
# full canvas, the 48-grid, N != M (ragged), a tensor-parallel rank's 4 heads
K4_F32 = [(8, 4096, 4096), (8, 2304, 2304), (8, 1000, 1024), (8, 2304, 4096),
          (4, 2304, 2304)]


@pytest.mark.parametrize("heads,n,m", K4_F32,
                         ids=[f"H{h}-N{n}-M{m}" for h, n, m in K4_F32])
def test_k4_f32_runs_the_f32_body_both_ways(monkeypatch, heads, n, m):
    """Through the adaptor's wrapper: the forward enters the f32 forward
    entry (d 128, an lse buffer), the backward the d-128 f32 entry twice,
    the delta and dk/dv kernels first and the dq kernel after them, with no
    plain delta pass, and each counter moves by one."""
    from wildlifemapper_tpu_torch.ops.cross_attention import (
        _CrossAttentionFn, cross_attention_packed)
    assert attention_body(F32, 128, n, m, False) == "f32"
    assert attention_body(F32, 128, n, m, False, None, "backward") == "f32"
    lib = _StandInLibrary()
    passes = []
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(_attention, "attention_delta",
                        lambda *a: passes.append(a))
    gen = torch.Generator().manual_seed(0)
    c = heads * 128
    q = torch.randn(1, n, c, generator=gen).requires_grad_()
    k, v = (torch.randn(1, m, c, generator=gen).requires_grad_()
            for _ in range(2))
    fn = cross_attention_packed
    before = (fn.launches, fn.backward_dq_launches, fn.backward_dkv_launches)
    with cuda_impls_on_cpu("cross_attention_packed",
                           "cross_attention_packed.lse"):
        out = _CrossAttentionFn.apply(q, k, v, 128 ** -0.5, heads)
    out.backward(torch.ones_like(out))
    after = (fn.launches, fn.backward_dq_launches, fn.backward_dkv_launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert passes == []
    assert [name for name, _ in lib.calls] == [
        "wm_attention_fwd_f32", "wm_attention_bwd_f32_d128",
        "wm_attention_bwd_f32_d128"]
    (_, fwd), (_, dkv_args), (_, dq_args) = lib.calls
    assert len(fwd) == len(_build._ATTENTION_FWD)
    assert fwd[0] == _build.DTYPE_CODES[F32] and fwd[7] is not None  # lse
    assert fwd[5] is None and fwd[9:13] == (heads, n, m, 128)
    assert len(dq_args) == len(_build._ATTENTION_BWD_F32_D128)
    # which, q, k, v, dout, out, lse, delta, ds, dq, dk, dv, B, H, N, M, d,
    # N': one scratch, written by the delta and dk/dv kernels, read by dq
    assert (dkv_args[0], dq_args[0]) == (0, 1)
    assert dq_args[1:] == dkv_args[1:]
    assert None not in dq_args[1:12]
    assert dq_args[13:18] == (heads, n, m, 128, -(-n // 128) * 128)


def test_k4_f32_body_refuses_what_it_does_not_hold(monkeypatch):
    """Named outright at d 128, the f32 body refuses before any launch, both
    ways, what it does not take: tables, bf16, fewer than 512 keys, the
    grouped family (the scale on the scores); d 32 it refuses too."""
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)

    def both(dtype=F32, d=128, n=1024, m=1024, rel=False, grouped=False):
        q = torch.zeros(1, n, d, dtype=dtype)
        k = torch.zeros(1, m, d, dtype=dtype)
        rh = rw = None
        if rel:
            rh = torch.zeros(1, n, 1, 32, dtype=dtype)
            rw = torch.zeros(1, n, 1, m // 32, dtype=dtype)
        _attention.attention_launch(q, k, k, 0.125, 1, rh, rw,
                                    scale_scores=grouped, body="f32")
        _attention.attention_backward_launch(
            q, k, k, q, torch.zeros(1, n, 1), q, 0.125, 1, rh, rw,
            scale_scores=grouped, body="f32")

    for kw in (dict(rel=True), dict(dtype=BF16), dict(m=STREAM_MIN_KEYS - 1),
               dict(n=600, m=256), dict(grouped=True)):
        with pytest.raises(ValueError, match="f32 body"):
            both(**kw)
    with pytest.raises(ValueError, match="f32 body takes float32 at d = 64 "
                       "or 80, or 128 without tables, got torch.float32 at "
                       "d = 32"):
        both(d=32)
    assert lib.calls == []
    both(n=600, m=STREAM_MIN_KEYS)
    assert [name for name, _ in lib.calls] == [
        "wm_attention_fwd_f32"] + ["wm_attention_bwd_f32_d128"] * 2


F32_D128_SOURCES = {"attention_fwd_f32.cu": "attention_fwd_f32.cuh",
                    "attention_bwd_f32_d128.cu": "attention_bwd_f32_d128.cuh"}


@pytest.mark.parametrize("name", sorted(F32_D128_SOURCES))
def test_k4_f32_source(name):
    """One small source an entry, so the nvcc runs stay side by side; each
    says which TPU kernel it stands for and where the other shapes run."""
    path = _build.CSRC / name
    assert path in _build.sources()
    text = path.read_text()
    assert "JAX package" in text and F32_D128_SOURCES[name] in text
    assert "K4" in text and "cross_attention.py" in text
    assert "tile body" in text
    assert len(re.findall(r"^WM_DEFINE_ATTENTION_\w+_F32\w*\(", text,
                          re.M)) == 1
    assert len(text.splitlines()) < 30


K4_F32_HEADERS = {
    "attention_fwd_f32.cuh": (
        "cross_attention.py::_fwd_kernel (:64", "pallas_call :160",
        "274.9 GFLOP", "8 x 8 register tile", "BK = 128 keys",
        "warp shuffles", "one stage", "200,704 B", "96-key tiles",
        "576 blocks"),
    "attention_bwd_f32_d128.cuh": (
        "cross_attention.py::_bwd_dq_kernel (:90", "pallas_call :208",
        "::_bwd_dkv_kernel (:116", "pallas_call :227", "687 GFLOP",
        "five products", "seven products here at 40 TFLOP/s",
        "8 x 4 register tiles", "8 x 8 register tiles", "the delta kernel",
        "no plain delta pass", "2.15 GB", "231,936 B", "98,304 B",
        "no atomics", "bit-identical"),
}


@pytest.mark.parametrize("name", sorted(K4_F32_HEADERS))
def test_k4_f32_header_note(name):
    """Each d-128 f32 body names the Pallas call sites it replaces, its
    bound on the H100 and what the design does about it, with no atomics in
    the code. The card test test_k4_f32_body holds what the code does."""
    text = (_build.CSRC / name).read_text()
    note = text[:text.index("#pragma once")]
    flat = " ".join(note.replace("//", " ").split())
    for w in ("What bounds it on the H100", "operations", "67 TFLOP/s",
              "No TF32", "cp.async", "__launch_bounds__(256, 1)", "ptxas",
              *K4_F32_HEADERS[name]):
        assert w in flat, w
    assert "atomic" not in text[text.index("#pragma once"):]


# ---- the f32 forward of K2 and K5 (d 64 / 80, rel tables) -------------------

@pytest.mark.parametrize("d", [64, 80])
def test_f32_forward_shared_memory_fits(d):
    """The f32 forward's shared memory (f32_forward_smem_bytes, the kernel's
    ff_smem_bytes) fits a block's 232,448 B at d 64 and 80 on every grid it
    takes (gh + gw <= F32_FORWARD_REL_COLS) and without tables; the
    constants are the kernel's own."""
    limit = 232448
    for gh in range(1, F32_FORWARD_REL_COLS):
        for gw in range(1, F32_FORWARD_REL_COLS - gh + 1):
            assert f32_forward_smem_bytes(d, gh, gw) <= limit, (gh, gw)
    assert f32_forward_smem_bytes(d) < f32_forward_smem_bytes(d, 64, 64)
    # the main paths' grids, as the header states them
    assert f32_forward_smem_bytes(64, 64, 64) == 196608
    assert f32_forward_smem_bytes(80, 64, 64) == 221184
    assert f32_forward_smem_bytes(128) == 200704
    text = (_build.CSRC / "attention_fwd_f32.cuh").read_text()
    assert f"constexpr int kFfKeys = {F32_FORWARD_KEYS};" in text
    assert f"kFfRelCols = {F32_FORWARD_REL_COLS};" in text
    assert (f"kFfPKeys = {_attention.F32_FORWARD_P_KEYS};" in text
            and f"kFfPLd = {_attention.F32_FORWARD_P_LD};" in text)


# The f32 forward launches that stay on the tile body: a global block below
# 512 keys, K2 / K5 on a grid wider than gh + gw = 128, d 32, d 128 with
# tables. (kernel, d, nq, nk, grid)
F32_FORWARD_TILE_BODY = [
    ("K1 global block of 484", 64, 484, 484, (22, 22)),
    ("K2 below 512 keys", 80, 300, 511, None),
    ("K2 grid 130 x 4", 64, 520, 520, (130, 4)),
    ("K5 grid 4 x 130", 80, 520, 520, (4, 130)),
    ("K5 grid 65 x 64", 64, 4160, 4160, (65, 64)),
    ("d 32", 32, 4096, 4096, (64, 64)),
    ("K5 d 128 with tables", 128, 2304, 2304, (48, 48)),
]


@pytest.mark.parametrize("what,d,nq,nk,grid", F32_FORWARD_TILE_BODY,
                         ids=[c[0] for c in F32_FORWARD_TILE_BODY])
def test_f32_forward_shapes_on_the_tile_body(what, d, nq, nk, grid):
    """What the f32 forward does not take stays on the tile body forward;
    the largest grid it takes, 64 x 64, and 48 x 80 (gh + gw = 128) do not."""
    assert attention_body(F32, d, nq, nk, grid is not None, grid) == "mma"
    for hw in ((64, 64), (48, 80), (80, 48)):
        n = hw[0] * hw[1]
        assert attention_body(F32, 64, n, n, True, hw) == "f32"


# The f32 forward of the windows of K1 and K6 takes the f32 window body, as
# their backward does: the main paths' windows of 14 and 12 at d 64 and 80,
# the largest window it holds (208 = 13 x 16, either way round); a block of
# 209 tokens and a grid 17 wide stay on the tile body. (what, d, grid, body)
F32_WINDOW_FORWARD = [
    ("K1 window of 14", 64, (14, 14), "f32_window"),
    ("K6 window of 12", 64, (12, 12), "f32_window"),
    ("K1 ViT-H window", 80, (14, 14), "f32_window"),
    ("K6 ViT-H window of 12", 80, (12, 12), "f32_window"),
    ("208 tokens, 13 x 16", 64, (13, 16), "f32_window"),
    ("208 tokens, 16 x 13 at d 80", 80, (16, 13), "f32_window"),
    ("209 tokens, 11 x 19", 64, (11, 19), "mma"),
    ("tables 17 wide, 12 x 17", 80, (12, 17), "mma"),
]


@pytest.mark.parametrize("what,d,grid,body", F32_WINDOW_FORWARD,
                         ids=[c[0] for c in F32_WINDOW_FORWARD])
def test_f32_window_forward_shapes(what, d, grid, body):
    """An f32 window takes the f32 window body forward, as it does
    backward; what the window bodies do not hold stays on the tile body
    both ways."""
    n = grid[0] * grid[1]
    assert attention_body(F32, d, n, n, True, grid, "forward") == body
    assert attention_body(F32, d, n, n, True, grid, "backward") == body


F32_WINDOW_FORWARD_HEADER = (
    "windowed_attention_v2.py::_fwd_kernel (:105", "pallas_call :227",
    "windowed_attention.py::_fwd_kernel (:52", "pallas_call :144",
    "What bounds it on the H100: operations", "11.8 GFLOP", "0.178 ms",
    "0.061 ms", "67 TFLOP/s", "1.575 ms", "1.71x", "padding",
    "shared-memory traffic", "reloads", "online softmax", "by shuffles",
    "double-buffered", "cp.async", "7 warps of 28", "no padded resident row",
    "two blocks a window-head", "3.5-7 %", "233,472 B",
    "__syncwarp", "8 x 10 at d 80", "stages its row of rel_h and of rel_w once",
    "bit-identical", "No TF32", "f32_window_forward_smem_bytes",
    "0 bytes spilled", "232,448")


def test_f32_window_forward_header_note():
    """The f32 window forward's note names the Pallas call sites of K1 and
    K6 it replaces, their bound on the H100, what held the tile body back
    and the design, and its shared memory at d 64 and 80 (from
    f32_window_forward_smem_bytes); the code carries the design. The card
    test test_f32_window_forward holds what the code does."""
    text = (_build.CSRC / "attention_fwd_f32_window.cuh").read_text()
    note = text[:text.index("#pragma once")]
    flat = " ".join(note.replace("//", " ").split())
    for words in F32_WINDOW_FORWARD_HEADER:
        assert words in flat, words
    for d in (64, 80):
        for tokens in (RESIDENT_MAX_TOKENS, 144):
            smem = f32_window_forward_smem_bytes(d, tokens)
            assert f"{smem:,} B" in flat, smem
    code = text[text.index("#pragma once"):]
    for word in ('#include "attention_bwd_f32_window.cuh"',
                 "fw_scores<D, 4, R>(s, qs, T, r0, ksl, LDT, lk)",
                 "fw_grad<D, R>(acc, xs, LDX, r0, vsl, LDT, lk, kn)",
                 "fw_put<R>(xs, LDX, r0, lk, s)", "__shfl_xor_sync",
                 "__syncwarp();", "fb_wait_all();", "load_kv(kt + 1)",
                 "SCALE_SCORES ? 1.f : a.scale",
                 "launch_f32_window_fwd<D, 4, 7, 2, SCALE_SCORES>",
                 "launch_f32_window_fwd<D, 7, 7, 1, SCALE_SCORES>",
                 "if constexpr (D == 64)", "blockIdx.x % P",
                 "launch_f32_window_fwd_for<80, SCALE_SCORES>"):
        assert word in code, word
    assert "atomic" not in code
    assert len(re.findall(r"^__global__ void", code, re.M)) == 1
    # the body's limits are the dispatch's
    assert "kFwMaxTokens" in code and "kFwMaxGrid" in code


@pytest.mark.parametrize("name,flag", [
    ("attention_fwd_f32_window.cu", "false"),
    ("grouped_attention_fwd_f32_window.cu", "true")])
def test_f32_window_forward_source(name, flag):
    """One small source a family, so the nvcc runs stay side by side; each
    says which TPU kernel it stands for and where the other shapes run."""
    path = _build.CSRC / name
    assert path in _build.sources()
    text = path.read_text()
    assert "JAX package" in text and "attention_fwd_f32_window.cuh" in text
    assert ("K6" if name.startswith("grouped") else "K1") in text
    assert "tile body" in text and "resident body" in text
    assert re.search(
        rf"^WM_DEFINE_ATTENTION_FWD_F32_WINDOW\(wm_\w+, {flag}\)", text, re.M)
    assert len(text.splitlines()) < 30


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("tokens", [1, 6, 100, 144, 160, 161, 196,
                                    RESIDENT_MAX_TOKENS])
def test_f32_window_forward_shared_memory_fits(d, tokens):
    """The f32 window forward's shared memory, one function of head dim and
    tokens, fits a block, and two blocks an SM where a window-head takes
    two: up to 160 tokens 3 warps, two blocks; 161 to 208 tokens at d 64 4
    warps, two blocks; at d 80 7 warps, one block. The constants are the
    kernel's own."""
    smem = f32_window_forward_smem_bytes(d, tokens)
    assert smem <= 232_448
    rows = 96 if tokens <= 160 else 128 if d == 64 else 224
    two = rows < 224
    assert (2 * (smem + 1024) <= 233_472) == two
    assert smem == 4 * (d * rows + 4 * F32_WINDOW_SLAB * (d + 4)
                        + F32_WINDOW_SLAB * (rows + F32_WINDOW_FORWARD_PAD)
                        + 2 * RESIDENT_MAX_GRID * rows)
    text = (_build.CSRC / "attention_fwd_f32_window.cuh").read_text()
    assert f"kFwfLdPad = {F32_WINDOW_FORWARD_PAD};" in text
    # the backward's header holds the slab and the tables' width
    text = (_build.CSRC / "attention_bwd_f32_window.cuh").read_text()
    assert f"kFwSlab = {F32_WINDOW_SLAB};" in text
    assert f"kFwMaxGrid = {RESIDENT_MAX_GRID};" in text


# K1 and K6 in f32 through their wrappers' autograd functions: the main
# paths' windows, ViT-H's d 80, a ragged window of 7 x 7
K1_K6_F32 = [("K1", 64, 2, (14, 14)), ("K1", 64, 2, (12, 12)),
             ("K6", 64, 1, (14, 14)), ("K6", 80, 1, (12, 12)),
             ("K1", 80, 2, (14, 14)), ("K1", 64, 3, (7, 7))]


@pytest.mark.parametrize("kernel,d,heads,hw", K1_K6_F32,
                         ids=[f"{k}-d{d}-H{h}-{g[0]}x{g[1]}"
                              for k, d, h, g in K1_K6_F32])
def test_k1_k6_f32_runs_the_window_bodies_both_ways(monkeypatch, kernel, d,
                                                    heads, hw):
    """Through the operator and the autograd function of K1 (packed) or K6
    (grouped): the f32 forward enters its family's f32 window forward entry
    with the tables, their grid, d and an lse buffer, and the launch count
    moves by one; the backward enters the f32 window backward's entry once,
    counted on `backward_launches`."""
    from wildlifemapper_tpu_torch.ops.flash_attention import \
        GroupedAttentionFn
    from wildlifemapper_tpu_torch.ops.windowed_attention import \
        windowed_attention_rel_pos
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import (
        PackedAttentionFn, windowed_attention_packed)

    grouped = kernel == "K6"
    n = hw[0] * hw[1]
    assert attention_body(F32, d, n, n, True, hw) == "f32_window"
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    gen = torch.Generator().manual_seed(d + n)
    c = heads * d
    rh, rw = (torch.randn(1, n, heads, g, generator=gen).requires_grad_()
              for g in hw)
    fn = windowed_attention_rel_pos if grouped else windowed_attention_packed
    name = fn.__name__
    before = (fn.launches, fn.backward_launches)
    with cuda_impls_on_cpu(name, name + ".lse"):
        if grouped:
            q, k, v = (torch.randn(1, n, d, generator=gen).requires_grad_()
                       for _ in range(3))
            out = GroupedAttentionFn.apply(q, k, v, rh, rw, d ** -0.5, fn)
        else:
            qkv = torch.randn(1, n, 3 * c, generator=gen).requires_grad_()
            out = PackedAttentionFn.apply(qkv, rh, rw, d ** -0.5, heads, fn)
    out.backward(torch.ones_like(out))
    assert (fn.launches - before[0], fn.backward_launches - before[1]) == (1, 1)
    family = "wm_grouped_attention" if grouped else "wm_attention"
    assert [entry for entry, _ in lib.calls] == [
        family + "_fwd_f32_window", family + "_bwd_f32_window"]
    fwd = lib.calls[0][1]
    assert len(fwd) == len(_build._ATTENTION_FWD)
    assert fwd[0] == _build.DTYPE_CODES[F32]
    assert None not in fwd[5:8]                      # tables, lse
    assert fwd[9:13] == (heads, n, n, d) and fwd[21:23] == hw


K2_K5_F32_HEADER = (
    "flash_attention_v2.py::_fwd_kernel (:95", "pallas_call :199",
    "flash_attention.py::_fwd_kernel (:88", "pallas_call :230",
    "206.2 GFLOP", "3.10 ms", "strip of its own", "__syncwarp",
    "24,576 B", "196,608 / 221,184 B", "gh + gw <= 128", "(64 + kl)",
    "K's next tile is copied under P.V", "f32_forward_smem_bytes",
    "one or two stages", "bit-identical", "864")


def test_k2_k5_f32_forward_header_note():
    """The f32 forward's note names the Pallas call sites of K2 and K5 it
    now replaces too, their bound on the H100 and what the design does at
    d 64 and 80 (p in strips of its own, the tables staged once a block, a
    16-column tail at d 80); the code carries the design. The card test
    test_f32_streaming_forward holds what the code does."""
    text = (_build.CSRC / "attention_fwd_f32.cuh").read_text()
    note = text[:text.index("#pragma once")]
    flat = " ".join(note.replace("//", " ").split())
    for words in K2_K5_F32_HEADER:
        assert words in flat, words
    code = text[text.index("#pragma once"):]
    for word in ("ff_p_own<D>()", "ff_tab_ld(a.gh)", "ff_put_p<NJ>(pw",
                 "__syncwarp();", "SCALE_SCORES ? 1.f : a.scale",
                 "if constexpr (NX > 4 * NV)",
                 "launch_f32_fwd<80, kFfKeys, SCALE_SCORES>",
                 "launch_f32_fwd<128, kFfKeys, false>"):
        assert word in code, word
    assert "atomic" not in code
    # one entry a family, the header's macro with the family's flag
    for name, flag in (("attention_fwd_f32.cu", "false"),
                       ("grouped_attention_fwd_f32.cu", "true")):
        src = (_build.CSRC / name).read_text()
        assert _build.CSRC / name in _build.sources()
        assert re.search(rf"^WM_DEFINE_ATTENTION_FWD_F32\(wm_\w+, {flag}\)",
                         src, re.M)
        assert "JAX package" in src and "tile body" in src
        assert ("K5" if name.startswith("grouped") else "K2") in src
        assert len(src.splitlines()) < 30


# K2 and K5 in f32 on the f32 bodies both ways, through their wrappers'
# autograd functions: the main paths' grids, ViT-H's d 80, a
# tensor-parallel rank's 6 heads, the 25 x 40 grid the backward's key tiles
# do not hold (its backward stays on the tile bodies)
K2_K5_F32 = [("K2", 64, 12, (64, 64)), ("K2", 64, 2, (48, 48)),
             ("K5", 64, 1, (64, 64)), ("K5", 64, 1, (48, 48)),
             ("K2", 80, 2, (64, 64)), ("K5", 80, 1, (48, 48)),
             ("K2", 64, 6, (48, 48)), ("K2", 64, 2, (25, 40))]


@pytest.mark.parametrize("kernel,d,heads,hw", K2_K5_F32,
                         ids=[f"{k}-d{d}-H{h}-{g[0]}x{g[1]}"
                              for k, d, h, g in K2_K5_F32])
def test_k2_k5_f32_forward_runs_the_f32_body(monkeypatch, kernel, d, heads,
                                              hw):
    """Through the operator and the autograd function of K2 (packed) or K5
    (grouped): the f32 forward enters its family's f32 forward entry with
    the tables, their grid, d and an lse buffer, and the launch count moves
    by one; the backward enters the f32 streaming backward's entry twice
    (the tile bodies' on a grid its key tiles do not hold)."""
    from wildlifemapper_tpu_torch.ops.flash_attention import (
        GroupedAttentionFn, flash_attention_rel_pos)
    from wildlifemapper_tpu_torch.ops.flash_attention_v2 import (
        flash_attention_packed)
    from wildlifemapper_tpu_torch.ops.windowed_attention_v2 import \
        PackedAttentionFn

    grouped = kernel == "K5"
    n = hw[0] * hw[1]
    assert attention_body(F32, d, n, n, True, hw) == "f32"
    lib = _StandInLibrary()
    monkeypatch.setattr(_build, "load_kernels", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    gen = torch.Generator().manual_seed(d + n)
    c = heads * d
    rh, rw = (torch.randn(1, n, heads, g, generator=gen).requires_grad_()
              for g in hw)
    fn = flash_attention_rel_pos if grouped else flash_attention_packed
    name = fn.__name__
    before = fn.launches
    with cuda_impls_on_cpu(name, name + ".lse"):
        if grouped:
            q, k, v = (torch.randn(1, n, d, generator=gen).requires_grad_()
                       for _ in range(3))
            out = GroupedAttentionFn.apply(q, k, v, rh, rw, d ** -0.5, fn)
        else:
            qkv = torch.randn(1, n, 3 * c, generator=gen).requires_grad_()
            out = PackedAttentionFn.apply(qkv, rh, rw, d ** -0.5, heads, fn)
    out.backward(torch.ones_like(out))
    assert fn.launches - before == 1
    family = "wm_grouped_attention" if grouped else "wm_attention"
    names = [entry for entry, _ in lib.calls]
    backward = (family + "_bwd_f32" if f32_key_tile(hw[1]) else
                family + "_bwd")
    assert names == [family + "_fwd_f32", backward, backward]
    fwd = lib.calls[0][1]
    assert len(fwd) == len(_build._ATTENTION_FWD)
    assert fwd[0] == _build.DTYPE_CODES[F32]
    assert None not in fwd[5:8]                      # tables, lse
    assert fwd[9:13] == (heads, n, n, d) and fwd[21:23] == hw
