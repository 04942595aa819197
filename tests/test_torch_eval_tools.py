"""The rest of the port's evaluation against the JAX package's: fast_ap50
(tensor ops) within 1e-6 of the JAX proxy, drift-as-mAP's summaries equal,
run_detections padding and trimming a tail batch, the native host helpers
(lapjv, nms, coco_match) equal to the JAX package's library and the port's
evaluator equal with and without them, augment_extra bit for bit under the
same seed; and the visualize and sanity-check CLIs on a tiny config."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu import native as jnative
from wildlifemapper_tpu.data import augment_extra as jaug
from wildlifemapper_tpu.eval import drift as jdrift
from wildlifemapper_tpu.eval.fast_ap import fast_ap50 as jfast_ap50
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch import native as tnative
from wildlifemapper_tpu_torch.data import augment_extra as taug
from wildlifemapper_tpu_torch.eval import coco_eval as tce
from wildlifemapper_tpu_torch.eval import drift as tdrift
from wildlifemapper_tpu_torch.eval.fast_ap import fast_ap50
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.test_coco_eval import FakeIndex, _ann, _pred
from tests.test_fast_ap_consistency import _scene
from tests.torch_common import flat_numpy, tiny_config


# ---- fast_ap50 -------------------------------------------------------------------

def _perfect_and_empty():
    b, q, t = 2, 8, 8
    gt_boxes = np.tile(np.asarray([[10, 10, 20, 20.0]]), (b, t, 1))
    for i in range(t):
        gt_boxes[:, i] += i * 15
    gt_valid = np.zeros((b, t), bool)
    gt_valid[:, :4] = True
    scores = np.linspace(0.9, 0.2, q)[None, :].repeat(b, 0)
    args = [gt_boxes.astype(np.float32), scores.astype(np.float32),
            np.ones((b, q), np.int32), gt_valid.copy(),
            gt_boxes.astype(np.float32), np.ones((b, t), np.int32), gt_valid]
    empty = list(args)
    empty[3] = np.zeros((b, q), bool)
    return [(args, 1.0), (empty, 0.0)]


def _half():
    b, q, t = 1, 2, 4
    gt_boxes = np.zeros((b, t, 4), np.float32)
    gt_boxes[0, 0] = [0, 0, 10, 10]
    gt_valid = np.zeros((b, t), bool)
    gt_valid[0, 0] = True
    return ([np.asarray([[[50, 50, 60, 60], [0, 0, 10, 10.0]]], np.float32),
             np.asarray([[0.9, 0.8]], np.float32), np.ones((b, q), np.int32),
             np.ones((b, q), bool), gt_boxes, np.ones((b, t), np.int32),
             gt_valid], 0.5)


def _scenes(hit_rate, seed=0):
    """test_fast_ap_consistency.py's scenes: 4 images, 16 slots, 6 GT and
    10 detections each, with labels drawn from two classes here."""
    rng = np.random.default_rng(seed)
    n, q, t = 4, 16, 16
    det_boxes = np.zeros((n, q, 4), np.float32)
    det_scores = np.zeros((n, q), np.float32)
    det_keep = np.zeros((n, q), bool)
    gt_boxes = np.zeros((n, t, 4), np.float32)
    gt_valid = np.zeros((n, t), bool)
    gts_all = []
    for img in range(n):
        gts, dets, scores = _scene(rng, 6, 10, hit_rate)
        gts_all.append(gts)
        for i, (x, y, w, h) in enumerate(gts):
            gt_boxes[img, i] = [x, y, x + w, y + h]
            gt_valid[img, i] = True
        nd = min(len(dets), q)
        det_boxes[img, :nd] = dets[:nd]
        det_scores[img, :nd] = scores[:nd]
        det_keep[img, :nd] = True
    det_labels = rng.integers(1, 3, (n, q)).astype(np.int32)
    gt_labels = rng.integers(1, 3, (n, t)).astype(np.int32)
    return [det_boxes, det_scores, det_labels, det_keep, gt_boxes, gt_labels,
            gt_valid], gts_all


FAST_AP_CASES = {"perfect": _perfect_and_empty()[0],
                 "empty": _perfect_and_empty()[1], "half": _half()}


@pytest.mark.parametrize("case", sorted(FAST_AP_CASES))
def test_fast_ap50_cases_match_jax(case):
    args, expected = FAST_AP_CASES[case]
    want = float(jfast_ap50(*map(jnp.asarray, args)))
    got = fast_ap50(*map(torch.as_tensor, args))
    assert got.dim() == 0 and got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-6
    assert float(got) == pytest.approx(expected, abs=0.01)


@pytest.mark.parametrize("hit_rate", [1.0, 0.6, 0.2])
@pytest.mark.parametrize("same_class", [True, False])
def test_fast_ap50_scenes_match_jax(hit_rate, same_class):
    args, gts = _scenes(hit_rate)
    if same_class:
        args[2] = np.ones_like(args[2])
        args[5] = np.ones_like(args[5])
    want = float(jfast_ap50(*map(jnp.asarray, args)))
    got = float(fast_ap50(*map(torch.as_tensor, args)))
    assert abs(got - want) <= 1e-6
    if same_class:
        # and it tracks the port's COCO AP50 as the JAX proxy tracks its own
        ev = tce.CocoEvaluator(FakeIndex({}, cats=(1,)))
        for img in range(len(gts)):
            keep = args[3][img]
            ev.update({img: _pred(args[0][img][keep], args[1][img][keep],
                                  np.ones(int(keep.sum()), np.int64))})
        ev.gt = FakeIndex({img: [_ann(x, y, w, h, 1) for x, y, w, h in g]
                           for img, g in enumerate(gts)}, cats=(1,))
        ev.accumulate()
        assert got == pytest.approx(ev.summarize()["AP50"], abs=0.08)


# ---- drift ---------------------------------------------------------------------------

BOXES = [[[10, 10, 50, 60], [100, 100, 180, 150]], [[200, 40, 260, 90]]]


def _dets(boxes_per_img, scores_per_img, labels_per_img, q=8):
    n = len(boxes_per_img)
    boxes = np.zeros((n, q, 4), np.float32)
    scores = np.zeros((n, q), np.float32)
    labels = np.ones((n, q), np.int32)
    for i, (b, s, lab) in enumerate(zip(boxes_per_img, scores_per_img,
                                        labels_per_img)):
        boxes[i, :len(b)] = b
        scores[i, :len(s)] = s
        labels[i, :len(lab)] = lab
    return {"boxes": boxes, "scores": scores, "labels": labels}


GT = _dets(BOXES, [[0.9, 0.8], [0.7]], [[1, 2], [1]])
GT_LOW = _dets(BOXES, [[0.9, 0.45], [0.7]], [[1, 1], [1]])
ONE_MISSING = _dets([BOXES[0][:1], BOXES[1]], [[0.9], [0.7]], [[1], [1]])
SHIFTED = _dets([[[b[0] + 3, b[1] + 3, b[2] + 3, b[3] + 3] for b in img]
                 for img in BOXES], [[0.9, 0.8], [0.7]], [[1, 2], [1]])
DRIFT_CASES = {  # test_drift.py's cases: (gt, pred, gt_thresh, check)
    "identical": (GT, GT, 0.3, lambda s: s["AP"] == s["AP50"] == 1.0),
    "missing": (GT, ONE_MISSING, 0.3, lambda s: s["AP"] < 1.0),
    "low_gt_at_0.3": (GT_LOW, ONE_MISSING, 0.3, lambda s: s["AP"] < 1.0),
    "low_gt_at_0.5": (GT_LOW, ONE_MISSING, 0.5, lambda s: s["AP"] == 1.0),
    "shifted": (GT, SHIFTED, 0.3,
                lambda s: s["AP50"] == 1.0 and s["AP"] < s["AP50"]),
}


@pytest.mark.parametrize("case", sorted(DRIFT_CASES))
def test_drift_summary_matches_jax(case):
    gt, pred, thresh, check = DRIFT_CASES[case]
    got = tdrift.drift_summary(gt, pred, 2, gt_thresh=thresh)
    want = jdrift.drift_summary(gt, pred, 2, gt_thresh=thresh)
    assert got == want and check(got)
    for t in (0.3, 0.5):
        g = tdrift.pseudo_gt_index(gt, 2, t)
        w = jdrift.pseudo_gt_index(gt, 2, t)
        assert g.categories == w.categories
        assert [g.annotations(i) for i in range(2)] == [
            w.annotations(i) for i in range(2)]


def test_run_detections_pads_and_trims_tail_batch():
    """5 tiles through batch 4 in both packages from the same weights: the
    tail batch padded, the output trimmed to 5, the same detections; the
    self-drift of the result is 1.0."""
    jc = dataclasses.replace(tiny_config(jcfg), img_size=64)
    tc = dataclasses.replace(tiny_config(tcfg), img_size=64)
    tiles = np.random.default_rng(0).normal(size=(5, 64, 64, 3)
                                            ).astype(np.float32)
    params = jax.jit(JaxWildlifeMapper(jc).init)(jax.random.PRNGKey(0),
                                                 tiles[:1])
    tm = WildlifeMapper(tc, device="cpu").eval()
    load_reference_state_dict(tm, state_dict_from_jax(flat_numpy(params),
                                                      depth=jc.vit.depth))
    want = jdrift.run_detections(jc, params, tiles, batch=4)
    got = tdrift.run_detections(tm, tiles, batch=4)
    assert sorted(got) == sorted(want)
    assert got["boxes"].shape == (5, 7, 4) and got["scores"].shape == (5, 7)
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert tdrift.drift_summary(got, got, n=5, gt_thresh=0.0)["AP"] == 1.0


# ---- native ------------------------------------------------------------------------

needs_native = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="no C++ compiler here")


def test_native_source_is_a_byte_copy():
    assert (tnative.SRC.read_bytes()
            == (jnative._DIR / "src" / "wm_native.cpp").read_bytes())


@needs_native
@pytest.mark.parametrize("n", [3, 17, 64])
def test_native_lapjv_matches_jax(n):
    c = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32) * 10
    got, want = tnative.lapjv(c), jnative.lapjv(c)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@needs_native
@pytest.mark.parametrize("iou", [0.3, 0.5])
def test_native_nms_matches_jax(iou):
    rng = np.random.default_rng(1)
    n = 200
    boxes = np.zeros((n, 4), np.float32)
    boxes[:, :2] = rng.uniform(0, 500, (n, 2))
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 50, (n, 2))
    scores = rng.uniform(size=n).astype(np.float32)
    got, want = tnative.nms(boxes, scores, iou), jnative.nms(boxes, scores, iou)
    assert np.array_equal(got, want)
    from wildlifemapper_tpu_torch.eval.orthomosaic import _nms_numpy
    assert set(got) == set(_nms_numpy(boxes.astype(np.float64),
                                      scores.astype(np.float64), iou))


@needs_native
def test_native_coco_match_matches_jax():
    rng = np.random.default_rng(2)
    ious = rng.uniform(0, 1, (9, 6))
    thrs = np.linspace(0.5, 0.95, 10)
    g_ignore = np.asarray([0, 0, 0, 0, 1, 1], bool)
    g_crowd = np.asarray([0, 0, 0, 0, 0, 1], bool)
    got = tnative.coco_match(ious, thrs, g_ignore, g_crowd)
    want = jnative.coco_match(ious, thrs, g_ignore, g_crowd)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(got, tce.match_greedy(ious, thrs, g_ignore, g_crowd)):
        assert np.array_equal(a, b)


def test_native_builds_from_a_clean_copy(tmp_path):
    """A fresh checkout has no library: the tracked source alone builds one,
    keyed by its hash, and it solves an assignment."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    src = tmp_path / "src" / "wm_native.cpp"
    src.parent.mkdir()
    shutil.copy(tnative.SRC, src)
    lib = tnative.build(src, tmp_path / "build")
    assert lib == tnative.library_path(src, tmp_path / "build")
    assert lib.parent.name == tnative.library_path().parent.name
    handle = tnative.bind(lib)
    import ctypes
    c = np.ascontiguousarray(np.random.default_rng(3).normal(size=(8, 8)),
                             np.float32)
    out = np.empty(8, np.int32)
    assert handle.wm_lapjv(c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           8, out.ctypes.data_as(
                               ctypes.POINTER(ctypes.c_int))) == 0
    from scipy.optimize import linear_sum_assignment
    r, cc = linear_sum_assignment(c)
    np.testing.assert_allclose(c[np.arange(8), out].sum(), c[r, cc].sum(),
                               rtol=1e-6, atol=1e-4)


@needs_native
def test_evaluator_native_equals_numpy_matcher(monkeypatch):
    """test_native.py's scene through the port's evaluator, with the native
    matcher and with match_greedy: the same 12 stats."""
    anns = {1: [_ann(i * 15, 0, 10, 10, 1) for i in range(6)]
            + [_ann(0, 100, 20, 20, 2, crowd=1)],
            2: [_ann(5, 5, 30, 30, 2)]}
    boxes = np.concatenate([
        np.asarray([[i * 15 + 1, 0, i * 15 + 11, 10] for i in range(6)]),
        np.asarray([[0, 100, 20, 120], [300, 300, 310, 310.0]])])
    scores = np.random.default_rng(0).uniform(0.2, 1.0, size=8)
    labels = np.asarray([1] * 6 + [2, 2])
    calls = []

    def run():
        ev = tce.CocoEvaluator(FakeIndex(anns))
        ev.update({1: _pred(boxes, scores, labels),
                   2: _pred([[5, 6, 34, 36]], [0.9], [2])})
        ev.accumulate()
        return ev.summarize()

    coco_match = tnative.coco_match
    monkeypatch.setattr(tnative, "coco_match",
                        lambda *a: calls.append(1) or coco_match(*a))
    with_native = run()
    assert calls
    monkeypatch.setattr(tnative, "coco_match", lambda *a: None)
    assert run() == with_native


# ---- augment_extra ---------------------------------------------------------------

@pytest.mark.parametrize("fn", ["hsv_roundtrip", "augment_hsv", "mixup",
                                "cutout"])
def test_augment_extra_matches_jax(fn):
    def call(mod):
        rng = np.random.default_rng(7)
        img = rng.integers(0, 255, (48, 40, 3), dtype=np.uint8)
        if fn == "hsv_roundtrip":
            hsv = mod.rgb_to_hsv(img)
            return [hsv, mod.hsv_to_rgb(hsv)]
        if fn == "augment_hsv":
            return [mod.augment_hsv(img, rng)]
        if fn == "mixup":
            t1 = {"boxes": np.asarray([[0, 0, 4, 4.0]]),
                  "labels": np.asarray([1])}
            t2 = {"boxes": np.asarray([[2, 2, 6, 6.0]]),
                  "labels": np.asarray([2])}
            out, tgt = mod.mixup(img, t1, img[::-1].copy(), t2, rng)
            return [out, tgt["boxes"], tgt["labels"]]
        boxes = np.asarray([[0, 0, 10, 10.0], [20, 20, 36, 40]])
        return list(mod.cutout(img, boxes, rng))

    for got, want in zip(call(taug), call(jaug)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---- the drawing CLIs (PIL; held on the CPU only) ---------------------------------

def _cli_config():
    vit = tcfg.ViTConfig(embed_dim=64, depth=2, num_heads=2,
                         global_attn_indexes=(1,), window_size=4,
                         out_chans=32)
    model = dataclasses.replace(
        tcfg.model_config("vit_b"), vit=vit, img_size=64, patch_size=16,
        hfc=tcfg.HFCConfig(embed_dim=32, proj_dim=32, num_heads=2,
                           ffn_dim=32),
        decoder=tcfg.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                   num_queries=16, num_heads=2))
    data = tcfg.DataConfig(resize_size=48, canvas_size=64, max_targets=32,
                           allow_truncation=True, batch_size=2,
                           synthetic=True, synthetic_size=64, flip_prob=0.5)
    return tcfg.Config(model=model, data=data,
                       criterion=tcfg.MatchCriterionConfig(max_targets=32))


@pytest.fixture
def no_disk_cache(monkeypatch):
    monkeypatch.setenv("WM_SYNTH_CACHE", "0")


@pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")
def test_visualize_cli_writes_overlays(tmp_path, monkeypatch, no_disk_cache):
    from PIL import Image

    from wildlifemapper_tpu_torch.cli import visualize as viz

    cfg = _cli_config()
    monkeypatch.setattr(viz, "config_from_args", lambda args: cfg)
    m = WildlifeMapper(cfg.model, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    torch.save({k: v * 1.5 for k, v in m.state_dict().items()},
               tmp_path / "w.pth")
    out = tmp_path / "plots"
    assert viz.main(["--output_dir", str(out), "--max_images", "2",
                     "--score_threshold", "0.0", "--device", "cpu",
                     "--checkpoint", str(tmp_path / "w.pth")]) == 2
    files = sorted(out.glob("*.jpg"))
    assert len(files) == 2 and all(f.stem.isdigit() for f in files)
    img = Image.open(files[0])
    # the content region of the 64-canvas (resize_size=48, aspect kept)
    assert max(img.size) == 48 and min(img.size) >= 1

    # --draw_gt adds white GT outlines under the detections
    out_gt = tmp_path / "plots_gt"
    viz.main(["--output_dir", str(out_gt), "--max_images", "1",
              "--score_threshold", "0.99", "--draw_gt", "--device", "cpu"])
    arr = np.asarray(Image.open(sorted(out_gt.glob("*.jpg"))[0]))
    assert (arr > 235).all(axis=-1).any()


@pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")
def test_sanitycheck_cli_writes_overlays(tmp_path, monkeypatch,
                                         no_disk_cache):
    from PIL import Image

    from wildlifemapper_tpu_torch.cli import sanitycheck as sc

    monkeypatch.setattr(sc, "config_from_args", lambda args: _cli_config())
    out = tmp_path / "data_sanitycheck.png"
    written = sc.main(["--output", str(out), "-n", "2"])
    assert written == [str(out), str(tmp_path / "data_sanitycheck_1.png")]
    assert 46 <= max(Image.open(out).size) <= 48


def test_render_sample_draws_gt_box_in_species_color():
    """test_cli_sanitycheck.py's case, against the JAX renderer's pixels."""
    from wildlifemapper_tpu.cli.sanitycheck import \
        render_sample as jrender_sample
    from wildlifemapper_tpu_torch.cli.sanitycheck import render_sample
    from wildlifemapper_tpu_torch.train.logging import SPECIES

    example = {
        "image": np.zeros((64, 64, 3), np.uint8),
        "size": np.asarray([40, 64], np.int32),
        "boxes": np.asarray([[0.5, 0.5, 0.5, 0.5], [0.1, 0.1, 0.05, 0.05]],
                            np.float32),
        "labels": np.asarray([2, 1], np.int64),
        "valid": np.asarray([True, False]),
    }
    arr = np.asarray(render_sample(example, emit_uint8=True))
    assert arr.shape == (40, 64, 3)
    assert tuple(arr[10, 32]) == SPECIES[2][1]
    assert tuple(arr[3, 6]) == (0, 0, 0)
    assert np.array_equal(arr, np.asarray(jrender_sample(example, True)))
