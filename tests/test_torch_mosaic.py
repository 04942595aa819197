"""The port's orthomosaic path against the JAX package's: the tiler (a numpy
copy: grids and tiles ==), the host NMS (the same kept indices, in order),
OrthomosaicDetector over a tiny model from the same weights (the candidates
before the cross-seam NMS and the fused detections at atol 1e-4 / rtol
1e-3, labels equal), and the detect_mosaic CLI on a PNG with a reference
.pth. Also that the modules of the slice import with PIL blocked (the card's
machine has none)."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.data import tiler as jtiler
from wildlifemapper_tpu.eval import orthomosaic as jortho
from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.data import tiler as ttiler
from wildlifemapper_tpu_torch.eval import orthomosaic as tortho
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.torch_common import flat_numpy, perturbed, tiny_config

REPO = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-3)


# ---- the tiler ---------------------------------------------------------------

@pytest.mark.parametrize("hw,tile,overlap", [
    ((3648, 5472), 1024, 256), ((500, 700), 1024, 256), ((100, 150), 64, 16),
    ((64, 64), 64, 16), ((1000, 1025), 1024, 0), ((130, 97), 32, 8)])
def test_tile_grid_matches_jax(hw, tile, overlap):
    got = ttiler.make_tile_grid(*hw, tile=tile, overlap=overlap)
    want = jtiler.make_tile_grid(*hw, tile=tile, overlap=overlap)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    cover = np.zeros(hw, dtype=bool)
    for y0, x0 in got.origins:
        cover[y0:y0 + tile, x0:x0 + tile] = True
    assert cover.all()


@pytest.mark.parametrize("hw,tile,overlap,indices", [
    ((100, 150), 64, 16, None), ((100, 150), 64, 16, [5, 0, 3]),
    ((40, 70), 64, 16, None), ((130, 97), 32, 8, [1, 2])])
def test_tiles_match_jax(hw, tile, overlap, indices):
    img = np.random.default_rng(0).integers(0, 255, hw + (3,), np.uint8)
    grid = ttiler.make_tile_grid(*hw, tile=tile, overlap=overlap)
    got = ttiler.extract_tiles(img, grid, indices)
    want = jtiler.extract_tiles(
        img, jtiler.make_tile_grid(*hw, tile=tile, overlap=overlap), indices)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    # written into a used, larger buffer (the detector's padded batch)
    out = np.full((len(want) + 2, tile, tile, 3), 7, np.uint8)
    assert ttiler.extract_tiles(img, grid, indices, out=out) is out
    assert np.array_equal(out[:len(want)], want) and not out[len(want):].any()


def test_uncrop_and_batched_match_jax():
    b = np.asarray([[10.0, 20, 30, 40], [0, 0, 1, 1]], np.float32)
    got = ttiler.uncrop_boxes(b, (100, 200))
    want = jtiler.uncrop_boxes(b, (100, 200))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (list(ttiler.batched(range(9), 4))
            == list(jtiler.batched(range(9), 4)))


# ---- the host NMS --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_numpy_matches_jax(seed):
    """The kept indices, in their order (part of the fused result), on
    clustered boxes with tied scores."""
    rng = np.random.default_rng(seed)
    n = 120
    boxes = np.zeros((n, 4), np.float32)
    boxes[:, :2] = rng.uniform(0, 200, (n, 2))
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 40, (n, 2))
    scores = rng.choice(np.linspace(0.1, 0.9, 9), n).astype(np.float32)
    for iou in (0.3, 0.4, 0.7):
        got = tortho._nms_numpy(boxes, scores, iou)
        want = jortho._nms_numpy(boxes, scores, iou)
        assert got.dtype == want.dtype and np.array_equal(got, want)


# ---- the detector --------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_models():
    """The tiny model at a 64-px tile (grid 4, windows of 4) in both
    packages from the same perturbed weights."""
    jc = dataclasses.replace(tiny_config(jcfg), img_size=64)
    tc = dataclasses.replace(tiny_config(tcfg), img_size=64)
    jm = JaxWildlifeMapper(jc)
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 64, 64, 3))),
                       np.random.default_rng(1))
    tm = WildlifeMapper(tc, device="cpu").eval()
    load_reference_state_dict(tm, state_dict_from_jax(flat_numpy(params),
                                                      depth=jc.vit.depth))
    return jc, jm, params, tc, tm


def _mosaic(seed=0, hw=(100, 150)):
    return np.random.default_rng(seed).integers(0, 255, hw + (3,), np.uint8)


def test_orthomosaic_matches_jax(tiny_models, monkeypatch):
    """A 100 x 150 mosaic, tile 64, overlap 16, tile_batch 2 (6 tiles in 3
    batches): the candidates the cross-seam NMS sees, then the fused
    detections."""
    jc, jm, params, tc, tm = tiny_models
    seen = {}
    nms = jortho._nms_numpy

    def spy(boxes, scores, iou):
        seen.update(boxes=boxes, scores=scores)
        return nms(boxes, scores, iou)

    monkeypatch.setattr(jortho, "_nms_numpy", spy)
    kw = dict(tile_batch=2, overlap=16, confidence_threshold=0.0,
              nms_iou=0.4)
    mosaic = _mosaic()
    want = jortho.OrthomosaicDetector(jm, params, jc, **kw).detect(mosaic)
    det = tortho.OrthomosaicDetector(tm, tc, **kw)
    boxes, scores, labels = det.candidates(mosaic)
    assert boxes.shape == seen["boxes"].shape == (6 * 7, 4)
    np.testing.assert_allclose(boxes, seen["boxes"], **TOL)
    np.testing.assert_allclose(scores, seen["scores"], **TOL)
    got = det.detect(mosaic)
    assert sorted(got) == sorted(want) == ["boxes", "labels", "scores"]
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    for k in ("boxes", "scores"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], **TOL)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert (got["boxes"][:, 2] <= 150 + 64).all()
    assert set(det.timing) == {"extract_ms", "launch_ms", "wait_ms", "nms_ms"}


def test_orthomosaic_empty_case_matches_jax(tiny_models):
    """Nothing above the threshold: the JAX detector's empty arrays."""
    jc, jm, params, tc, tm = tiny_models
    kw = dict(tile_batch=4, overlap=16, confidence_threshold=1.1)
    mosaic = _mosaic(1, (70, 90))
    want = jortho.OrthomosaicDetector(jm, params, jc, **kw).detect(mosaic)
    got = tortho.OrthomosaicDetector(tm, tc, **kw).detect(mosaic)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype


def test_detect_is_the_synchronous_loop(tiny_models):
    """The double-buffered detect gives what one batch at a time gives:
    extract, pad, run, uncrop, NMS."""
    _, _, _, tc, tm = tiny_models
    det = tortho.OrthomosaicDetector(tm, tc, tile_batch=4, overlap=8,
                                     confidence_threshold=0.2)
    mosaic = _mosaic(2, (150, 170))
    grid = ttiler.make_tile_grid(150, 170, 64, 8)
    found = []
    for idxs in ttiler.batched(range(grid.num_tiles), 4):
        batch = np.zeros((4, 64, 64, 3), np.uint8)
        batch[:len(idxs)] = ttiler.extract_tiles(mosaic, grid, idxs)
        dets = {k: v.numpy() for k, v in det.run(torch.from_numpy(batch))
                .items()}
        for j, ti in enumerate(idxs):
            keep = dets["keep"][j]
            found.append((ttiler.uncrop_boxes(dets["boxes"][j][keep],
                                              grid.origins[ti]),
                          dets["scores"][j][keep], dets["labels"][j][keep]))
    boxes, scores, labels = (np.concatenate(c) for c in zip(*found))
    keep = tortho._nms_numpy(boxes, scores, det.nms_iou)
    got = det.detect(mosaic)
    assert grid.num_tiles == 9 and len(keep) > 0     # the last batch padded
    np.testing.assert_array_equal(got["boxes"], boxes[keep])
    np.testing.assert_array_equal(got["scores"], scores[keep])
    np.testing.assert_array_equal(got["labels"], labels[keep])


# ---- the CLI ---------------------------------------------------------------------

def test_detect_mosaic_cli_with_a_pth(tiny_models, tmp_path, monkeypatch):
    """A PNG and a trained-checkpoint .pth: the JAX CLI's JSON keys, the
    detector's detections from the file's weights."""
    from PIL import Image

    from wildlifemapper_tpu_torch.cli import detect_mosaic as dm

    _, _, params, tc, tm = tiny_models
    cfg = tcfg.Config(model=tc)
    monkeypatch.setattr(dm, "config_from_args", lambda args: cfg)
    sd = state_dict_from_jax(flat_numpy(params), depth=tc.vit.depth)
    torch.save({"model": {"module." + k: v for k, v in sd.items()},
                "optimizer": {}, "epoch": 3}, tmp_path / "w.pth")
    mosaic = _mosaic(3, (150, 200))
    Image.fromarray(mosaic).save(tmp_path / "mosaic.png")
    out_json = tmp_path / "dets.json"
    dm.main(["--images", str(tmp_path / "mosaic.png"), "--output",
             str(out_json), "--tile_batch", "2", "--overlap", "16",
             "--score_threshold", "0.0", "--checkpoint",
             str(tmp_path / "w.pth"), "--device", "cpu"])
    r = json.loads(out_json.read_text())["mosaic.png"]
    assert set(r) == {"boxes", "scores", "labels"}
    assert len(r["boxes"]) == len(r["scores"]) == len(r["labels"]) > 0
    want = tortho.OrthomosaicDetector(
        tm, tc, tile_batch=2, overlap=16, confidence_threshold=0.0,
        nms_iou=cfg.eval.nms_iou).detect(mosaic)
    np.testing.assert_array_equal(np.asarray(r["boxes"], np.float32),
                                  want["boxes"])
    for b in r["boxes"]:          # mosaic coordinates, within a tile of it
        assert -64 <= b[0] <= 200 and -64 <= b[1] <= 150


@pytest.mark.parametrize("cli", ["detect_mosaic", "visualize"])
def test_model_clis_run_on_the_card(cli, tmp_path, monkeypatch):
    """Without CUDA the CLIs that run the model raise, unless asked for the
    CPU."""
    import importlib

    mod = importlib.import_module(f"wildlifemapper_tpu_torch.cli.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--images", str(tmp_path / "none.png")] if cli == "detect_mosaic"
            else ["--synthetic_data", "--output_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)


def test_slice_imports_without_pil():
    """With PIL blocked, the detector, the .pth reader, drift, the tools and
    the CLIs import: the card's machine has no PIL."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import wildlifemapper_tpu_torch.eval.orthomosaic\n"
        "import wildlifemapper_tpu_torch.compat.torch_convert\n"
        "import wildlifemapper_tpu_torch.eval.drift\n"
        "import wildlifemapper_tpu_torch.eval.fast_ap\n"
        "import wildlifemapper_tpu_torch.native\n"
        "import wildlifemapper_tpu_torch.data.augment_extra\n"
        "import wildlifemapper_tpu_torch.cli.detect_mosaic\n"
        "import wildlifemapper_tpu_torch.cli.visualize\n"
        "import wildlifemapper_tpu_torch.cli.sanitycheck\n"
        "assert not [m for m in sys.modules if m.startswith('PIL.')]\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
