"""The port's data pipeline (wildlifemapper_tpu_torch/data: coco, transforms,
mosaic, loader) against the JAX package's, on the vendored annotation bundle
with synthetic tiles.

The port resizes with torch's antialiased bilinear interpolation where the
JAX package calls PIL: at a 3/4 shrink (64 -> 48, 256 -> 192, 1024 -> 768)
and at an enlargement (256 -> 768) the pixels are PIL's bit for bit, so
every key of every batch is compared with ==; at the original 5472 x 3648
frames and on a real file the images may differ by one level and the boxes
not at all. The disk cache of rendered tiles is off (WM_SYNTH_CACHE=0)
unless a test points it at its own directory.
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.data import coco as jcoco
from wildlifemapper_tpu.data import loader as jloader
from wildlifemapper_tpu.data import transforms as jtf
from wildlifemapper_tpu.eval.coco_eval import CocoEvaluator as JEvaluator
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.data import coco as tcoco
from wildlifemapper_tpu_torch.data import loader as tloader
from wildlifemapper_tpu_torch.data import transforms as ttf
from wildlifemapper_tpu_torch.eval.coco_eval import CocoEvaluator

REPO = Path(__file__).resolve().parents[1]


# the tiny shapes cap the targets at 32 and truncate with a warning
pytestmark = pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny shapes gain nothing from torch's intra-op threads, which thrash
    when the suite runs in several processes at once (and the loader's
    threads run torch beside the step's)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_disk_cache(monkeypatch):
    monkeypatch.setenv("WM_SYNTH_CACHE", "0")


def _data_configs(**kw):
    """The same DataConfig in both packages, on each package's bundle."""
    base = dict(synthetic=True, batch_size=3, max_targets=32,
                allow_truncation=True, flip_prob=0.5)
    base.update(kw)
    return (jcfg.DataConfig(coco_path=str(jcoco.ASSETS_DIR), **base),
            tcfg.DataConfig(coco_path=str(tcoco.ASSETS_DIR), **base))


def _batches(pkg, data_cfg, split, epoch, n, num_workers=0,
             worker_mode="thread"):
    ds = pkg.build_dataset(split, data_cfg)
    loader = pkg.DataLoader(ds, data_cfg.batch_size, shuffle=split == "train",
                            seed=7, drop_last=split == "train",
                            num_workers=num_workers, worker_mode=worker_mode)
    out = []
    try:
        for b in loader.epoch(epoch):
            out.append(b)
            if len(out) == n:
                break
    finally:
        loader.close()
    return out


def _assert_batches_equal(want, got, image_levels=0):
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k == "image" and image_levels:
                diff = np.abs(a[k].astype(np.float64) - b[k].astype(np.float64))
                assert diff.max() <= image_levels, diff.max()
            else:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)


# split, epoch, batches, DataConfig fields: the tiny test shapes (64 -> 48,
# train with flips, val with its padded last batch), a 256 -> 192 and a
# 1024 -> 768 shrink with uint8 canvases, a 256 -> 768 enlargement, mosaic
LOADER_CASES = {
    "train_64": ("train", 2, 6, dict(synthetic_size=64, resize_size=48,
                                      canvas_size=64)),
    "val_64_padded": ("val", 0, None, dict(synthetic_size=64, resize_size=48,
                                            canvas_size=64, batch_size=4)),
    "train_256_uint8": ("train", 1, 3, dict(
        synthetic_size=256, resize_size=192, canvas_size=256,
        device_normalize=True)),
    "val_256_to_768": ("val", 0, 1, dict(synthetic_size=256, resize_size=768,
                                          canvas_size=1024, batch_size=2,
                                          device_normalize=True)),
    "train_1024_uint8": ("train", 0, 1, dict(
        synthetic_size=1024, resize_size=768, canvas_size=1024, batch_size=2,
        device_normalize=True)),
    "train_mosaic_64": ("train", 1, 4, dict(synthetic_size=64,
                                             resize_size=48, canvas_size=64,
                                             use_mosaic=True,
                                             max_targets=None)),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_batches_match_jax(case):
    split, epoch, n, kw = LOADER_CASES[case]
    jd, td = _data_configs(**kw)
    want = _batches(jloader, jd, split, epoch, n)
    got = _batches(tloader, td, split, epoch, n)
    _assert_batches_equal(want, got)
    if split == "val" and n is None:
        # the padded final batch repeats its last example and says so
        valid = got[-1]["batch_valid"]
        assert not valid.all() and valid.any()
        assert all(b["batch_valid"].all() for b in got[:-1])


def test_loader_original_frame_within_one_level():
    """No synthetic_size: tiles at the annotation file's 5472 x 3648, shrunk
    to 48 x 32, where torch and PIL may round a pixel apart."""
    jd, td = _data_configs(resize_size=48, canvas_size=64, batch_size=2,
                           flip_prob=0.0)
    want = _batches(jloader, jd, "val", 0, 1)
    got = _batches(tloader, td, "val", 0, 1)
    _assert_batches_equal(want, got, image_levels=1)


def test_worker_modes_match_jax():
    """The thread pool and the spawned process pool give the JAX loader's
    worker-pool batches (the per-example seeds of the epoch stream)."""
    jd, td = _data_configs(synthetic_size=64, resize_size=48, canvas_size=64)
    want = _batches(jloader, jd, "train", 0, 2, num_workers=2)
    for mode in ("thread", "process"):
        got = _batches(tloader, td, "train", 0, 2, num_workers=2,
                       worker_mode=mode)
        _assert_batches_equal(want, got)


def test_pinned_batches_hold_the_same_values():
    """pin_memory collates into host tensors (pinned where CUDA is present)
    with the numpy batch's values."""
    if not torch.cuda.is_available():
        pytest.skip("pinned host memory needs CUDA")
    _, td = _data_configs(synthetic_size=64, resize_size=48, canvas_size=64)
    ds = tloader.build_dataset("val", td)
    plain = next(iter(tloader.DataLoader(ds, 3, shuffle=False).epoch(0)))
    pinned = next(iter(tloader.DataLoader(ds, 3, shuffle=False,
                                          pin_memory=True).epoch(0)))
    for k in plain:
        assert pinned[k].is_pinned()
        np.testing.assert_array_equal(pinned[k].numpy(), plain[k])


def test_real_file_within_one_level(tmp_path):
    """A PNG decoded with PIL: the port's preprocess_example against the JAX
    one on Image.open of the same file."""
    rng = np.random.default_rng(3)
    h, w = 900, 1200
    smooth = np.kron(rng.integers(0, 256, (h // 30, w // 30, 3)),
                     np.ones((30, 30, 1))).astype(np.uint8)
    path = tmp_path / "tile.png"
    Image.fromarray(smooth).save(path)
    anns = [{"bbox": [100, 200, 50, 40], "category_id": 2, "iscrowd": 0},
            {"bbox": [600, 10, 300, 80], "category_id": 5, "iscrowd": 0}]
    jpre = jtf.PreprocessConfig(emit_uint8=True, flip_prob=0.0)
    tpre = ttf.PreprocessConfig(emit_uint8=True, flip_prob=0.0)
    want = jtf.preprocess_example(Image.open(path), anns, 7, jpre)
    got = ttf.preprocess_example(path, anns, 7, tpre)
    for k in want:
        if k == "image":
            diff = np.abs(want[k].astype(int) - got[k].astype(int))
            assert diff.max() <= 1, diff.max()
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(got["size"], [576, 768])


def test_imports_and_synthetic_batch_without_pil():
    """With PIL blocked, the loader, the transforms, the loop and both CLIs
    import, and a synthetic batch is built: the machine with the card has
    no PIL."""
    code = (
        "import sys, os\n"
        "sys.modules['PIL'] = None\n"
        "os.environ['WM_SYNTH_CACHE'] = '0'\n"
        "import wildlifemapper_tpu_torch.data.transforms\n"
        "import wildlifemapper_tpu_torch.train.loop\n"
        "import wildlifemapper_tpu_torch.cli.train\n"
        "import wildlifemapper_tpu_torch.cli.evaluate\n"
        "from wildlifemapper_tpu_torch.config import DataConfig\n"
        "from wildlifemapper_tpu_torch.data.loader import DataLoader, "
        "build_dataset\n"
        "dc = DataConfig(synthetic=True, synthetic_size=64, resize_size=48,\n"
        "                canvas_size=64, batch_size=2)\n"
        "b = next(iter(DataLoader(build_dataset('train', dc), 2, True)"
        ".epoch(0)))\n"
        "assert b['image'].shape == (2, 64, 64, 3), b['image'].shape\n"
        "assert 'PIL.Image' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_bundle_is_a_byte_copy():
    for split in ("train", "val", "test"):
        name = f"{split}.json.gz"
        assert ((tcoco.ASSETS_DIR / name).read_bytes()
                == (jcoco.ASSETS_DIR / name).read_bytes()), name


def test_annotation_resolution_rules(tmp_path):
    """resolve_ann_file's loud substitution (warning) and its refusal for a
    partly present dataset, as the JAX package's."""
    with pytest.warns(RuntimeWarning, match="substituting"):
        resolved = tcoco.resolve_ann_file(str(tmp_path / "absent" / "val.json"))
    assert resolved == str(tcoco.ASSETS_DIR / "val.json.gz")
    (tmp_path / "train.json").write_text('{"images": [], "annotations": []}')
    with pytest.raises(FileNotFoundError, match="partially-present"):
        tcoco.resolve_ann_file(str(tmp_path / "val.json"))
    d = tcoco.load_ann_json(str(tcoco.ASSETS_DIR / "val.json"))
    assert d == jcoco.load_ann_json(str(jcoco.ASSETS_DIR / "val.json"))


@pytest.mark.parametrize("use_mosaic", [False, True])
def test_max_targets_resolution(use_mosaic):
    """max_targets=None sizes the cap from the annotation file (densest
    image, x4 under mosaic, a multiple of 8), as the JAX dataset does."""
    jd, td = _data_configs(max_targets=None, use_mosaic=use_mosaic)
    want = jloader.build_dataset("train", jd).preprocess.max_targets
    got = tloader.build_dataset("train", td).preprocess.max_targets
    densest = tcoco.CocoIndex(str(tcoco.ASSETS_DIR / "train.json")) \
        .max_anns_per_image()
    assert got == want
    assert got % 8 == 0 and got >= densest * (4 if use_mosaic else 1)


@pytest.mark.parametrize("size", [64, 256])
def test_scaled_index_matches_rendered_frame(size):
    """With synthetic_size the index the evaluator scores against lives in
    the rendered frame: its annotations equal the JAX view's, and perfect
    predictions read from it score AP 1 in both evaluators."""
    jd, td = _data_configs(synthetic_size=size, resize_size=size * 3 // 4,
                           canvas_size=size)
    jidx = jloader.build_dataset("val", jd).index
    tidx = tloader.build_dataset("val", td).index
    some = [i for i in tidx.ids[:16] if tidx.annotations(i)]
    assert some
    preds = {}
    for iid in some:
        assert tidx.image_info(iid) == jidx.image_info(iid)
        assert tidx.image_info(iid)["width"] == size
        anns = tidx.annotations(iid)
        assert anns == jidx.annotations(iid)
        boxes = np.array([[a["bbox"][0], a["bbox"][1],
                           a["bbox"][0] + a["bbox"][2],
                           a["bbox"][1] + a["bbox"][3]] for a in anns])
        assert (boxes >= 0).all() and (boxes <= size).all()
        preds[iid] = {"boxes": boxes,
                      "scores": np.ones(len(anns), np.float32),
                      "labels": np.array([a["category_id"] for a in anns])}
    for ev in (CocoEvaluator(tidx), JEvaluator(jidx)):
        ev.update(preds)
        ev.accumulate()
        assert ev.summarize()["AP"] >= 0.99


def test_disk_cache_is_exact_and_keyed_as_jax(tmp_path, monkeypatch):
    """A tile served from WM_SYNTH_CACHE equals a fresh render, under the
    JAX loader's key."""
    monkeypatch.setenv("WM_SYNTH_CACHE", str(tmp_path))
    jd, td = _data_configs(synthetic_size=64, resize_size=48,
                           canvas_size=64, flip_prob=0.0)
    cold = tloader.build_dataset("val", td)
    a = cold.get(3)
    warm = tloader.build_dataset("val", td)
    assert warm._disk_load(warm.index.ids[3]) is not None
    b = warm.get(3)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    jds = jloader.build_dataset("val", jd)
    iid = cold.index.ids[3]
    # the same tag and file name, given the same annotation file (the two
    # copies of the bundle differ in their mtime, which the key includes)
    jds._ann_fingerprint = cold._ann_fingerprint
    assert (Path(cold._disk_key(iid)).name
            == Path(jds._disk_key(iid)).name)


def test_transforms_semantics():
    """The transform-level cases of tests/test_data.py on the port's copy."""
    assert ttf.resize_keep_aspect((5472, 3648), 768, 768) == (768, 512)
    assert ttf.resize_keep_aspect((768, 768), 768, 768) == (768, 768)
    assert ttf.resize_keep_aspect((100, 200), 768, 768) == (384, 768)
    anns = [
        {"bbox": [10, 10, 20, 20], "category_id": 3, "iscrowd": 0},
        {"bbox": [-5, -5, 8, 8], "category_id": 1, "iscrowd": 0},
        {"bbox": [50, 50, 0, 10], "category_id": 2, "iscrowd": 0},
        {"bbox": [5, 5, 10, 10], "category_id": 4, "iscrowd": 1},
    ]
    t = ttf.target_from_annotations(anns, 100, 100)
    j = jtf.target_from_annotations(anns, 100, 100)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    img = np.zeros((4, 4, 3), dtype=np.float32)
    img[0, :, 0] = 1.0
    boxes = np.asarray([[0.5, 0.25, 0.2, 0.1]], dtype=np.float32)
    for vertical in (True, False):
        fi, fb = ttf.flip(img, boxes, vertical)
        ji, jb = jtf.flip(img, boxes, vertical)
        np.testing.assert_array_equal(fi, ji)
        np.testing.assert_array_equal(fb, jb)
    big = np.random.default_rng(0).uniform(size=(100, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="exceed"):
        ttf.pad_targets(big, np.ones(100, np.int32), 64)
    with pytest.warns(RuntimeWarning, match="truncating"):
        b, _, v = ttf.pad_targets(big, np.ones(100, np.int32), 64,
                                  allow_truncate=True)
    assert b.shape == (64, 4) and v.sum() == 64


def test_mosaic_matches_jax():
    from wildlifemapper_tpu.data.mosaic import make_mosaic as jmosaic
    from wildlifemapper_tpu_torch.data.mosaic import make_mosaic as tmosaic

    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, (48, 40 + 4 * i, 3), np.uint8)
              for i in range(4)]
    targets = [{"boxes": np.array([[2, 3, 20, 30]], np.float32) + i,
                "labels": np.array([i + 1], np.int32)} for i in range(4)]
    want = jmosaic(images, targets, 48, np.random.default_rng(9))
    got = tmosaic(images, targets, 48, np.random.default_rng(9))
    np.testing.assert_array_equal(got[0], want[0])
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])


def test_build_dataset_from_config_defaults():
    """The port's DataConfig defaults to its bundle, so build_dataset finds
    the annotations without a warning."""
    dc = dataclasses.replace(tcfg.DataConfig(), synthetic=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        ds = tloader.build_dataset("val", dc)
    assert len(ds) == 111 and ds.preprocess.max_targets >= 56
