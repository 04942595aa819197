"""The north-star evidence chain of the PyTorch port (scripts/
drift_proxy_torch.py, build_scaled_ann_torch.py, conjunction_torch.py)
against the JAX scripts it ports (drift_proxy_cpu.py, build_scaled_ann.py,
conjunction.py), on the CPU at small sizes.

What is held, and against what:
  * build_scaled_annotations and build_scaled_ann's main: the same JSON
    files, byte for byte, both splits, at factor 4 and 16, the train split
    whole and cut to 8 images.
  * proxy_model_config and proxy_data_config: field for field.
  * the proxy model (f32, full canvas and the 192 crop) from the JAX init at
    PRNGKey(0), carried across with weights.state_dict_from_jax: pred_logits
    and pred_boxes within atol 1e-4 / rtol 1e-3 (the full model's tolerance
    of record, tests/test_goldens.py).
  * drift_ap on the same numpy detections: within 1e-6.
  * drift_proxy_torch's main end to end on the CPU (one epoch, a tiny
    annotation set): its JSON lines carry the JAX script's keys.
  * the conjunction's verdict: both mains with the same legs faked (the
    drift subprocess's output, the AP legs, the rate), one case each of
    all legs, drift skipped / failed / timed out, throughput skipped, full
    AP 0 and a verdict that meets nothing: the same JSON line but `config`.
    The drift-line parser on what drift_map_torch's main prints; eval_ap
    against cli.evaluate's own coco/AP on a tiny run's checkpoint; the
    throughput leg at a tiny config.
  * none of the three scripts imports jax or the JAX package.
"""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.cli import evaluate as tcli_eval
from wildlifemapper_tpu_torch.data.coco import ASSETS_DIR
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.weights import (load_reference_state_dict,
                                              state_dict_from_jax)

from tests.test_torch_scripts import _script, _tiny_coco, tiny_run  # noqa: F401
from tests.torch_common import flat_numpy, tiny_config

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
PORTS = ("drift_proxy_torch", "build_scaled_ann_torch", "conjunction_torch")

pytestmark = pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_disk_cache(monkeypatch):
    monkeypatch.setenv("WM_SYNTH_CACHE", "0")


@pytest.fixture(scope="module")
def proxies():
    return _script("drift_proxy_cpu"), _script("drift_proxy_torch")


# ---- the scaled annotations ---------------------------------------------------

@pytest.mark.parametrize("factor,n_train", [(4.0, None), (4.0, 8),
                                            (16.0, None), (16.0, 8)])
def test_build_scaled_annotations_matches_jax(proxies, tmp_path, factor,
                                              n_train):
    jax_script, port = proxies
    jax_script.build_scaled_annotations(str(ASSETS_DIR), str(tmp_path / "j"),
                                        factor, n_train)
    port.build_scaled_annotations(str(ASSETS_DIR), str(tmp_path / "p"),
                                  factor, n_train)
    for split in ("train", "val"):
        want = (tmp_path / "j" / f"{split}.json").read_bytes()
        got = (tmp_path / "p" / f"{split}.json").read_bytes()
        assert got == want, split
    train = json.loads((tmp_path / "p" / "train.json").read_text())
    assert len(train["images"]) == (n_train or 928)


def test_build_scaled_ann_main_matches_jax(tmp_path, monkeypatch, capsys):
    out = {}
    for tag, name in (("jax", "build_scaled_ann"),
                      ("port", "build_scaled_ann_torch")):
        out[tag] = tmp_path / tag
        monkeypatch.setattr(sys, "argv", [name, "--out", str(out[tag]),
                                          "--factor", "16", "--n_train", "8"])
        _script(name).main()
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith(f"wrote {out['port']} (factor 16, n_train 8) "
                           "from ")
    assert Path(line.rsplit(" from ", 1)[1]) == ASSETS_DIR
    for split in ("train", "val"):
        assert ((out["port"] / f"{split}.json").read_bytes()
                == (out["jax"] / f"{split}.json").read_bytes()), split


# ---- the proxy's configuration and model ------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"dtype": "bfloat16"},
                                {"content_size": 192}, {"aux_loss": True}],
                         ids=["f32", "bf16", "crop192", "aux_loss"])
def test_proxy_model_config_matches_jax(proxies, kw):
    jax_script, port = proxies
    want, got = (m.proxy_model_config(**kw) for m in proxies)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(want)])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.vit.embed_dim // got.vit.num_heads == 32
    assert not got.use_flash_attention


@pytest.mark.parametrize("present", [True, False], ids=["ann_dir", "bundle"])
def test_proxy_data_config_matches_jax(proxies, tmp_path, present):
    """With the annotation set in place both point at it; without it each
    falls back to its own package's copy of the vendored bundle."""
    ann = tmp_path / "ann"
    if present:
        _tiny_coco(ann)
    want, got = (dataclasses.asdict(m.proxy_data_config(str(ann)))
                 for m in proxies)
    if present:
        assert got["coco_path"] == str(ann)
    else:
        assert got.pop("coco_path") == str(ASSETS_DIR)
        want.pop("coco_path")
    assert got == want


@pytest.fixture(scope="module")
def proxy_init(proxies):
    jc = proxies[0].proxy_model_config("float32")
    return jax.jit(JaxWildlifeMapper(jc).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)))


@pytest.mark.parametrize("content_size", [None, 192],
                         ids=["full_canvas", "crop192"])
def test_proxy_forward_matches_jax(proxies, proxy_init, content_size):
    jax_script, port = proxies
    x = np.zeros((2, 256, 256, 3), np.float32)
    x[:, :192, :192] = np.random.default_rng(3).normal(
        size=(2, 192, 192, 3))
    jc = jax_script.proxy_model_config("float32", content_size=content_size)
    want = jax.jit(JaxWildlifeMapper(jc).apply)(proxy_init, x)
    tm = WildlifeMapper(port.proxy_model_config(
        "float32", content_size=content_size), device="cpu").eval()
    load_reference_state_dict(tm, state_dict_from_jax(
        flat_numpy(proxy_init), depth=6))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for k in ("pred_logits", "pred_boxes"):
        assert got[k].shape == (2, 51, 8 if k == "pred_logits" else 4)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, rtol=1e-3, err_msg=k)


# ---- drift ------------------------------------------------------------------------

def _detections(rng, n=4, q=12):
    xy = rng.uniform(0, 200, size=(n, q, 2))
    wh = rng.uniform(8, 56, size=(n, q, 2))
    return {"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
            "scores": rng.uniform(0, 1, size=(n, q)).astype(np.float32),
            "labels": rng.integers(1, 7, size=(n, q)).astype(np.int32)}


@pytest.mark.parametrize("gt_thresh", [0.3, 0.5])
def test_drift_ap_matches_jax(proxies, gt_thresh):
    rng = np.random.default_rng(5)
    gt = _detections(rng)
    pred = {"boxes": gt["boxes"] + rng.normal(0, 3, size=gt["boxes"].shape
                                              ).astype(np.float32),
            "scores": np.clip(gt["scores"] + rng.normal(
                0, 0.1, size=gt["scores"].shape), 0, 1).astype(np.float32),
            "labels": gt["labels"].copy()}
    pred["labels"][:, ::5] = 6
    want, got = (m.drift_ap(gt, pred, 4, gt_thresh=gt_thresh)
                 for m in proxies)
    assert 0 < got < 1
    assert abs(got - want) <= 1e-6


def _tiny_ann(d: Path):
    """A train split of 8 frames and a val split of 4, 512 x 384, a few
    boxes each: what build_scaled_annotations writes for them at factor 16."""
    src = d.parent / "src"
    src.mkdir()
    rng = np.random.default_rng(1)
    for split, n in (("train", 8), ("val", 4)):
        images, anns = [], []
        for i in range(1, n + 1):
            images.append({"id": i, "file_name": f"{split}{i}.jpg",
                           "width": 512, "height": 384})
            for _ in range(int(rng.integers(2, 5))):
                x, y = rng.uniform(40, 440, 1)[0], rng.uniform(40, 320, 1)[0]
                anns.append({"id": len(anns) + 1, "image_id": i,
                             "category_id": int(rng.integers(1, 7)),
                             "bbox": [float(x), float(y), 5.0, 4.0],
                             "area": 20.0, "iscrowd": 0})
        cats = [{"id": c, "name": f"class_{c}"} for c in range(1, 7)]
        (src / f"{split}.json").write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": cats}))
    return src


def test_drift_proxy_main_on_the_cpu(proxies, tmp_path, monkeypatch,
                                     capsys):
    """One epoch on 8 tiles, the verdict over 4, then the trend over the
    epoch's checkpoint: the JSON lines carry the JAX script's keys."""
    jax_script, port = proxies
    monkeypatch.setattr(port, "PROXY_ANN_ROOT",
                        str(tmp_path / "proxy_ann"))
    ann_dir = Path(port.proxy_ann_dir(16.0, 8))
    assert ann_dir == tmp_path / "proxy_ann16_n8"
    port.build_scaled_annotations(str(_tiny_ann(ann_dir)), str(ann_dir),
                                  16.0, 8)
    work = tmp_path / "work"
    base = ["--device", "cpu", "--box_scale", "16", "--n_train", "8",
            "--n_imgs", "4", "--work_dir", str(work)]
    port.main(base + ["--epochs", "1", "--eval_every", "1"])
    out = capsys.readouterr().out
    assert "device: cpu" in out
    verdict = json.loads(out.strip().splitlines()[-1])
    assert set(verdict) == {"experiment", "geometry", "trained",
                            "trained_serve05", "random_init_crop",
                            "ap_vs_gt", "map_parity_ratio"}
    assert verdict["experiment"] == "cpu_proxy_trained_weights_crop_drift"
    tiers = {"f32-self", "bf16-full", "bf16-crop"}
    assert set(verdict["trained"]) == set(verdict["trained_serve05"]) == \
        set(verdict["ap_vs_gt"]) == tiers
    for ap, ap50 in verdict["ap_vs_gt"].values():
        assert 0 <= ap <= 1 and 0 <= ap50 <= 1
    assert sorted(p.name for p in work.glob("checkpoint_epoch_*")) == [
        "checkpoint_epoch_0"]

    port.main(base + ["--skip_train", "--checkpoint_trend", "0"])
    trend = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert trend["experiment"] == "cpu_proxy_parity_trend"
    assert [set(r) for r in trend["rows"]] == [
        {"epoch", "crop_drift_ap", "crop_drift_serve05", "full_ap",
         "crop_ap", "parity_ratio", "parity_ratio_ap50"}]
    assert trend["rows"][0]["epoch"] == 0
    full = verdict["ap_vs_gt"]["bf16-full"][0]
    assert trend["rows"][0]["full_ap"] == pytest.approx(full, abs=1e-6)


# ---- the conjunction ---------------------------------------------------------------

DRIFT_OUT = "\n".join([
    "loaded trained params from ckpt", "pseudo-GT detections: 41",
    "f32-self : AP=1.0000 AP50=1.0000",
    "f32-self@serve0.5: AP=1.0000 AP50=1.0000",
    "f32+kernels: AP=0.9990 AP50=1.0000",
    "f32+kernels@serve0.5: AP=1.0000 AP50=1.0000",
    "bf16+flash: AP=0.9420 AP50=1.0000",
    "bf16+flash@serve0.5: AP=0.9610 AP50=1.0000",
    "bf16+crop : AP=0.9180 AP50=0.9950",
    "bf16+crop@serve0.5: AP=0.9930 AP50=1.0000", ""])

# case: (extra flags, drift subprocess (returncode, stdout) or "timeout",
# AP full, AP crop, tiles/s)
VERDICT_CASES = {
    "all_legs": ([], (0, DRIFT_OUT), {"AP": 0.2, "AP50": 0.5},
                 {"AP": 0.1995, "AP50": 0.5}, 131.25),
    "drift_skipped": (["--skip_drift"], None, {"AP": 0.2, "AP50": 0.5},
                      {"AP": 0.19, "AP50": 0.45}, 140.0),
    "drift_failed": ([], (1, "pseudo-GT detections: 3\n"),
                     {"AP": 0.2, "AP50": 0.5}, {"AP": 0.2, "AP50": 0.5},
                     140.0),
    "drift_timed_out": ([], "timeout", {"AP": 0.2, "AP50": 0.5},
                        {"AP": 0.2, "AP50": 0.5}, 140.0),
    "throughput_skipped": (["--skip_throughput"], (0, DRIFT_OUT),
                           {"AP": 0.2, "AP50": 0.5},
                           {"AP": 0.2, "AP50": 0.5}, None),
    "full_ap_zero": ([], (0, DRIFT_OUT), {"AP": 0.0, "AP50": 0.0},
                     {"AP": 0.0, "AP50": 0.0}, 90.0),
    "meets_nothing": ([], (0, DRIFT_OUT.replace("AP=0.9180", "AP=0.4000")),
                      {"AP": 0.2, "AP50": 0.5}, {"AP": 0.1, "AP50": 0.3},
                      80.5),
}


def _verdicts(monkeypatch, capsys, flags, drift, ap_full, ap_crop, tps):
    """The last line of each script's main with its legs faked: the drift
    subprocess, the AP legs and the rate."""
    def fake_run(cmd, **kw):
        if drift == "timeout":
            raise subprocess.TimeoutExpired(cmd, kw.get("timeout"),
                                            output=b"pseudo-GT detections:",
                                            stderr=None)
        return subprocess.CompletedProcess(cmd, drift[0], stdout=drift[1],
                                           stderr="boom" if drift[0] else "")

    def fake_ap(ckpt, content_size=None, **kw):
        return dict(ap_crop if content_size else ap_full)

    monkeypatch.setattr(subprocess, "run", fake_run)
    lines = {}
    for tag, name, argv in (
            ("jax", "conjunction", ["--orbax_checkpoint", "ckpt"]),
            ("port", "conjunction_torch", ["--torch_checkpoint", "ckpt",
                                           "--device", "cpu"])):
        mod = _script(name)
        monkeypatch.setattr(mod, "eval_ap", fake_ap)
        monkeypatch.setattr(mod, "throughput", lambda **kw: tps)
        argv = argv + ["--n_imgs", "8", "--coco_path", "ann"] + flags
        monkeypatch.setattr(sys, "argv", [name] + argv)
        if tag == "jax":
            mod.main()
        else:
            mod.main(argv)
        out = capsys.readouterr().out
        lines[tag] = json.loads(out.strip().splitlines()[-1])
    return lines["jax"], lines["port"]


@pytest.mark.parametrize("case", list(VERDICT_CASES))
def test_conjunction_verdict_matches_jax(monkeypatch, capsys, case):
    want, got = _verdicts(monkeypatch, capsys, *VERDICT_CASES[case])
    assert set(got) == set(want)
    assert got.pop("config").startswith(
        "checkpoint-compat crop (content_size=768, bf16")
    want.pop("config")
    assert got == want
    partial = {"all_legs": [], "drift_skipped": ["drift"],
               "drift_failed": ["drift(failed)"],
               "drift_timed_out": ["drift(failed)"],
               "throughput_skipped": ["throughput"], "full_ap_zero": [],
               "meets_nothing": []}[case]
    assert got["partial"] == partial
    if case == "full_ap_zero":
        # no ratio; the crop drift of 0.918 alone decides parity
        assert got["map_parity_ratio"] is None
        assert got["meets_parity"] is False
    if case == "meets_nothing":
        assert got["meets_parity"] is False and got["meets_5x"] is False


def test_drift_parser_reads_drift_map_main(tmp_path, monkeypatch, capsys):
    """drift_map_torch's main at the tiny model (as
    tests/test_torch_scripts.py::test_drift_map_main_on_the_cpu runs it):
    parse_drift reads its eight rows, and both conjunction mains handed that
    output give one verdict."""
    mod = _script("drift_map_torch")
    monkeypatch.setattr(mod, "model_config",
                        lambda variant, **kw: tiny_config(tcfg, **kw))
    model = WildlifeMapper(tiny_config(tcfg), generator=torch.Generator()
                           .manual_seed(0), device="cpu")
    with torch.no_grad():
        model.mask_decoder.class_embed.layers[-1].weight.mul_(4.0)
    ckpt = tmp_path / "weights.pt"
    torch.save(model.state_dict(), ckpt)
    mod.main(["--n_imgs", "4", "--device", "cpu", "--torch_checkpoint",
              str(ckpt)])
    out = capsys.readouterr().out
    parsed = _script("conjunction_torch").parse_drift(out)
    printed = {m[0]: float(m[1]) for m in re.findall(
        r"^(\S+) *: AP=([-\d.]+) AP50=", out, re.M)}
    assert len(parsed) == 8 and parsed == printed
    assert parsed["f32-self"] == 1.0
    want, got = _verdicts(monkeypatch, capsys, [], (0, out),
                          {"AP": 0.2, "AP50": 0.5},
                          {"AP": 0.2, "AP50": 0.5}, 130.0)
    got.pop("config"), want.pop("config")
    assert got == want
    assert got["drift_ap_vs_f32_full_canvas"] == parsed["bf16+crop"]
    assert got["parity_tier_drift_ap"] == parsed["bf16+flash"]


def test_eval_ap_is_the_cli_coco_ap(tiny_run, capsys):
    cfg, work, _ = tiny_run
    extra = ["--config_json", str(work / "config.json"), "--synthetic_size",
             "64", "--resize_size", "48", "--canvas_size", "64",
             "--max_batches", "2"]
    ckpt = str(work / "checkpoint_epoch_1")
    got = _script("conjunction_torch").eval_ap(
        ckpt, batch_size=cfg.data.batch_size,
        coco_path=cfg.data.coco_path, device="cpu", extra=extra)
    argv = ["--synthetic_data", "--use_amp", "--fix_hw_swap",
            "--torch_checkpoint", ckpt, "--batch_size",
            str(cfg.data.batch_size), "--coco_path", cfg.data.coco_path,
            "--device", "cpu"] + extra
    want = tcli_eval.main(argv)
    capsys.readouterr()
    assert set(got) == {"AP", "AP50"}
    for k in got:
        assert got[k] == pytest.approx(want[f"coco/{k}"], abs=5e-5), k


def test_throughput_leg_on_the_cpu():
    cfg = tiny_config(tcfg, dtype="bfloat16", use_flash_attention=True,
                      content_size=96)
    tps = _script("conjunction_torch").throughput(batch=2, iters=10,
                                                  device="cpu", cfg=cfg)
    assert np.isfinite(tps) and tps > 0


# ---- no JAX -------------------------------------------------------------------------

_BLOCKED = """
import importlib.abc, importlib.util, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "wildlifemapper_tpu"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location(path, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0].startswith("wildlife"))))
"""


@pytest.fixture(scope="module")
def imported_with_jax_blocked():
    """The three scripts imported in one fresh interpreter in which any
    import of jax, flax, optax or the JAX package raises."""
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED,
         *(str(SCRIPTS / f"{n}.py") for n in PORTS)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    return res


@pytest.mark.parametrize("name", PORTS)
def test_script_imports_no_jax(imported_with_jax_blocked, name):
    res = imported_with_jax_blocked
    assert res.returncode == 0, res.stderr
    modules = json.loads(res.stdout.strip().splitlines()[-1])
    assert modules and all(m.split(".")[0] == "wildlifemapper_tpu_torch"
                           for m in modules)
    path = SCRIPTS / f"{name}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "wildlifemapper_tpu"), (name, n)
            assert not n.startswith(("drift_proxy_cpu", "conjunction",
                                     "drift_map")) or n.endswith("_torch")
