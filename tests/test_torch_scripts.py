"""The scripts users run with the PyTorch port (scripts/*_torch.*), on the
CPU at tiny sizes.

What is held, and against what:
  * drift_map_torch.py: its synthetic field equals the JAX script's
    (scripts/drift_map.py: synth_tiles) bit for bit from the same rng; its
    main runs on the CPU at the tiny model of tests/torch_common.py and
    scores f32 through the kernels' path (their plain versions here)
    against f32 plain at AP50 1.000 at both pseudo-GT thresholds.
  * prewarm_synth_cache_torch.py writes the cache files the JAX script
    (scripts/prewarm_synth_cache.py) writes, under the same names, on the
    same tiny annotation set: the same boxes and labels, the same tiles
    within one level (the two loaders resize with other libraries).
  * scripts/val_curve.py (no package imported) parses a log of the port's
    training loop: one row an epoch, with the val AP of each.
  * Every flag each *_torch.sh passes (each case of run_with_wandb_torch.sh)
    is accepted by the parser of the port's CLI it runs.
  * eval_checkpoint_series_torch.sh over a tiny CPU run's checkpoints
    (EXTRA_ARGS carrying --device cpu) prints each epoch's coco/AP lines,
    equal within 1e-3 to the loop's own evaluation of that epoch.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.models import WildlifeMapper
from wildlifemapper_tpu_torch.train import loop as tloop

from tests.test_torch_train_loop import tiny_config as loop_config
from tests.torch_common import tiny_config

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"

pytestmark = pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- drift_map_torch.py -------------------------------------------------------

def test_drift_map_field_is_the_jax_scripts():
    jax_script, port_script = _script("drift_map"), _script("drift_map_torch")
    want = jax_script.synth_tiles(np.random.default_rng(0), 3)
    got = port_script.synth_tiles(np.random.default_rng(0), 3)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_drift_map_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The whole script at the tiny model (canvas 128, content 96), seeded
    weights with the class head's output layer scaled x4 (as chip_smoke.py
    does: confident, distinct detections), saved as a bare state dict."""
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
    n_gt = int(re.search(r"pseudo-GT detections: (\d+)", out).group(1))
    assert n_gt > 0
    rows = {m[0]: (float(m[1]), float(m[2])) for m in re.findall(
        r"^(\S+) *: AP=([-\d.]+) AP50=([-\d.]+)$", out, re.M)}
    assert set(rows) == {"f32-self", "f32-self@serve0.5", "f32+kernels",
                         "f32+kernels@serve0.5", "bf16+flash",
                         "bf16+flash@serve0.5", "bf16+crop",
                         "bf16+crop@serve0.5"}
    for tag in ("f32-self", "f32+kernels"):
        assert rows[tag][1] == 1.0 and rows[tag + "@serve0.5"][1] in (1.0,
                                                                     -1.0)


# ---- prewarm_synth_cache_torch.py ---------------------------------------------

def _tiny_coco(d: Path):
    """A val split of 3 images of two sizes with a few boxes each, and a
    train split of 2."""
    d.mkdir()
    rng = np.random.default_rng(0)
    for split, n in (("val", 3), ("train", 2)):
        images, anns = [], []
        for i in range(1, n + 1):
            w, h = (96, 64) if i % 2 else (64, 64)
            images.append({"id": i, "file_name": f"{split}{i}.jpg",
                           "width": w, "height": h})
            for _ in range(3):
                x, y = rng.uniform(2, 40, 2)
                anns.append({"id": len(anns) + 1, "image_id": i,
                             "category_id": int(rng.integers(1, 7)),
                             "bbox": [float(x), float(y), 8.0, 6.0],
                             "area": 48.0, "iscrowd": 0})
        cats = [{"id": c, "name": f"class_{c}"} for c in range(1, 7)]
        (d / f"{split}.json").write_text(json.dumps(
            {"images": images, "annotations": anns, "categories": cats}))
    return d


def test_prewarm_writes_the_jax_scripts_cache(tmp_path, monkeypatch):
    coco = _tiny_coco(tmp_path / "coco")
    argv = ["--coco_path", str(coco), "--synthetic_size", "64"]
    dirs = {}
    for tag, name in (("jax", "prewarm_synth_cache"),
                      ("port", "prewarm_synth_cache_torch")):
        dirs[tag] = tmp_path / f"cache_{tag}"
        monkeypatch.setenv("WM_SYNTH_CACHE", str(dirs[tag]))
        monkeypatch.setattr(sys, "argv", [name] + argv)
        assert _script(name).main() == 0
    names = {t: sorted(p.name for p in d.iterdir()) for t, d in dirs.items()}
    assert len(names["port"]) == 5 and names["port"] == names["jax"]
    for name in names["port"]:
        a, b = (np.load(dirs[t] / name) for t in ("jax", "port"))
        assert set(a.files) == set(b.files)
        for k in ("boxes", "labels", "orig_size"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        diff = np.abs(b["arr"].astype(int) - a["arr"].astype(int))
        assert b["arr"].shape == a["arr"].shape and diff.max() <= 1


# ---- a tiny run of the port's loop: val_curve and the checkpoint series --------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """Two epochs of 2 steps, each evaluated on 2 val batches, a checkpoint
    every epoch; the whole log as the CLI prints it (the loop's lines and
    the COCO summary tables)."""
    work = tmp_path_factory.mktemp("run")
    mp = pytest.MonkeyPatch()
    mp.setenv("WM_SYNTH_CACHE", "0")
    cfg = loop_config(tcfg, epochs=2)
    lines = []

    def capture(*args, **kw):
        lines.append(" ".join(str(a) for a in args))

    mp.setattr("builtins.print", capture)
    try:
        tloop.train(cfg, workdir=str(work), device="cpu", print_fn=capture,
                    max_steps_per_epoch=2, max_eval_batches=2)
    finally:
        mp.undo()
    log = work / "train.log"
    log.write_text("\n".join(lines) + "\n")
    return cfg, work, log


def test_val_curve_parses_the_port_loop_log(tiny_run, capsys):
    _, _, log = tiny_run
    text = log.read_text()
    aps = [float(x) for x in re.findall(
        r"Average Precision\s+\(AP\) @\[ IoU=0\.50:0\.95 \| area=\s*all \| "
        r"maxDets=100 \] = ([-\d.]+)", text)]
    assert len(aps) == 2
    _script("val_curve").main([str(log)])
    rows = [line.split() for line in capsys.readouterr().out.splitlines()
            if line.strip() and line.split()[0].isdigit()]
    assert [int(r[0]) for r in rows] == [0, 1]
    assert all(len(r) == 5 for r in rows)
    assert [float(r[3]) for r in rows] == pytest.approx(aps, abs=5e-4)


def test_eval_checkpoint_series_over_a_cpu_run(tiny_run):
    cfg, work, log = tiny_run
    # the loop's own evaluation of each epoch, from its COCO summary tables
    # (3 decimals): AP, AP50, AP75 and AR at 100 detections
    table = re.findall(
        r"Average (?:Precision|Recall)\s+\((AP|AR)\) @\[ IoU=(\S+)\s*\| "
        r"area=\s*all \| maxDets=100 \] = ([-\d.]+)", log.read_text())
    keys = {("AP", "0.50:0.95"): "AP", ("AP", "0.50"): "AP50",
            ("AP", "0.75"): "AP75", ("AR", "0.50:0.95"): "AR100"}
    loop_stats = [{keys[k, iou]: float(v) for k, iou, v in table[i:i + 4]}
                  for i in range(0, len(table), 4)]
    env = dict(os.environ, RUN=str(work), BATCH=str(cfg.data.batch_size),
               CONFIG_JSON=str(work / "config.json"), WM_SYNTH_CACHE="0",
               PYTHONPATH=str(REPO), EXTRA_ARGS=" ".join([
                   "--synthetic_data", "--device", "cpu",
                   "--coco_path", cfg.data.coco_path,
                   "--synthetic_size", "64", "--resize_size", "48",
                   "--canvas_size", "64", "--max_batches", "2"]))
    res = subprocess.run(["bash", str(SCRIPTS /
                                      "eval_checkpoint_series_torch.sh")],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    out = res.stdout
    assert "FAILED" not in out and out.rstrip().endswith("SERIES_DONE")
    assert re.findall(r"^=== epoch (\d+) ===$", out, re.M) == ["0", "1"]
    series = [dict(re.findall(r"^coco/(AP|AP50|AP75|AR100): ([-\d.]+)$",
                              block, re.M))
              for block in re.split(r"^=== epoch \d+ ===$", out, flags=re.M)[1:]]
    assert len(loop_stats) == len(series) == 2
    for got, want in zip(series, loop_stats):
        assert set(got) == set(want) == {"AP", "AP50", "AP75", "AR100"}
        for k in want:
            assert float(got[k]) == pytest.approx(want[k], abs=1e-3), k


# ---- the launchers ---------------------------------------------------------------

LAUNCHERS = [("run_torch.sh", ()), ("debug_torch.sh", ()),
             ("infer_torch.sh", ()), ("train_herdnet_torch.sh", ()),
             ("distributed_run_torch.sh", ())] + [
    ("run_with_wandb_torch.sh", (case,)) for case in
    ("single_chip", "resume", "distributed", "debug", "high_lr", "custom")]


class _Parsed(Exception):
    pass


def _record_calls(tmp_path, script, args):
    """Run a launcher with `python` and `torchrun` replaced by a recorder;
    returns each call's argv."""
    bin_dir, record = tmp_path / "bin", tmp_path / "calls"
    bin_dir.mkdir()
    fake = "#!/bin/sh\n{ printf '%s\\n' \"$@\"; echo __END__; } >> \"$REC\"\n"
    for name in ("python", "torchrun"):
        (bin_dir / name).write_text(fake)
        (bin_dir / name).chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               REC=str(record), CHECKPOINT="best.pth", NPROC="2")
    res = subprocess.run(["bash", str(SCRIPTS / script), *args], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stderr
    calls = record.read_text().split("__END__\n")[:-1]
    return [c.splitlines() for c in calls]


@pytest.mark.parametrize("script,args", LAUNCHERS,
                         ids=[f"{s}{'-' + a[0] if a else ''}"
                              for s, a in LAUNCHERS])
def test_launcher_flags_parse(tmp_path, monkeypatch, script, args):
    calls = _record_calls(tmp_path, script, args)
    assert calls
    real_parse = argparse.ArgumentParser.parse_args

    def parse_only(self, argv=None, namespace=None):
        raise _Parsed(real_parse(self, argv, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_only)
    for argv in calls:
        m = argv.index("-m")
        if script.startswith("distributed") or "distributed" in args:
            assert argv[:m] == ["--nproc_per_node", "2"]
        else:
            assert m == 0
        module = argv[m + 1]
        assert module.startswith("wildlifemapper_tpu_torch.")
        with pytest.raises(_Parsed) as parsed:
            importlib.import_module(module).main(argv[m + 2:])
        ns = parsed.value.args[0]
        if module.endswith("cli.train"):
            assert ns.model_parallel == 1


def test_every_launcher_has_a_port_counterpart():
    """Each JAX launcher that a user runs has its *_torch.sh beside it, and
    no port script names the JAX package's modules."""
    for name in ("run", "debug", "infer", "train_herdnet",
                 "distributed_run", "run_with_wandb",
                 "eval_checkpoint_series"):
        assert (SCRIPTS / f"{name}.sh").exists()
        text = (SCRIPTS / f"{name}_torch.sh").read_text()
        assert "wildlifemapper_tpu_torch" in text
        assert not re.search(r"wildlifemapper_tpu\.(cli|data)", text)
        assert "JAX_COMPILATION_CACHE_DIR" not in text
    assert "wildlifemapper_tpu_torch.data.csv_to_coco" in (
        SCRIPTS / "train_herdnet_torch.sh").read_text()
