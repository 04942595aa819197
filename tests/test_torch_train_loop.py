"""The port's training loop (wildlifemapper_tpu_torch/train/loop.py), its
checkpoints, evaluation and CLIs, on the CPU at a tiny size (the port's
counterpart of tests/test_train_loop.py's tiny_full_config: D 64, depth 2,
canvas 64, resize 48, 16 queries) over the vendored annotation bundle with
synthetic tiles rendered at 64 px (where the port's resize is the JAX
loader's bit for bit).

Against the JAX package, end to end, in float32 from the same weights with
the adaptor's dropout off (its masks differ by construction): three steps of
one loop epoch through both train()s, each step's losses and grad_norm at
the full model's atol 1e-4 / rtol 1e-3 (tests/test_goldens.py), then the
evaluation on two val batches: the criterion's meters at the same tolerance,
the detections handed to the COCO evaluator at atol 1e-4 / rtol 1e-3, and
the COCO stats. The JAX run is made once for the module.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.data.coco import ASSETS_DIR as JASSETS
from wildlifemapper_tpu.eval import coco_eval as jce
from wildlifemapper_tpu.train import loop as jloop
from wildlifemapper_tpu.train import step as jstep
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.cli import evaluate as tcli_eval
from wildlifemapper_tpu_torch.cli import train as tcli
from wildlifemapper_tpu_torch.eval import coco_eval as tce
from wildlifemapper_tpu_torch.train import loop as tloop
from wildlifemapper_tpu_torch.train import step as tstep
from wildlifemapper_tpu_torch.train.checkpoints import CheckpointManager
from wildlifemapper_tpu_torch.weights import state_dict_from_jax

from tests.torch_common import flat_numpy

ATOL, RTOL = 1e-4, 1e-3
QUIET = dict(print_fn=lambda *a, **k: None)

# the tiny shapes cap the targets at 32 and truncate with a warning
pytestmark = pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")


def tiny_config(mod, dropout=0.1, **train):
    vit = mod.ViTConfig(embed_dim=64, depth=2, num_heads=2,
                        global_attn_indexes=(1,), window_size=4, out_chans=32)
    model = dataclasses.replace(
        mod.model_config("vit_b"), vit=vit, img_size=64, patch_size=16,
        hfc=mod.HFCConfig(embed_dim=32, proj_dim=32, num_heads=2, ffn_dim=32,
                          dropout=dropout),
        decoder=mod.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                  num_queries=16, num_heads=2))
    coco = JASSETS if mod is jcfg else tcfg.DataConfig().coco_path
    data = mod.DataConfig(coco_path=str(coco), resize_size=48, canvas_size=64,
                          max_targets=32, allow_truncation=True, batch_size=2,
                          synthetic=True, flip_prob=0.5, synthetic_size=64)
    train = dict(dict(lr=1e-3, epochs=1, clip_max_norm=1.0,
                      checkpoint_every=1), **train)
    return mod.Config(model=model, data=data, train=mod.TrainConfig(**train),
                      criterion=mod.MatchCriterionConfig(max_targets=32))


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


def run(cfg, workdir, **kw):
    return tloop.train(cfg, workdir=str(workdir), device="cpu",
                       **dict(QUIET, **kw))


# ---- against the JAX package ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_init_sd():
    """What the JAX train() draws for the tiny config, in the port's names."""
    jc = tiny_config(jcfg, dropout=0.0)
    params = jstep.StepBuilder(jc).init_params(
        jax.random.PRNGKey(jc.train.seed))
    return state_dict_from_jax(flat_numpy(params), depth=jc.model.vit.depth)


@pytest.fixture(scope="module")
def jax_and_port(tmp_path_factory, jax_init_sd):
    """One epoch of 3 steps, then evaluation on 2 val batches, through both
    train()s from the same weights: each step's metrics, the evaluator's
    inputs and the returned stats of each."""
    mp = pytest.MonkeyPatch()
    mp.setenv("WM_SYNTH_CACHE", "0")
    jc, tc = tiny_config(jcfg, dropout=0.0), tiny_config(tcfg, dropout=0.0)
    sd = jax_init_sd
    steps = {"jax": [], "port": []}
    preds = {"jax": [], "port": []}

    jit_train_step = jstep.StepBuilder.jit_train_step

    def recording_jit(self):
        fn = jit_train_step(self)

        def wrapped(state, batch, rng):
            state, metrics = fn(state, batch, rng)
            steps["jax"].append(metrics)
            return state, metrics
        return wrapped

    class Recording(tstep.StepBuilder):
        def train_step(self, *a, **k):
            state, metrics = super().train_step(*a, **k)
            steps["port"].append(metrics)
            return state, metrics

    def recording_update(mod, key):
        update = mod.CocoEvaluator.update

        def wrapped(self, predictions):
            preds[key].append(predictions)
            return update(self, predictions)
        return wrapped

    mp.setattr(jstep.StepBuilder, "jit_train_step", recording_jit)
    mp.setattr(tloop, "StepBuilder", Recording)
    mp.setattr(jce.CocoEvaluator, "update", recording_update(jce, "jax"))
    mp.setattr(tce.CocoEvaluator, "update", recording_update(tce, "port"))
    try:
        base = tmp_path_factory.mktemp("loop")
        stats = {
            "jax": jloop.train(jc, workdir=str(base / "jax"), epochs=1,
                               max_steps_per_epoch=3, max_eval_batches=2,
                               **QUIET),
            "port": tloop.train(tc, workdir=str(base / "port"), epochs=1,
                                max_steps_per_epoch=3, max_eval_batches=2,
                                device="cpu", init_state_dict=sd, **QUIET)}
    finally:
        mp.undo()
    return steps, preds, stats


@pytest.mark.parametrize("step", [0, 1, 2])
def test_loop_steps_match_jax(jax_and_port, step):
    steps, _, _ = jax_and_port
    assert len(steps["jax"]) == len(steps["port"]) == 3
    want, got = steps["jax"][step], steps["port"][step]
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {step} {k}")


def test_evaluation_matches_jax(jax_and_port):
    _, preds, stats = jax_and_port
    js, ts = stats["jax"], stats["port"]
    # the criterion's meters over the two val batches
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou",
              "cardinality_error", "class_error", "num_boxes"):
        np.testing.assert_allclose(ts[f"val/{k}"], js[f"val/{k}"], atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    # the detections handed to the evaluator, image by image
    jp = {i: p for batch in preds["jax"] for i, p in batch.items()}
    tp = {i: p for batch in preds["port"] for i, p in batch.items()}
    assert list(jp) == list(tp) and len(tp) == 4
    same_order = True
    for iid in jp:
        for f in ("labels", "scores", "boxes"):
            want, got = np.asarray(jp[iid][f]), np.asarray(tp[iid][f])
            assert got.shape == want.shape, (iid, f)
            if f == "labels":
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{iid} {f}")
        order = np.argsort(-np.asarray(jp[iid]["scores"]), kind="mergesort")
        same_order &= bool((np.argsort(-np.asarray(tp[iid]["scores"]),
                                       kind="mergesort") == order).all())
    # COCO stats: equal where the kept detections rank alike; a score tie
    # broken the other way may move them, within 1e-3
    coco = [k for k in js if k.startswith("val/coco/")]
    assert coco and set(coco) <= set(ts)
    for k in coco:
        if same_order:
            assert ts[k] == js[k], k
        else:
            assert abs(ts[k] - js[k]) <= 1e-3, k


# ---- the port alone ------------------------------------------------------------

def test_one_epoch_then_resume(tmp_path):
    cfg = tiny_config(tcfg)
    stats = run(cfg, tmp_path, epochs=1, max_steps_per_epoch=3,
                max_eval_batches=2)
    assert np.isfinite(stats["train/loss"]) and "val/coco/AP" in stats
    assert {"checkpoint_epoch_0", "best_checkpoint", "config.json",
            "best_loss.json"} <= set(os.listdir(tmp_path))
    msgs = []
    stats2 = run(cfg, tmp_path, epochs=2, resume=True, max_steps_per_epoch=3,
                 max_eval_batches=2,
                 print_fn=lambda *a, **k: msgs.append(" ".join(map(str, a))))
    assert "resumed from epoch 0" in msgs
    assert any(m.startswith("resumed best_loss=") for m in msgs)
    assert np.isfinite(stats2["train/loss"])
    assert (tmp_path / "checkpoint_epoch_1").exists()


def test_watch_sees_every_step_and_evaluation(tmp_path):
    """train(..., watch=) hands each step and each evaluation to the watch
    (train/profiling.py::StepWatch on the card; a counting stand-in here)
    and changes nothing of the run."""
    class Counting:
        steps = evals = 0

        def train_step(self, builder, *a):
            self.steps += 1
            return builder.train_step(*a)

        def evaluate(self, evaluate, *a, **k):
            self.evals += 1
            return evaluate(*a, **k)

    cfg = tiny_config(tcfg)
    kw = dict(epochs=2, max_steps_per_epoch=2, max_eval_batches=1)
    plain = run(cfg, tmp_path / "plain", **kw)
    watch = Counting()
    watched = run(cfg, tmp_path / "watched", watch=watch, **kw)
    assert (watch.steps, watch.evals) == (4, 2)
    assert watched == plain


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_trees_equal(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_segmented_run_is_epoch_exact(tmp_path):
    """Two epochs in one call == one epoch, then a resumed call for the
    second: parameters, Adam's moments and counts, the schedule, step, the
    EMA and the dropout generator bit-identical (dropout on, so the
    restored generator matters)."""
    cfg = tiny_config(tcfg, checkpoint_every=100, ema_decay=0.9)
    single, seg = tmp_path / "single", tmp_path / "seg"
    run(cfg, single, epochs=2, max_steps_per_epoch=3, max_eval_batches=1)
    assert (single / "checkpoint_epoch_1").exists()      # force_epoch
    assert not (single / "checkpoint_epoch_0").exists()  # cadence 100
    run(cfg, seg, epochs=1, max_steps_per_epoch=3, max_eval_batches=1)
    assert (seg / "checkpoint_epoch_0").exists()
    run(cfg, seg, epochs=2, resume=True, max_steps_per_epoch=3,
        max_eval_batches=1)
    want = _load(single / "checkpoint_epoch_1")
    got = _load(seg / "checkpoint_epoch_1")
    assert want["step"] == 6 and want["ema_params"] is not None
    assert want["optimizer"]["state"]
    _assert_trees_equal(want, got)


def test_restore_is_bit_exact(tmp_path):
    """A restored state equals the saved one: the model, the optimizer's
    state, the scheduler's lr and count, step, EMA, the generator."""
    from wildlifemapper_tpu_torch.train.checkpoints import state_tree

    cfg = tiny_config(tcfg, ema_decay=0.5)
    run(cfg, tmp_path, epochs=1, max_steps_per_epoch=2, max_eval_batches=1)
    builder = tstep.StepBuilder(cfg, device="cpu")
    state = builder.init_state(steps_per_epoch=2)
    gen = torch.Generator().manual_seed(0)
    CheckpointManager(str(tmp_path)).restore("checkpoint_epoch_0", state, gen)
    _assert_trees_equal(_load(tmp_path / "checkpoint_epoch_0"),
                        state_tree(state, gen))
    assert state.scheduler.get_last_lr() == [1e-3, 1e-4]


def test_nan_guard_exits_before_any_checkpoint(tmp_path, monkeypatch):
    """A non-finite loss exits (SystemExit, one step late) before
    save_epoch sees the poisoned state."""
    class Poisoned(tstep.StepBuilder):
        def train_step(self, *a, **k):
            state, metrics = super().train_step(*a, **k)
            return state, dict(metrics, loss=metrics["loss"] * float("nan"))

    monkeypatch.setattr(tloop, "StepBuilder", Poisoned)
    msgs = []
    with pytest.raises(SystemExit):
        run(tiny_config(tcfg), tmp_path, epochs=1, max_steps_per_epoch=3,
            max_eval_batches=1, print_fn=lambda *a, **k: msgs.append(a[0]))
    assert "Loss is nan, stopping training" in msgs
    assert not (tmp_path / "checkpoint_epoch_0").exists()
    assert not (tmp_path / "best_checkpoint").exists()


def test_eval_every_skips_intermediate_epochs(tmp_path, monkeypatch):
    calls = []
    real = tloop.evaluate

    def spy(*a, **k):
        calls.append(k.get("epoch"))
        return real(*a, **k)

    monkeypatch.setattr(tloop, "evaluate", spy)
    cfg = tiny_config(tcfg, epochs=2, eval_every=2)
    stats = run(cfg, tmp_path, epochs=2, max_steps_per_epoch=2,
                max_eval_batches=2)
    assert calls == [1]
    assert "val/coco/AP" in stats


def test_best_metric_val_ap_tracks_highest_ap(tmp_path, monkeypatch):
    aps = iter([0.2, 0.5, 0.3])
    monkeypatch.setattr(tloop, "evaluate",
                        lambda *a, **k: {"coco/AP": next(aps),
                                         "coco/AP50": 1.0})
    cfg = tiny_config(tcfg, best_metric="val_ap", checkpoint_every=100)
    run(cfg, tmp_path, epochs=3, max_steps_per_epoch=2, max_eval_batches=1)
    best = json.loads((tmp_path / "best_loss.json").read_text())
    assert best["metric"] == "val_ap"
    assert best["epoch"] == 1 and best["value"] == 0.5
    assert (tmp_path / "best_checkpoint").exists()


def test_best_metric_switch_resets_tracker(tmp_path, monkeypatch):
    monkeypatch.setattr(tloop, "evaluate",
                        lambda *a, **k: {"coco/AP": 0.1, "coco/AP50": 0.2})
    cfg = tiny_config(tcfg)
    run(cfg, tmp_path, epochs=1, max_steps_per_epoch=2, max_eval_batches=1)
    first = json.loads((tmp_path / "best_loss.json").read_text())
    assert first["metric"] == "train_loss" and "loss" in first
    # a legacy file ({"loss": ...} only) still resumes the default metric
    (tmp_path / "best_loss.json").write_text(json.dumps(
        {"loss": first["loss"]}))
    msgs = []
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, best_metric="val_ap"))
    run(cfg2, tmp_path, epochs=2, resume=True, max_steps_per_epoch=2,
        max_eval_batches=1,
        print_fn=lambda *a, **k: msgs.append(" ".join(map(str, a))))
    assert any("best tracker reset" in m for m in msgs)
    second = json.loads((tmp_path / "best_loss.json").read_text())
    assert second["metric"] == "val_ap" and second["value"] == 0.1


def test_config_json_round_trips_through_both_packages(tmp_path):
    """train() writes the run's Config (max_targets resolved); it loads
    back equal in the port, and in the JAX package as the same config, mesh
    included. A JAX config.json loads in the port, mesh included."""
    cfg = dataclasses.replace(tiny_config(tcfg), data=dataclasses.replace(
        tiny_config(tcfg).data, max_targets=None, allow_truncation=False))
    run(cfg, tmp_path, epochs=1, max_steps_per_epoch=1, max_eval_batches=1)
    text = (tmp_path / "config.json").read_text()
    got = tcfg.config_from_json(text)
    resolved = got.data.max_targets
    assert resolved is not None and got.criterion.max_targets == resolved
    assert got == dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, max_targets=resolved),
        criterion=dataclasses.replace(cfg.criterion, max_targets=resolved))
    j = jcfg.config_from_json(text)
    assert j.mesh == jcfg.MeshConfig()
    assert json.loads(jcfg.config_to_json(j)) == json.loads(text)
    jc = dataclasses.replace(tiny_config(jcfg),
                             mesh=jcfg.MeshConfig(model_parallel_size=2))
    jtext = jcfg.config_to_json(jc)
    from_jax = tcfg.config_from_json(jtext)
    assert from_jax.mesh == tcfg.MeshConfig(model_parallel_size=2)
    assert json.loads(tcfg.config_to_json(from_jax)) == json.loads(jtext)


def test_load_params_from_trainstate_and_ema(tmp_path):
    """load_params takes the model's weights (or the EMA's, with use_ema)
    out of a saved train state, or a bare state dict, strictly."""
    cfg = tiny_config(tcfg, ema_decay=0.9)
    run(cfg, tmp_path, epochs=1, max_steps_per_epoch=2, max_eval_batches=1)
    raw = _load(tmp_path / "checkpoint_epoch_0")
    model = tstep.StepBuilder(cfg, device="cpu").model
    CheckpointManager.load_params(str(tmp_path / "checkpoint_epoch_0"), model)
    _assert_trees_equal(model.state_dict(), raw["model"])
    CheckpointManager.load_params(str(tmp_path / "checkpoint_epoch_0"),
                                  model, use_ema=True)
    for k, v in raw["ema_params"].items():
        assert torch.equal(model.state_dict()[k], v), k
    assert any(not torch.equal(raw["ema_params"][k], raw["model"][k])
               for k in raw["ema_params"])
    torch.save(raw["model"], tmp_path / "bare")
    CheckpointManager.load_params(str(tmp_path / "bare"), model)
    _assert_trees_equal(model.state_dict(), raw["model"])
    # no EMA in the checkpoint: a warning, and the raw weights
    cfg0 = tiny_config(tcfg)
    run(cfg0, tmp_path / "no_ema", epochs=1, max_steps_per_epoch=1,
        max_eval_batches=1)
    with pytest.warns(RuntimeWarning, match="no EMA"):
        CheckpointManager.load_params(
            str(tmp_path / "no_ema" / "checkpoint_epoch_0"),
            tstep.StepBuilder(cfg0, device="cpu").model, use_ema=True)


def test_val_image_overlays_logged(tmp_path):
    from wildlifemapper_tpu_torch.train.logging import JsonlLogger

    backend = JsonlLogger(str(tmp_path / "logs"), run_name="t")
    run(tiny_config(tcfg), tmp_path, epochs=1, max_steps_per_epoch=1,
        max_eval_batches=1, logger_backend=backend)
    backend.finish()
    events = [json.loads(line) for line in
              (tmp_path / "logs" / "t.jsonl").read_text().splitlines()]
    kinds = [e["event"] for e in events]
    assert kinds.count("epoch") == 1 and "artifact" in kinds
    img = [e for e in events if e["event"] == "images"]
    assert img and img[0]["count"] >= 1
    written = list((tmp_path / "logs" / "t_images").glob("epoch_0_*.jpg"))
    assert len(written) == img[0]["count"]


class _FirstStep(tstep.StepBuilder):
    """A step builder that records each train step's metrics."""
    metrics = []

    def train_step(self, *a, **k):
        state, metrics = super().train_step(*a, **k)
        self.metrics.append(metrics)
        return state, metrics


def test_init_checkpoint_gives_jax_first_loss(jax_and_port, jax_init_sd,
                                              tmp_path, monkeypatch):
    """train(init_checkpoint=<a trained checkpoint's .pth>) of the weights
    the JAX train() drew: the JAX run's first step, and the JAX loop's
    line."""
    steps, _, _ = jax_and_port
    path = tmp_path / "wm.pth"
    torch.save({"model": {"module." + k: v for k, v in jax_init_sd.items()},
                "optimizer": {}, "epoch": 3}, path)
    monkeypatch.setattr(tloop, "StepBuilder", _FirstStep)
    monkeypatch.setattr(_FirstStep, "metrics", [])
    lines = []
    run(tiny_config(tcfg, dropout=0.0), tmp_path / "run", epochs=1,
        max_steps_per_epoch=1, max_eval_batches=1, init_checkpoint=str(path),
        print_fn=lambda *a, **k: lines.append(" ".join(map(str, a))))
    assert (f"loaded {len(jax_init_sd)} tensors from {path}; kept init for 0"
            in lines)
    got, want = _FirstStep.metrics[0], steps["jax"][0]
    for k in ("loss", "loss_ce", "loss_bbox", "loss_giou", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)


# ---- the CLIs ------------------------------------------------------------------

def _argv(*extra):
    return ["--synthetic_data", "--synthetic_size", "64", "--resize_size",
            "48", "--canvas_size", "64", "--use_amp", *extra]


@pytest.mark.parametrize("extra", [
    (), ("--model_type", "vit_h", "--remat"),
    ("--train_encoder", "--content_size", "48", "--crop_prologue",
     "--window_size", "3", "--mosaic", "--worker_mode", "process")])
def test_cli_config_matches_jax(extra):
    """The same flags give the JAX CLI's Config, mesh included, less the
    annotations' default directory."""
    from wildlifemapper_tpu.cli import train as jcli

    import argparse
    targs = tcli.add_config_args(argparse.ArgumentParser()).parse_args(
        _argv(*extra))
    jargs = jcli.add_config_args(argparse.ArgumentParser()).parse_args(
        _argv(*extra))
    assert set(vars(targs)) == set(vars(jargs))
    got = dataclasses.asdict(tcli.config_from_args(targs))
    want = dataclasses.asdict(jcli.config_from_args(jargs))
    assert got["data"].pop("coco_path") == tcfg.DataConfig().coco_path
    want["data"].pop("coco_path")
    assert got == want


@pytest.mark.parametrize("cli", [tcli, tcli_eval], ids=["train", "evaluate"])
def test_cli_takes_model_parallel(cli, tmp_path, monkeypatch):
    """--model_parallel 2: the trainer, as two gloo ranks on the CPU under
    torchrun's environment, reaches the split step (each rank holds half of
    every block's heads); the evaluation CLI parses the flag and evaluates
    in one process with the model whole, as the JAX package's does."""
    if cli is tcli:
        from tests.test_torch_tensor_parallel import run_cli_ranks

        for r in run_cli_ranks(tmp_path, _argv("--model_parallel", "2")):
            assert r["model_parallel"] == 2
            assert r["split"] and r["model_size"] == 2
            assert r["qkv"] == [3 * 64 // 2, 64]
            assert np.isfinite(r["loss"])
        return
    seen = []
    init = tstep.StepBuilder.__init__

    def recording_init(self, cfg, *a, **k):
        seen.append(cfg.mesh.model_parallel_size)
        init(self, cfg, *a, **k)

    def tiny(args):
        seen.append(args.model_parallel)
        return tiny_config(tcfg)

    monkeypatch.setattr(cli, "config_from_args", tiny)
    monkeypatch.setattr(tstep.StepBuilder, "__init__", recording_init)
    stats = cli.main(_argv("--model_parallel", "2", "--device", "cpu",
                           "--max_batches", "1"))
    assert seen == [2, 1]
    assert "coco/AP" in stats


@pytest.mark.parametrize("cli", [tcli, tcli_eval], ids=["train", "evaluate"])
def test_cli_takes_a_reference_checkpoint(cli, tmp_path, monkeypatch,
                                          capsys):
    """--checkpoint reads a reference .pth (a raw SAM file: no hfc keys, so
    the decoder heads are cut and the adaptor keeps its initialisation)."""
    cfg = tiny_config(tcfg)
    monkeypatch.setattr(cli, "config_from_args", lambda args: cfg)
    sd = tstep.StepBuilder(cfg, device="cpu").model.state_dict()
    sam = {k: v for k, v in sd.items() if "hfc" not in k}
    torch.save(sam, tmp_path / "sam.pth")
    kept = sum("hfc" in k or (k.startswith("mask_decoder.")
                              and "transformer" not in k) for k in sd)
    argv = ["--checkpoint", str(tmp_path / "sam.pth"), "--device", "cpu",
            "--work_dir", str(tmp_path / "w")]
    if cli is tcli:
        train = tloop.train
        monkeypatch.setattr(tloop, "train", lambda c, **kw: train(
            c, **dict(kw, epochs=1, max_steps_per_epoch=1,
                      max_eval_batches=1)))
        cli.main(argv)
        want = (f"loaded {len(sd) - kept} tensors from "
                f"{tmp_path / 'sam.pth'}; kept init for {kept}")
    else:
        cli.main(argv + ["--max_batches", "1"])
        want = f"loaded {len(sd) - kept} tensors ({kept} kept at init)"
    assert want in capsys.readouterr().out


@pytest.mark.parametrize("cli", [tcli, tcli_eval], ids=["train", "evaluate"])
def test_cli_runs_on_the_card(cli, tmp_path, monkeypatch):
    """Both CLIs build on the card: without CUDA they raise, rather than
    run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_argv("--work_dir", str(tmp_path)))


@pytest.mark.parametrize("hw_swap_compat", [True, False])
def test_evaluate_warns_on_non_square_and_masks_padded_rows(hw_swap_compat):
    """evaluate() warns once when hw_swap_compat meets non-square frames
    (evaluate.py:111-125 of the JAX package), and a padded row
    (batch_valid False) reaches neither the evaluator nor the meters."""
    from wildlifemapper_tpu_torch.eval.evaluate import evaluate

    cfg = tiny_config(tcfg)
    cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
        cfg.eval, hw_swap_compat=hw_swap_compat))
    builder = tstep.StepBuilder(cfg, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    t = cfg.criterion.max_targets

    def batch(first_id):
        return {"image": rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
                "labels": np.ones((2, t), np.int32),
                "boxes": np.full((2, t, 4), 0.3, np.float32),
                "valid": np.arange(t)[None].repeat(2, 0) < 3,
                "size": np.full((2, 2), 48, np.int32),
                "batch_valid": np.array([True, first_id == 1]),
                "image_id": np.array([first_id, first_id + 1]),
                "orig_size": np.array([[30, 40], [30, 40]], np.int32)}

    class Loader:
        def batches_per_epoch(self):
            return 2

        def epoch(self, epoch):
            yield batch(1)
            yield batch(3)      # its second row pads the epoch

    class Index:
        categories = [{"id": 1, "name": "shoats"}]

        def annotations(self, image_id):
            return [{"bbox": [5, 5, 10, 10], "area": 100.0, "category_id": 1,
                     "iscrowd": 0}]

    seen, msgs = [], []

    class Recording(tce.CocoEvaluator):
        def update(self, predictions):
            seen.extend(predictions)
            super().update(predictions)

    import wildlifemapper_tpu_torch.eval.evaluate as ev_mod
    mp = pytest.MonkeyPatch()
    mp.setattr(ev_mod, "CocoEvaluator", Recording)
    try:
        stats = evaluate(builder.eval_step, builder.model, Loader(), Index(),
                         cfg, print_fn=lambda *a, **k: msgs.append(a[0]))
    finally:
        mp.undo()
    assert seen == [1, 2, 3]
    assert sum("hw_swap_compat=True" in str(m) for m in msgs) == (
        1 if hw_swap_compat else 0)
    assert "coco/AP_shoats" in stats and np.isfinite(stats["loss"])
