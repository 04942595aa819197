"""The port's data-parallel path (wildlifemapper_tpu_torch/parallel/, and the
criterion, step, meters, checkpoints, evaluation, loop and mosaic over a
process group) on the CPU, in two real processes over gloo.

The two ranks are this file run as a script (`python
tests/test_torch_distributed.py --worker ...`, a free port,
init_method=tcp://127.0.0.1:<port>); they import torch and the port only.
This pytest process, which has imported jax through tests/conftest.py, makes
the JAX side and the one-process references. One spawn of the two ranks
runs every check (module fixture `ranks`), under a timeout, so that a hung
collective fails the tests and cannot stall the suite. Each rank:

  * the checks of tests/twoproc_worker.py, mirrored: the ragged object
    gather, meter sync (a global average of 3.0 from [1, 2] and [6]), the
    eval merge over 1 + 2 image ids;
  * one data-parallel train step of twoproc_worker's tiny config (f32,
    plain path, hfc.dropout 0, no clipping so that the gradients stay in
    .grad), one row a rank, the rows holding 5 and 1 valid targets:
    against the JAX StepBuilder on a 2-device CPU mesh (losses and
    grad_norm at rtol 1e-4, gradients at atol 1e-5 / rtol 1e-3, updated
    parameters where |g| > 1e-6 at atol 2e-7 / rtol 1e-6: the tolerances
    of tests/test_torch_train_step.py) and against the port's one-process
    step on both rows (the same tolerances; the two differ by the order of
    f32 sums only); loss, grad_norm and parameters identical on both ranks.
    With per-rank normalisers (box count, CE weight sum) the unequal rows
    give another loss and gradient, which this comparison fails;
  * two DDP steps of each training configuration's freeze policy (tiny
    fine-tune, from scratch, grouped, and head-dim-80 with remat_blocks, the
    non-reentrant checkpoint under DDP): no trainable parameter without a
    gradient, the ranks in lock-step;
  * the mosaic split over the ranks, against one process's detect;
  * the loop (train/loop.py) for 2 epochs of 2 steps with evaluation over
    the whole val split, then a resumed third epoch: only rank 0 writes,
    parameters equal across ranks, the evaluation's image ids the split's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 420
VALID_COUNTS = (5, 1)          # valid targets of the step's two rows
LOSSES = ("loss", "loss_ce", "loss_bbox", "loss_giou", "class_error",
          "cardinality_error", "num_boxes")

# the tiny shapes cap the targets at 32 and truncate with a warning
pytestmark = pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")


# ---- configurations and data, shared by the ranks and the parent -------------

def step_config(mod, **model_overrides):
    """tests/twoproc_worker.py's tiny config (D 64, depth 2, canvas 64, 16
    queries) in package `mod`, f32 on the plain path, hfc.dropout 0 and
    no clipping."""
    vit = mod.ViTConfig(embed_dim=64, depth=2, num_heads=2,
                        global_attn_indexes=(1,), window_size=4, out_chans=32)
    model = dataclasses.replace(
        mod.model_config("vit_b"), vit=vit, img_size=64, patch_size=16,
        hfc=mod.HFCConfig(embed_dim=32, proj_dim=32, num_heads=2, ffn_dim=32,
                          dropout=0.0),
        decoder=mod.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                  num_queries=16, num_heads=2),
        **model_overrides)
    return mod.Config(model=model, data=mod.DataConfig(synthetic=True),
                      train=mod.TrainConfig(lr=1e-3, clip_max_norm=1e9),
                      criterion=mod.MatchCriterionConfig(max_targets=32))


def step_batch(b=2, t=32, counts=VALID_COUNTS, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.normal(size=(b, 64, 64, 3)).astype(np.float32),
        "labels": rng.integers(1, 7, size=(b, t)).astype(np.int64),
        "boxes": rng.uniform(0.3, 0.6, size=(b, t, 4)).astype(np.float32),
        "valid": np.arange(t)[None, :] < np.asarray(counts)[:, None],
    }


def policy_configs(tcfg):
    """Each training configuration's freeze policy at a tiny size."""
    base = step_config(tcfg)
    m = base.model
    scratch = dataclasses.replace(
        m, content_size=48, crop_prologue=True,
        vit=dataclasses.replace(m.vit, window_size=3),
        hfc=dataclasses.replace(m.hfc, compat_scrambled_reshape=False))
    vit_h = dataclasses.replace(
        m, remat_blocks=True, vit=dataclasses.replace(
            m.vit, embed_dim=160, num_heads=2))        # head dim 80
    grouped = dataclasses.replace(m, use_flash_attention=True,
                                  attn_impl="grouped")
    out = {}
    for name, model, freeze in (("fine_tune", m, True),
                                ("from_scratch", scratch, False),
                                ("grouped", grouped, True),
                                ("vit_h_remat", vit_h, True)):
        out[name] = dataclasses.replace(
            base, model=model,
            train=dataclasses.replace(base.train, freeze_encoder=freeze))
    return out


def loop_config(tcfg):
    """The loop's tiny run over the vendored bundle, synthetic tiles at 64."""
    cfg = step_config(tcfg)
    data = tcfg.DataConfig(resize_size=48, canvas_size=64, max_targets=32,
                           allow_truncation=True, batch_size=2,
                           synthetic=True, synthetic_size=64)
    return dataclasses.replace(
        cfg, data=data, train=tcfg.TrainConfig(
            lr=1e-3, epochs=2, clip_max_norm=1.0, checkpoint_every=1))


def mosaic_frame(seed=3):
    return np.random.default_rng(seed).integers(
        0, 256, size=(150, 230, 3), dtype=np.uint8)


MOSAIC = dict(tile_batch=2, overlap=16, confidence_threshold=0.05)


def mosaic_model(tcfg):
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    return WildlifeMapper(step_config(tcfg).model,
                          generator=torch.Generator().manual_seed(0),
                          device="cpu").eval()


# ---- the ranks ------------------------------------------------------------------

def worker(args):
    """One rank: every check, results to <out>/rank<r>.json and .npz."""
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    os.environ["WM_SYNTH_CACHE"] = "0"
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.eval import coco_eval
    from wildlifemapper_tpu_torch.eval.orthomosaic import OrthomosaicDetector
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.parallel.mesh import make_mesh
    from wildlifemapper_tpu_torch.train import loop as tloop
    from wildlifemapper_tpu_torch.train.metrics import MetricLogger
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    rank = args.rank
    out = Path(args.out)
    assert dist.init_distributed_mode(
        init_method=f"tcp://127.0.0.1:{args.port}", world_size=WORLD,
        rank=rank, device="cpu")
    assert torch.distributed.get_backend() == "gloo"
    assert make_mesh() is torch.distributed.group.WORLD
    res = {"world_size": dist.get_world_size(), "rank": dist.get_rank()}
    arrays = {}

    # 1. ragged object gather (misc.py:180-220)
    res["gather"] = dist.all_gather_objects(
        {"rank": rank, "items": list(range(3 + 5 * rank)),
         "name": f"proc{rank}"})

    # 2. meter sync (misc.py:240-251); a meter only rank 1 has
    logger = MetricLogger(print_fn=lambda *a, **k: None)
    for v in ([1.0, 2.0] if rank == 0 else [6.0]):
        logger.update(loss=v)
    if rank == 1:
        logger.update(only_rank1=4.0)
    logger.synchronize_between_processes()
    res["meters"] = logger.global_averages()

    # 3. eval merge: ragged per-process detection dicts
    dts = {100 + rank * 10 + i: {"scores": [0.5 + 0.1 * i], "labels": [1],
                                 "boxes": [[0.0, 0.0, 10.0, 10.0 + i]]}
           for i in range(1 + rank)}
    merged = {}
    for other in dist.all_gather_objects(dts):
        merged.update(other)
    res["merged_image_ids"] = sorted(merged)

    # 4. one data-parallel train step, this rank's row of the batch
    weights = {k: torch.from_numpy(v)
               for k, v in np.load(args.weights).items()}
    builder = StepBuilder(step_config(tcfg), device="cpu")
    load_reference_state_dict(builder.model, weights)
    state = builder.init_state(steps_per_epoch=4)
    batch = {k: torch.from_numpy(v[rank:rank + 1])
             for k, v in step_batch().items()}
    state, metrics = builder.train_step(state, batch)
    res["step"] = {k: float(v) for k, v in metrics.items()}
    for n, p in builder.model.named_parameters():
        arrays[f"param/{n}"] = p.detach().numpy().copy()
        if p.grad is not None:
            arrays[f"grad/{n}"] = p.grad.numpy().copy()

    # 5. DDP under each training configuration's freeze policy: two steps
    # (DDP raises in the second if a trainable parameter had no gradient)
    res["policies"] = {}
    for name, pcfg in policy_configs(tcfg).items():
        pb = StepBuilder(pcfg, generator=torch.Generator().manual_seed(1),
                         device="cpu")
        st = pb.init_state(steps_per_epoch=4)
        pbatch = {k: torch.from_numpy(v) for k, v in
                  step_batch(b=1, seed=10 + rank, counts=(3,)).items()}
        gen = torch.Generator().manual_seed(rank)
        losses = []
        for _ in range(2):
            st, m = pb.train_step(st, pbatch, gen)
            losses.append(float(m["loss"]))
        named = dict(pb.model.named_parameters())
        res["policies"][name] = {
            "losses": losses,
            "trainable": sum(p.requires_grad for p in named.values()),
            "no_grad": [n for n, p in named.items()
                        if p.requires_grad and p.grad is None]}
        for n, p in named.items():
            arrays[f"policy/{name}/{n}"] = p.detach().numpy().copy()

    # 6. the mosaic over the ranks
    det = OrthomosaicDetector(mosaic_model(tcfg), step_config(tcfg).model,
                              **MOSAIC)
    found = det.detect(mosaic_frame())
    for k, v in found.items():
        arrays[f"mosaic/{k}"] = v

    # 7. the loop: 2 epochs, then a resumed third; what each rank writes,
    # and the image ids each evaluation scores
    writes = []
    save, write_text = torch.save, Path.write_text

    def recording_save(obj, f, *a, **k):
        if isinstance(f, (str, os.PathLike)):     # not the gathers' buffers
            writes.append(str(f))
        return save(obj, f, *a, **k)

    def recording_write_text(self, *a, **k):
        writes.append(str(self))
        return write_text(self, *a, **k)

    scored = []
    accumulate = coco_eval.CocoEvaluator.accumulate

    def recording_accumulate(self):
        scored.append(sorted(self.img_ids))
        return accumulate(self)

    torch.save, Path.write_text = recording_save, recording_write_text
    coco_eval.CocoEvaluator.accumulate = recording_accumulate
    try:
        lcfg = loop_config(tcfg)
        quiet = dict(print_fn=lambda *a, **k: None, device="cpu")
        first = tloop.train(lcfg, workdir=args.workdir, epochs=2,
                            max_steps_per_epoch=2, **quiet)
        resumed = tloop.train(lcfg, workdir=args.workdir, epochs=3,
                              resume=True, max_steps_per_epoch=2, **quiet)
    finally:
        torch.save, Path.write_text = save, write_text
        coco_eval.CocoEvaluator.accumulate = accumulate
    res["loop"] = {"first": first, "resumed": resumed, "writes": writes,
                   "scored": scored}
    ckpt = torch.load(Path(args.workdir) / "checkpoint_epoch_2",
                      map_location="cpu", weights_only=True)
    for n, v in ckpt["model"].items():
        arrays[f"loop/{n}"] = v.numpy()

    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


# ---- the parent -----------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def step_weights():
    """The JAX package's init of the step's config, in the port's names."""
    import jax

    from tests.torch_common import flat_numpy
    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu.train import step as jstep
    from wildlifemapper_tpu_torch.weights import state_dict_from_jax

    jc = step_config(jcfg)
    params = jstep.StepBuilder(jc).init_params(jax.random.PRNGKey(0))
    sd = state_dict_from_jax(flat_numpy(params), depth=jc.model.vit.depth)
    return params, {k: v.numpy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, step_weights):
    """Both ranks' results: (json, npz) of each, rank order."""
    out = tmp_path_factory.mktemp("ranks")
    np.savez(out / "weights.npz", **step_weights[1])
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         "--port", str(port), "--rank", str(r), "--out", str(out),
         "--weights", str(out / "weights.npz"),
         "--workdir", str(out / "loop")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(REPO)) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [(json.loads((out / f"rank{r}.json").read_text()),
             dict(np.load(out / f"rank{r}.npz"))) for r in range(WORLD)]


def test_integration_mirrors_jax(ranks):
    """tests/test_distributed.py::test_two_process_integration on the port."""
    (r0, _), (r1, _) = ranks
    assert r0["world_size"] == r1["world_size"] == 2
    assert [r0["rank"], r1["rank"]] == [0, 1]
    # both ranks see the same gathered list, in rank order, ragged
    assert r0["gather"] == r1["gather"]
    assert [g["rank"] for g in r0["gather"]] == [0, 1]
    assert len(r0["gather"][1]["items"]) == 8
    # meter sync: the global average of [1, 2] + [6] on both; name sets
    # that differ between the ranks merge
    for r in (r0, r1):
        assert abs(r["meters"]["loss"] - 3.0) < 1e-9
        assert r["meters"]["only_rank1"] == 4.0
    # eval merge: both end with the full image-id set (1 + 2 images)
    assert r0["merged_image_ids"] == r1["merged_image_ids"]
    assert len(r0["merged_image_ids"]) == 3
    # the train step: loss and grad_norm identical on both ranks
    assert r0["step"] == r1["step"]


def _port_one_process(weights, batch):
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    builder = StepBuilder(step_config(tcfg), device="cpu")
    load_reference_state_dict(
        builder.model, {k: torch.from_numpy(v) for k, v in weights.items()})
    state = builder.init_state(steps_per_epoch=4)
    _, metrics = builder.train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    params = {n: p.detach().numpy() for n, p in
              builder.model.named_parameters()}
    grads = {n: p.grad.numpy() for n, p in builder.model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in metrics.items()}, params, grads


def _jax_two_device_step(params, batch):
    """The JAX StepBuilder's step over a 2-device data axis, and the
    gradient of its loss, in the port's names."""
    import jax
    import jax.numpy as jnp

    from tests.torch_common import flat_numpy
    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu.parallel import mesh as mesh_lib
    from wildlifemapper_tpu.train import step as jstep
    from wildlifemapper_tpu.train.criterion import set_criterion
    from wildlifemapper_tpu_torch.weights import state_dict_from_jax

    jc = step_config(jcfg)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:2])
    builder = jstep.StepBuilder(jc, mesh=mesh, use_tp=False)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    trainable, frozen = jstep._split_params(params, jc.train.freeze_encoder)

    def loss_fn(tr):
        out = builder.model.apply(jstep._merge_params(tr, frozen),
                                  jbatch["image"], deterministic=False,
                                  rngs={"dropout": jax.random.PRNGKey(1)})
        tgt = {k: jbatch[k] for k in ("labels", "boxes", "valid")}
        return set_criterion(out, tgt, jc.criterion,
                             num_classes=jc.model.num_classes)["loss"]

    grads = jax.jit(jax.grad(loss_fn))(trainable)
    # the step donates its state: taken after the gradient
    state = builder.place(builder.init_state(params, steps_per_epoch=4))
    new, metrics = builder.jit_train_step()(state, jbatch,
                                            jax.random.PRNGKey(1))
    depth = jc.model.vit.depth
    new_params = {k: v.numpy() for k, v in state_dict_from_jax(
        flat_numpy(new.params), depth=depth).items()}
    grads = {k: v.numpy() for k, v in state_dict_from_jax(
        {k: np.asarray(v) for k, v in grads.items()}, depth=depth).items()}
    return ({k: float(v) for k, v in metrics.items()}, new_params, grads)


def _assert_step_matches(metrics, params, grads, want_metrics, want_params,
                         want_grads, what):
    for k in LOSSES + ("grad_norm",):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what}: {k}")
    assert set(grads) == set(want_grads), what
    checked = 0
    for n, g in grads.items():
        np.testing.assert_allclose(g, want_grads[n], atol=1e-5, rtol=1e-3,
                                   err_msg=f"{what}: grad {n}")
        clear = np.abs(want_grads[n]) > 1e-6
        checked += int(clear.sum())
        np.testing.assert_allclose(params[n][clear], want_params[n][clear],
                                   atol=2e-7, rtol=1e-6,
                                   err_msg=f"{what}: param {n}")
    assert checked > 1000, what
    for n in set(params) - set(grads):          # frozen: unchanged
        np.testing.assert_array_equal(params[n], want_params[n], err_msg=n)


def test_dp_step_matches_jax_mesh_and_one_process(ranks, step_weights):
    """Rows with 5 and 1 valid targets, one a rank: the global batch's
    normalisers make the two ranks' step the JAX step over a 2-device mesh
    and the port's one-process step on both rows."""
    jparams, weights = step_weights
    (r0, a0), (r1, a1) = ranks
    batch = step_batch()
    metrics = r0["step"]
    params = {k[6:]: v for k, v in a0.items() if k.startswith("param/")}
    grads = {k[5:]: v for k, v in a0.items() if k.startswith("grad/")}
    # lock-step: both ranks hold the same parameters and gradients
    for k in a0:
        if k.startswith(("param/", "grad/")):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    assert metrics["num_boxes"] == sum(VALID_COUNTS)

    one = _port_one_process(weights, batch)
    _assert_step_matches(metrics, params, grads, *one, "port one process")
    jax_ref = _jax_two_device_step(jparams, batch)
    _assert_step_matches(metrics, params, grads, *jax_ref, "JAX 2-device")


def test_ddp_every_trainable_parameter_gets_a_gradient(ranks):
    """Two DDP steps of each configuration's freeze policy ran on both
    ranks (DDP without find_unused_parameters raises in the second step if
    a trainable parameter had no gradient); every trainable parameter holds
    one, and the ranks hold the same parameters."""
    (r0, a0), (r1, a1) = ranks
    assert set(r0["policies"]) == {"fine_tune", "from_scratch", "grouped",
                                   "vit_h_remat"}
    for name, p in r0["policies"].items():
        assert p["no_grad"] == [], name
        assert p["trainable"] > 10, name
        assert p["losses"] == r1["policies"][name]["losses"], name
        assert np.isfinite(p["losses"]).all(), name
    for k in a0:
        if k.startswith("policy/"):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)


def test_freeze_policies_leave_no_trainable_parameter_without_gradient():
    """The same configurations in one process without DDP: after one
    backward every parameter that requires a gradient has one (so the
    wrapper needs no find_unused_parameters)."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.train.step import StepBuilder

    for name, cfg in policy_configs(tcfg).items():
        builder = StepBuilder(cfg, generator=torch.Generator().manual_seed(1),
                              device="cpu")
        state = builder.init_state(steps_per_epoch=4)
        batch = {k: torch.from_numpy(v) for k, v in
                 step_batch(b=1, seed=10, counts=(3,)).items()}
        builder.train_step(state, batch, torch.Generator().manual_seed(0))
        named = dict(builder.model.named_parameters())
        missing = [n for n, p in named.items()
                   if p.requires_grad and p.grad is None]
        assert missing == [], (name, missing)
        assert any(not p.requires_grad for p in named.values()) == \
            cfg.train.freeze_encoder, name


def test_mosaic_over_two_ranks_equals_one_process(ranks):
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.eval.orthomosaic import OrthomosaicDetector

    want = OrthomosaicDetector(mosaic_model(tcfg), step_config(tcfg).model,
                               **MOSAIC).detect(mosaic_frame())
    assert len(want["boxes"]) > 0
    for _, a in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(a[f"mosaic/{k}"], v, err_msg=k)


def test_loop_over_two_ranks(ranks):
    """Rank 0 alone writes; both ranks end with the same parameters and
    the same COCO stats; every evaluation scores the whole val split."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.data.coco import CocoIndex

    (r0, a0), (r1, a1) = ranks
    assert r1["loop"]["writes"] == []
    names = {Path(w).name for w in r0["loop"]["writes"]}
    assert {"config.json", "checkpoint_epoch_0", "checkpoint_epoch_1",
            "checkpoint_epoch_2", "best_loss.json"} <= {
        n if not n.startswith(".") else n.split(".")[1] for n in names}
    for k in a0:
        if k.startswith("loop/"):
            np.testing.assert_array_equal(a0[k], a1[k], err_msg=k)
    for run in ("first", "resumed"):
        s0, s1 = r0["loop"][run], r1["loop"][run]
        assert s0 == s1, run
        assert 0.0 <= s0["val/coco/AP50"] <= 1.0 or s0["val/coco/AP50"] == -1
    ann = Path(loop_config(tcfg).data.coco_path) / "val.json"
    val_ids = sorted(CocoIndex(str(ann)).ids)
    assert len(val_ids) == 111
    for r in (r0, r1):
        assert len(r["loop"]["scored"]) == 3       # epochs 0, 1, and 2
        for ids in r["loop"]["scored"]:
            assert ids == val_ids


def test_loop_evaluation_equals_one_process(ranks, tmp_path, monkeypatch):
    """The last epoch's parameters (checkpoint_epoch_2) evaluated in one
    process over the val split give the two ranks' COCO stats exactly: the
    same detections, scored in the split's order."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.data.loader import DataLoader, build_dataset
    from wildlifemapper_tpu_torch.eval.evaluate import evaluate
    from wildlifemapper_tpu_torch.train.step import StepBuilder

    monkeypatch.setenv("WM_SYNTH_CACHE", "0")
    (r0, a0), _ = ranks
    cfg = loop_config(tcfg)
    builder = StepBuilder(cfg, device="cpu")
    builder.model.load_state_dict(
        {k[5:]: torch.from_numpy(v) for k, v in a0.items()
         if k.startswith("loop/")})
    ds = build_dataset("val", cfg.data)
    loader = DataLoader(ds, cfg.data.batch_size, shuffle=False,
                        drop_last=False)
    try:
        stats = evaluate(builder.eval_step, builder.model, loader, ds.index,
                         cfg, epoch=2, print_fn=lambda *a, **k: None)
    finally:
        loader.close()
    coco = {f"val/{k}": v for k, v in stats.items() if k.startswith("coco/")}
    assert len(coco) > 12
    assert coco == {k: v for k, v in r0["loop"]["resumed"].items()
                    if k.startswith("val/coco/")}


def test_config_round_trip_with_mesh():
    """A JAX config.json with a mesh loads in the port with it, and the
    port's loads in JAX, both ways equal."""
    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu_torch import config as tcfg

    for mp in (1, 4):
        jc, tc = (dataclasses.replace(
            step_config(mod), data=mod.DataConfig(coco_path="annotations"),
            mesh=mod.MeshConfig(model_parallel_size=mp))
            for mod in (jcfg, tcfg))
        port = tcfg.config_from_json(jcfg.config_to_json(jc))
        assert port.mesh == tc.mesh and port == tc
        assert json.loads(tcfg.config_to_json(port)) == json.loads(
            jcfg.config_to_json(jc))
        back = jcfg.config_from_json(tcfg.config_to_json(tc))
        assert back.mesh == jc.mesh
        assert json.loads(jcfg.config_to_json(back)) == json.loads(
            tcfg.config_to_json(tc))


def test_single_process_needs_no_group(monkeypatch):
    """Without torchrun's environment init_distributed_mode does nothing;
    the helpers answer for one process; there is no data axis, and a model
    axis asks for its ranks, from the mesh and from a StepBuilder whose
    config asks for one."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.parallel import mesh as mesh_lib
    from wildlifemapper_tpu_torch.train.step import StepBuilder

    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert dist.init_distributed_mode() is False
    assert (dist.get_rank(), dist.get_world_size()) == (0, 1)
    assert dist.is_main_process()
    obj = {"a": [1, 2]}
    assert dist.all_gather_objects(obj)[0] is obj
    assert dist.save_on_master(lambda x: x + 1, 1) == 2
    ask = "model_parallel=2 .* run a multiple of 2 processes"
    with pytest.raises(ValueError, match=ask):
        mesh_lib.make_mesh(model_parallel=2)
    assert mesh_lib.make_mesh() is None
    cfg = dataclasses.replace(step_config(tcfg), mesh=tcfg.MeshConfig(
        model_parallel_size=2))
    with pytest.raises(ValueError, match=ask):
        StepBuilder(cfg, device="cpu")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", action="store_true", required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--weights", required=True)
    parser.add_argument("--workdir", required=True)
    worker(parser.parse_args())
