"""The port's tensor parallelism (the model axis of
wildlifemapper_tpu_torch/parallel/mesh.py, parallel/tensor_parallel.py and
the split layers, step, clip, checkpoints and loop) on the CPU, in real gloo
processes: a model axis of P = 2 over a world of 2 (one data rank) and of 4
(2 data ranks x 2 model ranks).

The ranks are this file run as a script (`python
tests/test_torch_tensor_parallel.py --worker ...`); they import torch and the
port only. One spawn of each world runs every check of that world (module
fixture `ranks`), under a timeout, while this pytest process makes the JAX
side and the one-process references. Each world:

  * f32 train steps of tests/test_torch_distributed.py's tiny config (D 64,
    2 heads, adaptor and decoder 2 heads, no clipping so that the
    gradients stay in .grad), fine-tune and from scratch, hfc.dropout 0,
    on rows with 5 and 1 valid targets (world 2: both rows on every rank;
    world 4: a row a data rank): the gathered parameters and gradients of
    the first step against the JAX `StepBuilder(cfg, mesh=make_mesh(2,
    devices=jax.devices()[:W]), use_tp=True)` step and against the port's
    one-process step, at the train-step tolerances of record (losses and
    grad_norm rtol 1e-4, gradients atol 1e-5 / rtol 1e-3, updated
    parameters atol 2e-7 / rtol 1e-6); then two more steps, after which
    every whole (unsplit) parameter is bit-identical on every rank;
  * world 2 also: the fine-tune with hfc.dropout 0.1 (the adaptor's masks
    drawn whole and sliced, from the data rank's generator) and the
    grouped layout, against one process; the moments of a split parameter
    in its shard's shape; the all-reduces of a step with remat_blocks on
    and off; the loop's checkpoint written at P = 2, resumed at P = 2 and
    (here) at P = 1, against the unbroken run;
  * in one process: shard_params / gather_params round trips, the rules'
    dims against the JAX param_pspec's, whole pairs where heads do not
    divide, and the split layers handing the kernels' wrappers a rank's
    shapes (no library call in their place);
  * controls, each a check failing when its fix is undone: a row split's
    bias added on model rank 0 alone (its gradient on rank 1 is wrong), the
    criterion's normalisers over the world at 2 x 2 (num_boxes doubled), a
    remat segment that holds its sum over the model group (more
    all-reduces with remat than without).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TP = 2
WORLDS = (2, 4)
TIMEOUT_S = 300
STEPS = 3
VALID_COUNTS = (5, 1)
LOSSES = ("loss", "loss_ce", "loss_bbox", "loss_giou", "class_error",
          "cardinality_error", "num_boxes")
# (case, config, world sizes): the steps each world runs
STEP_CASES = (("fine_tune", "fine_tune", (2, 4)),
              ("from_scratch", "from_scratch", (2, 4)),
              ("fine_tune_dropout", "fine_tune_dropout", (2,)),
              ("grouped", "grouped", (2,)))

# the tiny shapes cap the targets at 32 and truncate with a warning
pytestmark = pytest.mark.filterwarnings("ignore:pad_targets:RuntimeWarning")


# ---- configurations and data, shared by the ranks and the parent -------------

def step_config(mod, name="fine_tune", model_parallel=1):
    """tests/test_torch_distributed.py's tiny config in package `mod` (f32,
    plain path, no clipping), in training configuration `name`, over a
    model axis of `model_parallel`."""
    vit = mod.ViTConfig(embed_dim=64, depth=2, num_heads=2,
                        global_attn_indexes=(1,), window_size=4, out_chans=32)
    model = dataclasses.replace(
        mod.model_config("vit_b"), vit=vit, img_size=64, patch_size=16,
        hfc=mod.HFCConfig(embed_dim=32, proj_dim=32, num_heads=2, ffn_dim=32,
                          dropout=0.1 if name == "fine_tune_dropout" else 0.0),
        decoder=mod.DecoderConfig(transformer_dim=32, mlp_dim=64,
                                  num_queries=16, num_heads=2))
    freeze = name != "from_scratch"
    if name == "from_scratch":
        model = dataclasses.replace(
            model, content_size=48, crop_prologue=True,
            vit=dataclasses.replace(model.vit, window_size=3),
            hfc=dataclasses.replace(model.hfc,
                                    compat_scrambled_reshape=False))
    elif name == "grouped":
        model = dataclasses.replace(model, use_flash_attention=True,
                                    attn_impl="grouped")
    elif name == "remat":                 # head dim 80, as ViT-H's
        model = dataclasses.replace(model, remat_blocks=True, vit=dataclasses
                                    .replace(model.vit, embed_dim=160))
    return mod.Config(
        model=model, data=mod.DataConfig(synthetic=True),
        train=mod.TrainConfig(lr=1e-3, clip_max_norm=1e9,
                              freeze_encoder=freeze),
        criterion=mod.MatchCriterionConfig(max_targets=32),
        mesh=mod.MeshConfig(model_parallel_size=model_parallel))


def weights_config(name):
    """Which weights a step case loads: the configurations with the
    fine-tune's parameter shapes share its weights."""
    return "from_scratch" if name == "from_scratch" else "fine_tune"


def step_batch(step=0, rows=slice(None)):
    rng = np.random.default_rng(step)
    b, t = 2, 32
    full = {
        "image": rng.normal(size=(b, 64, 64, 3)).astype(np.float32),
        "labels": rng.integers(1, 7, size=(b, t)).astype(np.int64),
        "boxes": rng.uniform(0.3, 0.6, size=(b, t, 4)).astype(np.float32),
        "valid": (np.arange(t)[None, :]
                  < np.asarray(VALID_COUNTS)[:, None]),
    }
    return {k: v[rows] for k, v in full.items()}


def loop_config(mod, model_parallel=1):
    """The loop's tiny run over the vendored bundle, synthetic tiles at 64,
    the adaptor's dropout on."""
    cfg = step_config(mod, "fine_tune_dropout", model_parallel)
    data = mod.DataConfig(resize_size=48, canvas_size=64, max_targets=32,
                          allow_truncation=True, batch_size=2,
                          synthetic=True, synthetic_size=64)
    return dataclasses.replace(cfg, data=data, train=mod.TrainConfig(
        lr=1e-3, epochs=2, clip_max_norm=1.0, checkpoint_every=1))


LOOP = dict(max_steps_per_epoch=2, max_eval_batches=1)


def seeded_weights(name):
    """The port's seeded initialisation of configuration `name`, every
    tensor plus seeded noise so that zero biases and tables carry signal."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    model = WildlifeMapper(step_config(tcfg, name).model,
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(1)
    return {k: (v.numpy() + 0.05 * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in model.state_dict().items()}


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


# ---- the ranks ------------------------------------------------------------------

def _steps(tcfg, name, weights, rows, res, arrays, tag=None):
    """STEPS train steps of configuration `name` at P = TP; the gathered
    state after the first (rank 0), every parameter's digest after the
    last."""
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    tag = tag or name
    cfg = step_config(tcfg, name, TP)
    sb = StepBuilder(cfg, device="cpu")
    load_reference_state_dict(sb.model, weights)
    state = sb.init_state(steps_per_epoch=4)
    gen = torch.Generator().manual_seed(cfg.train.seed + 1
                                        + dist.get_data_rank())
    out = {"metrics": []}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in
                 step_batch(i, rows).items()}
        state, m = sb.train_step(state, batch, gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            named = dict(sb.model.named_parameters())
            grads = {n: p.grad for n, p in named.items()
                     if p.grad is not None}
            shards = state.model_parallel
            full_params = shards.gather({n: p.detach()
                                         for n, p in named.items()})
            full_grads = shards.gather(grads)
            if dist.get_rank() == 0:
                for n, v in full_params.items():
                    arrays[f"{tag}/param/{n}"] = v.numpy().copy()
                for n, v in full_grads.items():
                    arrays[f"{tag}/grad/{n}"] = v.numpy().copy()
            out["local_grads"] = {n: digest(g) for n, g in grads.items()}
    named = dict(sb.model.named_parameters())
    out["split"] = sorted(n for n, p in named.items()
                          if hasattr(p, "model_parallel_split"))
    out["digests"] = {n: digest(p) for n, p in named.items()}
    out["shapes"] = {n: list(p.shape) for n, p in named.items()}
    res[tag] = out
    return sb, state


def worker(args):
    """One rank: every check of its world, results to <out>/rank<r>.json
    (and .npz)."""
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    os.environ["WM_SYNTH_CACHE"] = "0"
    from torch.utils.checkpoint import checkpoint

    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.models import common, vit
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.parallel.mesh import make_mesh
    from wildlifemapper_tpu_torch.parallel.tensor_parallel import \
        all_reduce_model
    from wildlifemapper_tpu_torch.train import loop as tloop
    from wildlifemapper_tpu_torch.train.step import StepBuilder

    rank, world = args.rank, args.world
    out = Path(args.out)
    assert dist.init_distributed_mode(
        init_method=f"tcp://127.0.0.1:{args.port}", world_size=world,
        rank=rank, device="cpu")
    mesh = make_mesh(TP)
    res = {"rank": rank, "data_rank": dist.get_data_rank(),
           "data_size": dist.get_data_world_size(),
           "model_rank": dist.get_model_rank(),
           "model_size": dist.get_model_world_size(),
           "data_members": torch.distributed.get_process_group_ranks(
               mesh.data),
           "model_members": torch.distributed.get_process_group_ranks(
               mesh.model)}
    arrays = {}
    weights = {name: {k: torch.from_numpy(v) for k, v in
                      np.load(out / f"weights_{name}.npz").items()}
               for name in ("fine_tune", "from_scratch")}
    d = dist.get_data_rank()
    rows = slice(None) if world == TP else slice(d, d + 1)

    # the steps against JAX and one process; lock step after STEPS
    for case, name, worlds in STEP_CASES:
        if world in worlds:
            sb, state = _steps(tcfg, name, weights[weights_config(name)],
                               rows, res, arrays)
            if case == "fine_tune":
                p = sb.model.image_encoder.hfc_attn.cross_attn.in_proj_weight
                res["moments"] = {
                    "param": list(p.shape),
                    "moments": {k: list(v.shape) for k, v in
                                state.optimizer.state[p].items()
                                if v.dim() > 0}}
            del sb, state

    if world == 4:
        # control: the criterion's normalisers over the world, not the
        # data group, at 2 x 2 (the model ranks' rows counted twice)
        data_group = dist.data_group
        dist.data_group = lambda: torch.distributed.group.WORLD
        try:
            _steps(tcfg, "fine_tune", weights["fine_tune"], rows, res,
                   arrays, tag="control_world_normalisers")
        finally:
            dist.data_group = data_group

    if world == 2:
        # control: a row split's bias added on model rank 0 alone, before
        # the sum (the forward is the same; rank 1's bias gets no gradient)
        finish = common.Linear.finish

        def rank0_bias(self, y):
            if self.split != "row":
                return y
            if self.bias is not None and dist.get_model_rank() == 0:
                y = y + self.bias.to(y.dtype)
            from wildlifemapper_tpu_torch.parallel.tensor_parallel import \
                reduce_from_model
            return reduce_from_model(y, self.group).to(y.dtype)

        common.Linear.finish = rank0_bias
        try:
            _steps(tcfg, "fine_tune", weights["fine_tune"], rows, res,
                   arrays, tag="control_rank0_bias")
        finally:
            common.Linear.finish = finish

        # the all-reduces of one step, remat on and off, and with the whole
        # block one remat segment, which holds the attention's sum over
        # the model group before norm2 (the control)
        def held_sums(self, x):
            if not (self.remat and torch.is_grad_enabled()):
                return forward(self, x)

            def body(t):
                y, m = self._residual_mlp(t, self._attention(t, self._attend))
                return y + self.mlp.finish(m)

            return checkpoint(body, x, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=vit._recompute_contexts)

        forward = vit.Block.forward
        rcfg = step_config(tcfg, "remat", TP)
        res["remat"] = {}
        for label, remat in (("on", True), ("off", False), ("held", True)):
            cfg = dataclasses.replace(rcfg, model=dataclasses.replace(
                rcfg.model, remat_blocks=remat))
            sb = StepBuilder(cfg, generator=torch.Generator().manual_seed(2),
                             device="cpu")
            state = sb.init_state(steps_per_epoch=4)
            batch = {k: torch.from_numpy(v) for k, v in step_batch().items()}
            if label == "held":
                vit.Block.forward = held_sums
            try:
                before = all_reduce_model.count
                _, m = sb.train_step(state, batch)
                count = all_reduce_model.count - before
            finally:
                vit.Block.forward = forward
            res["remat"][label] = {"all_reduces": count,
                                   "loss": float(m["loss"])}
            del sb, state

        # the loop: unbroken for 2 epochs, and 1 epoch then resumed
        lcfg = loop_config(tcfg, TP)
        quiet = dict(print_fn=lambda *a, **k: None, device="cpu", **LOOP)
        unbroken = tloop.train(lcfg, workdir=str(out / "unbroken"),
                               epochs=2, **quiet)
        tloop.train(lcfg, workdir=str(out / "segmented"), epochs=1, **quiet)
        if rank == 0:
            shutil.copytree(out / "segmented", out / "at_p1")
        torch.distributed.barrier()
        resumed = tloop.train(lcfg, workdir=str(out / "segmented"), epochs=2,
                              resume=True, **quiet)
        res["loop"] = {"unbroken": unbroken, "resumed": resumed}

    np.savez(out / f"rank{rank}.npz", **arrays)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    torch.distributed.destroy_process_group()


def cli_worker(args):
    """One rank of cli.train.main under torchrun's environment, on the
    loop's tiny config with the parsed --model_parallel, for one step and
    one evaluation batch; what it built into <out>/cli_rank<r>.json."""
    sys.path.insert(0, str(REPO))
    torch.set_num_threads(1)
    os.environ["WM_SYNTH_CACHE"] = "0"
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.cli import train as cli
    from wildlifemapper_tpu_torch.parallel import distributed as dist
    from wildlifemapper_tpu_torch.train import loop as tloop
    from wildlifemapper_tpu_torch.train import step as tstep

    res = {}

    def tiny(parsed):
        res["model_parallel"] = parsed.model_parallel
        return loop_config(tcfg, parsed.model_parallel)

    train, init_state = tloop.train, tstep.StepBuilder.init_state

    def short(cfg, **kw):
        return train(cfg, **dict(kw, epochs=1, max_steps_per_epoch=1,
                                 max_eval_batches=1))

    def recording(self, *a, **k):
        state = init_state(self, *a, **k)
        res["split"] = state.model_parallel is not None
        res["model_size"] = dist.get_model_world_size()
        res["qkv"] = list(
            state.model.image_encoder.blocks[0].attn.qkv.weight.shape)
        return state

    cli.config_from_args, tloop.train = tiny, short
    tstep.StepBuilder.init_state = recording
    stats = cli.main(json.loads(args.argv) + [
        "--device", "cpu", "--work_dir", str(Path(args.out) / "cli")])
    res["loss"] = stats["train/loss"]
    (Path(args.out) / f"cli_rank{os.environ['RANK']}.json").write_text(
        json.dumps(res))


# ---- the parent -----------------------------------------------------------------

def run_cli_ranks(out: Path, argv) -> list:
    """cli.train.main with `argv` as TP ranks under torchrun's environment
    (cli_worker); their reports in rank order."""
    port = free_port()
    procs = []
    try:
        for r in range(TP):
            env = dict(os.environ, OMP_NUM_THREADS="1", RANK=str(r),
                       LOCAL_RANK=str(r), WORLD_SIZE=str(TP),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--cli",
                 "--argv", json.dumps(list(argv)), "--out", str(out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=str(REPO)))
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [json.loads((out / f"cli_rank{r}.json").read_text())
            for r in range(TP)]


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _one_process(name, weights, steps=1):
    """The port's one-process step(s) of configuration `name` on both rows:
    (metrics of the first, parameters after it, its gradients, and every
    step's metrics)."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.train.step import StepBuilder
    from wildlifemapper_tpu_torch.weights import load_reference_state_dict

    cfg = step_config(tcfg, name)
    builder = StepBuilder(cfg, device="cpu")
    load_reference_state_dict(
        builder.model, {k: torch.from_numpy(v) for k, v in weights.items()})
    state = builder.init_state(steps_per_epoch=4)
    gen = torch.Generator().manual_seed(cfg.train.seed + 1)
    seen = []
    for i in range(steps):
        state, m = builder.train_step(
            state, {k: torch.from_numpy(v)
                    for k, v in step_batch(i).items()}, gen)
        seen.append({k: float(v) for k, v in m.items()})
        if i == 0:
            named = dict(builder.model.named_parameters())
            params = {n: p.detach().numpy().copy() for n, p in named.items()}
            grads = {n: p.grad.numpy().copy() for n, p in named.items()
                     if p.grad is not None}
    return seen[0], params, grads, seen


def _jax_params(name, weights):
    import jax.numpy as jnp
    from flax import traverse_util

    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu.compat.torch_convert import map_torch_keys

    depth = step_config(jcfg, name).model.vit.depth
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in
         map_torch_keys(weights, depth=depth).items()}, sep="/")}


def _jax_grads(name, weights):
    """The gradient of the JAX step's loss on both rows, in the port's
    names (the same function whatever the mesh)."""
    import jax
    import jax.numpy as jnp

    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
    from wildlifemapper_tpu.train import step as jstep
    from wildlifemapper_tpu.train.criterion import set_criterion
    from wildlifemapper_tpu_torch.weights import state_dict_from_jax

    jc = step_config(jcfg, name, TP)
    model = JaxWildlifeMapper(jc.model)
    jbatch = {k: jnp.asarray(v) for k, v in step_batch().items()}
    trainable, frozen = jstep._split_params(_jax_params(name, weights),
                                            jc.train.freeze_encoder)

    def loss_fn(tr):
        out = model.apply(jstep._merge_params(tr, frozen), jbatch["image"],
                          deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(1)})
        tgt = {k: jbatch[k] for k in ("labels", "boxes", "valid")}
        return set_criterion(out, tgt, jc.criterion,
                             num_classes=jc.model.num_classes)["loss"]

    grads = jax.jit(jax.grad(loss_fn))(trainable)
    return {k: v.numpy() for k, v in state_dict_from_jax(
        {k: np.asarray(v) for k, v in grads.items()},
        depth=jc.model.vit.depth).items()}


def _jax_tp_step(name, weights, world):
    """The JAX StepBuilder's step over make_mesh(2) on `world` devices
    (use_tp): its metrics and parameters, in the port's names."""
    import jax
    import jax.numpy as jnp

    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu.parallel import mesh as mesh_lib
    from wildlifemapper_tpu.train import step as jstep
    from wildlifemapper_tpu_torch.weights import state_dict_from_jax

    from tests.torch_common import flat_numpy

    jc = step_config(jcfg, name, TP)
    mesh = mesh_lib.make_mesh(TP, devices=jax.devices()[:world])
    builder = jstep.StepBuilder(jc, mesh=mesh, use_tp=True)
    state = builder.place(builder.init_state(_jax_params(name, weights),
                                             steps_per_epoch=4))
    jbatch = {k: jnp.asarray(v) for k, v in step_batch().items()}
    new, metrics = builder.jit_train_step()(state, jbatch,
                                            jax.random.PRNGKey(1))
    new_params = {k: v.numpy() for k, v in state_dict_from_jax(
        flat_numpy(new.params), depth=jc.model.vit.depth).items()}
    return {k: float(v) for k, v in metrics.items()}, new_params


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Both worlds' ranks, started: (processes by world, weights, their
    directory). They run while `references` is made."""
    base = tmp_path_factory.mktemp("tp")
    weights = {name: seeded_weights(name)
               for name in ("fine_tune", "from_scratch")}
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    try:
        for world in WORLDS:
            out = base / f"world{world}"
            out.mkdir()
            for name, w in weights.items():
                np.savez(out / f"weights_{name}.npz", **w)
            port = free_port()
            procs[world] = [subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 "--port", str(port), "--rank", str(r), "--world",
                 str(world), "--out", str(out)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=str(REPO)) for r in range(world)]
        yield procs, weights, base
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.communicate()


@pytest.fixture(scope="module")
def references(spawned):
    """The port's one-process steps, the JAX TP steps and the JAX gradient,
    made while the ranks run."""
    _, weights, _ = spawned
    one = {name: _one_process(name, weights[weights_config(name)], STEPS)
           for name in ("fine_tune", "from_scratch", "fine_tune_dropout",
                        "grouped")}
    # XLA compiles outside the GIL: the six compiles in threads
    names = ("fine_tune", "from_scratch")
    with ThreadPoolExecutor(6) as pool:
        grads = {n: pool.submit(_jax_grads, n, weights[n]) for n in names}
        steps = {(n, w): pool.submit(_jax_tp_step, n, weights[n], w)
                 for n in names for w in WORLDS}
        jax_ref = {(n, w): (*f.result(), grads[n].result())
                   for (n, w), f in steps.items()}
    return one, jax_ref


@pytest.fixture(scope="module")
def ranks(spawned, references):
    """Each world's results: {world: [(json, npz) a rank]}, with the
    weights and the directory they ran in."""
    procs, weights, base = spawned
    results = {}
    for world, ps in procs.items():
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in ps]
        for p, log in zip(ps, logs):
            assert p.returncode == 0, log[-4000:]
        out = base / f"world{world}"
        results[world] = [(json.loads((out / f"rank{r}.json").read_text()),
                           dict(np.load(out / f"rank{r}.npz")))
                          for r in range(world)]
    return results, weights, base


def _assert_step_matches(metrics, params, grads, want_metrics, want_params,
                         want_grads, what):
    """tests/test_torch_distributed.py's tolerances of record; the updated
    parameters are held where the gradient exceeds its own atol (1e-5).
    Adam's first step moves a parameter by lr * g / (|g| + eps), so a
    gradient within its tolerance of 0 leaves the direction and size of
    its update undetermined: the split sums change the gradient of record's
    smallest elements by ~1e-7 (one of 1952 of the decoder MLP's lin1
    weights, |g| ~ 2e-6, moved by 2e-6 against 2e-7)."""
    for k in LOSSES + ("grad_norm",):
        np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what}: {k}")
    assert set(grads) == set(want_grads), what
    checked = 0
    for n, g in grads.items():
        np.testing.assert_allclose(g, want_grads[n], atol=1e-5, rtol=1e-3,
                                   err_msg=f"{what}: grad {n}")
        clear = np.abs(want_grads[n]) > 1e-5
        checked += int(clear.sum())
        np.testing.assert_allclose(params[n][clear], want_params[n][clear],
                                   atol=2e-7, rtol=1e-6,
                                   err_msg=f"{what}: param {n}")
    assert checked > 1000, what
    for n in set(params) - set(grads):          # frozen: unchanged
        np.testing.assert_array_equal(params[n], want_params[n], err_msg=n)


def _gathered(arrays, tag):
    params = {k.split("/", 2)[2]: v for k, v in arrays.items()
              if k.startswith(f"{tag}/param/")}
    grads = {k.split("/", 2)[2]: v for k, v in arrays.items()
             if k.startswith(f"{tag}/grad/")}
    return params, grads


# ---- the sharding rules, in one process ----------------------------------------

def _tiny_model(heads=2, name="fine_tune"):
    """The tiny model with `heads` heads of 32 in the ViT blocks."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.models import WildlifeMapper

    cfg = step_config(tcfg, name).model
    if heads != 2:
        cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
            cfg.vit, num_heads=heads, embed_dim=32 * heads))
    return WildlifeMapper(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")


@pytest.mark.parametrize("ranks_", [2, 4])
def test_shard_then_gather_is_the_identity(ranks_):
    """shard_params / gather_params round-trip bit for bit on the port's
    whole state dict, and a rank's qkv holds [q, k, v] of its heads."""
    from wildlifemapper_tpu_torch.parallel import mesh

    model = _tiny_model(heads=4)
    sd = model.state_dict()
    specs = mesh.param_pspec(model, ranks_)
    shards = [mesh.shard_params(sd, specs, r, ranks_) for r in range(ranks_)]
    back = mesh.gather_params(shards, specs)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    qkv = "image_encoder.blocks.0.attn.qkv.weight"
    width = 128 // ranks_
    for r, s in enumerate(shards):
        assert s[qkv].shape == (3 * width, 128)
        for part in range(3):
            want = sd[qkv][part * 128 + r * width:
                           part * 128 + (r + 1) * width]
            assert torch.equal(s[qkv][part * width:(part + 1) * width], want)


def test_rules_split_the_dim_the_jax_rules_name():
    """Every parameter the JAX param_pspec splits is split here, on the
    torch dim its flax kernel's axis maps to through weights.py's name map
    (the kernel transposed), and nothing else is."""
    import jax
    from jax.sharding import PartitionSpec as P

    from wildlifemapper_tpu import config as jcfg
    from wildlifemapper_tpu.models import WildlifeMapper as JaxWildlifeMapper
    from wildlifemapper_tpu.parallel import mesh as jmesh
    from wildlifemapper_tpu_torch.parallel import mesh
    from flax import traverse_util

    from wildlifemapper_tpu_torch.weights import state_dict_from_jax

    jc = step_config(jcfg).model
    shapes = jax.eval_shape(JaxWildlifeMapper(jc).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    specs = jmesh.param_pspec(shapes["params"])
    flat_specs = traverse_util.flatten_dict(
        specs, sep="/", is_leaf=lambda _, x: isinstance(x, P))
    flat_shapes = traverse_util.flatten_dict(shapes["params"], sep="/")
    # each kernel marked by its index along the split axis
    marked = {}
    for k, s in flat_specs.items():
        shape = flat_shapes[k].shape
        axis = [i for i, a in enumerate(s) if a is not None]
        assert len(axis) <= 1, k
        arr = np.zeros(shape, np.float32)
        if axis:
            idx = [1] * len(shape)
            idx[axis[0]] = shape[axis[0]]
            arr = arr + np.arange(shape[axis[0]], dtype=np.float32).reshape(
                idx) + 1.0
        marked[k] = arr
    sd = state_dict_from_jax(marked, depth=jc.vit.depth)
    ours = mesh.param_pspec(_tiny_model(), TP)
    assert sorted(ours) == sorted(sd)
    for name, t in sd.items():
        varying = [d for d in range(t.dim())
                   if t.dim() and (t != t.select(d, 0).unsqueeze(d)).any()]
        if not t.any():
            assert ours[name] is None, name
            continue
        assert ours[name] is not None, name
        assert varying == [ours[name].dim], (name, varying, ours[name])


def test_heads_that_do_not_divide_keep_the_pair_whole():
    """3 heads of 32 at P = 2: qkv and proj both stay whole (the JAX
    package's per-dimension check would split both, qkv's 288 columns
    through the middle of a head of k); the MLP, whose hidden width
    divides, is still split, and so is the adaptor. At P = 3 nothing of 4
    heads, 2 adaptor heads or a hidden width of 512 splits."""
    from wildlifemapper_tpu_torch.parallel import mesh

    specs = mesh.param_pspec(_tiny_model(heads=4), 3)
    assert not any(specs.values())
    specs = mesh.param_pspec(_tiny_model(heads=3), 2)
    b0 = "image_encoder.blocks.0."
    for k in ("attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight"):
        assert specs[b0 + k] is None, k
    assert specs[b0 + "mlp.lin1.weight"] == mesh.Split(0)
    assert specs[b0 + "mlp.lin2.weight"] == mesh.Split(1)
    assert specs["image_encoder.hfc_attn.cross_attn.in_proj_weight"] == \
        mesh.Split(0, 3)


@pytest.mark.parametrize("layout", ["packed", "grouped"])
def test_split_layers_run_the_kernels_at_a_ranks_shapes(monkeypatch, layout):
    """A split model (rank 0 of 2; no group, so the sums are left out) hands
    the kernels' wrappers a rank's shapes: K1 / K2 (K5 / K6) half the heads
    of the packed qkv, K3 half the hidden width with a zero fc2 bias, K4
    half the adaptor's heads. No library call stands in for them."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.models import adaptor, common, vit
    from wildlifemapper_tpu_torch.models import WildlifeMapper
    from wildlifemapper_tpu_torch.parallel import mesh

    cfg = step_config(tcfg).model
    # windows of 2 x 2 go to the windowed kernel, the 4 x 4 grid to the
    # global one
    cfg = dataclasses.replace(cfg, use_flash_attention=True, attn_impl=layout,
                              vit=dataclasses.replace(cfg.vit, window_size=2))
    monkeypatch.setattr(vit, "GLOBAL_N_THRESHOLD", 8)
    model = WildlifeMapper(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    mesh.shard_model(model, mesh.Mesh(None, None, None, 1, TP, 0, 0))
    calls = []

    def recording(mod, name, what):
        wrapper = getattr(mod, name)

        def call(*args):
            calls.append((name, what(*args)))
            return wrapper(*args)
        monkeypatch.setattr(mod, name, call)

    packed = lambda qkv, rh, rw, scale, heads, hw: (qkv.shape[-1], heads)
    grouped = lambda q, k, v, rh, rw, scale, hw: (q.shape[0], q.shape[-1])
    recording(vit, "windowed_attention_packed", packed)
    recording(vit, "flash_attention_packed", packed)
    recording(vit, "windowed_attention_rel_pos", grouped)
    recording(vit, "flash_attention_rel_pos", grouped)
    recording(common, "fused_mlp", lambda x, w1, b1, w2, b2: (
        tuple(w1.shape), tuple(w2.shape), bool(b2.eq(0).all())))
    recording(adaptor, "cross_attention_packed",
              lambda q, k, v, scale, heads: (q.shape[-1], heads))
    with torch.no_grad():
        model(torch.zeros(1, 64, 64, 3))
    got = dict(calls)
    if layout == "packed":
        assert got["windowed_attention_packed"] == (3 * 32, 1)
        assert got["flash_attention_packed"] == (3 * 32, 1)
        assert got["fused_mlp"] == ((128, 64), (64, 128), True)
    else:
        # a window-head a batch row: 4 windows of one head of 32
        assert got["windowed_attention_rel_pos"] == (4, 32)
        assert got["flash_attention_rel_pos"] == (1, 32)
        assert "fused_mlp" not in got
    assert got["cross_attention_packed"] == (16, 1)


def test_a_model_axis_needs_its_ranks():
    """make_mesh(P > 1) asks for P ranks when there is no process group."""
    from wildlifemapper_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="run a multiple of 2 processes"):
        mesh.make_mesh(2)


# ---- the ranks against JAX and one process ----------------------------------------

def test_grid_layout(ranks):
    """2 x 2: model groups {0, 1}, {2, 3}; data groups {0, 2}, {1, 3}."""
    results, _, _ = ranks
    for world in WORLDS:
        for r, (res, _) in enumerate(results[world]):
            assert res["model_size"] == TP
            assert res["data_size"] == world // TP
            assert res["model_rank"] == r % TP
            assert res["data_rank"] == r // TP
            base = r - r % TP
            assert res["model_members"] == list(range(base, base + TP))
            assert res["data_members"] == list(range(r % TP, world, TP))


@pytest.mark.parametrize("name", ["fine_tune", "from_scratch"])
@pytest.mark.parametrize("world", WORLDS)
def test_tp_step_matches_jax_and_one_process(ranks, references, world, name):
    """The gathered first step at P = 2 equals the JAX TP step and the
    port's one-process step; num_boxes is the global batch's."""
    results, _, _ = ranks
    one, jax_ref = references
    res, arrays = results[world][0]
    metrics = res[name]["metrics"][0]
    assert metrics["num_boxes"] == sum(VALID_COUNTS)
    params, grads = _gathered(arrays, name)
    assert res[name]["split"], "no parameter was split"
    _assert_step_matches(metrics, params, grads, *one[name][:3],
                         f"port one process ({name}, world {world})")
    _assert_step_matches(metrics, params, grads, *jax_ref[(name, world)],
                         f"JAX TP step ({name}, world {world})")


@pytest.mark.parametrize("name", ["fine_tune_dropout", "grouped"])
def test_tp_step_matches_one_process(ranks, references, name):
    """The fine-tune with the adaptor's dropout 0.1 (every head's mask drawn
    from the data rank's generator, this rank's heads kept) and the grouped
    layout equal the one-process step, over STEPS steps."""
    results, _, _ = ranks
    one, _ = references
    res, arrays = results[2][0]
    params, grads = _gathered(arrays, name)
    _assert_step_matches(res[name]["metrics"][0], params, grads,
                         *one[name][:3], f"port one process ({name})")
    for got, want in zip(res[name]["metrics"], one[name][3]):
        for k in LOSSES + ("grad_norm",):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name}: {k}")


def test_moments_follow_their_shard(ranks):
    """The JAX test's own assertion (tests/test_train_loop.py:145-152) on the
    adaptor's q-projection: its moments have the rank's shard's shape."""
    results, _, _ = ranks
    for world in WORLDS:
        for res, _ in results[world]:
            m = res["moments"]
            assert m["param"] == [3 * 32 // TP, 32]
            assert m["moments"] == {"exp_avg": m["param"],
                                    "exp_avg_sq": m["param"]}


@pytest.mark.parametrize("world", WORLDS)
def test_whole_parameters_in_lock_step(ranks, world):
    """After STEPS steps every whole parameter (LayerNorms, rel-pos tables,
    patch embed, neck, row splits' biases, heads) is bit-identical on every
    rank, and each split one on the ranks of its model index."""
    results, _, _ = ranks
    rs = [res for res, _ in results[world]]
    for case, _, worlds in STEP_CASES:
        if world not in worlds:
            continue
        split = set(rs[0][case]["split"])
        assert "image_encoder.blocks.0.attn.rel_pos_h" not in split
        for n, h in rs[0][case]["digests"].items():
            for r in rs[1:]:
                if n not in split:
                    assert r[case]["digests"][n] == h, (case, n, r["rank"])
                elif r["model_rank"] == 0:
                    assert r[case]["digests"][n] == h, (case, n, r["rank"])


def test_control_bias_on_one_rank_breaks_the_gradient(ranks, references):
    """Undoing design point 2 (a row split's bias added by model rank 0
    alone): the forward is unchanged, but rank 1's bias gets no gradient,
    so its bias and the step no longer match one process."""
    results, _, _ = ranks
    one, _ = references
    (r0, _), (r1, _) = results[2]
    ctl0, ctl1 = r0["control_rank0_bias"], r1["control_rank0_bias"]
    good0, good1 = r0["fine_tune"], r1["fine_tune"]
    bias = "mask_decoder.transformer.layers.0.self_attn.out_proj.bias"
    assert good0["local_grads"][bias] == good1["local_grads"][bias]
    assert bias in ctl0["local_grads"] and bias not in ctl1["local_grads"]
    assert ctl0["digests"][bias] != ctl1["digests"][bias]
    np.testing.assert_allclose(ctl0["metrics"][0]["loss"],
                               one["fine_tune"][0]["loss"], rtol=1e-4)


def test_control_world_normalisers_double_num_boxes(ranks):
    """Undoing the data group at 2 x 2 (the criterion's sums over the world):
    every row is counted by both ranks of its model group."""
    results, _, _ = ranks
    for res, _ in results[4]:
        good = res["fine_tune"]["metrics"][0]["num_boxes"]
        bad = res["control_world_normalisers"]["metrics"][0]["num_boxes"]
        assert good == sum(VALID_COUNTS)
        assert bad == 2 * good


def test_remat_issues_no_collective_in_the_recompute(ranks):
    """A step issues as many all-reduces over the model group with
    remat_blocks as without, and computes the same loss; the control, a
    remat segment that holds its sums over the group, issues more (its
    recompute sums again; a rank that did so alone would hang)."""
    results, _, _ = ranks
    for res, _ in results[2]:
        r = res["remat"]
        assert r["on"]["all_reduces"] == r["off"]["all_reduces"] > 0
        assert r["on"]["loss"] == r["off"]["loss"]
        assert r["held"]["all_reduces"] > r["off"]["all_reduces"]


def test_checkpoint_at_p2_resumes_at_p1_and_p2(ranks, tmp_path, monkeypatch):
    """The loop's checkpoint written at P = 2 (the one-process format)
    resumes at P = 2 with the unbroken run's epoch bit for bit, and in one
    process at P = 1 with its loss at the step tolerance."""
    from wildlifemapper_tpu_torch import config as tcfg
    from wildlifemapper_tpu_torch.train import loop as tloop

    monkeypatch.setenv("WM_SYNTH_CACHE", "0")
    results, _, base = ranks
    (r0, _), (r1, _) = results[2]
    for r in (r0, r1):
        assert r["loop"]["resumed"] == r["loop"]["unbroken"]
    raw = torch.load(base / "world2" / "at_p1" / "checkpoint_epoch_0",
                     map_location="cpu", weights_only=True)
    whole = _tiny_model().state_dict()
    assert {k: tuple(v.shape) for k, v in raw["model"].items()} == {
        k: tuple(v.shape) for k, v in whole.items()}
    work = tmp_path / "p1"
    shutil.copytree(base / "world2" / "at_p1", work)
    at_p1 = tloop.train(loop_config(tcfg), workdir=str(work), epochs=2,
                        resume=True, device="cpu",
                        print_fn=lambda *a, **k: None, **LOOP)
    want = r0["loop"]["unbroken"]
    np.testing.assert_allclose(at_p1["train/loss"], want["train/loss"],
                               rtol=1e-4)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--cli", action="store_true")
    parser.add_argument("--port", type=int)
    parser.add_argument("--rank", type=int)
    parser.add_argument("--world", type=int)
    parser.add_argument("--argv")
    parser.add_argument("--out", required=True)
    parsed = parser.parse_args()
    cli_worker(parsed) if parsed.cli else worker(parsed)
