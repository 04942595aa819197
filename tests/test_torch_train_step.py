"""The port's optimizer and train / eval steps (train/optimizer.py,
train/step.py) against the JAX package's, at a tiny width (2 blocks, width
64, grid 8), float32, same seeded weights and batch.

What is compared, and how tightly:
  * the optimizer alone, fed identical gradients from numpy over 6 updates
    across a warm-up boundary and an lr_drop boundary: parameters and Adam
    moments at atol 1e-6;
  * one whole train step: losses and grad_norm at rtol 1e-4, every
    trainable gradient at atol 1e-5 / rtol 1e-3. Updated parameters are
    compared only where |g| > 1e-6: after one Adam update the step is
    lr * g / (|g| + 1e-8), so an element whose gradient is rounding noise
    moves by up to 2 * lr in either package and says nothing;
  * one eval step with a padded batch: outputs at 1e-4, losses at rtol 1e-4.
Every comparison with the JAX package sets hfc.dropout = 0 (the two
generators cannot give the same mask); the dropout path is tested in the
port alone.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.models import vit as jvit
from wildlifemapper_tpu.train import optimizer as jopt
from wildlifemapper_tpu.train import step as jstep
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.models import WildlifeMapper, common
from wildlifemapper_tpu_torch.models import vit as tvit
from wildlifemapper_tpu_torch.train import optimizer as topt
from wildlifemapper_tpu_torch.train import step as tstep
from wildlifemapper_tpu_torch.train.synthetic import (synthetic_batch,
                                                      training_config)
from wildlifemapper_tpu_torch.weights import (load_adam_state,
                                              load_reference_state_dict,
                                              state_dict_from_jax)

from tests.torch_common import flat_numpy, perturbed, tiny_config, to_numpy

REPO = Path(__file__).resolve().parents[1]


def _configs(use_flash=False, dropout=0.0, **train):
    """The same tiny Config in both packages."""
    out = []
    for mod in (jcfg, tcfg):
        model = tiny_config(mod, use_flash_attention=use_flash)
        model = dataclasses.replace(
            model, hfc=dataclasses.replace(model.hfc, dropout=dropout))
        out.append(mod.Config(model=model, train=mod.TrainConfig(**train)))
    return out


def _jax_params(cfg, seed=4):
    builder = jstep.StepBuilder(cfg)
    params = perturbed(builder.init_params(jax.random.PRNGKey(0)),
                       np.random.default_rng(seed))
    return builder, params


def _port_state_dict(tree, depth=2):
    """A JAX tree shaped like the parameters -> the port's names/layouts."""
    return state_dict_from_jax(flat_numpy({"params": tree}), depth=depth)


def _batch(seed=0, b=2, t=6, counts=(4, 2), size=128, content=96):
    rng = np.random.default_rng(seed)
    image = np.zeros((b, size, size, 3), np.float32)
    image[:, :content, :content] = rng.normal(size=(b, content, content, 3))
    boxes = rng.uniform(0.15, 0.6, size=(b, t, 4)).astype(np.float32)
    boxes[..., 2:] *= 0.3
    return {"image": image,
            "labels": rng.integers(1, 7, size=(b, t)).astype(np.int32),
            "boxes": boxes,
            "valid": np.arange(t)[None, :] < np.asarray(counts)[:, None]}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _adam_moments(opt_state):
    """(mu, nu, count) of optax's two AdamW groups as flat numpy dicts."""
    mu, nu, count = {}, {}, None
    for group in opt_state[-1].inner_states.values():
        inner = group.inner_state
        if not inner or not hasattr(inner[0], "mu"):
            continue                      # the frozen group keeps no moments
        adam = inner[0]
        count = int(adam.count)
        for dst, tree in ((mu, adam.mu), (nu, adam.nu)):
            for k, v in traverse_util.flatten_dict(tree, sep="/").items():
                if hasattr(v, "shape"):   # masked-out leaves carry none
                    dst[k] = np.asarray(v)
    return mu, nu, count


# ---- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("freeze", [True, False])
def test_param_group_matches_jax_labels(freeze):
    """Every parameter of the port gets the group the JAX package gives the
    leaf it came from: a tree of label codes goes through
    state_dict_from_jax and must come out as the port's own labels."""
    jc, tc = _configs()
    _, params = _jax_params(jc)
    codes = {"main": 0.0, "hfc": 1.0, "frozen": 2.0}
    flat = traverse_util.flatten_dict(params["params"], sep="/")
    coded = {k: np.full(v.shape, codes[jopt.param_group(k, freeze)],
                        np.float32) for k, v in flat.items()}
    sd = state_dict_from_jax(coded, depth=jc.model.vit.depth)
    model = WildlifeMapper(tc.model, device="cpu")
    names = dict(model.named_parameters())
    assert set(names) <= set(sd) and len(names) > 50
    for name in list(names) + [
            "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]:
        want = np.unique(sd[name].numpy())
        assert want.tolist() == [codes[topt.param_group(name, freeze)]], name
    groups = topt.apply_freeze(model, freeze)
    assert all(not p.requires_grad for _, p in groups["frozen"])
    assert all(p.requires_grad for g in ("main", "hfc") for _, p in groups[g])
    assert bool(groups["frozen"]) == freeze


def test_lr_factor_boundaries():
    """The staircase per update, and the warm-up after which the decay's
    count restarts (optax.join_schedules)."""
    plain = topt.lr_factor(steps_per_epoch=3, lr_drop_epochs=2, factor=0.1)
    assert [plain(s) for s in (0, 5, 6, 11, 12)] == pytest.approx(
        [1, 1, 0.1, 0.1, 0.01])
    warm = topt.lr_factor(3, 2, 0.1, warmup_steps=4)
    assert [warm(s) for s in (0, 2, 3, 4, 9, 10)] == pytest.approx(
        [0, 0.5, 0.75, 1, 1, 0.1])
    sched = jopt.step_lr(1.0, 3, 2, 0.1, 4)
    for s in range(20):
        assert warm(s) == pytest.approx(float(sched(s)), rel=1e-6), s


@pytest.mark.parametrize("freeze", [True, False])
def test_optimizer_matches_optax(freeze):
    """Six updates fed the same gradients, across the warm-up boundary
    (2 updates) and an lr_drop boundary (2 epochs of 1 step after it), some
    above and some below the clipping norm: parameters, moments and the
    reported norm agree; frozen parameters never move."""
    train = dict(freeze_encoder=freeze, warmup_steps=2, lr_drop=2, lr=1e-2,
                 hfc_lr=3e-3, weight_decay=1e-2)
    jc, tc = _configs(**train)
    _, params = _jax_params(jc)
    tx = jopt.build_optimizer(params, jc.train, steps_per_epoch=1)
    opt_state = tx.init(params["params"])
    model = WildlifeMapper(tc.model, device="cpu")
    load_reference_state_dict(model, _port_state_dict(params["params"]))
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt, sched = topt.build_optimizer(model, tc.train, steps_per_epoch=1)
    named = dict(model.named_parameters())
    trainable = [n for n, p in named.items() if p.requires_grad]

    rng = np.random.default_rng(0)
    jparams = params["params"]
    for step, scale in enumerate([1e-4, 1e-2, 1e-5, 3e-3, 1e-2, 1e-6]):
        grads = jax.tree.map(
            lambda p: jnp.asarray(scale * rng.normal(size=p.shape)
                                  .astype(np.float32)), jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gsd = _port_state_dict(grads)
        for n in trainable:
            named[n].grad = gsd[n].clone()
        norm = topt.clip_by_global_norm_([named[n].grad for n in trainable],
                                         tc.train.clip_max_norm)
        want_norm = np.sqrt(sum(float((gsd[n] ** 2).sum()) for n in trainable))
        np.testing.assert_allclose(float(norm), want_norm, rtol=1e-5)
        opt.step()
        sched.step()
        want = _port_state_dict(jparams)
        for n, p in named.items():
            np.testing.assert_allclose(to_numpy(p), to_numpy(want[n]),
                                       atol=1e-6, err_msg=f"step {step} {n}")
    mu, nu, count = _adam_moments(opt_state)
    assert count == 6
    mu_sd, nu_sd = (state_dict_from_jax(m, depth=2) for m in (mu, nu))
    for n in trainable:
        st = opt.state[named[n]]
        assert int(st["step"]) == 6
        np.testing.assert_allclose(to_numpy(st["exp_avg"]),
                                   to_numpy(mu_sd[n]), atol=1e-6, err_msg=n)
        np.testing.assert_allclose(to_numpy(st["exp_avg_sq"]),
                                   to_numpy(nu_sd[n]), atol=1e-6, err_msg=n)
    for n, p in named.items():
        if not p.requires_grad:
            assert torch.equal(p, before[n]), n


def test_adam_state_crosses_from_optax():
    """Three optax updates, the moments carried into a fresh torch AdamW
    through state_dict_from_jax + load_adam_state, then one more update in
    both: the parameters agree at atol 1e-6."""
    jc, tc = _configs(freeze_encoder=False, lr=1e-2, hfc_lr=1e-2)
    _, params = _jax_params(jc)
    tx = jopt.build_optimizer(params, jc.train, steps_per_epoch=100)
    opt_state = tx.init(params["params"])
    rng = np.random.default_rng(1)
    jparams = params["params"]

    def grads_like(tree):
        return jax.tree.map(lambda p: jnp.asarray(
            1e-3 * rng.normal(size=p.shape).astype(np.float32)), tree)

    for _ in range(3):
        updates, opt_state = tx.update(grads_like(jparams), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    model = WildlifeMapper(tc.model, device="cpu")
    load_reference_state_dict(model, _port_state_dict(jparams))
    opt, _ = topt.build_optimizer(model, tc.train, steps_per_epoch=100)
    mu, nu, count = _adam_moments(opt_state)
    load_adam_state(opt, model.named_parameters(),
                    state_dict_from_jax(mu, depth=2),
                    state_dict_from_jax(nu, depth=2), count)
    grads = grads_like(jparams)
    updates, opt_state = tx.update(grads, opt_state, jparams)
    jparams = optax.apply_updates(jparams, updates)
    gsd = _port_state_dict(grads)
    for n, p in model.named_parameters():
        p.grad = gsd[n].clone()
    topt.clip_by_global_norm_([p.grad for p in model.parameters()],
                              tc.train.clip_max_norm)
    opt.step()
    want = _port_state_dict(jparams)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(to_numpy(p), to_numpy(want[n]), atol=1e-6,
                                   err_msg=n)


def test_clip_follows_optax_not_torch():
    g = [torch.full((4,), 3.0), torch.full((9,), -4.0)]     # norm 13.41...
    want = [t / 13.416407864998739 * 0.1 for t in g]
    norm = topt.clip_by_global_norm_(g, 0.1)
    assert float(norm) == pytest.approx(13.416407864998739, rel=1e-6)
    for a, b in zip(g, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    small = [torch.full((4,), 0.01)]
    topt.clip_by_global_norm_(small, 0.1)                   # below: untouched
    assert torch.equal(small[0], torch.full((4,), 0.01))


# ---- the steps ------------------------------------------------------------------

def _step_pair(monkeypatch, use_flash, freeze, **train):
    """Both packages' builders and states on the same weights. The global
    block (64 tokens) goes through K2 and the windows through K1."""
    monkeypatch.setattr(jvit, "GLOBAL_N_THRESHOLD", 32)
    monkeypatch.setattr(tvit, "GLOBAL_N_THRESHOLD", 32)
    jc, tc = _configs(use_flash=use_flash, freeze_encoder=freeze, **train)
    jb, params = _jax_params(jc)
    jstate = jb.init_state(params, steps_per_epoch=10)
    tb = tstep.StepBuilder(tc, device="cpu")
    load_reference_state_dict(tb.model, _port_state_dict(params["params"]))
    tstate = tb.init_state(steps_per_epoch=10)
    return jc, jb, jstate, tb, tstate


LOSSES = ("loss", "loss_ce", "loss_bbox", "loss_giou", "class_error",
          "cardinality_error", "num_boxes")


@pytest.mark.parametrize("use_flash,freeze", [(False, True), (True, True),
                                              (True, False), (False, False)])
def test_train_step_matches_jax(monkeypatch, use_flash, freeze):
    # no clipping here, so that the raw gradients stay in .grad
    jc, jb, jstate, tb, tstate = _step_pair(monkeypatch, use_flash, freeze,
                                            clip_max_norm=1e9)
    batch = _batch()
    params = jstate.params
    trainable, frozen = jstep._split_params(params, freeze)
    key = jax.random.PRNGKey(1)

    def loss_fn(tr):
        out = jb.model.apply(jstep._merge_params(tr, frozen),
                             jnp.asarray(batch["image"]), deterministic=False,
                             rngs={"dropout": key})
        tgt = {k: jnp.asarray(batch[k]) for k in ("labels", "boxes", "valid")}
        return jcrit_loss(out, tgt, jc)

    jgrads = jax.grad(loss_fn)(trainable)
    jnew, jmetrics = jax.jit(jb.train_step_fn())(jstate, _jax_batch(batch), key)

    launches = tvit.flash_attention_packed.launches
    _, tmetrics = tb.train_step(tstate, _torch_batch(batch))
    assert tvit.flash_attention_packed.launches == launches   # CPU: plain
    for k in LOSSES + ("grad_norm",):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert tstate.step == 1 == int(jnew.step)

    gsd = state_dict_from_jax({k: np.asarray(v) for k, v in jgrads.items()},
                              depth=2)
    named = dict(tb.model.named_parameters())
    want_p = _port_state_dict(jnew.params["params"])
    checked = 0
    for n, p in named.items():
        if not p.requires_grad:
            assert p.grad is None, n
            np.testing.assert_array_equal(to_numpy(p), to_numpy(want_p[n]))
            continue
        g = to_numpy(p.grad)
        np.testing.assert_allclose(g, to_numpy(gsd[n]), atol=1e-5, rtol=1e-3,
                                   err_msg=n)
        clear = np.abs(to_numpy(gsd[n])) > 1e-6
        checked += int(clear.sum())
        np.testing.assert_allclose(to_numpy(p)[clear],
                                   to_numpy(want_p[n])[clear], atol=2e-7,
                                   rtol=1e-6, err_msg=n)
    assert checked > 10000
    # the trainable groups below the blocks receive gradient through all of
    # them, frozen or not
    for prefix in topt.HFC_PREFIXES:
        total = sum(float(p.grad.abs().sum()) for n, p in named.items()
                    if n.startswith(prefix))
        assert total > 0, prefix


def jcrit_loss(out, tgt, jc):
    from wildlifemapper_tpu.train.criterion import set_criterion

    return set_criterion(out, tgt, jc.criterion,
                         num_classes=jc.model.num_classes)["loss"]


def test_train_step_clip_ema_and_second_step(monkeypatch):
    """With the default clip (0.1) and an EMA: grad_norm is the norm before
    clipping, and two consecutive steps keep losses and EMA in agreement."""
    jc, jb, jstate, tb, tstate = _step_pair(monkeypatch, True, True,
                                            ema_decay=0.9)
    batch = _batch(seed=3)
    step = jax.jit(jb.train_step_fn())
    key = jax.random.PRNGKey(0)
    for i in range(2):
        jstate, jmetrics = step(jstate, _jax_batch(batch), key)
        tstate, tmetrics = tb.train_step(tstate, _torch_batch(batch))
        for k in ("loss", "grad_norm"):
            # the second step sees parameters that differ by Adam's noise
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                       rtol=1e-4 if i == 0 else 1e-3,
                                       err_msg=f"step {i} {k}")
    assert float(tmetrics["grad_norm"]) > tb.cfg.train.clip_max_norm
    want = _port_state_dict(jstate.ema_params["params"])
    got = tstate.ema_params
    assert set(got) == set(dict(tb.model.named_parameters()))
    for n in got:
        # 0.19 of two updates of at most 2 * lr each
        np.testing.assert_allclose(to_numpy(got[n]), to_numpy(want[n]),
                                   atol=1e-4, err_msg=n)
    moved = sum(not torch.equal(got[n], p.detach())
                for n, p in tb.model.named_parameters() if p.requires_grad)
    assert moved > 0


def test_eval_step_matches_jax(monkeypatch):
    jc, jb, jstate, tb, tstate = _step_pair(monkeypatch, True, True)
    batch = _batch(seed=5, b=3, counts=(4, 2, 5))
    batch["batch_valid"] = np.array([True, True, False])
    jout, jlosses = jax.jit(jb.eval_step_fn())(jstate.params,
                                               _jax_batch(batch))
    tout, tlosses = tb.eval_step(tstate.model, _torch_batch(batch))
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(to_numpy(tout[k]), np.asarray(jout[k]),
                                   atol=1e-4, rtol=1e-3)
    for k in LOSSES:
        np.testing.assert_allclose(float(tlosses[k]), float(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert not tlosses["loss"].requires_grad


def test_device_normalize_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(2, 32, 40, 3), dtype=np.uint8)
    sizes = np.array([[20, 40], [32, 17]], np.int32)
    want = np.asarray(jstep._device_normalize(jnp.asarray(img),
                                              jnp.asarray(sizes)))
    got = tstep.device_normalize(torch.from_numpy(img),
                                 torch.from_numpy(sizes))
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-6)
    assert float(got[0, 20:].abs().max()) == 0.0          # the pad band
    f = torch.randn(1, 4, 4, 3)
    assert tstep.device_normalize(f) is f                 # floats pass through


# ---- the port alone ---------------------------------------------------------------

def test_dropout_path_is_seeded():
    """hfc.dropout = 0.1: the same generator seed gives the same loss, another
    seed a different one; kept elements are scaled by 1 / (1 - rate)."""
    _, tc = _configs(dropout=0.1)
    tb = tstep.StepBuilder(tc, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    batch = _torch_batch(_batch())

    def loss(seed):
        out = tb.model(batch["image"], deterministic=False,
                       generator=torch.Generator().manual_seed(seed))
        return float(tstep.set_criterion(out, batch,
                                         tc.criterion)["loss"].detach())

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    with pytest.raises(ValueError, match="Generator"):
        tb.model(batch["image"], deterministic=False)
    x = torch.ones(200, 200)
    y = common.dropout(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(1 / 0.75))
    assert abs(float(kept.float().mean()) - 0.75) < 0.02
    assert common.dropout(x, 0.25, True, None) is x


def test_frozen_parameters_get_no_gradient_and_never_move():
    _, tc = _configs(dropout=0.1, freeze_encoder=True)
    tb = tstep.StepBuilder(tc, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    state = tb.init_state(steps_per_epoch=5)
    before = {n: p.detach().clone() for n, p in tb.model.named_parameters()}
    gen = torch.Generator().manual_seed(1)
    _, metrics = tb.train_step(state, _torch_batch(_batch()), gen)
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    for n, p in tb.model.named_parameters():
        if topt.param_group(n, True) == "frozen":
            assert p.grad is None and torch.equal(p, before[n]), n
        else:
            assert p.grad is not None and not torch.equal(p, before[n]), n


def test_uint8_batch_trains_in_bf16_with_aux():
    """The loader's uint8 batch (device_normalize) through a bf16 step with
    deep supervision: f32 parameters, finite f32 losses, aux terms present."""
    batch = synthetic_batch(2, seed=0, canvas=128, content=96, max_targets=8,
                            min_boxes=1, max_boxes=5)
    assert batch["image"].dtype == np.uint8 and batch["valid"].any()
    model = dataclasses.replace(
        tiny_config(tcfg, dtype="bfloat16"),
        decoder=dataclasses.replace(tiny_config(tcfg).decoder, aux_loss=True))
    tb = tstep.StepBuilder(tcfg.Config(model=model),
                           generator=torch.Generator().manual_seed(0),
                           device="cpu")
    state = tb.init_state(steps_per_epoch=5)
    _, metrics = tb.train_step(state, _torch_batch(batch),
                               torch.Generator().manual_seed(1))
    assert "loss_ce_0" in metrics
    assert all(v.dtype == torch.float32 and torch.isfinite(v)
               for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in tb.model.parameters())


def test_training_configs():
    fine, scratch = (training_config(n) for n in ("fine_tune", "from_scratch"))
    assert fine.train.freeze_encoder and fine.model.hfc.dropout == 0.1
    assert fine.model.content_size is None
    assert not scratch.train.freeze_encoder and scratch.model.hfc.dropout == 0
    assert scratch.model.crop_prologue and scratch.model.vit.window_size == 12
    assert fine.data.device_normalize and fine.model.use_flash_attention
    with pytest.raises(ValueError):
        training_config("other")


def test_remat_leaves_the_serving_output_bit_identical():
    """remat_blocks only changes what a backward keeps: the same weights
    serve the same detections to the bit, under inference_mode and with
    gradients on, and a training forward runs (tests/test_torch_remat.py
    holds its gradients)."""
    x = torch.randn(2, 128, 128, 3, generator=torch.Generator().manual_seed(1))
    outs = {}
    for remat in (False, True):
        model = WildlifeMapper(tiny_config(tcfg, remat_blocks=remat),
                               generator=torch.Generator().manual_seed(0),
                               device="cpu")
        with torch.inference_mode():
            served = model(x)
        outs[remat] = (served, model(x))
        model(x, deterministic=False,
              generator=torch.Generator().manual_seed(2))["pred_boxes"].sum(
              ).backward()
    for (a, b) in zip(outs[False], outs[True]):
        for k in ("pred_logits", "pred_boxes"):
            assert torch.equal(a[k], b[k]), k
    assert outs[True][1]["pred_boxes"].requires_grad


def test_default_device_is_the_card():
    """Without a device argument the model and the step builder go to the
    card and raise where there is none; device='cpu' is the only way onto
    the CPU."""
    if torch.cuda.is_available():
        assert next(WildlifeMapper(tiny_config(tcfg)).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        WildlifeMapper(tiny_config(tcfg))
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tstep.StepBuilder(tcfg.Config(model=tiny_config(tcfg)))
    same = [WildlifeMapper(tiny_config(tcfg), device="cpu",
                           generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    for a, b in zip(same[0].parameters(), same[1].parameters()):
        assert a.device.type == "cpu" and torch.equal(a, b)


BANNED = {"jax", "jaxlib", "flax", "optax", "PIL", "wildlifemapper_tpu"}
# The machine with the card has no PIL: only the functions that decode a real
# image file or draw detection overlays import it, when they are called
# (tests/test_torch_data.py imports the loop and the CLIs with PIL blocked,
# tests/test_torch_mosaic.py the orthomosaic slice and the drawing CLIs).
PIL_INSIDE = {"decode_image", "draw_detections", "render_detections",
              "decode_mosaic", "render_sample", "render_overlay",
              "probe_image_size"}


def _imports(path: Path):
    """(module, name of the function the import sits in or None) of each
    absolute import of a file."""
    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
            elif isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name, fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, fn
            else:
                yield from walk(child, fn)
    yield from walk(ast.parse(path.read_text()), None)


def test_port_sources_import_no_jax():
    """No module of the port, nor the smoke test or a script of the port
    (one that names the port's package), imports jax, flax, optax or the
    JAX package, nor PIL outside the functions that decode an image file or
    draw overlays (walked with ast, so imports inside functions count
    too)."""
    files = sorted((REPO / "wildlifemapper_tpu_torch").rglob("*.py"))
    scripts = [p for p in sorted((REPO / "scripts").glob("*.py"))
               if "wildlifemapper_tpu_torch" in p.read_text()]
    assert {"profile_port.py", "profile_loop.py"} <= {p.name for p in scripts}
    files += [REPO / "chip_smoke.py", *scripts]
    assert len(files) > 25
    for path in files:
        bad = {m for m, fn in _imports(path) if m.split(".")[0] in BANNED
               and not (m.split(".")[0] == "PIL" and fn in PIL_INSIDE)}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_no_backward_raises_not_implemented():
    """Every kernel of the port has its backward: nothing under ops/ still
    refuses one."""
    for path in (REPO / "wildlifemapper_tpu_torch" / "ops").glob("*.py"):
        text = path.read_text()
        assert "no_backward" not in text, path.name
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.FunctionDef) and node.name == "backward":
                raises = [n for n in ast.walk(node)
                          if isinstance(n, ast.Raise)]
                assert not raises, f"{path.name}: backward raises"
