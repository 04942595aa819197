"""The port's matcher and set criterion (ops/lsap.py, ops/boxes.py,
train/criterion.py) against the JAX package's on the same seeded numpy
inputs, and against the PyTorch reference's captured losses
(tests/goldens/criterion.npz).

Tolerances: assignments exactly (seeded continuous costs have no ties;
a case built with ties compares total cost); losses against the JAX
criterion at rtol 1e-5 / atol 1e-6 (f32, the same formulas); against the
goldens at rtol 1e-5 (the JAX golden test allows 1e-4,
tests/test_goldens.py:132; the port's losses sit within 3e-7); loss
gradients at atol 1e-6.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from scipy.optimize import linear_sum_assignment

from wildlifemapper_tpu import config as jcfg
from wildlifemapper_tpu.ops import boxes as jboxes
from wildlifemapper_tpu.ops import lsap as jlsap
from wildlifemapper_tpu.train import criterion as jcrit
from wildlifemapper_tpu_torch import config as tcfg
from wildlifemapper_tpu_torch.ops import boxes as tboxes
from wildlifemapper_tpu_torch.ops import lsap as tlsap
from wildlifemapper_tpu_torch.train import criterion as tcrit

from tests.torch_common import to_numpy, to_torch


def _problem(seed, b, q, t, counts, num_logits=8):
    """Seeded predictions and padded targets; counts[i] valid targets in
    image i."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, q, num_logits)).astype(np.float32)
    pboxes = rng.uniform(0.1, 0.9, size=(b, q, 4)).astype(np.float32)
    pboxes[..., 2:] *= 0.3
    labels = rng.integers(1, num_logits - 1, size=(b, t)).astype(np.int32)
    tb = rng.uniform(0.1, 0.9, size=(b, t, 4)).astype(np.float32)
    tb[..., 2:] *= 0.3
    valid = np.arange(t)[None, :] < np.asarray(counts)[:, None]
    return logits, pboxes, labels, tb, valid


def _jax_io(logits, pboxes, labels, tb, valid):
    return ({"pred_logits": jnp.asarray(logits),
             "pred_boxes": jnp.asarray(pboxes)},
            {"labels": jnp.asarray(labels), "boxes": jnp.asarray(tb),
             "valid": jnp.asarray(valid)})


def _torch_io(logits, pboxes, labels, tb, valid):
    return ({"pred_logits": to_torch(logits), "pred_boxes": to_torch(pboxes)},
            {"labels": torch.from_numpy(labels.astype(np.int64)),
             "boxes": to_torch(tb), "valid": torch.from_numpy(valid)})


def test_giou_matches_jax(rng):
    a = rng.uniform(0.0, 1.0, size=(3, 9, 4)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, size=(3, 9, 4)).astype(np.float32)
    b[0, 0] = a[0, 0]                      # identical boxes
    a[1, 1] = [0.5, 0.5, 0.0, 0.0]         # degenerate: zero area
    ja, jb = (jboxes.box_cxcywh_to_xyxy(jnp.asarray(t)) for t in (a, b))
    ta, tb_ = (tboxes.box_cxcywh_to_xyxy(to_torch(t)) for t in (a, b))
    np.testing.assert_allclose(
        to_numpy(tboxes.generalized_box_iou_pairwise(ta, tb_)),
        np.asarray(jboxes.generalized_box_iou_pairwise(ja, jb)), atol=1e-5)
    np.testing.assert_allclose(
        to_numpy(tboxes.generalized_box_iou_aligned(ta, tb_)),
        np.asarray(jboxes.generalized_box_iou_aligned(ja, jb)), atol=1e-5)
    # differentiable, degenerate boxes included
    ta.requires_grad_()
    tboxes.generalized_box_iou_aligned(ta, tb_).sum().backward()
    assert torch.isfinite(ta.grad).all()


@pytest.mark.parametrize("q,t", [(7, 5), (7, 12), (6, 6)])
def test_matching_cost_pad_matches_jax(q, t):
    rng = np.random.default_rng(q * 10 + t)
    cost = rng.normal(size=(3, q, t)).astype(np.float32)
    valid = rng.random((3, t)) > 0.3
    want = np.asarray(jlsap.matching_cost_pad(jnp.asarray(cost),
                                              jnp.asarray(valid)))
    got = tlsap.matching_cost_pad(to_torch(cost), torch.from_numpy(valid))
    np.testing.assert_array_equal(to_numpy(got), want)


def _total(cost, row_to_col):
    return float(cost[np.arange(cost.shape[0]), row_to_col].sum())


@pytest.mark.parametrize("n", [5, 17, 40])
def test_solve_lsap_is_optimal(n):
    """On seeded continuous costs the optimum is unique: the port's solver,
    the JAX solver and scipy agree exactly."""
    cost = np.random.default_rng(n).normal(size=(3, n, n)).astype(np.float32)
    got = tlsap.solve_lsap(to_torch(cost)).numpy()
    want = np.asarray(jlsap.solve_lsap(jnp.asarray(cost)))
    np.testing.assert_array_equal(got, want)
    for i in range(3):
        np.testing.assert_array_equal(got[i],
                                      linear_sum_assignment(cost[i])[1])


def test_solve_lsap_ties_nan_and_n_rows():
    # ties: integer costs, many optima; the total cost must be the optimum
    rng = np.random.default_rng(1)
    cost = rng.integers(0, 3, size=(2, 9, 9)).astype(np.float32)
    got = tlsap.solve_lsap(to_torch(cost)).numpy()
    want = np.asarray(jlsap.solve_lsap(jnp.asarray(cost)))
    for i in range(2):
        assert sorted(got[i]) == list(range(9))
        assert _total(cost[i], got[i]) == _total(cost[i], want[i])
    # non-finite entries are sanitised, not raised on (scipy alone raises)
    bad = rng.normal(size=(1, 6, 6)).astype(np.float32)
    bad[0, 2, 3], bad[0, 4, 1], bad[0, 0, 0] = np.nan, np.inf, -np.inf
    got = tlsap.solve_lsap(to_torch(bad)).numpy()
    want = np.asarray(jlsap.solve_lsap(jnp.asarray(bad)))
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 0 and got[0, 2] != 3 and got[0, 4] != 1
    # n_rows: the first rows optimally against all columns; a permutation
    cost = rng.normal(size=(2, 8, 8)).astype(np.float32)
    got = tlsap.solve_lsap(to_torch(cost), 3).numpy()
    want = np.asarray(jlsap.solve_lsap(jnp.asarray(cost), 3))
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    for i in range(2):
        assert sorted(got[i]) == list(range(8))
        np.testing.assert_array_equal(
            got[i, :3], linear_sum_assignment(cost[i, :3])[1])


@pytest.mark.parametrize("q,t,counts", [
    (7, 16, (3, 0, 7)),          # fewer targets than queries, one image empty
    (51, 64, (60, 51, 5)),       # T > Q: targets beyond the 51 queries
    (7, 5, (5, 5, 5)),           # every slot valid
    (9, 12, (0, 0, 0)),          # no target at all
])
def test_hungarian_match_matches_jax(q, t, counts):
    prob = _problem(q + t, 3, q, t, counts)
    cfg_j, cfg_t = jcfg.MatchCriterionConfig(), tcfg.MatchCriterionConfig()
    jcols, jmatched = jcrit.hungarian_match(*_jax_io(*prob), cfg_j)
    tcols, tmatched = tcrit.hungarian_match(*_torch_io(*prob), cfg_t)
    jmatched, tmatched = np.asarray(jmatched), tmatched.numpy()
    np.testing.assert_array_equal(tmatched, jmatched)
    np.testing.assert_array_equal(tcols.numpy()[tmatched],
                                  np.asarray(jcols)[jmatched])
    assert tmatched.sum(1).tolist() == [min(c, q) for c in counts]


def test_hungarian_match_with_holes_and_nan():
    """Valid slots need not be a prefix; a NaN logit must not raise."""
    logits, pboxes, labels, tb, valid = _problem(5, 2, 7, 10, (10, 10))
    valid[0, [1, 4, 5]] = False
    valid[1, :] = False
    valid[1, 7] = True
    cfg_j, cfg_t = jcfg.MatchCriterionConfig(), tcfg.MatchCriterionConfig()
    jcols, jmatched = jcrit.hungarian_match(
        *_jax_io(logits, pboxes, labels, tb, valid), cfg_j)
    tcols, tmatched = tcrit.hungarian_match(
        *_torch_io(logits, pboxes, labels, tb, valid), cfg_t)
    np.testing.assert_array_equal(tmatched.numpy(), np.asarray(jmatched))
    np.testing.assert_array_equal(tcols.numpy()[tmatched.numpy()],
                                  np.asarray(jcols)[np.asarray(jmatched)])
    # query 3's costs become 1e9, so one of the 7 targets goes unmatched
    logits[0, 3, 2] = np.nan
    _, jmatched = jcrit.hungarian_match(
        *_jax_io(logits, pboxes, labels, tb, valid), cfg_j)
    _, matched = tcrit.hungarian_match(
        *_torch_io(logits, pboxes, labels, tb, valid), cfg_t)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jmatched))
    assert matched.sum(1).tolist() == [6, 1] and not matched[0, 3]


GOLDENS = Path(__file__).resolve().parent / "goldens"

LOSS_KEYS = ("loss", "loss_ce", "loss_bbox", "loss_giou", "class_error",
             "cardinality_error", "num_boxes")


@pytest.mark.parametrize("q,t,counts,row_valid", [
    (7, 16, (3, 0, 7), None),
    (51, 64, (60, 51, 5), None),
    (7, 16, (4, 6, 2), (True, True, False)),    # a padded final eval batch
    (9, 12, (0, 0, 0), None),
])
def test_set_criterion_matches_jax(q, t, counts, row_valid):
    prob = _problem(3 * q + t, 3, q, t, counts)
    jrv = None if row_valid is None else jnp.asarray(row_valid)
    trv = None if row_valid is None else torch.tensor(row_valid)
    want = jcrit.set_criterion(*_jax_io(*prob), jcfg.MatchCriterionConfig(),
                               num_classes=7, row_valid=jrv)
    got = tcrit.set_criterion(*_torch_io(*prob), tcfg.MatchCriterionConfig(),
                              num_classes=7, row_valid=trv)
    assert set(got) == set(want)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_set_criterion_aux_and_gradients_match_jax():
    """Deep supervision: the aux-layer recursion, and the gradient of the
    total loss with respect to every prediction (atol 1e-6)."""
    prob = _problem(11, 2, 7, 9, (4, 6))
    aux = [_problem(12 + i, 2, 7, 9, (4, 6))[:2] for i in range(2)]
    jout, jtgt = _jax_io(*prob)
    tout, ttgt = _torch_io(*prob)
    jout["aux_outputs"] = [{"pred_logits": jnp.asarray(a),
                            "pred_boxes": jnp.asarray(b)} for a, b in aux]
    tout["aux_outputs"] = [{"pred_logits": to_torch(a),
                            "pred_boxes": to_torch(b)} for a, b in aux]
    keys = ("pred_logits", "pred_boxes")
    leaves = [d[k] for d in [tout] + tout["aux_outputs"] for k in keys]
    for t in leaves:
        t.requires_grad_()
    cfg_j, cfg_t = jcfg.MatchCriterionConfig(), tcfg.MatchCriterionConfig()
    want, jgrad = jax.value_and_grad(
        lambda o: jcrit.set_criterion(o, jtgt, cfg_j)["loss"])(jout)
    got = tcrit.set_criterion(tout, ttgt, cfg_t)
    full = jcrit.set_criterion(jout, jtgt, cfg_j)
    assert set(got) == set(full) and "loss_giou_1" in got
    for k in full:
        np.testing.assert_allclose(float(got[k].detach()), float(full[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got["loss"].backward()
    jleaves = [d[k] for d in [jgrad] + jgrad["aux_outputs"] for k in keys]
    for t, j in zip(leaves, jleaves):
        np.testing.assert_allclose(to_numpy(t.grad), np.asarray(j), atol=1e-6)
    np.testing.assert_allclose(float(got["loss"].detach()), float(want),
                               rtol=1e-5)


@pytest.mark.parametrize("case", [0, 1, 2])
def test_set_criterion_goldens(case):
    """The PyTorch reference's SetCriterion + HungarianMatcher losses on the
    captured problems (counts 0 / mid / full-51), at rtol 1e-5."""
    npz = np.load(GOLDENS / "criterion.npz")
    labels = npz[f"c{case}_labels"]
    counts = npz[f"c{case}_counts"]
    valid = np.arange(labels.shape[1])[None, :] < counts[:, None]
    ours = tcrit.set_criterion(
        {"pred_logits": to_torch(npz[f"c{case}_logits"]),
         "pred_boxes": to_torch(npz[f"c{case}_boxes"])},
        {"labels": torch.from_numpy(labels.astype(np.int64)),
         "boxes": to_torch(npz[f"c{case}_tboxes"]),
         "valid": torch.from_numpy(valid)},
        tcfg.MatchCriterionConfig(), num_classes=7)
    for k in ("loss_ce", "loss_bbox", "loss_giou", "cardinality_error"):
        np.testing.assert_allclose(float(ours[k]), float(npz[f"c{case}_{k}"]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(ours["class_error"]),
                               float(npz[f"c{case}_class_error"]),
                               rtol=1e-5, atol=1e-3)
    total = (3 * float(npz[f"c{case}_loss_ce"])
             + 5 * float(npz[f"c{case}_loss_bbox"])
             + 2 * float(npz[f"c{case}_loss_giou"]))
    np.testing.assert_allclose(float(ours["loss"]), total, rtol=1e-5)


def test_set_criterion_rejects_mismatched_head():
    out, tgt = _torch_io(*_problem(0, 1, 5, 4, (2,), num_logits=6))
    with pytest.raises(ValueError, match="no-object slot"):
        tcrit.set_criterion(out, tgt, tcfg.MatchCriterionConfig(),
                            num_classes=7)


def test_matcher_copies_the_batch_to_the_host_once(monkeypatch):
    """One scipy solve per image, all on slices of a single host copy: the
    criterion calls solve_lsap once per set of outputs (once more per aux
    layer), never per image. Around it nothing reads a value or a count
    back from the device (`item`, `nonzero`, a tensor as a condition): on
    a card each would wait for it a second time."""
    def waits(*a, **k):
        raise AssertionError("the criterion read a value back to the host")

    for name in ("item", "nonzero", "tolist", "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, waits)
    monkeypatch.setattr(torch, "nonzero", waits)
    calls = []
    real = tlsap.solve_lsap
    monkeypatch.setattr(tcrit, "solve_lsap",
                        lambda cost, *a: calls.append(cost.shape) or
                        real(cost, *a))
    prob = _problem(2, 3, 7, 9, (4, 6, 1))
    out, tgt = _torch_io(*prob)
    out["aux_outputs"] = [dict(out)]
    tcrit.set_criterion(out, tgt, tcfg.MatchCriterionConfig())
    assert calls == [(3, 9, 9), (3, 9, 9)]
