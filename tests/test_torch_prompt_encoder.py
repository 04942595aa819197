"""The port's SAM prompt encoder (wildlifemapper_tpu_torch/compat/
prompt_encoder.py) against the JAX package's (wildlifemapper_tpu/compat/
prompt_encoder.py): the same seeded numpy prompts and the JAX module's
perturbed parameters, carried across by
`weights.prompt_encoder_state_dict_from_jax`, through both modules at embed
32, an 8x8 embedding grid and a 64x64 input, float32. Sparse and dense
embeddings and the dense PE within atol 2e-5 / rtol 1e-5, in every prompt
combination (none, points, points + boxes, N > 1 boxes a row, masks).
SAM's state-dict names: a `prompt_encoder.*` dict loads after the prefix
strip, and the JAX package's own converter maps the port's state dict back
onto the JAX parameters exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wildlifemapper_tpu.compat import prompt_encoder as jpe
from wildlifemapper_tpu_torch.compat import prompt_encoder as tpe
from wildlifemapper_tpu_torch.weights import \
    prompt_encoder_state_dict_from_jax

from tests.torch_common import flat_numpy, perturbed, to_numpy, to_torch

EMBED, GRID, INPUT, MASK_CHANS = 32, (8, 8), (64, 64), 16
TOL = dict(atol=2e-5, rtol=1e-5)


def _prompts(seed: int = 5) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "points": rng.uniform(0, 64, (2, 3, 2)).astype(np.float32),
        "point_labels": np.asarray([[1, 0, -1], [1, 1, 0]], np.int32),
        "boxes": np.asarray([[10, 20, 50, 60], [5, 5, 60, 58]], np.float32),
        "boxes_n": rng.uniform(0, 64, (2, 3, 4)).astype(np.float32),
        "masks": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
    }


COMBOS = {
    "none": (),
    "points": ("points", "point_labels"),
    "points_boxes": ("points", "point_labels", "boxes"),
    "boxes_n": ("boxes_n",),
    "masks": ("masks",),
}


@pytest.fixture(scope="module")
def modules():
    jm = jpe.PromptEncoder(embed_dim=EMBED, image_embedding_size=GRID,
                           input_image_size=INPUT, mask_in_chans=MASK_CHANS)
    p = _prompts()
    params = jm.init(jax.random.PRNGKey(0), points=jnp.asarray(p["points"]),
                     point_labels=jnp.asarray(p["point_labels"]),
                     boxes=jnp.asarray(p["boxes"]),
                     masks=jnp.asarray(p["masks"]))
    # LayerNorm scale 1 / bias 0 and zero conv biases carry signal too
    params = perturbed(params, np.random.default_rng(1))
    tm = tpe.PromptEncoder(embed_dim=EMBED, image_embedding_size=GRID,
                           input_image_size=INPUT, mask_in_chans=MASK_CHANS,
                           device="cpu")
    tm.load_state_dict(prompt_encoder_state_dict_from_jax(
        flat_numpy(params)))
    return jm, params, tm.eval()


def _kwargs(names, p):
    out = {}
    for n in names:
        key = "boxes" if n == "boxes_n" else n
        out[key] = p[n]
    return out


@pytest.mark.parametrize("combo", list(COMBOS))
def test_prompt_combination_matches_jax(modules, combo):
    jm, params, tm = modules
    kw = _kwargs(COMBOS[combo], _prompts())
    js, jd = jm.apply(params, **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        ts, td = tm(**{k: (torch.from_numpy(v) if k == "point_labels"
                           else to_torch(v)) for k, v in kw.items()})
    assert tuple(ts.shape) == js.shape and tuple(td.shape) == jd.shape
    np.testing.assert_allclose(to_numpy(ts), np.asarray(js), **TOL)
    np.testing.assert_allclose(to_numpy(td), np.asarray(jd), **TOL)


def test_shapes_of_each_combination(modules):
    """Points alone get the pad slot, points with boxes do not; N boxes a
    row give 2N corners; no mask gives the no-mask embedding everywhere."""
    _, _, tm = modules
    p = {k: (torch.from_numpy(v) if k == "point_labels" else to_torch(v))
         for k, v in _prompts().items()}
    with torch.no_grad():
        assert tm()[0].shape == (1, 0, EMBED)
        assert tm(points=p["points"], point_labels=p["point_labels"]
                  )[0].shape == (2, 4, EMBED)
        assert tm(points=p["points"], point_labels=p["point_labels"],
                  boxes=p["boxes"])[0].shape == (2, 5, EMBED)
        assert tm(boxes=p["boxes_n"])[0].shape == (2, 6, EMBED)
        sparse, dense = tm(masks=p["masks"])
        assert sparse.shape == (2, 0, EMBED)
        assert dense.shape == (2, *GRID, EMBED)
        dense = tm(boxes=p["boxes"])[1]
    torch.testing.assert_close(dense[1, 3, 5], tm.no_mask_embed.weight[0],
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="point_labels"):
        tm(points=p["points"])


def test_dense_pe_matches_jax(modules):
    jm, params, tm = modules
    jd = jm.apply(params, method=jm.get_dense_pe)
    with torch.no_grad():
        td = tm.get_dense_pe()
    assert tuple(td.shape) == jd.shape == (1, *GRID, EMBED)
    np.testing.assert_allclose(to_numpy(td), np.asarray(jd), **TOL)


def test_sam_state_dict_names_round_trip(modules):
    """A SAM checkpoint's `prompt_encoder.*` entries load with
    load_state_dict after the prefix strip (strict: every name is SAM's),
    and the JAX package's converter of such a dict gives back the JAX
    parameters bit for bit."""
    _, params, tm = modules
    sam = {tpe.PREFIX + k: v.clone() for k, v in tm.state_dict().items()}
    sam["image_encoder.neck.0.weight"] = torch.zeros(1)
    assert sorted(tpe.sam_state_dict(sam)) == sorted(tm.state_dict())
    fresh = tpe.PromptEncoder(embed_dim=EMBED, image_embedding_size=GRID,
                              input_image_size=INPUT,
                              mask_in_chans=MASK_CHANS, device="cpu")
    fresh.load_state_dict(tpe.sam_state_dict(sam))
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert sorted(k for k, _ in fresh.named_buffers()) == [
        "pe_layer.positional_encoding_gaussian_matrix"]
    back = jpe.convert_torch_prompt_encoder(sam, {})
    want = flat_numpy(params)
    got = flat_numpy({"params": back})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
