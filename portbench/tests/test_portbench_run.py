"""Whole runs without the card: run.py refuses to run on the CPU, and with
its look for a card skipped a run drives the program at tiny widths on the
CPU, where `correct` holds for the sound program and falls for each fault
a cell can have, planted under the timed path. Also: nothing that a run
loads is JAX or the JAX package, and the reference loads nothing of the
port."""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import cells, compare, env, runner

ROOT = cells.ROOT
CHECKOUT = ROOT.parent
TINY = json.loads((Path(__file__).parent / "data" / "tiny_vit.json")
                  .read_text())
TINY_CELLS = {
    "tiny_serve": {
        "traffic": "serve_tiles", "like": "vitb_serve_tiles_b16",
        "params": {"batch": 2, "pool_batches": 2, "trace_batches": 2}},
    "tiny_train": {
        "traffic": "train_steps", "like": "vitb_train_herdnet_b8",
        "params": {"batch": 2, "pool_batches": 4, "trace_batches": 2,
                   "launcher_args": ["--content_size", "96",
                                     "--crop_prologue", "--window_size", "3",
                                     "--batch_size", "2",
                                     "--device_normalize",
                                     "--canvas_size", "128",
                                     "--max_targets", "8"]}},
}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A benchmark folder of tiny cells: the traffic kinds and metric
    readers as they are, a tiny configuration, the real cells' limits."""
    root = tmp_path_factory.mktemp("portbench")
    shutil.copytree(ROOT / "traffic", root / "traffic")
    shutil.copytree(ROOT / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    (root / "configs" / "tiny_vit.json").write_text(json.dumps(TINY))
    for name, c in TINY_CELLS.items():
        like = cells.cell(c["like"])
        (root / "workloads" / f"{name}.json").write_text(json.dumps({
            "name": name, "config": "tiny_vit", "traffic": c["traffic"],
            "chips": 1, "why": "a CPU test", "params": c["params"],
            "limits": like["limits"]}))
    return root


def bench_for_tiny():
    bench = json.loads(json.dumps(cells.benchmark()))
    for m in bench["end_to_end"] + bench["per_layer"]:
        for name, c in TINY_CELLS.items():
            if c["like"] in m.get("workloads", []):
                m["workloads"].append(name)
    return bench


def run_tiny(root, name, trace=False, seed=2 ** 31 + 17):
    return runner.run(name, seed, 0.5, trace, "cpu", time.perf_counter(),
                      bench_for_tiny(), ("cpu", 1, None), root)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "vitb_serve_tiles_b16", "--seed", str(2 ** 31 + 5),
                        "--seconds", "1", "--trace", "0"], cwd=CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "vitb_serve_tiles_b16", "--seed", "3", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name", sorted(TINY_CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_program_is_correct(tiny_root, name, trace):
    out = run_tiny(tiny_root, name, trace)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    if trace:
        assert "breakdown" in out and "busy_s" in out["device"]
    else:
        assert "setup_s" in out["metrics"]


def test_report_prints_the_numbers_then_the_result(tiny_root, capsys):
    from portbench import run

    out = run_tiny(tiny_root, "tiny_serve")
    run.report(out)
    printed = capsys.readouterr()
    assert json.loads(printed.out.strip().splitlines()[-1]) == out
    err = printed.err.strip().splitlines()
    assert err[-1] == "correct True"
    assert re.fullmatch(r"compared images_compared [1-9]\d* limit "
                        r"'at least 1'", err[-2])


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)


def _half_batch(monkeypatch):
    import wildlifemapper_tpu_torch.train.step as step

    original = step.set_criterion

    def half(outputs, targets, *args, **kwargs):
        b = outputs["pred_logits"].shape[0] // 2
        return original({k: v[:b] for k, v in outputs.items()},
                        {k: v[:b] for k, v in targets.items()},
                        *args, **kwargs)

    monkeypatch.setattr(step, "set_criterion", half)


def _altered_answer(monkeypatch):
    import wildlifemapper_tpu_torch.eval.orthomosaic as om

    original = om.postprocess

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        out["boxes"] = out["boxes"].clone()
        out["boxes"][0, 0] += 64.0
        return out

    monkeypatch.setattr(om, "postprocess", altered)


@pytest.mark.parametrize("name,fault", [
    ("tiny_train", _unchanged_state), ("tiny_train", _half_batch),
    ("tiny_serve", _altered_answer)],
    ids=["unchanged_state", "half_batch", "altered_answer"])
def test_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    fault(monkeypatch)
    out = run_tiny(tiny_root, name)
    assert not out["correct"], out["compared"]


def test_verdict_over_nothing_is_not_correct():
    ok, rows = compare.verdict({"score_gap": 0.0, "images_compared": 0},
                               {"score_gap": 0.01})
    assert not ok and rows[-1]["name"] == "images_compared"
    assert all("limit" in row for row in rows)
    assert compare.verdict({"score_gap": 0.0, "images_compared": 2},
                           {"score_gap": 0.01})[0]


def test_row_grad_gap_reads_a_row_left_out_or_doubled():
    gen = torch.Generator().manual_seed(5)
    want = {"pred_logits": torch.randn(4, 6, 8, generator=gen),
            "pred_boxes": torch.randn(4, 6, 4, generator=gen)}
    near = {k: v * 1.01 for k, v in want.items()}
    assert compare.row_grad_gap(near, want) == pytest.approx(0.01)
    half = {k: torch.cat([2 * v[:2], 0 * v[2:]]) for k, v in want.items()}
    assert compare.row_grad_gap(half, want) == pytest.approx(1.0)
    assert compare.row_grad_gap({}, want) == pytest.approx(1.0)


def _modules_after(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted(sys.modules)))"],
                       cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=600, check=True)
    return {m.split(".")[0] for m in json.loads(p.stdout.splitlines()[-1])}


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time, json\n"
        "sys.argv = ['x']\n"
        "import portbench.run\n"
        "from portbench.tests import test_portbench_run as t\n"
        "from pathlib import Path\n"
        f"root = Path({str(tiny_root)!r})\n"
        "for name in sorted(t.TINY_CELLS):\n"
        "    t.run_tiny(root, name, trace=True)\n")
    top = _modules_after(code)
    assert "wildlifemapper_tpu_torch" in top
    assert not set(env.FORBIDDEN) & top


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import json, torch\n"
        "from portbench.reference import model, criterion, postprocess\n"
        "from portbench.harness import weights\n"
        "cfg = json.load(open('portbench/tests/data/tiny_vit.json'))\n"
        "s = model.model_spec(cfg)\n"
        "P = weights.make(model.param_shapes(s), 1, 'cpu')\n"
        "x = model.normalize(torch.zeros(1, 128, 128, 3, dtype=torch.uint8))\n"
        "out = model.forward(x, P, s)\n"
        "postprocess.nms(out['pred_boxes'], out['pred_logits'][..., 0],\n"
        "                out['pred_logits'][..., 0] > 0, 0.4)\n")
    top = _modules_after(code)
    assert not (set(env.FORBIDDEN) | {"wildlifemapper_tpu_torch"}) & top


def test_forbidden_names_compare_whole():
    assert env.forbidden_modules(["wildlifemapper_tpu_torch.models",
                                  "jaxtyping", "torch"]) == []
    assert env.forbidden_modules(["jax.numpy", "wildlifemapper_tpu.ops",
                                  "flax"]) == ["flax", "jax",
                                               "wildlifemapper_tpu"]
