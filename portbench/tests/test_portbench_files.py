"""Every file the benchmark finds by name is there and well formed:
BENCHMARK.json against the benchmark's contract, each configuration,
traffic kind or mix, cell and per-layer metric reader."""

import json
import math
import re

import pytest

from portbench.harness import cells

BENCH = cells.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "_dim",
               "_rank", "head", "expansion", "experts_per")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.endswith("_torch")
        assert (cells.ROOT.parent / p).is_dir()
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")


def test_run_seconds_fits_the_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and LINE.match(entry["source"])
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    cfg = cells.config(entry["name"])
    assert cfg["source"] == entry["source"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key)
        assert not any(w in key for w in WIDTH_WORDS)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(entry["file"]) == 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_files(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    c = cells.cell(name)
    for key in ("config", "traffic", "chips", "why"):
        assert c[key] == entry[key]
    assert LINE.match(c["why"]) and c["chips"] == 1
    kind, mix = cells.traffic(c["traffic"])
    assert kind.MODE in ("serve", "train")
    params = {**kind.DEFAULTS, **mix, **c["params"]}
    assert set(c["params"]) <= set(kind.DEFAULTS)
    assert c["limits"] and set(c["limits"]) <= set(kind.NUMBERS)
    assert all(isinstance(v, (int, float)) and v >= 0
               for v in c["limits"].values())
    assert params["batch"] >= 1
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((c["config"], c["traffic"])) == 1


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_the_contract_asks(name):
    e2e = [m["name"] for m in cells.metrics_of(BENCH, name, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cells.metrics_of(BENCH, name, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    for w in metric.get("workloads", []):
        assert w in CELLS
    names = [m["name"] for m in METRICS]
    assert names.count(metric["name"]) == 1


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bound(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source",
                           "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"}
    assert LINE.match(metric["layer"])
    assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
    assert callable(cells.metric_reader(metric["name"]))
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_one_layer_name_per_layer():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({layer.lower() for layer in layers}) == len(layers)


def test_names_are_found_by_name_only():
    for bad in ("../x", "a b", "a/b", ""):
        with pytest.raises(ValueError):
            cells.cell(bad)


def test_boxes_table():
    table = cells.load_json(cells.ROOT / "traffic" /
                            "herdnet_train_split.json")
    counts = table["boxes_per_image"]
    assert len(counts) == table["images"] == 928
    assert sorted(counts)[len(counts) // 2] == 3 and max(counts) == 118
    assert sum(counts) == len(table["box_w_h_category"])
    assert all(1 <= c <= 6 for _, _, c in table["box_w_h_category"])
    assert all(math.isfinite(w) and w > 0 for w, _, _ in
               table["box_w_h_category"])
