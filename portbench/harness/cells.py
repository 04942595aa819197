"""Finding a cell's files by name: its workload, configuration, traffic
kind and per-layer metric readers. Everything that belongs to one cell, one
configuration, one traffic kind or one metric lives in a file of its own
under `portbench/`; this module only maps names to those files.

    workloads/<cell>.json      config, traffic, chips, why, params, limits
    configs/<config>.json      the configuration's published numbers
    traffic/<traffic>.py       a traffic kind: the generator and the loop
    traffic/<traffic>.json     or a named mix of an existing kind:
                               {"kind": <kind>, "params": {...}}
    metrics/<metric>.py        a per-layer metric's reader, read(ctx)
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parents[1]          # portbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELL_KEYS = {"name", "config", "traffic", "chips", "why", "params", "limits"}


def _name(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file at `path` as a module of its own (its file name may
    hold dots, as a metric's name does)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload file of cell `name`, checked."""
    c = load_json(root / "workloads" / f"{_name('cell', name)}.json")
    missing = CELL_KEYS - set(c)
    extra = set(c) - CELL_KEYS
    if missing or extra:
        raise ValueError(f"workload {name}: missing {sorted(missing)}, "
                         f"unknown {sorted(extra)}")
    if c["name"] != name:
        raise ValueError(f"workload file {name}.json names {c['name']!r}")
    if c["chips"] not in (1, 4):
        raise ValueError(f"workload {name}: chips must be 1 or 4")
    _name("config", c["config"])
    _name("traffic", c["traffic"])
    return c


def config(name: str, root: Path = ROOT) -> dict:
    c = load_json(root / "configs" / f"{_name('config', name)}.json")
    if c.get("name") != name:
        raise ValueError(f"config file {name}.json names {c.get('name')!r}")
    return c


def traffic(name: str, root: Path = ROOT):
    """(kind module, the mix's default params) for traffic `name`: a kind
    of its own (traffic/<name>.py) or a named mix of one
    (traffic/<name>.json holding its kind and params)."""
    _name("traffic", name)
    code = root / "traffic" / f"{name}.py"
    if code.is_file():
        return load_module(code, f"portbench_traffic_{name}"), {}
    mix = load_json(root / "traffic" / f"{name}.json")
    kind = _name("traffic kind", mix["kind"])
    return (load_module(root / "traffic" / f"{kind}.py",
                        f"portbench_traffic_{kind}"), dict(mix["params"]))


def metric_reader(name: str, root: Path = ROOT):
    """The `read(ctx)` of metric `name` (metrics/<name>.py)."""
    mod = load_module(root / "metrics" / f"{_name('metric', name)}.py",
                      "portbench_metric_" + name.replace(".", "_"))
    return mod.read


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root.parent / "BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, section: str) -> List[dict]:
    """The metrics of BENCHMARK.json's `section` that cell `cell_name`
    reports: those without a `workloads` list, and those that list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]
