"""One run of a cell: set-up, the measured window, the traced stretch with
`trace`, and the comparison with the reference once the program's state is
freed. Returns the result line's object; run.py prints it.

The traffic kind (traffic/<kind>.py) supplies a `Job` with build(),
window(seconds) -> its end-to-end metrics, traced(units), release() and
check() -> the numbers compared; everything else here is the same for
every cell.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import sys
import time
from typing import Optional

import torch

from . import cells, compare, counts, trace


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader sees (harness/readers.py)."""

    mode: str
    spec: dict
    batch: int
    products: list
    encoder_trains: bool
    unit_s: float
    units: int = 0
    timeline: Optional[trace.Timeline] = None
    # the device-only stretch: seconds busy and its length
    busy_s: float = 0.0
    window_s: float = 0.0


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def traced(job, units: int, device):
    """Two stretches of `units` batches or steps after the window: one
    under torch.profiler with the host's ranges and the device's operations
    (the Timeline the readers attribute device time with), and one that
    traces the device alone, whose host overhead is small, for the busy and
    window seconds. Returns (timeline, busy_s, window_s)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            job.traced(units)
            if cuda:
                torch.cuda.synchronize(device)
    tl = trace.from_profiler(prof)
    if not cuda:
        return tl, tl.busy_s(), tl.window_s()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        job.traced(units)
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev = trace.from_profiler(prof)
    start = min((d[0] for d in dev.dev), default=0)
    dev.window = (start, start + int(window * 1e9))
    return tl, dev.busy_s(), window


def setup(cell_name: str, seed: int, device, root=cells.ROOT):
    """(cell, kind module, job) of a cell, not yet built."""
    c = cells.cell(cell_name, root)
    cfg = cells.config(c["config"], root)
    kind, mix = cells.traffic(c["traffic"], root)
    params = {**kind.DEFAULTS, **mix, **c["params"]}
    return c, kind, kind.Job(c, cfg, params, seed, device)


def run(cell_name: str, seed: int, seconds: float, trace_on: bool, device,
        t_start: float, bench: dict, card: tuple, root=cells.ROOT) -> dict:
    device = torch.device(device)
    c, kind, job = setup(cell_name, seed, device, root)
    before = time.perf_counter() - t_start
    job.build()
    setup_s = time.perf_counter() - t_start
    print("setup_s phases: " + json.dumps(
        dict(before_the_program=before, **job.phases)), file=sys.stderr)
    peak = _peak(device)
    e2e = job.window(seconds)
    peak = max(peak, _peak(device))
    name, count, power = card
    dev = {"platform": "gpu", "kind": name, "count": count,
           "memory_peak_bytes": peak, "power_limit_w": power}
    metrics, breakdown = {}, None
    if trace_on:
        units = job.p["trace_batches"]
        tl, busy_s, window_s = traced(job, units, device)
        peak = max(peak, _peak(device))
        encoder_trains = getattr(job, "encoder_trains", False)
        ctx = LayerContext(
            mode=kind.MODE, spec=job.spec, batch=job.batch,
            products=counts.products(job.spec, job.batch,
                                     train=kind.MODE == "train",
                                     encoder_trains=encoder_trains),
            encoder_trains=encoder_trains,
            unit_s=job.unit_s, units=units, timeline=tl,
            busy_s=busy_s,
            window_s=window_s)
        for m in cells.metrics_of(bench, cell_name, "per_layer"):
            value = cells.metric_reader(m["name"], root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=busy_s, window_s=window_s, memory_peak_bytes=peak)
        breakdown = {"device_ops": [list(x) for x in tl.top_ops()],
                     "idle_gaps": [list(x) for x in tl.top_gaps()]}
    else:
        measured = dict(e2e, setup_s=setup_s)
        for m in cells.metrics_of(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}
    job.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ok, rows = compare.verdict(job.check(), c["limits"])
    out = {"correct": bool(ok and job.failed == 0),
           "attempted": job.attempted, "failed": job.failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = rows
    return out
