"""Tracing / profiling utilities; counterpart of
wildlifemapper_tpu/train/profiling.py.

Provides:
  * trace(): context manager around torch.profiler, writing a Chrome trace
    (kernels on the card included when CUDA is present) into `logdir`.
  * StepTimer: wall-clock step timing that waits for the card to finish
    the step (torch returns before the device does).
  * device_memory_stats(): live device memory per card, from
    torch.cuda.memory_stats, under the JAX package's keys.
  * StepWatch: clocks on the training loop's steps and evaluations, for
    train/loop.py::train(..., watch=) on a CUDA GPU.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Capture a profiler trace of the block into `logdir`/trace.json
    (chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Accurate per-step timing: call start() before and stop(result) after;
    stop() waits for the card to finish the work queued before it."""

    def __init__(self):
        self.times = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, result=None) -> float:
        if result is not None and torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.time() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """{device: {bytes_in_use_gb, peak_bytes_gb, bytes_limit_gb}} for each
    CUDA device; empty without CUDA."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gb": s.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_gb": s.get("allocated_bytes.all.peak", 0) / 2**30,
            "bytes_limit_gb":
                torch.cuda.get_device_properties(i).total_memory / 2**30,
        }
    return out


class StepWatch:
    """Clocks on the training loop, for train(..., watch=) on a CUDA GPU: a
    CUDA event as each step starts and ends, the host's ms inside each step
    and between two, each step's metrics as the step returns them, the last
    step's (builder, state, batch, generator) to time the same step bare,
    and each evaluation's seconds with the card drained before and after.
    `before(k)` and `after(k)`, where given, run just before and just after
    step k (the run's first is 0), outside the host's clock."""

    def __init__(self, before: Optional[Callable[[int], None]] = None,
                 after: Optional[Callable[[int], None]] = None):
        self.before, self.after = before, after
        self.starts: List[torch.cuda.Event] = []
        self.ends: List[torch.cuda.Event] = []
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self.inside_ms: List[float] = []
        self.between_ms: List[float] = []
        self.eval_seconds: List[float] = []
        self.last = None
        self._returned: Optional[float] = None

    def train_step(self, builder, state, batch, generator=None):
        """builder.train_step(state, batch, generator), watched."""
        k = len(self.starts)
        if self.before is not None:
            self.before(k)
        now = time.perf_counter()
        if self._returned is not None:
            self.between_ms.append((now - self._returned) * 1e3)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = builder.train_step(state, batch, generator)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.inside_ms.append((time.perf_counter() - now) * 1e3)
        self.starts.append(start)
        self.ends.append(end)
        self.metrics.append(metrics)
        self.last = (builder, state, batch, generator)
        if self.after is not None:
            self.after(k)
        self._returned = time.perf_counter()
        return state, metrics

    def evaluate(self, evaluate, *args, **kwargs):
        """evaluate(*args, **kwargs), its seconds recorded."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = evaluate(*args, **kwargs)
        torch.cuda.synchronize()
        self.eval_seconds.append(time.perf_counter() - t0)
        return out

    def ms_per_step(self, steps: int) -> List[float]:
        """ms a step in each epoch of `steps` steps, from the start of its
        second step to the end of its last (the CUDA events; the card must
        have passed them)."""
        return [self.starts[e * steps + 1].elapsed_time(
                    self.ends[e * steps + steps - 1]) / (steps - 1)
                for e in range(len(self.starts) // steps)]
