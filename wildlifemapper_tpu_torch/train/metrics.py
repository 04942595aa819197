"""Windowed metric smoothing + training-loop logging; a copy of
wildlifemapper_tpu/train/metrics.py.

Equivalent of the reference's SmoothedValue / MetricLogger
(segment_anything/utils/misc.py:222-378): median/avg over a sliding window,
global averages, periodic progress lines with ETA and iteration/data timing,
and the merge of the meters over the ranks of a process group.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict, Iterable


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, value=self.value)


class MetricLogger:
    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total: int = None):
        i = 0
        total = total if total is not None else len(iterable)  # type: ignore
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = int(iter_time.global_avg * (total - i))
                self.print_fn(
                    f"{header} [{i}/{total}] eta: "
                    f"{datetime.timedelta(seconds=eta)}  {self}  "
                    f"time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        self.print_fn(f"{header} Total time: "
                      f"{datetime.timedelta(seconds=int(elapsed))} "
                      f"({elapsed / max(total, 1):.4f} s / it)")

    def global_averages(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def synchronize_between_processes(self):
        """Sum each meter's (count, total) across processes so global_avg is
        a true global average (reference: SmoothedValue.synchronize_between_
        processes, misc.py:240-251 — a dist.all_reduce of [count, total]).

        Meter NAME SETS can differ across processes (ragged), so this
        gathers a dict of pairs by the object all_gather rather than a
        collective over a tensor. The sums run in rank order, so every rank
        ends with the same averages to the last bit. They run over the data
        group: the ranks of a model group hold the same rows' meters."""
        from ..parallel.distributed import (all_gather_objects, data_group,
                                            get_data_world_size)

        if get_data_world_size() == 1:
            return
        local = {k: (m.count, m.total) for k, m in self.meters.items()}
        gathered = all_gather_objects(local, data_group())
        for k in sorted(set().union(*gathered)):
            pairs = [g[k] for g in gathered if k in g]
            self.meters[k].count = sum(c for c, _ in pairs)
            self.meters[k].total = sum(t for _, t in pairs)
