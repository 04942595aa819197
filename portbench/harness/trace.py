"""The device trace of a traced stretch, reduced to what the per-layer
readers need.

`Timeline` holds the host ranges (PyTorch's operators, autograd nodes and
the harness's own `record_function` ranges, by thread) and the device
operations (kernels, copies and fills), each device operation tagged with
the chain of host ranges in flight on the thread that launched it, innermost
first. A device operation is tied to its launch by the profiler's
correlation ids; where that link is missing, by the time of its launch call
on the host.

The readers ask three things: the device time of the operations launched
under ranges whose names match (`device_time`), the time in which any
device operation ran (`busy`, the union of their intervals, so overlapping
operations count once), and the idle gaps between them with the host range
in flight (`gaps`). `to_json` / `from_json` keep a timeline as a table, so
the readers can be tested on a recorded one.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
WINDOW = "portbench::traced"
_API = re.compile(r"^cu(da)?[A-Z]")


@dataclass
class Timeline:
    """ops: (thread, start_ns, end_ns, name) host ranges; dev: (start_ns,
    end_ns, name, kind, owners) device operations, owners the names of the
    launching thread's ranges in flight, innermost first; window: the
    traced stretch (start_ns, end_ns)."""

    ops: List[Tuple[int, int, int, str]] = field(default_factory=list)
    dev: List[Tuple[int, int, str, str, Tuple[str, ...]]] = \
        field(default_factory=list)
    window: Tuple[int, int] = (0, 0)

    # ---- queries --------------------------------------------------------
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _clipped(self):
        a, b = self.window
        for s, e, name, kind, owners in self.dev:
            s, e = max(s, a), min(e, b)
            if e > s:
                yield s, e, name, kind, owners

    def device_time(self, match: Callable[[str], bool]) -> Tuple[float, int]:
        """(seconds, count) of device operations in the window launched
        under a host range whose name satisfies `match`."""
        total, n = 0, 0
        for s, e, _, _, owners in self._clipped():
            if any(match(o) for o in owners):
                total += e - s
                n += 1
        return total / 1e9, n

    def intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals, sorted."""
        out: List[List[int]] = []
        for s, e, *_ in sorted(self._clipped()):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) / 1e9

    def gaps(self, min_s: float = 1e-5) -> List[Tuple[float, str]]:
        """Every idle stretch of the window (seconds, the host range in
        flight at its middle), longest first; stretches under `min_s` are
        summed into one entry."""
        a, b = self.window
        edges = [a] + [x for iv in self.intervals() for x in iv] + [b]
        label = _HostLabels(self.ops)
        out, short = [], 0.0
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e <= s:
                continue
            if (e - s) / 1e9 < min_s:
                short += (e - s) / 1e9
            else:
                out.append(((e - s) / 1e9, label((s + e) // 2)))
        if short:
            out.append((short, f"gaps under {min_s * 1e6:g} us"))
        out.sort(key=lambda x: -x[0])
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time, by name."""
        by: Dict[str, int] = {}
        for s, e, name, *_ in self._clipped():
            by[name] = by.get(name, 0) + e - s
        top = sorted(by.items(), key=lambda x: -x[1])[:n]
        return [(name, t / 1e9) for name, t in top]

    def top_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle time by the host range in flight, the largest first."""
        by: Dict[str, float] = {}
        for sec, label in self.gaps():
            by[label] = by.get(label, 0.0) + sec
        return sorted(by.items(), key=lambda x: -x[1])[:n]

    # ---- persistence ----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({"window": list(self.window),
                           "ops": [list(o) for o in self.ops],
                           "dev": [[s, e, n, k, list(o)]
                                   for s, e, n, k, o in self.dev]})

    @classmethod
    def from_json(cls, text: str) -> "Timeline":
        d = json.loads(text)
        return cls([tuple(o) for o in d["ops"]],
                   [(s, e, n, k, tuple(o)) for s, e, n, k, o in d["dev"]],
                   tuple(d["window"]))


def _innermost(ranges, starts, t: int) -> Optional[int]:
    """Index of the innermost range of one thread (sorted by start, outer
    before inner) that holds time t: of those that hold it, the one that
    started last."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if ranges[i][1] >= t:
            return i
        i -= 1
    return None


class _HostLabels:
    """The host range in flight at a time: the innermost range of the
    thread that entered one last, under the harness's own range."""

    def __init__(self, ops):
        self.threads = {}
        for t, s, e, name in ops:
            self.threads.setdefault(t, []).append((s, e, name))
        self.starts = {}
        for t, rs in self.threads.items():
            rs.sort(key=lambda r: (r[0], -r[1]))
            self.starts[t] = [r[0] for r in rs]
        self.harness = sorted((s, e, n) for _, s, e, n in ops
                              if n.startswith("portbench::") and n != WINDOW)

    def __call__(self, t: int) -> str:
        best = None
        for th, rs in self.threads.items():
            i = _innermost(rs, self.starts[th], t)
            if i is not None and (best is None or rs[i][0] > best[0]):
                best = rs[i]
        outer = next((n for s, e, n in self.harness if s <= t <= e), None)
        if best is None:
            return outer or "no host range"
        if outer is None or outer == best[2]:
            return best[2]
        return f"{outer} > {best[2]}"


def from_events(events) -> Timeline:
    """Build a Timeline from the profiler's raw events (objects with
    name(), device_type(), start_ns(), end_ns(), start_thread_id(),
    correlation_id(), linked_correlation_id(), and in newer torch
    activity_type())."""
    events = [(_kind(ev), ev) for ev in events]
    host_names = {ev.name() for k, ev in events if k in HOST_KINDS}
    host, dev, launch = [], [], {}
    for kind, ev in events:
        start, end = _span(ev)
        if kind in HOST_KINDS:
            host.append((ev.start_thread_id(), start, end, ev.name(),
                         ev.correlation_id()))
        elif kind in DEVICE_KINDS and ev.name() not in host_names:
            # (a device-side copy of a host range is no device operation)
            dev.append((start, end, ev.name(), kind, ev.correlation_id(),
                        ev.linked_correlation_id()))
        elif kind in LAUNCH_KINDS:
            launch[ev.correlation_id()] = (ev.start_thread_id(), start,
                                           ev.linked_correlation_id())
    by_thread: Dict[int, list] = {}
    for t, s, e, name, corr in host:
        by_thread.setdefault(t, []).append((s, e, name, corr))
    parent: Dict[Tuple[int, int], Optional[int]] = {}
    where: Dict[int, Tuple[int, int]] = {}      # corr -> (thread, index)
    starts: Dict[int, list] = {}
    for t, ranges in by_thread.items():
        ranges.sort(key=lambda r: (r[0], -r[1]))
        stack: List[int] = []
        for i, (s, e, name, corr) in enumerate(ranges):
            while stack and ranges[stack[-1]][1] <= s:
                stack.pop()
            parent[(t, i)] = stack[-1] if stack else None
            stack.append(i)
            if corr:
                where[corr] = (t, i)
        starts[t] = [r[0] for r in ranges]

    def chain(t: int, i: Optional[int]) -> Tuple[str, ...]:
        out = []
        while i is not None:
            out.append(by_thread[t][i][2])
            i = parent[(t, i)]
        return tuple(out)

    out_dev = []
    for s, e, name, kind, corr, linked in dev:
        owner = where.get(linked) if linked else None
        if owner is None and corr in launch:
            t, ts, lk = launch[corr]
            owner = where.get(lk) if lk else None
            if owner is None and t in by_thread:
                owner = (t, _innermost(by_thread[t], starts[t], ts))
        owners = chain(*owner) if owner and owner[1] is not None else ()
        out_dev.append((s, e, name, kind, owners))
    ops = [(t, s, e, name) for t, rs in by_thread.items()
           for s, e, name, _ in rs]
    win = [(s, e) for _, s, e, name in ops if name == WINDOW]
    window = win[0] if win else (
        min((o[1] for o in ops), default=0), max((o[2] for o in ops),
                                                 default=0))
    return Timeline(ops, out_dev, window)


def _kind(ev) -> str:
    """The event's activity type; where torch does not give it, from the
    device it ran on and its name (API calls are cu* / cuda*)."""
    if hasattr(ev, "activity_type"):
        return ev.activity_type()
    if str(ev.device_type()).endswith("CUDA"):
        name = ev.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if _API.match(ev.name()):
        return "cuda_runtime"
    return "cpu_op"


def _span(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        return ev.start_ns(), ev.end_ns()
    start = int(ev.start_us() * 1000)
    return start, start + int(ev.duration_us() * 1000)


def from_profiler(prof) -> Timeline:
    """The Timeline of a stopped torch.profiler.profile."""
    return from_events(prof.profiler.kineto_results.events())
