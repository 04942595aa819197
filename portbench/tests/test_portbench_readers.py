"""The trace reduction and each per-layer metric's reader on profiler
tables: a hand-made one whose answers are known, and tables recorded on the
card (tests/data/timeline_*.json) where they are present."""

import json
from pathlib import Path

import pytest

from portbench.harness import cells, counts, runner, trace
from portbench.reference import model as ref

DATA = Path(__file__).parent / "data"
BENCH = cells.benchmark()
MS = 1_000_000


class Ev:
    """A stand-in for the profiler's raw event."""

    def __init__(self, kind, name, s, e, tid=1, corr=0, linked=0):
        self.k, self.n, self.s, self.e = kind, name, s, e
        self.t, self.c, self.l = tid, corr, linked

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def end_ns(self):
        return self.e

    def start_thread_id(self):
        return self.t

    def correlation_id(self):
        return self.c

    def linked_correlation_id(self):
        return self.l


def hand_made():
    """10 ms window: submit range (0-4 ms) holding two operators, a backward
    node on another thread; kernels linked by id, one only by its launch
    call's time, two that overlap."""
    ev = [
        Ev("user_annotation", trace.WINDOW, 0, 10 * MS, corr=1),
        Ev("user_annotation", "portbench::submit", 0, 4 * MS, corr=2),
        Ev("cpu_op", "wm::flash_attention_packed", 1 * MS, 2 * MS, corr=3),
        Ev("cpu_op", "wm::fused_mlp", 2 * MS, 3 * MS, corr=4),
        Ev("user_annotation", "portbench::postprocess", 3 * MS, 4 * MS,
           corr=5),
        Ev("user_annotation", "portbench::wait", 4 * MS, 10 * MS, corr=6),
        Ev("cpu_op", "autograd::engine::evaluate_function: "
           "PackedAttentionFnBackward", 5 * MS, 6 * MS, tid=2, corr=7),
        # kernels
        Ev("kernel", "attn_fwd", 2 * MS, 4 * MS, corr=100, linked=3),
        Ev("kernel", "mlp", 4 * MS, 5 * MS, corr=101, linked=4),
        Ev("kernel", "softmax", int(4.5 * MS), int(5.5 * MS), corr=102,
           linked=5),
        Ev("kernel", "attn_bwd", 7 * MS, 8 * MS, corr=103),
        Ev("cuda_runtime", "cudaLaunchKernel", int(5.5 * MS),
           int(5.6 * MS), tid=2, corr=103),
    ]
    return trace.from_events(ev)


def test_timeline_reduction():
    tl = hand_made()
    assert tl.window_s() == pytest.approx(0.010)
    # union: 2-5.5 and 7-8 ms
    assert tl.busy_s() == pytest.approx(0.0045)
    sec, n = tl.device_time(lambda o: o == "wm::flash_attention_packed")
    assert (sec, n) == (pytest.approx(0.002), 1)
    sec, n = tl.device_time(lambda o: o.endswith("PackedAttentionFnBackward"))
    assert (sec, n) == (pytest.approx(0.001), 1)
    sec, n = tl.device_time(lambda o: o == "portbench::submit")
    assert n == 3 and sec == pytest.approx(0.004)
    gaps = dict((label, s) for label, s in tl.top_gaps())
    assert gaps["portbench::submit > wm::flash_attention_packed"] == \
        pytest.approx(0.002)
    assert gaps["portbench::wait"] == pytest.approx(0.0035)
    assert tl.top_ops(1) == [("attn_fwd", pytest.approx(0.002))]
    again = trace.Timeline.from_json(tl.to_json())
    assert again.busy_s() == tl.busy_s() and again.dev == tl.dev


def context(tl, mode, units, unit_s, batch, s):
    return runner.LayerContext(
        mode=mode, spec=s, batch=batch,
        products=counts.products(s, batch, train=mode == "train"),
        encoder_trains=False, unit_s=unit_s, units=units, timeline=tl,
        busy_s=tl.busy_s(),
        window_s=tl.window_s())


def spec_b():
    return ref.model_spec(cells.config("sam_vit_b"))


def test_readers_on_the_hand_made_table():
    tl = hand_made()
    s = spec_b()
    ctx = context(tl, "serve", 1, 0.1, 16, s)
    read = {m["name"]: cells.metric_reader(m["name"])(ctx)
            for m in BENCH["per_layer"]}
    assert read["postprocess_ms.serve"] == pytest.approx(1.0)
    assert read["device_idle.serve"] == pytest.approx(55.0)
    bound = sum(counts.attention_bound(c)
                for c in counts.attention_calls(s, 16))
    assert read["attn_roofline.serve"] == pytest.approx(bound / 0.002 * 100)
    bound = sum(counts.mlp_bound(c) for c in counts.mlp_calls(s, 16))
    assert read["mlp_roofline.serve"] == pytest.approx(bound / 0.001 * 100)
    assert read["mfu.serve"] == pytest.approx(
        counts.least_seconds(counts.products(s, 16)) / 0.1 * 100)
    for name in ("mfu.train", "attn_roofline.train", "mlp_roofline.train",
                 "optimizer_ms.train", "device_idle.train"):
        assert read[name] is None


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = context(trace.Timeline(window=(0, MS)), "train", 2, 0.2, 8,
                  spec_b())
    assert cells.metric_reader("optimizer_ms.train")(ctx) is None
    assert cells.metric_reader("attn_roofline.train")(ctx) is None
    assert cells.metric_reader("device_idle.train")(ctx) == 100.0


RECORDED = sorted(DATA.glob("timeline_*.json"))


@pytest.mark.parametrize("path", RECORDED, ids=lambda p: p.stem)
def test_readers_on_a_recorded_table(path):
    """A stretch recorded on the card (two serving batches, or one step):
    every reader of its mode reads a number, shares stay within 100 %."""
    rec = json.loads(path.read_text())
    tl = trace.Timeline.from_json(json.dumps(rec["timeline"]))
    c = cells.cell(rec["cell"])
    kind, mix = cells.traffic(c["traffic"])
    params = {**kind.DEFAULTS, **mix, **c["params"]}
    job = kind.Job(c, cells.config(c["config"]), params, 1, "cpu")
    ctx = context(tl, kind.MODE, rec["units"], rec["unit_s"], job.batch,
                  job.spec)
    ctx.encoder_trains = getattr(job, "encoder_trains", False)
    for m in cells.metrics_of(BENCH, rec["cell"], "per_layer"):
        value = cells.metric_reader(m["name"])(ctx)
        assert value is not None, m["name"]
        if m["unit"] == "%":
            assert 0 < value <= 100, (m["name"], value)
    assert 0 < tl.busy_s() <= tl.window_s()


class OldEv:
    """An event of a torch without activity_type(): its device and name
    tell the kinds apart."""

    def __init__(self, kind, name, s, e, corr=0, linked=0):
        self.ev = Ev(kind, name, s, e, corr=corr, linked=linked)
        for m in ("name", "start_ns", "end_ns", "start_thread_id",
                  "correlation_id", "linked_correlation_id"):
            setattr(self, m, getattr(self.ev, m))

    def device_type(self):
        on_card = trace.DEVICE_KINDS + ("gpu_user_annotation",)
        return "DeviceType.CUDA" if self.ev.k in on_card else \
            "DeviceType.CPU"


def test_timeline_without_activity_types():
    ev = [OldEv("user_annotation", trace.WINDOW, 0, 10 * MS, corr=1),
          OldEv("cpu_op", "wm::fused_mlp", 1 * MS, 2 * MS, corr=2),
          OldEv("kernel", "mlp_kernel", 2 * MS, 3 * MS, corr=9, linked=2),
          OldEv("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 3 * MS,
                4 * MS, corr=10, linked=2),
          OldEv("gpu_user_annotation", trace.WINDOW, 0, 10 * MS),
          OldEv("cuda_runtime", "cudaLaunchKernel", int(1.5 * MS),
                int(1.6 * MS), corr=9, linked=2)]
    tl = trace.from_events(ev)
    assert [d[3] for d in tl.dev] == ["kernel", "gpu_memcpy"]
    assert tl.busy_s() == pytest.approx(0.002)
    assert tl.device_time(lambda o: o == "wm::fused_mlp")[1] == 2
    assert [o[3] for o in tl.ops] == [trace.WINDOW, "wm::fused_mlp"]
