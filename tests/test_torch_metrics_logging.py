"""The port's meters, loggers and profiling helpers
(wildlifemapper_tpu_torch/train/{metrics,logging,profiling}.py): the cases of
tests/test_metrics_logging.py and tests/test_profiling.py on the port's
copies, and the JSONL events of both packages side by side."""

import json

import numpy as np
import pytest
import torch

from wildlifemapper_tpu.train import logging as jlog
from wildlifemapper_tpu.train.metrics import MetricLogger as JMetricLogger
from wildlifemapper_tpu_torch.train import logging as tlog
from wildlifemapper_tpu_torch.train.metrics import MetricLogger, SmoothedValue
from wildlifemapper_tpu_torch.train.profiling import (StepTimer,
                                                      device_memory_stats,
                                                      trace)


def test_smoothed_value_window():
    s = SmoothedValue(window_size=3)
    for v in (1.0, 2.0, 3.0, 4.0):
        s.update(v)
    assert s.median == 3.0          # window holds 2,3,4
    assert s.avg == 3.0
    assert s.global_avg == 2.5      # all four
    assert s.value == 4.0


@pytest.mark.parametrize("cls", [MetricLogger, JMetricLogger],
                         ids=["port", "jax"])
def test_metric_logger_log_every(cls):
    lines = []
    logger = cls(print_fn=lines.append)
    total = 0
    for x in logger.log_every(range(7), print_freq=3, header="T:"):
        logger.update(loss=float(x))
        total += x
    assert total == 21
    assert sum("eta" in ln for ln in lines) == 3      # steps 0, 3, 6
    assert any("Total time" in ln for ln in lines)
    assert logger.global_averages()["loss"] == 3.0


def test_meter_sync_single_process_noop():
    lg = MetricLogger(print_fn=lambda *a, **k: None)
    lg.update(loss=2.0)
    lg.update(loss=4.0)
    lg.synchronize_between_processes()
    assert lg.global_averages()["loss"] == 3.0


def _events(path):
    return [{k: v for k, v in json.loads(line).items() if k != "time"}
            for line in path.read_text().splitlines()]


def test_jsonl_events_match_jax(tmp_path):
    """The same calls write the same events (less their times)."""
    for mod, name in ((jlog, "jax"), (tlog, "port")):
        lg = mod.JsonlLogger(str(tmp_path / name), config={"lr": 1e-4},
                             run_name="t")
        lg.log_batch(0, 10, {"loss": 1.5})
        lg.log_epoch(0, {"val/AP": 0.3})
        lg.log_table("per_class_ap", ["class", "ap"], [["zebra", 0.5]])
        lg.log_artifact("ckpt", "best_checkpoint",
                        metadata={"epoch": 3, "loss": 1.25})
        lg.log_summary({"best": 0.4})
        lg.finish()
    want = _events(tmp_path / "jax" / "t.jsonl")
    got = _events(tmp_path / "port" / "t.jsonl")
    assert got == want
    assert [e["event"] for e in got] == ["config", "batch", "epoch", "table",
                                         "artifact", "summary"]


def test_setup_logger_fallbacks(tmp_path):
    assert isinstance(tlog.setup_logger(False, str(tmp_path)), tlog.NoOpLogger)
    try:
        import wandb  # noqa: F401
        pytest.skip("wandb is installed; the fallback is not taken")
    except ImportError:
        pass
    lg = tlog.setup_logger(True, str(tmp_path), config=None, run_name="x")
    assert isinstance(lg, tlog.JsonlLogger)
    lg.finish()


def test_jsonl_image_logging(tmp_path):
    """Overlays of a normalised f32 image and of a uint8 one are written."""
    lg = tlog.JsonlLogger(str(tmp_path), run_name="imgs")
    det = {"boxes": [[2, 2, 20, 20]], "labels": [3], "scores": [0.9]}
    lg.log_images(1, [np.zeros((32, 32, 3), np.float32),
                      np.full((32, 32, 3), 200, np.uint8)], [det, None])
    lg.finish()
    files = sorted((tmp_path / "imgs_images").glob("*.jpg"))
    assert [f.name for f in files] == ["epoch_1_0.jpg", "epoch_1_1.jpg"]


def test_render_detections_matches_jax():
    """The port's draw_detections draws the JAX package's pixels."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(40, 50, 3)).astype(np.float32)
    boxes, labels, scores = [[3, 4, 30, 20], [10, 10, 45, 38]], [2, 9], \
        [0.9, 0.55]
    want = np.asarray(jlog.render_detections(img, boxes, labels, scores))
    got = np.asarray(tlog.render_detections(img, boxes, labels, scores))
    np.testing.assert_array_equal(got, want)


def test_histograms_over_tensors(tmp_path):
    """Histograms summarise each tensor of a (nested) mapping, as the JAX
    logger summarises a pytree's leaves."""
    lg = tlog.JsonlLogger(str(tmp_path), run_name="t")
    lg.log_histograms(0, {"block.kernel": torch.arange(12.0).reshape(3, 4),
                          "nested": {"bias": torch.zeros(4)}})
    lg.finish()
    h = _events(tmp_path / "t.jsonl")[0]["histograms"]
    assert set(h) == {"params/block.kernel", "params/nested/bias"}
    k = h["params/block.kernel"]
    assert k["min"] == 0.0 and k["max"] == 11.0 and sum(k["counts"]) == 12
    ref = jlog._histogram_summaries(
        {"block": {"kernel": np.arange(12.0).reshape(3, 4)}}, "params")
    assert ref["params/block/kernel"] == k


def test_trace_writes_profile(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir) as d:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum().item()
    assert d == logdir
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_step_timer_averages():
    timer = StepTimer()
    x = torch.ones(128, 128)
    for _ in range(3):
        timer.start()
        out = (x @ x).sum()
        assert timer.stop(out) >= 0
    timer.start()
    timer.stop({"a": torch.ones(3), "b": [torch.zeros(2)]})
    timer.start()
    timer.stop(None)
    assert len(timer.times) == 5
    assert timer.mean == pytest.approx(sum(timer.times) / 5)


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert len(stats) == n
    for v in stats.values():
        assert set(v) == {"bytes_in_use_gb", "peak_bytes_gb",
                          "bytes_limit_gb"}
