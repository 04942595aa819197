"""Experiment logging with a wandb-compatible adapter; counterpart of
wildlifemapper_tpu/train/logging.py (histograms over torch tensors, and the
port's own copy of the visualize CLI's draw_detections, PIL imported inside).

Behavioral parity target: wandb_logger.py — per-batch loss/lr/class_error
every 50 iters (train.py:305-312), per-epoch train/val stats
(wandb_logger.py:68-99), config capture (:338-402), no-op when disabled
(:39-42). wandb itself is optional: when importable it
is used directly; otherwise an offline JSONL backend writes the same
payloads to disk so runs stay inspectable.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class NoOpLogger:
    """Disabled logging (reference: use_wandb=False path)."""

    def log_batch(self, epoch: int, step: int, metrics: Dict[str, float]):
        pass

    def log_epoch(self, epoch: int, stats: Dict[str, float]):
        pass

    def log_images(self, epoch: int, images, detections=None):
        """Bbox-overlay image logging (wandb_logger.py:169-270 equivalent)."""
        pass

    def log_histograms(self, epoch: int, tensors: Dict[str, Any],
                       prefix: str = "params"):
        """Param/grad histogram logging (wandb_logger.py:101-120 model watch
        + :272-288 histograms). `tensors` is a flat or nested mapping of
        tensors or arrays (a state dict)."""
        pass

    def log_table(self, name: str, columns, rows):
        """Tabular logging (wandb_logger.py:282-288)."""
        pass

    def log_artifact(self, path: str, name: str, type: str = "model",
                     metadata: Optional[Dict[str, Any]] = None):
        """Checkpoint-artifact logging (wandb_logger.py:306-329 logs the
        best checkpoint as a wandb artifact)."""
        pass

    def log_summary(self, stats: Dict[str, float]):
        pass

    def finish(self):
        pass


def _flat_tensors(tensors, prefix: str):
    """(name, numpy array) for each tensor of a flat or nested mapping
    (a state dict, named parameters), names joined by '/'."""
    import numpy as np
    import torch

    for key, value in tensors.items():
        name = f"{prefix}/{key}"
        if isinstance(value, dict):
            yield from _flat_tensors(value, name)
            continue
        if isinstance(value, torch.Tensor):
            value = value.detach().float().cpu().numpy()
        yield name, np.asarray(value)


def _histogram_summaries(tensors, prefix: str, bins: int = 64):
    """Flatten a mapping of tensors into {name: histogram-dict} summaries."""
    import numpy as np

    out = {}
    for name, arr in _flat_tensors(tensors, prefix):
        arr = arr.ravel()
        if arr.size == 0 or not np.issubdtype(arr.dtype, np.number):
            continue
        arr = arr.astype(np.float64)
        counts, edges = np.histogram(arr[np.isfinite(arr)], bins=bins)
        out[name] = {
            "min": float(arr.min()), "max": float(arr.max()),
            "mean": float(arr.mean()), "std": float(arr.std()),
            "counts": counts.tolist(), "edges": edges.tolist(),
        }
    return out


# Species map (visualize_prediction.py:82-91). BGR there; RGB here.
SPECIES = {
    1: ("Shoats", (255, 0, 0)),
    2: ("Cattle", (0, 255, 0)),
    3: ("Impala", (0, 0, 255)),
    4: ("Zebra", (255, 255, 0)),
    5: ("Wildebeest", (255, 0, 255)),
    6: ("Buffalo", (0, 255, 255)),
    7: ("Topi", (128, 0, 128)),
    8: ("Other", (255, 165, 0)),
}


def draw_detections(image, boxes, labels, scores, width: int = 2):
    """Per-species coloured boxes and labels on a PIL image
    (visualize_prediction.py:82-133; the JAX package's
    cli/visualize.py::draw_detections), PIL imported here."""
    from PIL import ImageDraw

    img = image.convert("RGB").copy()
    d = ImageDraw.Draw(img)
    for (x0, y0, x1, y1), lbl, sc in zip(boxes, labels, scores):
        name, color = SPECIES.get(int(lbl), ("Other", (255, 165, 0)))
        d.rectangle([x0, y0, x1, y1], outline=color, width=width)
        d.text((x0, max(y0 - 10, 0)), f"{name} {sc:.2f}", fill=color)
    return img


def render_detections(image_norm, boxes, labels, scores):
    """Draw detections on an (H, W, 3) pipeline image — ImageNet-normalized
    f32 (denormalized here) or uint8 (`--device_normalize` ships raw bytes);
    shared by the image-logging backends and the visualize CLI."""
    import numpy as np
    from PIL import Image

    from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD

    arr = np.asarray(image_norm)
    if arr.dtype != np.uint8:
        arr = ((arr * IMAGENET_STD + IMAGENET_MEAN)
               * 255).clip(0, 255).astype("uint8")
    return draw_detections(Image.fromarray(arr), boxes, labels, scores)


class JsonlLogger(NoOpLogger):
    """Offline backend: one JSON object per logged event."""

    def __init__(self, directory: str, config: Optional[Any] = None,
                 run_name: Optional[str] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        name = run_name or time.strftime("run_%Y%m%d_%H%M%S")
        self.path = self.dir / f"{name}.jsonl"
        self._f = open(self.path, "a")
        if config is not None:
            self._write({"event": "config", "config": _config_dict(config)})

    def _write(self, obj):
        obj["time"] = time.time()
        self._f.write(json.dumps(obj) + "\n")
        self._f.flush()

    def log_batch(self, epoch, step, metrics):
        self._write({"event": "batch", "epoch": epoch, "step": step,
                     **{k: float(v) for k, v in metrics.items()}})

    def log_epoch(self, epoch, stats):
        self._write({"event": "epoch", "epoch": epoch,
                     **{k: float(v) for k, v in stats.items()}})

    def log_images(self, epoch, images, detections=None):
        """Render overlays to <run>/images/epoch_<n>_<i>.jpg."""
        img_dir = self.path.parent / f"{self.path.stem}_images"
        img_dir.mkdir(exist_ok=True)
        detections = detections or [None] * len(images)
        for i, (img, det) in enumerate(zip(images, detections)):
            if det is not None:
                rendered = render_detections(img, det["boxes"],
                                             det["labels"], det["scores"])
            else:
                rendered = render_detections(img, [], [], [])
            rendered.save(img_dir / f"epoch_{epoch}_{i}.jpg")
        self._write({"event": "images", "epoch": epoch, "count": len(images)})

    def log_histograms(self, epoch, tensors, prefix="params"):
        self._write({"event": "histograms", "epoch": epoch,
                     "histograms": _histogram_summaries(tensors, prefix)})

    def log_table(self, name, columns, rows):
        self._write({"event": "table", "name": name,
                     "columns": list(columns),
                     "rows": [list(r) for r in rows]})

    def log_artifact(self, path, name, type="model", metadata=None):
        self._write({"event": "artifact", "name": name, "type": type,
                     "path": str(path), "metadata": metadata or {}})

    def log_summary(self, stats):
        self._write({"event": "summary",
                     **{k: float(v) for k, v in stats.items()}})

    def finish(self):
        self._f.close()


class WandbLogger(NoOpLogger):
    """Real wandb backend (requires the wandb package)."""

    def __init__(self, project: str, config: Optional[Any] = None,
                 run_name: Optional[str] = None, **kwargs):
        import wandb  # optional dependency

        self._run = wandb.init(project=project, name=run_name,
                               config=_config_dict(config) if config else None,
                               **kwargs)
        self._wandb = wandb

    def log_batch(self, epoch, step, metrics):
        self._wandb.log({"epoch": epoch, "batch": step,
                         **{f"batch/{k}": v for k, v in metrics.items()}})

    def log_epoch(self, epoch, stats):
        self._wandb.log({"epoch": epoch, **stats})

    def log_images(self, epoch, images, detections=None):
        """wandb.Image overlays (wandb_logger.py:169-270 equivalent)."""
        import numpy as np

        detections = detections or [None] * len(images)
        rendered = []
        for img, det in zip(images, detections):
            det = det or {"boxes": [], "labels": [], "scores": []}
            rendered.append(self._wandb.Image(np.asarray(render_detections(
                img, det["boxes"], det["labels"], det["scores"]))))
        if rendered:
            self._wandb.log({"epoch": epoch, "detection_results": rendered})

    def log_histograms(self, epoch, tensors, prefix="params"):
        import numpy as np

        payload = {"epoch": epoch}
        for name, arr in _flat_tensors(tensors, prefix):
            arr = arr.ravel()
            if arr.size == 0 or not np.issubdtype(arr.dtype, np.number):
                continue
            payload[name] = self._wandb.Histogram(
                np.asarray(arr[np.isfinite(arr)], dtype=np.float64))
        self._wandb.log(payload)

    def log_table(self, name, columns, rows):
        self._wandb.log({name: self._wandb.Table(columns=list(columns),
                                                 data=[list(r) for r in rows])})

    def log_artifact(self, path, name, type="model", metadata=None):
        art = self._wandb.Artifact(name, type=type, metadata=metadata or {})
        from pathlib import Path as _P
        p = _P(path)
        if p.is_dir():
            art.add_dir(str(p))
        else:
            art.add_file(str(p))
        self._run.log_artifact(art)

    def log_summary(self, stats):
        for k, v in stats.items():
            self._run.summary[k] = v

    def finish(self):
        self._run.finish()


def _config_dict(config: Any) -> Dict[str, Any]:
    if dataclasses.is_dataclass(config):
        return dataclasses.asdict(config)
    return dict(config)


def setup_logger(use_wandb: bool, workdir: str, config: Optional[Any] = None,
                 project: str = "wildlifemapper-tpu",
                 run_name: Optional[str] = None):
    """Mirror of setup_wandb_logger (wandb_logger.py:338-402): returns a
    no-op unless logging is requested; falls back to JSONL when wandb is
    missing."""
    if not use_wandb:
        return NoOpLogger()
    try:
        return WandbLogger(project, config=config, run_name=run_name)
    except ImportError:
        return JsonlLogger(f"{workdir}/logs", config=config, run_name=run_name)
