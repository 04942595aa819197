"""Streaming orthomosaic inference on the card; counterpart of
wildlifemapper_tpu/eval/orthomosaic.py: sliding-window tiling -> fixed-shape
batched detection -> global cross-seam NMS.

A batch of uint8 tiles is extracted on the host into one of two pinned
buffers, copied to the card without a wait, normalised there, and runs
forward + postprocess; its detections cross back to pinned host memory
behind it. While the card runs batch i the host extracts batch i+1 and fuses
batch i-1. Tile extraction and the final fusion are host-side numpy over
small arrays.

Over a process group (the data axis, parallel/mesh.py) each rank, on its own card,
takes every N-th tile batch; the ranks' per-tile detections are gathered in
tile order and every rank runs the final NMS on the whole set. The JAX
package shards each batch over one process's devices instead; here one host
thread would not feed N cards, since the survey path is bound by the host's
dispatch on one.
"""

from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..data import tiler
from ..data.transforms import IMAGENET_MEAN, IMAGENET_STD
from ..parallel.distributed import (all_gather_objects, get_rank,
                                    get_world_size)
from .evaluate import to_host
from .postprocess import postprocess


def _nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou: float) -> np.ndarray:
    """Greedy class-agnostic NMS over the (small) fused candidate set."""
    order = np.argsort(-scores, kind="mergesort")
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        xx0 = np.maximum(boxes[i, 0], boxes[order, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[order, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[order, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[order, 3])
        inter = np.clip(xx1 - xx0, 0, None) * np.clip(yy1 - yy0, 0, None)
        ious = inter / np.maximum(areas[i] + areas[order] - inter, 1e-9)
        suppressed[order[ious > iou]] = True
    return np.asarray(keep, dtype=np.int64)


class OrthomosaicDetector:
    """Detect over an arbitrarily large RGB mosaic with a trained model.

    The model holds its parameters (there is no `params` argument) and its
    device is where the batches run. In a process group of N ranks the
    tile batches are split over the ranks, batch i to rank i mod N, and every rank returns
    the whole mosaic's detections: those of one process, since each tile
    runs at the same batch size and position either way. `timing` holds
    the host's ms of the last `detect`: extracting tiles, waiting for
    detections, and the final NMS.
    """

    def __init__(self, model: torch.nn.Module, model_cfg: ModelConfig,
                 tile_batch: int = 4, overlap: int = 256,
                 confidence_threshold: float = 0.5, nms_iou: float = 0.4):
        self.model = model
        self.cfg = model_cfg
        self.tile_batch = tile_batch
        self.overlap = overlap
        self.confidence_threshold = confidence_threshold
        self.nms_iou = nms_iou
        self.device = next(model.parameters()).device
        tile = model_cfg.img_size
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.as_tensor(IMAGENET_STD, device=self.device)
        self._sizes = torch.full((tile_batch, 2), tile, dtype=torch.int32,
                                 device=self.device)
        # two host buffers in turns, so that a copy in flight is never
        # overwritten: pinned on the card's host, so its copy does not wait
        pin = self.device.type == "cuda"
        self._buffers = [torch.zeros((tile_batch, tile, tile, 3),
                                     dtype=torch.uint8, pin_memory=pin)
                         for _ in range(2)]
        self._copied: List = [None, None]
        self.timing: Dict[str, float] = {}

    def run(self, tiles_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One batch on the model's device: uint8 (tile_batch, tile, tile, 3)
        -> postprocess's (tile_batch, Q) dict in tile coordinates, with the
        uint8 -> normalised f32 preprocessing fused in front."""
        with torch.inference_mode():
            x = tiles_u8.to(torch.float32) / 255.0
            x = (x - self._mean) / self._std
            out = self.model(x)
            return postprocess(out, self._sizes, self.confidence_threshold,
                               hw_swap_compat=False)

    def _fill(self, slot: int, mosaic: np.ndarray, grid: tiler.TileGrid,
              idxs: Sequence[int]) -> None:
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()    # its last copy has landed
        tiler.extract_tiles(mosaic, grid, idxs,
                            out=self._buffers[slot].numpy())

    def candidates(self, mosaic: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """mosaic: (H, W, 3) uint8 -> every tile's kept detections in mosaic
        coordinates before the cross-seam NMS: boxes (N, 4) xyxy, scores
        (N,), labels (N,), in tile order.

        Double-buffered: batch i is launched, then the host extracts batch
        i+1 and fuses batch i-1 (tile IO overlapped with device compute).
        In a process group this rank runs its own batches and the
        candidates of all are gathered."""
        h, w = mosaic.shape[:2]
        grid = tiler.make_tile_grid(h, w, self.cfg.img_size, self.overlap)
        batches = list(tiler.batched(range(grid.num_tiles), self.tile_batch))
        ranks = get_world_size()
        batches = batches[get_rank()::ranks]
        found = []          # (tile index, boxes, scores, labels)
        timing = dict(extract_ms=0.0, launch_ms=0.0, wait_ms=0.0)

        def drain(idxs, host, done):
            t0 = time.perf_counter()
            if done is not None:
                done.synchronize()
            timing["wait_ms"] += (time.perf_counter() - t0) * 1e3
            dets = {k: v.numpy() for k, v in host.items()}
            for j, ti in enumerate(idxs):
                keep = dets["keep"][j]
                if not keep.any():
                    continue
                found.append((ti, tiler.uncrop_boxes(dets["boxes"][j][keep],
                                                     grid.origins[ti]),
                              dets["scores"][j][keep],
                              dets["labels"][j][keep]))

        def fill(slot, idxs):
            t0 = time.perf_counter()
            self._fill(slot, mosaic, grid, idxs)
            timing["extract_ms"] += (time.perf_counter() - t0) * 1e3

        pending = None
        if batches:
            fill(0, batches[0])
        for i, idxs in enumerate(batches):
            slot = i % 2
            t0 = time.perf_counter()
            tiles = self._buffers[slot].to(self.device, non_blocking=True)
            if tiles.is_cuda:
                self._copied[slot] = torch.cuda.Event()
                self._copied[slot].record()
            host, done = to_host(self.run(tiles))
            timing["launch_ms"] += (time.perf_counter() - t0) * 1e3
            if i + 1 < len(batches):
                fill(1 - slot, batches[i + 1])
            if pending is not None:
                drain(*pending)
            pending = (idxs, host, done)
        if pending is not None:
            drain(*pending)
        self.timing = timing
        if ranks > 1:
            # every rank's tiles, back in tile order (each tile once)
            found = sorted((f for part in all_gather_objects(found)
                            for f in part), key=lambda f: f[0])
        if not found:
            return (np.zeros((0, 4), np.float32), np.zeros(0, np.float32),
                    np.zeros(0, np.int32))
        boxes, scores, labels = (np.concatenate(c)
                                 for c in list(zip(*found))[1:])
        return boxes, scores, labels

    def detect(self, mosaic: np.ndarray) -> Dict[str, np.ndarray]:
        """mosaic: (H, W, 3) uint8. Returns fused detections in mosaic
        coordinates: boxes (N, 4) xyxy, scores (N,), labels (N,)."""
        boxes, scores, labels = self.candidates(mosaic)
        if not len(boxes):
            return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0),
                    "labels": np.zeros(0, np.int64)}
        t0 = time.perf_counter()
        keep = _nms_numpy(boxes, scores, self.nms_iou)
        self.timing["nms_ms"] = (time.perf_counter() - t0) * 1e3
        return {"boxes": boxes[keep], "scores": scores[keep],
                "labels": labels[keep]}
