"""Per-epoch evaluation: forward + criterion logging + postprocess + COCO mAP;
counterpart of wildlifemapper_tpu/eval/evaluate.py.

Behavioral parity target: inference.py:29-88 (evaluate): per batch run the
model, log criterion losses, PostProcess at confidence 0.05, accumulate into
the COCO evaluator keyed by image_id, then summarize the 12-stat suite.
The forward, the criterion and the post-processing run on the model's
device; their results cross to the host behind them without a wait, and the
host reads them one batch behind, while the card runs the next.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.loader import DataLoader
from ..parallel.distributed import (all_gather_objects, data_group,
                                    get_data_world_size)
from ..train.metrics import MetricLogger
from .coco_eval import CocoEvaluator
from .postprocess import batched_nms, postprocess

# what the eval step reads of a batch ("size" re-zeroes the pad band of a
# uint8 canvas normalised on the device, as in training)
STEP_KEYS = ("image", "labels", "boxes", "valid", "size", "batch_valid")


def to_device(batch, keys, device: torch.device) -> Dict[str, torch.Tensor]:
    """The batch's `keys` on `device`. A pinned host tensor (the loader's
    `pin_memory`) is copied without a wait."""
    return {k: torch.as_tensor(batch[k]).to(device, non_blocking=True)
            for k in keys if k in batch}


def to_host(tensors: Dict[str, torch.Tensor]):
    """Host copies of `tensors`, queued behind the work that computes them
    (from the card into pinned memory, without a wait), and the CUDA event
    that marks them complete (None when they are already on the host): read
    them after `event.synchronize()`. Queued as soon as the work is, they
    are complete by the time the host has waited for any later work, so a
    read one step behind finds them complete and waits for nothing queued
    after them."""
    if not any(t.is_cuda for t in tensors.values()):
        return dict(tensors), None
    host = {k: t.to("cpu", non_blocking=True) for k, t in tensors.items()}
    done = torch.cuda.Event()
    done.record()
    return host, done


def _log_first_batch_images(logger_backend, epoch: int, batch, dets,
                            max_images: int = 8, score_threshold: float = 0.5):
    """Render val bbox overlays for the epoch log (reference:
    wandb_logger.py:169-270 log_detection_results — first batch, up to 8
    images, predictions above score 0.5)."""
    try:  # overlay building + rendering must never kill an eval epoch
        images, detections = [], []
        for i in range(len(batch["image_id"])):
            if not batch["batch_valid"][i] or len(images) >= max_images:
                continue
            h, w = int(batch["size"][i][0]), int(batch["size"][i][1])
            # dets boxes are at orig_size scale (COCO coords); map back onto
            # the resized content region for drawing
            oh, ow = (float(batch["orig_size"][i][0]),
                      float(batch["orig_size"][i][1]))
            sx, sy = w / max(ow, 1.0), h / max(oh, 1.0)
            keep = np.asarray(dets["keep"][i]) & (
                np.asarray(dets["scores"][i]) > score_threshold)
            boxes = np.asarray(dets["boxes"][i])[keep] * [sx, sy, sx, sy]
            images.append(np.asarray(batch["image"][i][:h, :w]))
            detections.append(
                {"boxes": boxes,
                 "labels": np.asarray(dets["labels"][i])[keep],
                 "scores": np.asarray(dets["scores"][i])[keep]})
        logger_backend.log_images(epoch, images, detections)
    except Exception as e:
        print(f"Warning: could not log detection overlays: {e}")


def evaluate(eval_step: Callable, model: torch.nn.Module, loader: DataLoader,
             gt_index, cfg: Config, epoch: int = 0,
             apply_nms: bool = False, print_fn=print,
             max_batches: Optional[int] = None,
             logger_backend=None) -> Dict[str, float]:
    """COCO stats, per-category AP and the criterion's meters over the
    loader's epoch. `eval_step(model, batch)` is StepBuilder.eval_step."""
    evaluator = CocoEvaluator(gt_index)
    logger = MetricLogger(print_fn=print_fn)
    device = next(model.parameters()).device

    n_batches = loader.batches_per_epoch()
    if max_batches:
        n_batches = min(n_batches, max_batches)

    def consume(batch, results, is_first: bool):
        """Host-side half of one batch: meters, overlays, COCO
        accumulation."""
        (dets, losses), done = results
        if done is not None:
            done.synchronize()
        dets = {k: v.numpy() for k, v in dets.items()}
        logger.update(**{k: float(v) for k, v in losses.items()})
        batch = {k: np.asarray(v) for k, v in batch.items()}

        if is_first and logger_backend is not None:
            # in-training val bbox overlays, first batch, like the
            # reference's log_detection_results (wandb_logger.py:169-270,
            # max 8 images, score > 0.5)
            _log_first_batch_images(logger_backend, epoch, batch, dets)

        preds = {}
        for i in range(len(batch["image_id"])):
            if not batch["batch_valid"][i]:
                continue
            keep = dets["keep"][i]
            preds[int(batch["image_id"][i])] = {
                "scores": dets["scores"][i][keep],
                "labels": dets["labels"][i][keep],
                "boxes": dets["boxes"][i][keep],
            }
        evaluator.update(preds)

    pending = None
    consumed_any = False
    warned_swap = False
    batches = loader.epoch(epoch)
    try:
        for i, batch in enumerate(logger.log_every(batches, 10, header="Eval:",
                                                   total=n_batches)):
            if i >= n_batches:
                break
            if not warned_swap and cfg.eval.hw_swap_compat:
                os_hw = np.asarray(batch["orig_size"])
                if (os_hw[:, 0] != os_hw[:, 1]).any():
                    # The replicated reference quirk (build_sam.py:252: x
                    # scaled by height, y by width) is a no-op on square
                    # tiles but misplaces every detection on non-square
                    # images, driving COCO AP to ~0 regardless of model
                    # quality.
                    print_fn("WARNING: hw_swap_compat=True with non-square "
                             "images — COCO mAP will be meaningless (boxes "
                             "scaled into a swapped frame). Pass "
                             "--fix_hw_swap unless you need bug-for-bug "
                             "reference parity.")
                warned_swap = True
            # padded final-batch rows (last example repeated) are masked out
            # of the loss meters in the criterion through batch_valid
            arrays = to_device(batch, STEP_KEYS, device)
            out, losses = eval_step(model, arrays)
            dets = postprocess(out, to_device(batch, ("orig_size",),
                                              device)["orig_size"],
                               cfg.eval.confidence_threshold,
                               cfg.eval.hw_swap_compat)
            if apply_nms:
                dets["keep"] = batched_nms(dets["boxes"], dets["scores"],
                                           dets["labels"], dets["keep"],
                                           cfg.eval.nms_iou,
                                           class_aware=False)
            if pending is not None:
                consume(*pending, is_first=not consumed_any)
                consumed_any = True
            # the second copy's event marks the first's complete too
            losses_host, _ = to_host(losses)
            dets_host, done = to_host(dets)
            pending = (batch, ((dets_host, losses_host), done))
        if pending is not None:
            consume(*pending, is_first=not consumed_any)
    finally:
        batches.close()

    if get_data_world_size() > 1:
        # cross-process merge (reference: pickle all_gather of eval_imgs,
        # inference.py:240-259) over the data group, whose ranks hold one
        # rank of each model group: a model group's detections, the same on
        # each of its ranks, enter once. Every rank scores the same list, in
        # the split's own order, which one process's unshuffled loader
        # follows: the same detections then give one process's stats to the
        # last bit (score ties across images break by that order). An id
        # that the loader repeats to pad a shard counts once.
        dts = {}
        for shard in all_gather_objects(evaluator._dts, data_group()):
            for img_id, pred in shard.items():
                dts.setdefault(img_id, pred)
        order = {img_id: n for n, img_id in enumerate(gt_index.ids)}
        evaluator = CocoEvaluator(gt_index)
        evaluator.update({i: dts[i] for i in sorted(dts, key=order.get)})
    evaluator.accumulate()
    stats = evaluator.summarize()
    evaluator.print_summary()
    out_stats = {f"coco/{k}": v for k, v in stats.items()}
    names = {c["id"]: c.get("name", f"class_{c['id']}")
             for c in getattr(gt_index, "categories", [])}
    for cat, ap in evaluator.per_category_ap().items():
        out_stats[f"coco/AP_{names.get(cat, cat)}"] = ap
    out_stats.update(logger.global_averages())
    return out_stats
