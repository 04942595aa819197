"""Batched data loading with background prefetch and shard-aware slicing;
counterpart of wildlifemapper_tpu/data/loader.py, with no PIL at import.

Replaces the reference's torch DataLoader + DistributedSampler + collate
stack (train.py:157-170, misc.py:75-84). Emits fixed-shape numpy batches;
with `pin_memory` (the training loop on the card) each array is collated
into a pinned host tensor instead, so that its copy to the card does not
wait. Sharding follows the DistributedSampler recipe: epoch-seeded global
permutation, rank-strided slice, drop_last.

When image files are absent, `synthetic=True` renders deterministic tiles
with the real annotation geometry drawn in (class-shaded ellipses on a
smooth background). The renderer, its cache keys and the three random
streams (the epoch permutation, the epoch stream of flips, the per-example
seeds of a worker pool) are the JAX loader's, so one seed gives the JAX
loader's batches; the resize is data/transforms.py's.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .coco import CocoIndex
from .transforms import (PreprocessConfig, decode_image, finish_example,
                         preprocess_example, resize_image_and_boxes,
                         target_from_annotations)


# Disk-cache schema version for _synthetic_image's output (the JAX
# loader's). Bump whenever the renderer changes so WM_SYNTH_CACHE entries
# rendered by an older version miss instead of serving stale pixels.
_SYNTH_RENDER_VERSION = 2

# Distinct per-class body shades (RGB) so class identity is visually
# recoverable from a synthetic tile — arbitrary but fixed.
_CLASS_SHADES = np.array(
    [(30, 30, 30), (60, 20, 20), (20, 60, 20), (20, 20, 70), (70, 60, 10),
     (10, 60, 70), (70, 10, 60), (45, 45, 5)], np.float64)


def _synthetic_image(image_id: int, width: int, height: int,
                     anns=()) -> np.ndarray:
    """Deterministic (id-seeded) stand-in tile for a missing file, as a
    uint8 (height, width, 3) RGB array.

    Smooth low-frequency background plus one shaded ellipse per annotation
    bbox (class-keyed color) — the image content *determines* the targets,
    so a model trained on synthetic data learns a real detection function
    rather than memorizing noise."""
    rng = np.random.default_rng(image_id)
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    base = (128.0 + 36.0 * np.sin(xs / 91.0 + rng.uniform(0, 6.3))[None, :]
            + 28.0 * np.sin(ys / 67.0 + rng.uniform(0, 6.3))[:, None]
            ).astype(np.float32)
    # coarse 8x8-upsampled noise: 64x cheaper than per-pixel normal() and
    # just as effective as background texture
    noise = rng.normal(0.0, 5.0, size=(-(-height // 8), -(-width // 8))
                       ).astype(np.float32)
    base = base + np.kron(noise, np.ones((8, 8), np.float32)
                          )[:height, :width]
    arr = np.repeat(base[..., None], 3, axis=2)
    for a in anns:
        bx, by, bw, bh = (float(v) for v in a["bbox"])
        x0, y0 = max(int(bx), 0), max(int(by), 0)
        x1 = min(int(np.ceil(bx + bw)) + 1, width)
        y1 = min(int(np.ceil(by + bh)) + 1, height)
        if x1 <= x0 or y1 <= y0:
            continue
        cx, cy = bx + bw / 2.0, by + bh / 2.0
        rx, ry = max(bw / 2.0, 1.5), max(bh / 2.0, 1.5)
        lx = (np.arange(x0, x1, dtype=np.float64) - cx) / rx
        ly = (np.arange(y0, y1, dtype=np.float64) - cy) / ry
        m = lx[None, :] ** 2 + ly[:, None] ** 2 <= 1.0
        patch = arr[y0:y1, x0:x1]
        patch[m] = _CLASS_SHADES[int(a.get("category_id", 1)) % 8]
    return arr.clip(0, 255).astype(np.uint8)


def _synthetic_for(info, image_id: int, anns):
    """Render the synthetic tile for one image record at the index's
    frame. All geometry scaling (synthetic_size proxies) happens once, in
    _ScaledIndexView — `info`/`anns` arrive here already in the rendered
    frame, so rescaling again would double-scale."""
    w, h = info.get("width", 1024), info.get("height", 1024)
    return _synthetic_image(image_id, w, h, anns), anns


class _ScaledIndexView:
    """CocoIndex view with all geometry rescaled into the rendered
    `synthetic_size` frame.

    Scaled synthetic proxies render every tile at `synthetic_size`, so the
    targets the dataset serves AND the ground truth `evaluate()` scores
    against (it reads `dataset.index`) must both live in that frame. The
    view scales once, at the index level, which keeps the three consumers
    — tile renderer, target builder, COCO evaluator — coherent by
    construction.
    """

    def __init__(self, inner: CocoIndex, size: int):
        self._inner = inner
        self._size = size
        self.ann_file = inner.ann_file
        self.categories = inner.categories
        self.ids = inner.ids
        self._anns_cache: dict = {}
        self._info_cache: dict = {}

    def __len__(self):
        return len(self._inner)

    def max_anns_per_image(self) -> int:
        return self._inner.max_anns_per_image()

    def image_info(self, image_id: int) -> dict:
        info = self._info_cache.get(image_id)
        if info is None:
            info = dict(self._inner.image_info(image_id),
                        width=self._size, height=self._size)
            self._info_cache[image_id] = info
        return info

    def image_path(self, image_id: int, root: Optional[str]):
        # Scaled proxies always render: a real file would be in the
        # original frame and disagree with the rescaled targets/GT.
        return None

    def annotations(self, image_id: int):
        anns = self._anns_cache.get(image_id)
        if anns is None:
            raw = self._inner.image_info(image_id)
            sx = self._size / raw.get("width", self._size)
            sy = self._size / raw.get("height", self._size)
            anns = [dict(a,
                         bbox=[a["bbox"][0] * sx, a["bbox"][1] * sy,
                               a["bbox"][2] * sx, a["bbox"][3] * sy],
                         area=float(a.get(
                             "area", a["bbox"][2] * a["bbox"][3])) * sx * sy)
                    for a in self._inner.annotations(image_id)]
            self._anns_cache[image_id] = anns
        return anns


class CocoDetectionDataset:
    """Index-addressable dataset of fixed-shape examples."""

    def __init__(self, ann_file: str, image_root: Optional[str],
                 preprocess: PreprocessConfig, synthetic: bool = False,
                 synthetic_size: Optional[int] = None):
        self.index = CocoIndex(ann_file)
        if synthetic and synthetic_size:
            self.index = _ScaledIndexView(self.index, synthetic_size)
        self.image_root = image_root
        self.preprocess = preprocess
        self.synthetic = synthetic
        self.synthetic_size = synthetic_size
        self._resolve_max_targets()
        # Synthetic tiles are deterministic (id-seeded): the post-resize raw
        # example is cached in memory (random augmentation happens after
        # this stage, so caching is exact), and on disk under
        # WM_SYNTH_CACHE (default wm_synth_cache in the temporary
        # directory; "0" or "" disables it) across processes.
        self._synth_cache: Optional[dict] = {} if synthetic else None
        disk = os.environ.get(
            "WM_SYNTH_CACHE",
            os.path.join(tempfile.gettempdir(), "wm_synth_cache"))
        self._synth_disk = (disk if synthetic and disk not in ("", "0")
                            else None)
        self._ann_fingerprint: Optional[str] = None  # lazy, see _disk_key

    def __len__(self):
        return len(self.index)

    def __getstate__(self):
        # A worker process gets the dataset without this process's render
        # cache (it may hold gigabytes); it fills its own.
        state = dict(self.__dict__)
        if state["_synth_cache"] is not None:
            state["_synth_cache"] = {}
        return state

    def _resolve_max_targets(self):
        """Size the fixed `max_targets` cap from the annotation file when
        it is left unset (None), so padding can never drop ground truth.
        Rounded up to a multiple of 8; mosaic composes 4 tiles, so its
        worst case is 4x the densest single image."""
        if self.preprocess.max_targets is not None:
            return
        densest = self.index.max_anns_per_image()
        if self.preprocess.use_mosaic:
            densest *= 4
        cap = max(8, -(-densest // 8) * 8)
        # replace() rather than mutate: the caller's PreprocessConfig may be
        # shared across datasets with different annotation files.
        self.preprocess = dataclasses.replace(self.preprocess,
                                              max_targets=cap)

    def _raw(self, i: int):
        """Load (resized uint8 array, xyxy boxes, labels, orig_size) for one
        index — the mosaic building block."""
        image_id = self.index.ids[i]
        info = self.index.image_info(image_id)
        path = self.index.image_path(image_id, self.image_root)
        anns = self.index.annotations(image_id)
        if path is not None:
            img = decode_image(path)
        elif self.synthetic:
            cached = self._synth_cache.get(i)
            if cached is None:
                cached = self._disk_load(image_id)
                if cached is not None:
                    self._synth_cache[i] = cached
            if cached is not None:
                return cached
            img, anns = _synthetic_for(info, image_id, anns)
        else:
            raise FileNotFoundError(
                f"image {info['file_name']} not found under {self.image_root}; "
                "pass synthetic=True to use generated tiles")
        tgt = target_from_annotations(anns, img.shape[1], img.shape[0])
        arr, boxes, size_hw = resize_image_and_boxes(
            img, tgt["boxes"], self.preprocess.resize_size,
            self.preprocess.resize_size)
        out = arr, boxes, tgt["labels"], tgt["orig_size"], image_id
        if path is None and self.synthetic:
            self._synth_cache[i] = out
            self._disk_save(image_id, out)
        return out

    def _disk_key(self, image_id: int) -> Optional[str]:
        if self._synth_disk is None:
            return None
        # Key includes the renderer schema version and an annotation-file
        # fingerprint (size+mtime): a renderer change or a regenerated ann
        # file with the same basename must MISS, not serve stale
        # images/targets.
        if self._ann_fingerprint is None:
            try:
                st = os.stat(self.index.ann_file)
                self._ann_fingerprint = f"{st.st_size}-{int(st.st_mtime)}"
            except OSError:
                self._ann_fingerprint = "nostat"
        tag = (f"{os.path.basename(self.index.ann_file)}"
               f"_v{_SYNTH_RENDER_VERSION}_{self._ann_fingerprint}"
               f"_{self.preprocess.resize_size}_{self.synthetic_size}")
        return f"{self._synth_disk}/{tag}_{image_id}.npz"

    def _disk_load(self, image_id: int):
        key = self._disk_key(image_id)
        if key is None or not os.path.exists(key):
            return None
        try:
            z = np.load(key, allow_pickle=False)
            return (z["arr"], z["boxes"], z["labels"], z["orig_size"],
                    image_id)
        except Exception:  # noqa: BLE001 - any torn/corrupt entry is a miss
            return None  # fall through to re-render

    def _disk_save(self, image_id: int, out):
        key = self._disk_key(image_id)
        if key is None:
            return
        try:
            os.makedirs(self._synth_disk, exist_ok=True)
            # tmp must already end in .npz: np.savez APPENDS the suffix to
            # names lacking it.
            tmp = f"{key}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
            np.savez(tmp, arr=out[0], boxes=out[1], labels=out[2],
                     orig_size=out[3])
            os.replace(tmp, key)  # atomic vs concurrent readers
        except OSError:
            pass  # cache is best-effort

    def _get_mosaic(self, i: int, rng: np.random.Generator):
        from .mosaic import make_mosaic

        idxs = [i] + [int(j) for j in rng.integers(0, len(self), 3)]
        rng.shuffle(idxs)
        raws = [self._raw(j) for j in idxs]
        s = self.preprocess.resize_size
        img, tgt = make_mosaic(
            [r[0] for r in raws],
            [{"boxes": r[1], "labels": r[2]} for r in raws], s, rng)
        return finish_example(img, tgt["boxes"], tgt["labels"], raws[0][4],
                              raws[0][3], (s, s), self.preprocess, rng)

    def get(self, i: int, rng: Optional[np.random.Generator] = None
            ) -> Dict[str, np.ndarray]:
        if self.preprocess.use_mosaic and rng is not None:
            return self._get_mosaic(i, rng)
        image_id = self.index.ids[i]
        info = self.index.image_info(image_id)
        path = self.index.image_path(image_id, self.image_root)
        if path is not None:
            return preprocess_example(path, self.index.annotations(image_id),
                                      image_id, self.preprocess, rng)
        if not self.synthetic:
            raise FileNotFoundError(
                f"image {info['file_name']} not found under {self.image_root}; "
                "pass synthetic=True to use generated tiles")
        # Route through the cached raw stage; finish_example applies the
        # per-epoch randomness (flip) after the cache boundary.
        arr, boxes, labels, orig_size, image_id = self._raw(i)
        return finish_example(arr, boxes, labels, image_id, orig_size,
                              arr.shape[:2], self.preprocess, rng)


def _stack(arrays, pin: bool):
    """np.stack, or with `pin` the same values in a pinned host tensor (its
    copy to the card then needs no wait)."""
    if not pin:
        return np.stack(arrays)
    first = np.asarray(arrays[0])
    out = torch.empty((len(arrays),) + first.shape,
                      dtype=torch.from_numpy(np.empty(0, first.dtype)).dtype,
                      pin_memory=True)
    np.stack(arrays, out=out.numpy())
    return out


def _collate(examples, pin: bool = False) -> Dict[str, np.ndarray]:
    return {k: _stack([e[k] for e in examples], pin) for k in examples[0]}


# Process-pool worker plumbing: the dataset is shipped once per worker via
# the initializer, not pickled per task.
_worker_ds: Optional[CocoDetectionDataset] = None


def _init_worker(ds):
    global _worker_ds
    # one intra-op thread a worker: the pool itself is the parallelism
    torch.set_num_threads(1)
    _worker_ds = ds


def _worker_get(i: int, seed: int):
    return _worker_ds.get(int(i), np.random.default_rng(int(seed)))


class DataLoader:
    """Epoch-based iterator over global batches (or this process's shard).

    drop_last is always on for the train split (train.py:162,
    BatchSampler(drop_last=True)); eval pads the final batch and reports
    `batch_valid` so downstream can mask padded rows.
    """

    def __init__(self, dataset: CocoDetectionDataset, batch_size: int,
                 shuffle: bool, seed: int = 42, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, num_workers: int = 0,
                 worker_mode: str = "thread", pin_memory: bool = False):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r}: 'thread' or "
                             "'process'")
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # >0: preprocess examples in a worker pool, like torch DataLoader
        # workers (train.py:167-170). worker_mode:
        #   "thread"  — ThreadPoolExecutor; the resize and the decode run
        #               in native code that releases the GIL.
        #   "process" — a ProcessPoolExecutor of spawned workers (the
        #               dataset shipped once a worker): full parallelism for
        #               the numpy rendering and augmentation. Spawned, not
        #               forked: the parent may have started CUDA and
        #               torch's thread pools, which a fork does not carry.
        # Determinism is identical in both modes: each example gets a child
        # rng derived from the epoch stream, so completion order is
        # irrelevant.
        self.num_workers = num_workers
        self.worker_mode = worker_mode
        self.pin_memory = pin_memory
        self._pool = None

    def _get_pool(self):
        if self.num_workers <= 0:
            return None
        if self._pool is None:
            if self.worker_mode == "process":
                import multiprocessing
                from concurrent.futures import ProcessPoolExecutor
                self._pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_init_worker, initargs=(self.ds,))
            else:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers)
        return self._pool

    def close(self):
        """Stop the worker pool (its processes, in process mode)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.ds)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(n)
        else:
            order = np.arange(n)
        # rank-strided shard, padded to equal length (DistributedSampler)
        if self.process_count > 1:
            per = -(-n // self.process_count)
            padded = np.concatenate([order, order[:per * self.process_count - n]])
            order = padded[self.process_index::self.process_count]
        return order

    def batches_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's batches, prepared one ahead by a producer thread.
        Closing the iterator early (a capped epoch) stops the thread."""
        order = self._epoch_indices(epoch)
        rng = np.random.default_rng((self.seed, epoch, self.process_index))
        nb = self.batches_per_epoch()

        pool = self._get_pool()

        def load_batch(idxs):
            if pool is None:
                return [self.ds.get(int(i), rng) for i in idxs]
            # per-example child rngs keep augmentation deterministic even
            # with out-of-order worker completion
            seeds = rng.integers(0, 2**31, size=len(idxs))
            if self.worker_mode == "process":
                futs = [pool.submit(_worker_get, int(i), int(s))
                        for i, s in zip(idxs, seeds)]
            else:
                futs = [pool.submit(self.ds.get, int(i),
                                    np.random.default_rng(int(s)))
                        for i, s in zip(idxs, seeds)]
            return [f.result() for f in futs]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                    examples = load_batch(idxs)
                    nvalid = len(examples)
                    while len(examples) < self.batch_size:  # pad final batch
                        examples.append(examples[-1])
                    batch = _collate(examples, self.pin_memory)
                    batch["batch_valid"] = _stack(
                        list(np.arange(self.batch_size) < nvalid),
                        self.pin_memory)
                    if not put(batch):
                        return
            except Exception as e:  # propagate into the consumer
                put(e)
            finally:
                put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def build_dataset(split: str, data_cfg) -> CocoDetectionDataset:
    """Mirror of build_dataset (dataloader_coco.py:322-334) on our config."""
    pre = PreprocessConfig(
        resize_size=data_cfg.resize_size, canvas_size=data_cfg.canvas_size,
        max_targets=data_cfg.max_targets,
        allow_truncation=data_cfg.allow_truncation,
        flip_prob=data_cfg.flip_prob if split == "train" else 0.0,
        flip_is_vertical=data_cfg.flip_is_vertical,
        use_mosaic=data_cfg.use_mosaic if split == "train" else False,
        emit_uint8=data_cfg.device_normalize)
    ann_file = f"{data_cfg.coco_path}/{split}.json"
    root = f"{data_cfg.image_root}/{split}" if data_cfg.image_root else None
    return CocoDetectionDataset(
        ann_file, root, pre, synthetic=data_cfg.synthetic,
        synthetic_size=data_cfg.synthetic_size)
