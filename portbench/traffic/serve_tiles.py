"""Traffic kind `serve_tiles`: survey tiles served in a closed loop.

A pool of `pool_batches` batches of `batch` seeded uint8 tiles (the
configuration's image size square, 3 channels, content everywhere, as a
survey mosaic gives them) sits in
pinned host memory. Each batch is copied to the card, goes through the
survey path's `OrthomosaicDetector.run` (normalised on the card, the
model in bf16 through its kernels, postprocess at CONFIDENCE) and a
class-agnostic `batched_nms` at NMS_IOU, and its detections come back to
pinned host memory. `in_flight` batches are outstanding at a time: the
host submits batch i and then waits for batch i - 1, as the survey path's
double buffering does. The loop is closed: no arrival rate.

End-to-end: serve_tiles_per_s, every tile completed over the window from
the first submission to the last completion; serve_batch_ms_p95, the 95th
percentile of the batches' times from the start of their submission to
their detections being on the host.

`correct`: after the window, SAMPLE_BATCHES of the completed batches,
drawn from the seed, are recomputed by the plain float32 reference
(portbench/reference/) from the same tiles and weights, and compared by
their scores (the widest gap), their boxes (the widest gap in pixels) and
their NMS (the reference's NMS over the program's own scores and boxes
must keep exactly what the program kept).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import env, program, weights
from portbench.reference import model as ref
from portbench.reference import postprocess as ref_post

MODE = "serve"
DEFAULTS = {"batch": 16, "in_flight": 2, "pool_batches": 8,
            "trace_batches": 24}
NUMBERS = ("score_gap", "box_gap_px", "nms_mismatch")
CONFIDENCE = 0.05       # the survey path's postprocess threshold
NMS_IOU = 0.4           # and its class-agnostic NMS
WARMUP_BATCHES = 3      # set-up's batches, every shape of the window
SAMPLE_BATCHES = 2      # completed batches the reference recomputes
REFERENCE_ROWS = 2      # tiles the reference runs at a time


class Job:
    """One run of a `serve_tiles` cell on `device`."""

    def __init__(self, cell: dict, cfg: dict, params: dict, seed: int,
                 device: torch.device):
        self.cell, self.cfg, self.p = cell, cfg, params
        self.seed, self.device = seed, torch.device(device)
        self.spec = ref.model_spec(cfg)
        self.batch = params["batch"]
        self.tile = cfg["image_size"]
        self.outputs: List[Dict[str, np.ndarray]] = []
        self.slots: List[int] = []
        self.attempted = self.failed = 0
        self.phases: Dict[str, float] = {}

    # ---- inputs --------------------------------------------------------
    def tiles(self) -> torch.Tensor:
        """The pool, (pool, batch, tile, tile, 3) uint8 on the device."""
        p = self.p
        gen = torch.Generator(device=self.device).manual_seed(
            env.seed_for(self.seed, "tiles"))
        return torch.randint(0, 256, (p["pool_batches"], self.batch,
                                      self.tile, self.tile, 3),
                             generator=gen, device=self.device,
                             dtype=torch.uint8)

    def weights(self):
        return weights.make(ref.param_shapes(self.spec),
                            env.seed_for(self.seed, "weights"), self.device)

    # ---- the program ---------------------------------------------------
    def build(self) -> None:
        from wildlifemapper_tpu_torch.eval.orthomosaic import \
            OrthomosaicDetector
        from wildlifemapper_tpu_torch.eval.postprocess import batched_nms
        from wildlifemapper_tpu_torch.models import WildlifeMapper

        mark = time.perf_counter()
        mcfg = program.serving_config(self.cfg)
        cuda = self.device.type == "cuda"
        model = WildlifeMapper(mcfg, generator=torch.Generator(
            device=self.device).manual_seed(0), device=self.device)
        model.load_state_dict(self.weights(), strict=True)
        model.eval()
        self.detector = OrthomosaicDetector(
            model, mcfg, tile_batch=self.batch, overlap=0,
            confidence_threshold=CONFIDENCE,
            nms_iou=NMS_IOU)
        self.nms = batched_nms
        self.phases["model"] = time.perf_counter() - mark
        mark = time.perf_counter()
        pool = self.tiles()
        self.pool = pool.cpu().pin_memory() if cuda else pool.clone()
        del pool
        q = mcfg.decoder.num_queries
        self.host = [{"scores": torch.empty((self.batch, q)),
                      "boxes": torch.empty((self.batch, q, 4)),
                      "keep": torch.empty((self.batch, q), dtype=torch.bool)}
                     for _ in range(self.p["in_flight"])]
        if cuda:
            self.host = [{k: v.pin_memory() for k, v in h.items()}
                         for h in self.host]
        self.phases["inputs"] = time.perf_counter() - mark
        mark = time.perf_counter()
        for i in range(WARMUP_BATCHES):
            self._finish(self._submit(i), record=False)
        self.next = 0
        if cuda:
            torch.cuda.synchronize(self.device)
        self.phases["warmup"] = time.perf_counter() - mark

    def _submit(self, i: int):
        t0 = time.perf_counter()
        slot = i % self.p["pool_batches"]
        host = self.host[i % self.p["in_flight"]]
        with record_function("portbench::submit"):
            tiles = self.pool[slot].to(self.device, non_blocking=True)
            dets = self.detector.run(tiles)
            with record_function("portbench::nms"):
                keep = self.nms(dets["boxes"], dets["scores"], dets["labels"],
                                dets["keep"], NMS_IOU)
            host["scores"].copy_(dets["scores"], non_blocking=True)
            host["boxes"].copy_(dets["boxes"], non_blocking=True)
            host["keep"].copy_(keep, non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
        return t0, done, host, slot

    def _finish(self, pending, record: bool = True) -> float:
        t0, done, host, slot = pending
        with record_function("portbench::wait"):
            if done is not None:
                done.synchronize()
        t1 = time.perf_counter()
        if record:
            self.outputs.append({k: v.numpy().copy() for k, v in host.items()})
            self.slots.append(slot)
        return t1

    def _loop(self, stop, record: bool = True):
        """Submit and finish batches until stop(now, n) says so: (start,
        end, latencies, batches)."""
        lat, n = [], 0
        pending = []
        t_start = time.perf_counter()
        t_end = t_start
        while not stop(time.perf_counter() - t_start, n):
            pending.append(self._submit(self.next))
            self.next += 1
            n += 1
            if len(pending) >= self.p["in_flight"]:
                first = pending.pop(0)
                t_end = self._finish(first, record)
                lat.append(t_end - first[0])
        for first in pending:
            t_end = self._finish(first, record)
            lat.append(t_end - first[0])
        return t_start, t_end, lat, n

    def window(self, seconds: float) -> Dict[str, float]:
        t0, t1, lat, n = self._loop(lambda t, _: t >= seconds)
        self.attempted, self.unit_s = n, (t1 - t0) / n
        lat_ms = sorted(x * 1e3 for x in lat)
        p95 = float(np.percentile(lat_ms, 95)) if lat_ms else float("nan")
        return {"serve_tiles_per_s": n * self.batch / (t1 - t0),
                "serve_batch_ms_p95": p95}

    def traced(self, units: int):
        """Run `units` batches under the harness's ranges around
        postprocess and NMS; the caller holds the profiler."""
        import wildlifemapper_tpu_torch.eval.orthomosaic as om

        original = om.postprocess

        def postprocess(*args, **kwargs):
            with record_function("portbench::postprocess"):
                return original(*args, **kwargs)

        om.postprocess = postprocess
        try:
            self._loop(lambda _, n: n >= units, record=False)
        finally:
            om.postprocess = original
        return units

    def release(self) -> None:
        for name in ("detector", "pool", "host"):
            if hasattr(self, name):
                delattr(self, name)

    # ---- the comparison ------------------------------------------------
    def sample(self) -> List[int]:
        """Indices of completed batches to compare, drawn from the seed,
        each of another pool slot where there are enough."""
        rng = np.random.default_rng(env.seed_for(self.seed, "sample"))
        order = rng.permutation(len(self.outputs))
        picked, slots = [], set()
        for i in order:
            if self.slots[i] not in slots:
                picked.append(int(i))
                slots.add(self.slots[i])
            if len(picked) == SAMPLE_BATCHES:
                break
        return picked

    @torch.no_grad()
    def reference(self, tiles_u8: torch.Tensor, P, arith) -> Dict:
        parts = []
        for r in range(0, tiles_u8.shape[0], REFERENCE_ROWS):
            out = ref.forward(ref.normalize(tiles_u8[r:r + REFERENCE_ROWS]),
                              P, self.spec, arith)
            parts.append(ref_post.detections(out, self.tile,
                                             CONFIDENCE))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def compare(self, got: Dict[str, torch.Tensor], want: Dict) -> Dict:
        """The numbers of one batch: the program's (or a stand-in's)
        detections `got` against the reference's `want`."""
        kept = ref_post.nms(got["boxes"], got["scores"],
                            got["scores"] > CONFIDENCE,
                            NMS_IOU)
        return {"score_gap": float((got["scores"] - want["scores"]).abs()
                                   .max()),
                "box_gap_px": float((got["boxes"] - want["boxes"]).abs()
                                    .max()),
                "nms_mismatch": int((kept != got["keep"].bool()).sum())}

    def check(self, arith=None, detail: bool = False) -> Dict[str, float]:
        """The worst of each number over the sampled batches, and the
        number of tiles compared. With `arith` the reference in that
        precision stands in for the program."""
        with ref.exact_f32():
            P = self.weights()
            pool = self.tiles()
            worst: Dict[str, float] = {k: 0.0 for k in NUMBERS}
            worst["images_compared"] = 0
            picks = self.sample() if arith is None else \
                list(range(min(SAMPLE_BATCHES, self.p["pool_batches"])))
            for i in picks:
                slot = self.slots[i] if arith is None else i
                want = self.reference(pool[slot], P, ref.Arith())
                if arith is None:
                    got = {k: torch.as_tensor(v, device=self.device)
                           for k, v in self.outputs[i].items()}
                else:
                    got = self.reference(pool[slot], P, arith)
                    got["keep"] = ref_post.nms(
                        got["boxes"], got["scores"], got["keep"],
                        NMS_IOU)
                for k, v in self.compare(got, want).items():
                    worst[k] = max(worst[k], v)
                worst["images_compared"] += int(want["scores"].shape[0])
            return worst
