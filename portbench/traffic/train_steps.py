"""Traffic kind `train_steps`: training steps of a launcher's recipe on
batches made on the card.

The model and the step are the CLI's: `cli/train.py::config_from_args` on
the cell's `launcher_args` (with --model_type from the configuration file),
`train/step.py::StepBuilder`, its `init_state` and `train_step`. A pool of
`pool_batches` batches of `batch` uint8 canvases (the launcher's canvas
square, content in its top-left `--content_size` pixels and zeros around it,
as train/synthetic.py's synthetic_batch lays them out) is made on the card
from the seed; the
content is a smooth random field with grain, of a brightness, contrast and
grain of each image's own, so that the rows of a batch differ as survey
tiles do. Boxes come
from BOXES_TABLE (traffic/herdnet_train_split.json): every seed takes the same
box counts, the table's quantiles at as many levels as the pool has images,
in another order; each box's width, height and category are drawn from the
table's boxes, its centre uniformly inside the content. The adaptor's
dropout draws from a generator the harness seeds and hands to train_step.

End-to-end: train_tiles_per_s, every tile stepped over the window (a step
ends with its loss on the card; the window ends with a synchronise);
train_peak_gib, torch's max_memory_allocated over the window, taken after
set-up.

`correct`: set-up drives the step through its first CHECKED_STEPS steps on
the pool's first batches (these are the window's own step, state and
generator; they also warm every shape up) and keeps each step's loss, the
first step's outputs and the loss's gradient with respect to them (hooks on
the model's output), its gradient as AdamW received it (its first moment
over 1 - beta1) and the trainable parameters before and after. After the
window the plain float32 reference (portbench/reference/) takes the same
steps from the same weights, batches and dropout draws, and
harness/compare.py's numbers compare the two; the cell's limits name those
it holds the program to.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from portbench.harness import compare, env, program, weights
from portbench.harness.cells import ROOT, load_json
from portbench.reference import criterion as ref_crit
from portbench.reference import model as ref

MODE = "train"
DEFAULTS = {"batch": 8, "pool_batches": 16, "launcher_args": [],
            "trace_batches": 8}
NUMBERS = ("loss_gap", "score_gap", "box_gap_px", "row_grad_gap",
           "grad_gap", "grad_diff", "update_gap")
CHECKED_STEPS = 3       # the steps set-up drives and the reference follows
COARSE = 12             # the content's smooth field, from a 12 x 12 grid
BOXES_TABLE = "herdnet_train_split"     # traffic/<table>.json
OUTPUTS = ("pred_logits", "pred_boxes")
BETA1 = 0.9


def content(n: int, side: int, coarse: int, gen: torch.Generator,
            device) -> torch.Tensor:
    """n uint8 (side, side, 3) images that differ from one another as
    survey tiles do: a smooth random field (bilinear from a coarse x coarse
    grid) at an image's own brightness and contrast, under fine grain of an
    image's own strength."""
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    field = torch.nn.functional.interpolate(
        rand(n, 3, coarse, coarse), size=(side, side), mode="bilinear",
        align_corners=False)
    x = (0.2 + 0.6 * rand(n, 1, 1, 1) + (0.3 + 0.7 * rand(n, 1, 1, 1))
         * (field - 0.5) + 0.4 * rand(n, 1, 1, 1) * (rand(n, 3, side, side)
                                                     - 0.5))
    return (x.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1)


class Job:
    """One run of a `train_steps` cell on `device`."""

    def __init__(self, cell: dict, cfg: dict, params: dict, seed: int,
                 device: torch.device):
        self.cell, self.cfg, self.p = cell, cfg, params
        self.seed, self.device = seed, torch.device(device)
        self.batch = params["batch"]
        self.conf = program.training_config(cfg, params["launcher_args"])
        m = self.conf.model
        self.canvas = m.img_size
        self.content = m.content_size or m.img_size
        self.table = load_json(ROOT / "traffic" / f"{BOXES_TABLE}.json")
        self.spec = ref.model_spec(
            cfg, window_size=m.vit.window_size, content_size=m.content_size,
            crop_prologue=m.crop_prologue,
            scrambled_reshape=m.hfc.compat_scrambled_reshape)
        self.encoder_trains = not self.conf.train.freeze_encoder
        self.attempted = self.failed = 0
        self.phases: Dict[str, float] = {}
        self.losses: List[torch.Tensor] = []
        self.step_ends: List[float] = []

    # ---- inputs --------------------------------------------------------
    def weights(self):
        return weights.make(ref.param_shapes(self.spec),
                            env.seed_for(self.seed, "weights"), self.device)

    def batches(self) -> List[Dict[str, torch.Tensor]]:
        """The pool of batches on the device, the same for the same seed."""
        p, dev, table = self.p, self.device, self.table
        n_img = p["pool_batches"] * self.batch
        rng = np.random.default_rng(env.seed_for(self.seed, "boxes"))
        levels = (np.arange(n_img) + 0.5) / n_img
        counts = np.quantile(table["boxes_per_image"], levels,
                             method="inverted_cdf").astype(int)
        t = self.conf.criterion.max_targets
        counts = np.minimum(rng.permutation(counts), t)
        pool_boxes = np.asarray(table["box_w_h_category"], np.float64)
        labels = np.zeros((n_img, t), np.int64)
        boxes = np.zeros((n_img, t, 4), np.float32)
        valid = np.zeros((n_img, t), bool)
        c, canvas = self.content, self.canvas
        scale = c / 768.0
        for i, n in enumerate(counts):
            pick = pool_boxes[rng.integers(0, len(pool_boxes), n)]
            wh = np.clip(pick[:, :2] * scale, 1.0, c / 2)
            centre = rng.uniform(wh / 2, c - wh / 2)
            boxes[i, :n] = np.concatenate([centre, wh], 1) / canvas
            labels[i, :n] = pick[:, 2].astype(np.int64)
            valid[i, :n] = True
        gen = torch.Generator(device=dev).manual_seed(
            env.seed_for(self.seed, "images"))
        image = torch.zeros((n_img, canvas, canvas, 3), dtype=torch.uint8,
                            device=dev)
        for i in range(0, n_img, 16):
            rows = min(16, n_img - i)
            image[i:i + rows, :c, :c] = content(rows, c, COARSE, gen, dev)
        size = torch.full((n_img, 2), c, dtype=torch.int64, device=dev)
        out = []
        for b in range(p["pool_batches"]):
            rows = slice(b * self.batch, (b + 1) * self.batch)
            out.append({
                "image": image[rows], "size": size[rows],
                "labels": torch.from_numpy(labels[rows]).to(dev),
                "boxes": torch.from_numpy(boxes[rows]).to(dev),
                "valid": torch.from_numpy(valid[rows]).to(dev)})
        return out

    def dropout_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            env.seed_for(self.seed, "dropout"))

    # ---- the program ---------------------------------------------------
    def build(self) -> None:
        from wildlifemapper_tpu_torch.train.step import StepBuilder

        mark = time.perf_counter()
        self.builder = StepBuilder(self.conf, generator=torch.Generator(
            device=self.device).manual_seed(0), device=self.device)
        self.builder.model.load_state_dict(self.weights(), strict=True)
        # an epoch of the boxes' split, as the loader would batch it
        self.state = self.builder.init_state(
            len(self.table["boxes_per_image"]) // self.batch)
        self.phases["model"] = time.perf_counter() - mark
        mark = time.perf_counter()
        self.pool = self.batches()
        self.gen = self.dropout_generator()
        self.phases["inputs"] = time.perf_counter() - mark
        mark = time.perf_counter()
        trainable = [(n, p) for n, p in self.builder.model.named_parameters()
                     if p.requires_grad]
        self.before = {n: p.detach().cpu().clone() for n, p in trainable}
        self.checked_losses = []
        self.next = 0
        first_out, out_grad = {}, {}

        def keep_first(module, args, out):
            first_out.update({k: out[k].detach().float().clone()
                              for k in OUTPUTS})
            for k in OUTPUTS:
                if out[k].requires_grad:
                    out[k].register_hook(
                        lambda g, k=k: out_grad.update(
                            {k: g.detach().float()}))

        hook = self.builder.model.register_forward_hook(keep_first)
        for i in range(CHECKED_STEPS):
            _, metrics = self.builder.train_step(self.state,
                                                 self.pool[i], self.gen)
            self.checked_losses.append(metrics["loss"].detach().clone())
            if i == 0:
                hook.remove()
                self.first_out = {k: v.cpu() for k, v in first_out.items()}
                self.out_grad = {k: v.cpu() for k, v in out_grad.items()}
                opt = self.state.optimizer
                self.first_grad = {
                    n: opt.state[p].get("exp_avg", torch.zeros_like(p))
                    .detach().cpu() / (1 - BETA1) for n, p in trainable}
            self.next += 1
        self.after = {n: p.detach().cpu().clone() for n, p in trainable}
        self.checked_losses = [float(x) for x in self.checked_losses]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases["checked_steps"] = time.perf_counter() - mark

    def _step(self, record: bool = True):
        batch = self.pool[self.next % self.p["pool_batches"]]
        self.next += 1
        with record_function("portbench::step"):
            _, metrics = self.builder.train_step(self.state, batch, self.gen)
        if record:
            self.losses.append(metrics["loss"].detach())

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> Dict[str, float]:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
            n += 1
            self.step_ends.append(time.perf_counter() - t0)
        self._sync()
        t1 = time.perf_counter()
        losses = torch.stack(self.losses).float().cpu()
        self.attempted = n
        self.failed = int((~torch.isfinite(losses)).sum())
        self.unit_s = (t1 - t0) / n
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        return {"train_tiles_per_s": n * self.batch / (t1 - t0),
                "train_peak_gib": peak / 2 ** 30}

    def traced(self, units: int):
        for _ in range(units):
            self._step(record=False)
        self._sync()
        return units

    def release(self) -> None:
        for name in ("builder", "state", "pool", "gen"):
            if hasattr(self, name):
                delattr(self, name)

    # ---- the comparison ------------------------------------------------
    def reference_steps(self, arith, rows: slice = slice(None)):
        """The reference's checked steps: (losses, first gradient by name,
        trainable parameters before and after by name, the first step's
        outputs, the first loss's gradient with respect to them)."""
        from portbench.reference.model import forward

        P = {k: v.clone() for k, v in self.weights().items()}
        names = [n for n in P
                 if ref_crit.trains(n, not self.encoder_trains)]
        for n in names:
            P[n].requires_grad_(True)
        before = {n: P[n].detach().cpu().clone() for n in names}
        opt = ref_crit.AdamW([P[n] for n in names],
                             lr=self.conf.train.lr,
                             wd=self.conf.train.weight_decay)
        gen = self.dropout_generator()
        pool = self.batches()
        losses, first, first_out, out_grad = [], None, None, None
        for i in range(CHECKED_STEPS):
            b = pool[i]
            images = ref.normalize(b["image"])
            h, w = images.shape[1:3]
            inside = ((torch.arange(h, device=images.device)[None, :, None]
                       < b["size"][:, 0, None, None])
                      & (torch.arange(w, device=images.device)[None, None, :]
                         < b["size"][:, 1, None, None]))
            images = images * inside[..., None]
            out = forward(images, P, self.spec, arith, gen, remat=True)
            if first_out is None:
                first_out = {k: out[k].detach().float().cpu()
                             for k in ("pred_logits", "pred_boxes")}
            loss = ref_crit.set_loss(out, b, self.cfg["num_classes"],
                                     rows=rows)
            wrt = [P[n] for n in names]
            if out_grad is None:
                wrt += [out[k] for k in OUTPUTS]
            grads = list(torch.autograd.grad(loss, wrt))
            if out_grad is None:
                out_grad = {k: g.detach().float().cpu() for k, g in
                            zip(OUTPUTS, grads[len(names):])}
                grads = grads[:len(names)]
            ref_crit.clip_global_norm_(grads, self.conf.train.clip_max_norm)
            if first is None:
                first = {n: g.detach().cpu() for n, g in zip(names, grads)}
            opt.step(grads)
            losses.append(float(loss.detach()))
            del out, loss, grads
        after = {n: P[n].detach().cpu().clone() for n in names}
        return losses, first, before, after, first_out, out_grad

    def check(self, arith=None, rows: slice = None, detail: bool = False
              ) -> Dict[str, float]:
        """The three numbers of the program's checked steps against the
        reference's. With `arith` or `rows` the reference stands in for the
        program: in that precision, or with its loss over those rows only
        (the fault of a step that leaves part of its batch out)."""
        with ref.exact_f32():
            want = self.reference_steps(ref.Arith())
            if arith is None and rows is None:
                got = (self.checked_losses, self.first_grad, self.before,
                       self.after, self.first_out, self.out_grad)
            else:
                got = self.reference_steps(arith or ref.Arith(),
                                           rows or slice(None))
        return compare.training_numbers(got, want, detail)
