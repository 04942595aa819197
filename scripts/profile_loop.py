"""Where a step of the port's training loop goes, on a CUDA GPU.

    python scripts/profile_loop.py [--from_scratch] [--device_normalize]
        [--num_workers 2] [--worker_mode thread|process] [--steps 12]
        [--cold]

Trains the CLI's configuration (cli/train.py: the vendored annotations,
synthetic tiles at 1024 resized to 768, bf16, batch 4, ViT-B at its full
width and depth from seeded weights; the fine-tune, or with
--from_scratch `--train_encoder --content_size 768 --crop_prologue
--window_size 12` with the adaptor's dropout 0) through train/loop.py for
three epochs of --steps steps, its tiles rendered beforehand into a
temporary WM_SYNTH_CACHE (warm, as on a dataset's second epoch) unless
--cold. The loop is watched (train/profiling.py::StepWatch): CUDA events at
each step's start and end (the loop's ms a step in each epoch, its first
step excluded), the host's ms inside a step (dispatch and the matcher's
wait) and between two steps (the previous step's metrics, the next batch,
its copy to the card) in the second epoch, and torch.profiler over the
third epoch's steps after its first: the device's busy ms a step and its
idle share. The profiler slows the host, so the third epoch's ms is not the
loop's, and its idle share is given twice: against the profiled wall time,
and as the busy ms against the second epoch's unprofiled ms a step. Then
the same step bare on a resident batch, timed the same way without the
profiler and then profiled in a pass of its own. One JSON line each, with
the card's name and power limit. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wildlifemapper_tpu_torch.cli import train as cli_train  # noqa: E402
from wildlifemapper_tpu_torch.data.loader import (DataLoader,  # noqa: E402
                                                  build_dataset)
from wildlifemapper_tpu_torch.train import loop as loop_mod  # noqa: E402
from wildlifemapper_tpu_torch.train.profiling import StepWatch  # noqa: E402

BATCH = 4


def device_busy_ms(prof) -> float:
    """The device's busy time over a profile: every kernel and copy."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1000


class Profiled:
    """torch.profiler over steps [first, last] of a StepWatch, with the
    wall time of that window (the card drained at both ends)."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self.wall_ms = None

    def before(self, k):
        if k == self.first:
            torch.cuda.synchronize()
            self.prof.start()
            self._t0 = time.perf_counter()

    def after(self, k):
        if k == self.last:
            torch.cuda.synchronize()
            self.wall_ms = (time.perf_counter() - self._t0) * 1e3
            self.prof.stop()

    def readings(self, unprofiled_ms: float) -> dict:
        steps = self.last - self.first + 1
        busy = device_busy_ms(self.prof) / steps
        return dict(profiled_steps=steps,
                    profiled_wall_ms_per_step=self.wall_ms / steps,
                    device_busy_ms_per_step=busy,
                    device_idle_share_profiled=max(
                        0.0, 1 - busy * steps / self.wall_ms),
                    device_idle_share_unprofiled=max(
                        0.0, 1 - busy / unprofiled_ms))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--from_scratch", action="store_true")
    ap.add_argument("--device_normalize", action="store_true")
    ap.add_argument("--num_workers", type=int, default=2)
    ap.add_argument("--worker_mode", default="thread",
                    choices=["thread", "process"])
    ap.add_argument("--steps", type=int, default=12,
                    help="steps an epoch (three epochs run)")
    ap.add_argument("--cold", action="store_true",
                    help="render the tiles inside the loop, not before")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_loop: needs a CUDA GPU", file=sys.stderr)
        return 2
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    flags = ["--synthetic_data", "--synthetic_size", "1024", "--use_amp",
             "--batch_size", str(BATCH), "--num_workers",
             str(args.num_workers), "--worker_mode", args.worker_mode,
             "--checkpoint_every", "1000"]
    if args.device_normalize:
        flags.append("--device_normalize")
    if args.from_scratch:
        flags += ["--train_encoder", "--content_size", "768",
                  "--crop_prologue", "--window_size", "12"]
    cfg = cli_train.config_from_args(
        cli_train.add_config_args(argparse.ArgumentParser()).parse_args(flags))
    if args.from_scratch:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, hfc=dataclasses.replace(cfg.model.hfc, dropout=0.0)))

    with tempfile.TemporaryDirectory(prefix="wm_profile_loop_") as work:
        os.environ["WM_SYNTH_CACHE"] = str(Path(work) / "synth")
        warm_s = None
        if not args.cold:
            t0 = time.perf_counter()
            loader = DataLoader(build_dataset("train", cfg.data), BATCH,
                                shuffle=True, seed=cfg.train.seed,
                                num_workers=4)
            try:
                for epoch in (0, 1, 2):
                    it = loader.epoch(epoch)
                    for _ in range(args.steps + 1):
                        next(it)
                    it.close()
            finally:
                loader.close()
            warm_s = time.perf_counter() - t0

        n = args.steps
        prof = Profiled(2 * n + 1, 3 * n - 1)
        watch = StepWatch(prof.before, prof.after)
        t0 = time.perf_counter()
        loop_mod.train(cfg, workdir=str(Path(work) / "run"), epochs=3,
                       max_steps_per_epoch=n, max_eval_batches=1,
                       print_fn=lambda *a, **k: None, watch=watch)
        train_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        loop_ms = watch.ms_per_step(n)
        # the second epoch's steps after its first, and what came before each
        inside = watch.inside_ms[n + 1:2 * n]
        between = watch.between_ms[n:2 * n - 1]
        config = "from_scratch" if args.from_scratch else "fine_tune"
        print(json.dumps(dict(
            what="loop", gpu=gpu, batch=BATCH, config=config,
            device_normalize=args.device_normalize,
            num_workers=args.num_workers, worker_mode=args.worker_mode,
            tiles="cold" if args.cold else "warm", warm_seconds=warm_s,
            steps_per_epoch=n, train_seconds=train_s,
            ms_per_step_by_epoch=loop_ms,
            tiles_per_s=BATCH * 1000 / loop_ms[1],
            host_ms_inside_step=sum(inside) / len(inside),
            host_ms_between_steps=sum(between) / len(between),
            **prof.readings(loop_ms[1]),
            peak_memory_bytes=torch.cuda.max_memory_allocated())),
            flush=True)

        # the same step bare, on the loop's last batch, resident on the card:
        # two warm-up steps and n - 1 timed ones, then n - 1 profiled
        builder, st, bt, g = watch.last
        bare = StepWatch()
        for _ in range(n + 1):
            bare.train_step(builder, st, bt, g)
        torch.cuda.synchronize()
        ms = bare.starts[2].elapsed_time(bare.ends[-1]) / (n - 1)
        prof = Profiled(0, n - 2)
        profiled = StepWatch(prof.before, prof.after)
        for _ in range(n - 1):
            profiled.train_step(builder, st, bt, g)
        print(json.dumps(dict(
            what="bare step", gpu=gpu, batch=BATCH, config=config,
            device_normalize=args.device_normalize, ms_per_step=ms,
            host_ms_inside_step=sum(bare.inside_ms[2:]) / (n - 1),
            **prof.readings(ms))), flush=True)
        os.environ.pop("WM_SYNTH_CACHE", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
