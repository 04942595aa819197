"""Readings that set a cell's limits: the program's numbers on many seeds
and the control's (the reference in float8 put in the program's place), at
the cell's own size, in one process, with a short window each:

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        [--first-seed N] [--control 3] [--faults 3] [--seconds 5] \
        [--out chiprun_out/calibrate_<cell>.jsonl]

One JSON line a seed: the window's end-to-end numbers, the numbers
compared, and for the first --control seeds the control's, for the first
--faults seeds of a training cell the fault of a step that leaves half its
batch out (read in the reference put in the program's place). Needs the
card, as run.py does; the benchmark's own runs never run it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import cells, env  # noqa: E402

env.set_cache_dirs()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    try:
        card = env.card(cell["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2
    import gc

    import torch

    from portbench.harness import runner
    from portbench.reference.model import Arith

    out = open(args.out, "a") if args.out else None
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        _, kind, job = runner.setup(args.workload, seed, "cuda")
        job.build()
        t_setup = time.perf_counter() - t0
        e2e = job.window(args.seconds)
        job.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        line = {"cell": args.workload, "seed": seed, "card": card,
                "setup_s": t_setup, "window": e2e, "attempted": job.attempted,
                "failed": job.failed, "program": job.check(detail=True),
                "steps_at_s": [round(x, 3) for x in
                               getattr(job, "step_ends", [])]}
        line["check_s"] = time.perf_counter() - t1
        if k < args.control:
            line["control"] = job.check(Arith(fp8=True), detail=True)
        if kind.MODE == "train" and k < args.faults:
            line["fault_half_batch"] = job.check(
                rows=slice(0, job.batch // 2), detail=True)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del job
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
