"""The benchmark of the PyTorch port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It builds the cell's program (the port,
`wildlifemapper_tpu_torch`) on the card with weights and inputs made from
the seed, warms up, measures for --seconds, with --trace 1 profiles a
stretch after the window, then frees the program and compares what the
timed path produced with the plain reference (portbench/reference/). The
last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, with --trace 1 breakdown, and the numbers compared
beside their limits); the last lines of standard error are those numbers
again. Without CUDA, or with fewer cards than the cell asks for, it exits
with 2 and prints no result. See portbench/README.md.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    try:
        card = env.card(cell["chips"])
    except SystemExit as e:
        print(e, file=sys.stderr)
        return 2

    from portbench.harness import runner

    result = runner.run(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", T_START, cells.benchmark(),
                        card)
    bad = env.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    report(result)
    return 0


def report(result: dict) -> None:
    """The numbers compared beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    sys.stdout.flush()
    for row in result["compared"]:
        print(f"compared {row['name']} {row['value']!r} limit "
              f"{row['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    sys.exit(main())
