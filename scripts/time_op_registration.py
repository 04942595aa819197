"""The host's cost of calling a Python kernel through PyTorch's dispatcher,
registered the two ways `torch.library` offers, beside a plain call.

    python3 scripts/time_op_registration.py [--device cpu|cuda] [--calls N]

A trivial operator (it returns copies of its input's two rows) with the
attention operators' schema shape (a tensor, an optional tensor, a float,
an int) is registered once with `torch.library.Library.define` / `impl`
(what ops/_library.py uses) and once with `torch.library.custom_op`; each
is called N times in inference mode and the mean microseconds a call
printed, with the plain Python function's (the same copies), as one JSON
line: the differences are the dispatcher's hop.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import Optional

import torch


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cpu")
    p.add_argument("--calls", type=int, default=20000)
    args = p.parse_args()

    def plain(q: torch.Tensor, r: Optional[torch.Tensor], scale: float,
              heads: int):
        return q[0].clone(), q[1].clone()

    lib = torch.library.Library("wm_time_registration", "DEF")
    lib.define("low(Tensor q, Tensor? r, float scale, int heads) "
               "-> (Tensor, Tensor)")
    lib.impl("low", plain, "CUDA" if args.device == "cuda" else "CPU")

    @torch.library.custom_op("wm_time_registration::high", mutates_args=())
    def high(q: torch.Tensor, r: Optional[torch.Tensor], scale: float,
             heads: int) -> tuple[torch.Tensor, torch.Tensor]:
        return plain(q, r, scale, heads)

    q = torch.zeros(2, 4, device=args.device)
    calls = {"plain": plain,
             "library_define_impl": torch.ops.wm_time_registration.low.default,
             "custom_op": torch.ops.wm_time_registration.high.default}
    out = {}
    with torch.inference_mode():
        for name, fn in calls.items():
            for _ in range(100):
                fn(q, None, 0.1, 2)
            t0 = time.perf_counter()
            for _ in range(args.calls):
                fn(q, None, 0.1, 2)
            out[name] = (time.perf_counter() - t0) / args.calls * 1e6
    print(json.dumps({"device": args.device, "host": platform.processor()
                      or platform.machine(), "torch": torch.__version__,
                      "us_per_call": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
