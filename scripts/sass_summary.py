"""What the compiler made of the Hopper attention forward, read from its SASS,
on the machine with the CUDA toolkit (written for the H100's sm_90a).

    python3 scripts/sass_summary.py [--out DIR]

Builds the kernels (`ops/_build.py`, cached by source hash), disassembles
every instantiation of the Hopper attention forward (`attn_fwd_sm90_kernel`)
with the toolkit's `cuobjdump -sass`, and prints one JSON line a kernel: its
template arguments, its instruction count, the order of its products, waits,
exponentials and barriers (HGMMA, WARPGROUP.DEPBAR, MUFU.EX2, BAR), runs of
one kind counted, and the opcodes of its main loop (the shortest span of a
backward branch that holds an HGMMA; every path of the loop, taken or not).
That order shows where ptxas placed the wait for a product: before the
exponentials or after them. With `--out` the disassembly of each kernel is
written there too. Fails without the toolkit.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wildlifemapper_tpu_torch.ops import _build  # noqa: E402

KERNEL = "attn_fwd_sm90_kernel"
INSTR = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Za-z0-9_.]*)(.*?);")
MARKS = ("HGMMA", "WARPGROUP.DEPBAR", "MUFU.EX2", "BAR.SYNC", "BAR.ARV")


def cuobjdump() -> str:
    nvcc = Path(_build.find_nvcc())
    tool = nvcc.parent / "cuobjdump"
    if tool.is_file():
        return str(tool)
    found = shutil.which("cuobjdump")
    if found is None:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH")
    return found


def parse(sass: str):
    """(address, opcode, operands) of each instruction."""
    out = []
    for line in sass.splitlines():
        m = INSTR.match(line)
        if m:
            out.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    return out


def order(instrs) -> str:
    """The products, waits, exponentials and barriers in program order,
    runs of one kind counted."""
    seq = [op for _, op, _ in instrs if op.startswith(MARKS)]
    runs = []
    for op in seq:
        if runs and runs[-1][0] == op:
            runs[-1][1] += 1
        else:
            runs.append([op, 1])
    return "; ".join(f"{k} x{n}" for k, n in runs)


def main_loop(instrs):
    """Opcode counts of the innermost loop that issues products: the
    shortest span of a backward branch that holds an HGMMA."""
    best = None
    for addr, op, rest in instrs:
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            span = [o for a, o, _ in instrs if lo <= a <= addr]
            if (any(o.startswith("HGMMA") for o in span)
                    and (best is None or len(span) < len(best))):
                best = span
    if best is None:
        return {}
    return dict(collections.Counter(o.split(".")[0] for o in best).most_common())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the SASS")
    args = ap.parse_args()
    lib = _build.build()
    tool = cuobjdump()
    names = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                           text=True, check=True).stdout
    kernels = sorted(set(re.findall(r"Function : (\S+)", names)))
    for name in kernels:
        if KERNEL not in name:
            continue
        sass = subprocess.run([tool, "-sass", "-fun", name, str(lib)],
                              capture_output=True, text=True).stdout
        instrs = parse(sass)
        targs = re.search(r"I(L.*?)EEv", name)
        row = dict(kernel=name, template=targs.group(1) if targs else None,
                   instructions=len(instrs), order=order(instrs),
                   main_loop=main_loop(instrs))
        print(json.dumps(row), flush=True)
        if args.out:
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            (out / (re.sub(r"\W", "_", name)[-120:] + ".sass")).write_text(sass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
