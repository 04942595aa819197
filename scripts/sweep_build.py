"""What the variant sweeps of the f32 bodies (scripts/sweep_f32_window.py,
scripts/sweep_f32_attention.py) share: a header with named text edits,
written with copies of the sources that include it into
build/<sweep>/<variant>/ and built there, one nvcc a source, all started
together; each library is loaded with ctypes, and the port's own library is
not touched. ptxas's registers and spills are read for each kernel. Every
edit must match the header once, so a variant that no longer applies fails
to build.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def variant_header(text: str, edits: list) -> str:
    """The header with `edits`, (old, new) pairs, made in order, each old
    text matching exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"edit matches {text.count(old)} times: {old!r}")
        text = text.replace(old, new)
    return text


def ptxas(log: str, kernel: str) -> list:
    """'kernel<args>: registers, spill bytes' lines of the kernels whose
    name matches the regex `kernel`, template arguments as numbers and
    true / false."""
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(rf"({kernel})I(.*?)EEv", line)
        if m and "entry function" in line:
            args = [v if kind == "i" else ("false", "true")[int(v)]
                    for kind, v in re.findall(r"L([ib])(\d+)", m.group(2))]
            name = f"{m.group(1)}<{','.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return out


def build(sweep: str, jobs: dict, kernel: str) -> dict:
    """Build `jobs`, {variant: (header, edits, sources)}: the header (a file
    name in csrc) with the edits, and the sources (stems of csrc's .cu files
    that include it), under build/<sweep>/<variant>/. Returns {(variant,
    source): (its C entry wm_<source> with the port's signature, ptxas
    lines of the kernels matching `kernel`)}."""
    from wildlifemapper_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    csrc = _build.CSRC
    procs = {}
    for name, (header, edits, sources) in jobs.items():
        out = ROOT / "build" / sweep / name
        out.mkdir(parents=True, exist_ok=True)
        (out / header).write_text(variant_header(
            (csrc / header).read_text(), edits))
        for src in sources:
            (out / f"{src}.cu").write_text((csrc / f"{src}.cu").read_text())
            # the copy's own directory first: its header, then csrc's
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
                   "-o", str(out / f"{src}.so"), str(out / f"{src}.cu")]
            procs[name, src] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    entries = {}
    for (name, src), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(ROOT / "build" / sweep / name / f"{src}.so"))
        fn = getattr(lib, "wm_" + src)
        fn.argtypes = _build._SIGNATURES["wm_" + src]
        fn.restype = ctypes.c_int
        entries[name, src] = (fn, ptxas(log, kernel))
    return entries
