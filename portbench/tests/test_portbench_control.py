"""The control of each cell's comparison at the cell's own size, on the
card: the reference computed in float8 (the precision below the program's
bfloat16) put in the program's place fails the cell's limits, and the
program itself passes them. Marked `requires_cuda`: it skips without a card.
Run on the card with `python -m pytest portbench/tests -m requires_cuda`."""

import gc

import pytest
import torch

from portbench.harness import cells, compare, env, runner
from portbench.reference.model import Arith

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA (H100)")
    env.set_cache_dirs()
    c, _, job = runner.setup(name, 2 ** 31 + 4242, "cuda")
    job.build()
    job.window(2.0)
    job.release()
    gc.collect()
    torch.cuda.empty_cache()
    ok, _ = compare.verdict(job.check(), c["limits"])
    assert ok
    ok, rows = compare.verdict(job.check(Arith(fp8=True)), c["limits"])
    assert not ok, rows
