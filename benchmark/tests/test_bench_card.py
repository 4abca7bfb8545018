"""On the card: a small report of each configuration against the plain
reference, judged by the cells' own limits (the comparison a run makes,
at a size a test run holds). Skips without a card."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import checks, spec
from benchmark.harness.main import compare
from benchmark.harness.program import Program


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["inst_pretax_1m", "param_pretax_16k"])
def test_a_small_report_on_the_card_meets_the_limits(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = spec.load_cell(spec.HERE.parent, cell)
    traffic = dict(c.traffic, trials=2048, years=2)
    config = dict(c.config, chunk_trials=1024)
    prog = Program(config, traffic, "cuda")
    prog.capture()
    seed = 2**31 + 99
    rep = prog.report(seed)
    held = prog.release()
    small = dataclasses.replace(c, config=config, traffic=traffic)
    ok, lines, _ = checks.judge(
        compare(small, held, seed, rep, torch.float32), c.limits)
    assert ok, lines
    assert np.isfinite(held["final_wealth"]).all()
