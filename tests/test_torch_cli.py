"""The CLI's default branch (the full analysis) and ``--quick`` on the
CPU: ``python -m letf_tpu_torch.cli --synthetic-data --sims 8 --horizons 1
--device cpu`` from a cold cache in a temporary directory, then ``--quick
--synthetic-data --device cpu`` (10 trials x 10 y over S1-S3) on the warm
cache; both run to their end and print their tables. The zero-drift
invariant runs at 256 paths here: it has its own test at the reference's
10,000 (tests/test_torch_validation.py).
"""

import functools

import pytest

from letf_tpu_torch import cli, validation
from letf_tpu_torch import config as tcfg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CACHES = ("DATA_CACHE", "REGIME_MODEL_CACHE", "CORRELATION_CACHE",
          "VALIDATION_RESULTS", "JOINT_RETURN_MODEL_CACHE",
          "FUNDING_MODEL_CACHE", "TRACKING_RESIDUAL_CACHE",
          "STRESS_STATE_CACHE", "BOOTSTRAP_CACHE")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """The port's caches in a temporary directory, 8 trials a horizon, the
    zero-drift invariant at 256 paths."""
    tmp = tmp_path_factory.mktemp("letf_tpu_torch_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "CACHE_DIR", tmp)
        for name in CACHES:
            mp.setattr(tcfg, name, tmp / getattr(tcfg, name).name)
        mp.setattr(tcfg, "NUM_SIMULATIONS", 8)
        mp.setattr(tcfg, "ANALYSIS_START_DATE", tcfg.ANALYSIS_START_DATE)
        mp.setattr(validation, "validate_zero_drift_vol_drag",
                   functools.partial(validation.validate_zero_drift_vol_drag,
                                     n_sims=256))
        mp.setenv("LETF_NON_INTERACTIVE", "1")
        yield tmp


def test_cli_default_branch_on_the_cpu(cache, capsys):
    cli.main(["--synthetic-data", "--sims", "8", "--horizons", "1",
              "--device", "cpu", "--state", "TX", "--income", "90000"])
    text = capsys.readouterr().out
    assert "FETCHING HISTORICAL DATA" in text
    assert "MONTE CARLO: 8 sims x 1Y (1 device: cpu" in text
    assert ("TAXABLE BROKERAGE - 1-YEAR HORIZON (Texas, $90,000, single)"
            in text)
    assert "TIMING SUMMARY" in text
    assert text.rstrip().endswith("ANALYSIS COMPLETE")


def test_cli_quick_on_the_cpu(cache, capsys):
    cli.main(["--quick", "--synthetic-data", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "QUICK TEST - LETF Monte Carlo, PyTorch/CUDA port" in text
    assert "Using cached historical data" in text
    assert "MONTE CARLO: 10 sims x 10Y" in text
    roth = text[text.index("ROTH IRA COMPATIBLE - 10-YEAR"):]
    for sid in ("S1", "S2", "S3"):
        assert f" {sid} " in roth.replace(f"{sid}  ", f" {sid} "), sid
    assert "QUICK TEST COMPLETE" in text
    assert tcfg.NUM_SIMULATIONS == 10
