"""The port's two Monte Carlo invariants (letf_tpu_torch/validation.py)
against the JAX package's validation battery, on the CPU (plain versions
of kernels K3 and K6; the card runs the kernels, chip_smoke.py).

Both packages must pass with the reference's tolerances (1.5% and 2%
absolute on the median annual drag); the two estimates come from
different random streams, so they agree to sampling error: 10,000
zero-drift paths put the median's standard error near 0.5%; off the card
and the TPU the flat decay runs 5,000 paths on both sides (~0.8% each;
the port's card route takes 65,536 K6 paths, as the JAX package's kernel
route does). The bounds are 2-3 standard errors of the difference, on
fixed seeds."""

import numpy as np
import pytest

from letf_tpu import validation as jval
from letf_tpu_torch import validation as tval
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_neutral_model_matches_jax():
    for lev in (2.0, 3.0):
        a, b = jval._neutral_model(lev), tval._neutral_model(lev)

        def leaves(m):
            out = []
            for part in m:
                out.extend(part if hasattr(part, "_fields") else [part])
            return out

        for x, y in zip(leaves(a), leaves(b), strict=True):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_zero_drift_vol_drag():
    got = tval.validate_zero_drift_vol_drag(device="cpu")
    ref = jval.validate_zero_drift_vol_drag()
    assert got["test_passed"] and ref["test_passed"]
    assert got["engine"] == "compose_strategies_plain"
    assert got["expected_drag"] == ref["expected_drag"]
    assert got["actual_drag"] == pytest.approx(ref["actual_drag"], abs=0.015)


def test_flat_market_decay():
    got = tval.validate_flat_market_decay(device="cpu")
    ref = jval.validate_flat_market_decay()
    assert got["all_passed"] and ref["all_passed"]
    for k in ("2.0x", "3.0x"):
        assert got[k]["engine"] == "gbm_plain"
        assert got[k]["expected"] == ref[k]["expected"]
        assert got[k]["actual_median"] == pytest.approx(
            ref[k]["actual_median"], abs=0.025)
