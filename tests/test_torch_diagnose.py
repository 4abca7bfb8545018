"""The port's diagnostics (``letf_tpu_torch/diagnose.py``) against
``letf_tpu/diagnose.py`` on the CPU in float64, at the sizes of
tests/test_aux.py:58: the pipeline trace at 8 trials x 1 year, the TQQQ
drag decomposition over 2 years and the detailed decomposition over 1.
Both packages run the institutional per-trial engine on the same
known-good model; every number agrees within relative 1e-9 (the paths
agree to ~1e-15, tests/test_torch_engine_modes.py)."""

import numpy as np
import pytest

from letf_tpu import diagnose as jdiag
from letf_tpu_torch import diagnose as tdiag
from letf_tpu_torch.models.params import from_jax_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = (("diagnose_pipeline", dict(years=1, n_trials=8)),
         ("diagnose_letf_drag", dict(years=2)),
         ("diagnose_tqqq_detailed", dict(years=1)))


def test_known_good_model_equals_jax():
    got, ref = tdiag.known_good_model(), from_jax_model(
        jdiag.known_good_model())
    for part in ("joint", "regime", "vix"):
        for f, a in getattr(ref, part)._asdict().items():
            np.testing.assert_array_equal(
                np.asarray(getattr(getattr(got, part), f)), a, err_msg=f)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_diagnose_matches_jax(name, kw):
    ref = getattr(jdiag, name)(**kw)
    got = getattr(tdiag, name)(**kw, device="cpu")
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert np.isfinite(got[k]), k
        np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-12,
                                   err_msg=k)
    if name == "diagnose_pipeline":
        assert 0 <= got["high_vol_frac"] <= 1
    elif name == "diagnose_letf_drag":
        assert got["full_etf_cagr"] <= got["perfect_3x_cagr"] + 1e-9
    else:
        assert got["daily_expense_bps"] > 0
