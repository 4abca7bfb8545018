"""The buy-and-hold headline path (kernel K6) and the reductions against
``letf_tpu/ops/pallas_path.py`` and ``letf_tpu/ops/reductions.py``.

- The XLA twin's port draws ``jax.random.normal`` bits (ops/rng.py), so it
  agrees with ``gbm_buyhold_xla`` trial by trial: wealth within rtol 2e-6
  and drawdown within 1e-6 (XLA:CPU's and torch's log1p differ by ulps).
- K6 (here its plain version, which draws the kernel's counter bits) can
  only agree in distribution with the TPU kernel, whose hardware PRNG is
  not reproducible: tests/test_pallas_path.py:51-80's moment test against
  the XLA twin and its zero-drift odd-day (63 days) test.
- The headline report through the twin equals the JAX package's."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops import pallas_path as jpp
from letf_tpu.ops import reductions as jred
from letf_tpu_torch.ops import gbm, reductions, rng

MU, SIGMA = 0.10 / 252, 0.24 / math.sqrt(252)


def test_xla_twin_matches_jax():
    n, days = 4096, 63
    jw, jm = jpp.gbm_buyhold_xla(jax.random.key(3), n, days, MU, SIGMA,
                                 3.0, 0.0086 / 252)
    tw, tm = gbm.gbm_buyhold_xla(rng.key(3), n, days, MU, SIGMA, 3.0,
                                 0.0086 / 252)
    assert tw.dtype == torch.float32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


def test_kernel_distribution_matches_xla_twin():
    """tests/test_pallas_path.py:51-69 with the port's K6 (plain version
    on the CPU): mean log-wealth within 5 standard errors, std within
    10%, finite drawdowns."""
    n, days = 2048, 126
    w_k, mdd_k = gbm.gbm_buyhold(0, n, days, MU, SIGMA, 3.0, 0.0086 / 252,
                                 device="cpu")
    w_x, _ = jpp.gbm_buyhold_xla(jax.random.key(0), 16384, days, MU, SIGMA,
                                 3.0, 0.0086 / 252)
    lp, lx = np.log(w_k.numpy()), np.log(np.asarray(w_x))
    se = lx.std() * math.sqrt(1 / len(lp) + 1 / len(lx))
    assert abs(lp.mean() - lx.mean()) < 5 * se
    assert lp.std() == pytest.approx(lx.std(), rel=0.1)
    assert torch.isfinite(mdd_k).all() and (mdd_k >= 0).all()


def test_odd_day_count_zero_drift():
    """tests/test_pallas_path.py:72-80: 63 days (the last pair's z2
    unused), zero drift, leverage 1: E[log w] = -0.5 sigma^2 T."""
    n, days = 1024, 63
    w, _ = gbm.gbm_buyhold(3, n, days, 0.0, 0.01, 1.0, 0.0, device="cpu")
    logw = np.log(w.numpy())
    assert logw.mean() == pytest.approx(-0.5 * 1e-4 * days,
                                        abs=5 * 0.01 * math.sqrt(days / n))
    # 63 days are 32 pairs, the last one's sin draw unused: 64 days differ
    # from 63 by exactly one more step.
    w64, _ = gbm.gbm_buyhold(3, n, 64, 0.0, 0.01, 1.0, 0.0, device="cpu")
    assert not torch.equal(w, w64)


def test_adjacent_seeds_give_unrelated_streams():
    a, _ = gbm.gbm_buyhold(5, 512, 20, 0.0, 0.02, 3.0, device="cpu")
    b, _ = gbm.gbm_buyhold(6, 512, 20, 0.0, 0.02, 3.0, device="cpu")
    for shift in (0, 1, -1):
        assert not np.isin(a.numpy(), np.roll(b.numpy(), shift)).any()
    assert abs(np.corrcoef(np.log(a.numpy()), np.log(b.numpy()))[0, 1]) < 0.2


def test_percentile_report_matches_jax_through_the_twin():
    ref = jpp.gbm_percentile_report(0, 4096, 2, use_pallas=False)
    got = gbm.gbm_percentile_report(0, 4096, 2, use_kernel=False,
                                    device="cpu")
    assert got["engine"] == "xla" and set(got["percentiles"]) == set(
        ref["percentiles"])
    for k in ("percentiles", "cagr_percentiles"):
        for p, v in ref[k].items():
            assert got[k][p] == pytest.approx(v, rel=1e-5, abs=1e-6), (k, p)
    for k in ("cvar_5pct_wealth", "median_max_drawdown"):
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    rep = gbm.gbm_percentile_report(0, 4096, 2, device="cpu")
    vals = list(rep["percentiles"].values())
    assert rep["engine"] == "kernel" and vals == sorted(vals)
    assert 0 <= rep["median_max_drawdown"] <= 1


def test_reductions_match_jax():
    rs = np.random.default_rng(1)
    w = rs.lognormal(0.0, 0.8, (1001, 5)) * 1e4
    bench = rs.lognormal(0.0, 0.5, 1001) * 1e4
    tw, tb = torch.from_numpy(w), torch.from_numpy(bench)
    np.testing.assert_allclose(reductions.percentile_fan(tw).numpy(),
                               np.asarray(jred.percentile_fan(jnp.asarray(w))),
                               rtol=1e-12)
    np.testing.assert_allclose(reductions.cvar(tw).numpy(),
                               np.asarray(jred.cvar(jnp.asarray(w))),
                               rtol=1e-12)
    np.testing.assert_allclose(
        reductions.win_rate(tw, tb).numpy(),
        np.asarray(jred.win_rate(jnp.asarray(w), jnp.asarray(bench))),
        rtol=1e-6)          # JAX averages the bool mask in float32
    np.testing.assert_allclose(
        reductions.wealth_to_cagr(tw - 5e3, 1e4, 30.0).numpy(),
        np.asarray(jred.wealth_to_cagr(jnp.asarray(w - 5e3), 1e4, 30.0)),
        rtol=1e-12)
