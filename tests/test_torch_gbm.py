"""The buy-and-hold headline path (kernel K6) and the reductions against
``letf_tpu/ops/pallas_path.py`` and ``letf_tpu/ops/reductions.py``.

- The XLA twin's port draws ``jax.random.normal`` bits (ops/rng.py), so it
  agrees with ``gbm_buyhold_xla`` trial by trial: wealth within rtol 2e-6
  and drawdown within 1e-6 (XLA:CPU's and torch's log1p differ by ulps).
- K6 (here its plain version, which draws the kernel's counter bits) can
  only agree in distribution with the TPU kernel, whose hardware PRNG is
  not reproducible: tests/test_pallas_path.py:51-80's moment test against
  the XLA twin and its zero-drift odd-day (63 days) test.
- K6's linear-domain form (products of the daily growth factors in
  blocks, one log a block) against a float64 evaluation of the reference's
  log1p recurrence (pallas_path.py:66-71) on the port's own normals: it is
  within rtol 2e-5 (wealth) and atol 1e-6 (drawdown) at 2,520 days, and
  no farther from float64 than the float32 log-domain form it replaced.
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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MU, SIGMA = 0.10 / 252, 0.24 / math.sqrt(252)
COST = 0.0086 / 252


def port_normals(seed, n, days):
    """[days, n] float32: the normals K6 draws for seed's trials 0..n-1,
    day by day (each pair's cos then sin; an odd last day takes cos)."""
    w = gbm.seed_words(seed)
    lane = rng.lane_keys(torch.arange(n), w)
    zs = []
    for i in range((days + 1) // 2):
        zs.extend(gbm.pair_normals(lane, i, w, "cpu"))
    return torch.stack(zs[:days]).numpy() if days else np.zeros((0, n),
                                                                np.float32)


def log_domain(z, mu, sigma, lev, cost, dtype):
    """The reference's recurrence (pallas_path.py:66-71) on the normals z
    [days, n] in numpy ``dtype``: (wealth, drawdown)."""
    mu, sigma, lev, cost, floor = (dtype(v) for v in
                                   (mu, sigma, lev, cost, -0.999))
    acc = np.zeros(z.shape[1], dtype)
    peak = np.zeros_like(acc)
    mdd = np.zeros_like(acc)
    for zt in z.astype(dtype):
        net = lev * (mu + sigma * zt) - cost
        acc = acc + np.log1p(np.maximum(net, floor))
        peak = np.maximum(peak, acc)
        mdd = np.maximum(mdd, peak - acc)
    return np.exp(acc), dtype(1) - np.exp(-mdd)


def test_plain_is_closer_to_float64_than_the_log_domain_form():
    """gbm_plain (the kernel's arithmetic) against float64 on the same
    normals, 1,024 trials x 2,520 days (blocks of 140 pairs): wealth within
    rtol 2e-5, drawdown within atol 1e-6, and no farther from float64 than
    the float32 log-domain recurrence of the first port."""
    n, days = 1024, 2520
    z = port_normals(4, n, days)
    w64, m64 = log_domain(z, MU, SIGMA, 3.0, COST, np.float64)
    w32, m32 = log_domain(z, MU, SIGMA, 3.0, COST, np.float32)
    w, m = (v.numpy() for v in gbm.gbm_plain(4, n, days, MU, SIGMA, 3.0,
                                             COST))
    err_w = np.abs(w / w64 - 1).max()
    err_m = np.abs(m - m64).max()
    np.testing.assert_allclose(w, w64, rtol=2e-5)
    np.testing.assert_allclose(m, m64, rtol=0, atol=1e-6)
    assert err_w <= np.abs(w32 / w64 - 1).max()
    assert err_m <= np.abs(m32 - m64).max()


def test_ruin_on_the_floor():
    """A drift that keeps net on the -0.999 floor every day for six weeks
    (blocks of 6 pairs, each block's product near 1e-36): wealth underflows
    to 0 as the float32 reference's does and is within 1e-37 of float64,
    drawdown is exactly 1."""
    n, days = 64, 30
    assert gbm.block_pairs(-0.5, 0.05, 3.0, 0.0) == 6
    z = port_normals(2, n, days)
    w64, _ = log_domain(z, -0.5, 0.05, 3.0, 0.0, np.float64)
    w32, m32 = log_domain(z, -0.5, 0.05, 3.0, 0.0, np.float32)
    w, m = gbm.gbm_buyhold(2, n, days, -0.5, 0.05, 3.0, device="cpu")
    np.testing.assert_allclose(w.numpy(), w64, rtol=0, atol=1e-37)
    np.testing.assert_array_equal(w.numpy(), w32)
    assert (m == 1.0).all() and (m32 == 1.0).all()


@pytest.mark.parametrize("days", [0, 1, 2, 63])
def test_short_and_odd_horizons(days):
    """Zero days give wealth 1 and drawdown 0 exactly; one day, one pair
    and an odd 63 days (the last pair's sine unused) match float64 on the
    same normals."""
    n = 256
    w, m = gbm.gbm_buyhold(6, n, days, 0.0004, 0.02, 3.0, 3e-5,
                           device="cpu")
    assert w.shape == m.shape == (n,) and w.dtype == torch.float32
    if days == 0:
        assert (w == 1.0).all() and (m == 0.0).all()
        return
    w64, m64 = log_domain(port_normals(6, n, days), 0.0004, 0.02, 3.0, 3e-5,
                          np.float64)
    np.testing.assert_allclose(w.numpy(), w64, rtol=2e-6)
    np.testing.assert_allclose(m.numpy(), m64, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mu,sigma", [(0.0, 1e30), (float("nan"), 0.01),
                                      (0.0, float("inf"))])
def test_parameters_no_block_can_hold_raise(mu, sigma):
    """A largest daily growth factor that overflows float32 over one day
    pair, or a non-finite parameter, raises ValueError in the wrapper."""
    with pytest.raises(ValueError):
        gbm.gbm_buyhold(0, 8, 10, mu, sigma, 3.0, device="cpu")
    with pytest.raises(ValueError):
        gbm.block_pairs(mu, sigma, 3.0, 0.0)


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
