"""The port's calibration against the JAX package's, under the suite's x64.

On the 2000-2025 synthetic history, each ``calibrate_*`` of the port
(fits on the CPU in float64) against the JAX package's: the historical
regime path exactly, GARCH alpha and beta within 1e-8 absolute, every
other fitted number within rtol 1e-9; ``calibrate_all``'s output builds
the same ``SimModel`` as the JAX package's fits carried across by
``from_jax_model``. Also ``fit_garch11_mle`` on the recovery test's
series (tests/test_data_calibration.py), on a series whose variance
floor binds and on a zero-variance one (Adam's starting point in both), and every ``ops/fitting`` core on
masked random inputs (as tests/test_fitting_device.py builds them).
Every cache path points at a temporary directory.
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from letf_tpu import calibration as jcal
from letf_tpu import config as jcfg
from letf_tpu.data import generate_synthetic_history
from letf_tpu.models.params import build_sim_model as jax_build
from letf_tpu.ops import fitting as jfit
from letf_tpu_torch import calibration as tcal
from letf_tpu_torch import config as tcfg
from letf_tpu_torch.models.params import build_sim_model, from_jax_model
from letf_tpu_torch.ops import fitting as tfit
from letf_tpu_torch.utils.frame import Frame
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CACHES = ("DATA_CACHE", "REGIME_MODEL_CACHE", "CORRELATION_CACHE",
          "JOINT_RETURN_MODEL_CACHE", "FUNDING_MODEL_CACHE",
          "TRACKING_RESIDUAL_CACHE", "STRESS_STATE_CACHE")
GARCH = ("garch_alpha", "garch_beta")


@pytest.fixture(scope="module", autouse=True)
def isolated_caches(tmp_path_factory):
    """Both packages' cache paths in temporary directories."""
    mp = pytest.MonkeyPatch()
    for cfg in (jcfg, tcfg):
        tmp = tmp_path_factory.mktemp("cache")
        mp.setattr(cfg, "CACHE_DIR", tmp)
        for name in CACHES:
            mp.setattr(cfg, name, tmp / getattr(cfg, name).name)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def frames():
    df = generate_synthetic_history("2000-01-01", "2025-12-31")
    return df, Frame({c: df[c].to_numpy() for c in df.columns},
                     df.index.values.astype("datetime64[D]"))


@pytest.fixture(scope="module")
def fits(frames):
    jdf, tdf = frames
    return tcal.calibrate_all(tdf, device="cpu"), jcal.calibrate_all(jdf)


def assert_tree_close(got, ref, path=""):
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            assert_tree_close(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            assert_tree_close(a, b, f"{path}[{i}]")
    elif isinstance(ref, str):
        assert got == ref, path
    elif path.rsplit("/", 1)[-1] in GARCH:
        assert abs(got - ref) <= 1e-8, (path, got, ref)
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(ref, float), rtol=1e-9,
                                   atol=0, err_msg=path)


def test_calibrate_all_matches_jax(fits):
    (got, got_corr), (ref, ref_corr) = fits
    np.testing.assert_array_equal(got["regimes_historical"],
                                  ref["regimes_historical"])
    assert got["regimes_historical"].sum() > 0
    assert_tree_close(got, ref)
    assert_tree_close(got_corr, ref_corr)
    jm = got["joint_return_model"]["regimes"]
    assert all(jm[r]["garch_alpha"] not in (0.06, 0.09) for r in (0, 1))


def test_each_calibration_matches_jax(frames, fits):
    """Each calibrate_* called alone (no cache) against the JAX package's,
    and predict_borrow_spread_series on a frame with gaps."""
    jdf, tdf = frames
    regimes = fits[1][0]["regimes_historical"]
    assert_tree_close(tcal.calibrate_vix_dynamics(tdf, regimes),
                      jcal.calibrate_vix_dynamics(jdf, regimes))
    fm = tcal.calibrate_funding_spread_model(tdf, bypass_cache=True,
                                             device="cpu")
    assert_tree_close(fm, jcal.calibrate_funding_spread_model(
        jdf, bypass_cache=True))
    assert_tree_close(
        tcal.calibrate_tracking_residual_model(tdf, funding_model=fm,
                                               bypass_cache=True,
                                               device="cpu"),
        jcal.calibrate_tracking_residual_model(jdf, funding_model=fm,
                                               bypass_cache=True))
    assert_tree_close(
        tcal.calibrate_tracking_residual_model(tdf, bypass_cache=True,
                                               device="cpu"),
        jcal.calibrate_tracking_residual_model(jdf, bypass_cache=True))
    gaps = jdf[["VIX", "IRX", "TNX"]].iloc[:400].copy()
    gaps.iloc[::7, 0] = np.nan
    gaps.iloc[3::11, 2] = np.nan
    np.testing.assert_allclose(
        tcal.predict_borrow_spread_series(
            Frame({c: gaps[c].to_numpy() for c in gaps.columns},
                  gaps.index.values.astype("datetime64[D]")), fm),
        jcal.predict_borrow_spread_series(gaps, fm), rtol=1e-12)
    # The joint model on 100 days (the small-sample fallbacks), caches off.
    small = jdf.iloc[:100]
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jcal, tcal):
            mp.setattr(mod, "load_cache", lambda path: None)
            mp.setattr(mod, "save_cache", lambda data, path: None)
        assert_tree_close(
            tcal.calibrate_joint_return_model(
                Frame({c: small[c].to_numpy() for c in small.columns},
                      small.index.values.astype("datetime64[D]")),
                regimes[:100], device="cpu"),
            jcal.calibrate_joint_return_model(small, regimes[:100]))


def test_sim_model_roundtrip(fits):
    """build_sim_model of the port's fits is the SimModel that the JAX
    package builds from its own fits, carried across by from_jax_model."""
    got = build_sim_model(fits[0][0])
    ref = from_jax_model(jax_build(fits[1][0]))
    for part in got._fields:
        a, b = getattr(got, part), getattr(ref, part)
        for f in getattr(a, "_fields", (None,)):
            x = np.asarray(a if f is None else getattr(a, f), float)
            y = np.asarray(b if f is None else getattr(b, f), float)
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{part}.{f}")
    assert got.regime.has_dwell.sum() == 2


def test_pairwise_corr_equals_pandas():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.01, 3000)
    y = 0.8 * x + rng.normal(0, 0.005, 3000)
    x[rng.random(3000) < 0.05] = np.nan
    y[rng.random(3000) < 0.05] = np.nan
    want = pd.DataFrame({"a": x, "b": y}).corr().loc["a", "b"]
    assert tcal.pairwise_corr(x, y) == pytest.approx(want, rel=1e-13)


def garch_series():
    """tests/test_data_calibration.py::test_garch_mle_recovers_truth's."""
    rng = np.random.default_rng(0)
    n, alpha_true, beta_true = 5000, 0.08, 0.88
    h, r = 1e-4, np.zeros(n)
    for t in range(1, n):
        h = (1e-4 * (1 - alpha_true - beta_true)
             + alpha_true * r[t - 1] ** 2 + beta_true * h)
        r[t] = np.sqrt(h * (3 / 5)) * rng.standard_t(5)
    return r


def test_garch_mle_matches_jax():
    r = garch_series()
    got = tcal.fit_garch11_mle(r, nu=5.0, device="cpu")
    ref = jcal.fit_garch11_mle(r, nu=5.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    assert abs(got[0] - 0.08) < 0.04 and abs(got[1] - 0.88) < 0.06
    # A batch of series of different lengths and nus equals one at a time.
    batch = tcal.fit_garch11_mle_batch([r, r[:1200], r[:150]],
                                       [5.0, 7.0, 5.0], device="cpu")
    assert batch[2] is None
    np.testing.assert_allclose(batch[0], got, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        batch[1], jcal.fit_garch11_mle(r[:1200], nu=7.0), rtol=0, atol=1e-8)


def test_garch_variance_floor_and_zero_variance():
    """A series with variance ~1e-14: h hits the reference's 1e-12 floor,
    so the closed form is not the reference's recurrence there and the
    port runs the floored day loop (maxiter cut to keep it short, in both
    packages). A zero-variance series gives None in both."""
    tiny = np.random.default_rng(1).normal(0, 1e-7, 200)
    assert tiny.var() < tcal._FLOOR_FREE_VAR
    got = tcal.fit_garch11_mle(tiny, nu=5.0, maxiter=40, device="cpu")
    ref = jcal.fit_garch11_mle(tiny, nu=5.0, maxiter=40)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    # Zero variance: h sits on the floor, every gradient is 0, and both
    # return Adam's starting point.
    zero = np.zeros(300)
    ref = jcal.fit_garch11_mle(zero, maxiter=40)
    assert ref == tcal.fit_garch11_mle(zero, maxiter=40, device="cpu")
    alpha0 = 0.30 / (1 + np.exp(1.5))
    assert ref == pytest.approx((alpha0, (1 - alpha0) * 0.999
                                 / (1 + np.exp(-2.0))), rel=1e-14)


def test_garch_closed_form_is_the_recurrence():
    """The doubling scan equals the day-by-day recurrence where the floor
    cannot bind."""
    rng = np.random.default_rng(2)
    x2 = torch.as_tensor(rng.standard_t(5, (3, 777)) ** 2 * 1e-4)
    var0 = x2.mean(1)
    alpha = torch.tensor([0.05, 0.2, 0.29], dtype=torch.float64)
    beta = torch.tensor([0.9, 0.6, 0.7], dtype=torch.float64)
    omega = var0 * (1 - alpha - beta)
    got = tcal._garch_variances(omega, alpha, beta, var0, x2)
    ref = tcal._garch_variances_floored(omega, alpha, beta, var0, x2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12)


@pytest.fixture()
def rng():
    return np.random.default_rng(7)


def test_fitting_cores_match_jax(rng):
    """Every fitting core on the JAX package's test inputs (NaNs, regime
    masks), float64, against the JAX cores under fit_context."""
    n = 3000
    stress = np.maximum(rng.normal(5, 8, n), 0.0)
    inv_curve = np.maximum(rng.normal(-0.5, 0.7, n), 0.0)
    liquidity = np.abs(rng.normal(0.3, 0.5, n))
    credit = np.abs(rng.normal(0.2, 0.4, n))
    target = (0.005 + 0.0003 * stress + 0.001 * inv_curve
              + rng.normal(0, 0.002, n))
    target[rng.integers(0, n, 40)] = np.nan
    args = (target, stress, inv_curve, liquidity, credit)
    got = tfit.funding_fit_device(*tfit.to_f64(*args, device="cpu"))
    with jfit.fit_context():
        ref = jfit.funding_fit_device(*jfit.to_x64(*args))
        ref = [np.asarray(v) for v in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-15)

    liq = np.abs(rng.normal(0.3, 0.3, 4000))
    cred = np.abs(rng.normal(0.2, 0.2, 4000))
    rv = np.abs(rng.normal(0.2, 0.1, 4000))
    liq[5] = np.nan
    for regimes in ((rng.random(4000) < 0.3), np.zeros(4000, bool)):
        mask = regimes & np.isfinite(liq) & np.isfinite(cred)
        got = tfit.stress_channel_fit_device(
            *tfit.to_f64(liq, cred, rv, device="cpu"), torch_bool(mask))
        with jfit.fit_context():
            ref = jfit.stress_channel_fit_device(
                *jfit.to_x64(liq, cred, rv), jnp.asarray(mask))
            ref = [np.asarray(v) for v in ref]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-15)

    resid = rng.normal(0, 3e-4, 2500)
    resid[1:] += 0.3 * resid[:-1]
    resid[rng.integers(0, 2500, 25)] = np.nan
    for mask in (np.isfinite(resid), np.isfinite(resid) & (resid > 0)):
        got = tfit.tracking_residual_fit_device(
            *tfit.to_f64(resid, device="cpu"), torch_bool(mask),
            lo_scale=1.5e-4, hi_scale=2.4e-3)
        with jfit.fit_context():
            ref = jfit.tracking_residual_fit_device(
                *jfit.to_x64(resid), jnp.asarray(mask), lo_scale=1.5e-4,
                hi_scale=2.4e-3)
            ref = [np.asarray(v) for v in ref]
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-9, atol=1e-15)

    x = rng.normal(0, 1, 500)
    x[rng.random(500) < 0.1] = np.nan
    mask = np.isfinite(x) & (rng.random(500) < 0.7)
    xt, mt = tfit.to_f64(x, device="cpu")[0], torch_bool(mask)
    with jfit.fit_context():
        xj, mj = jfit.to_x64(x)[0], jnp.asarray(mask)
        pairs = [
            (tfit.masked_quantile(xt, mt, [0.0, 0.01, 0.5, 0.995, 1.0]),
             jfit.masked_quantile(xj, mj, jnp.asarray(
                 [0.0, 0.01, 0.5, 0.995, 1.0]))),
            (tfit.masked_median(xt, mt), jfit.masked_median(xj, mj)),
            (tfit.masked_mean(xt, mt), jfit.masked_mean(xj, mj)),
            (tfit.masked_std(xt, mt), jfit.masked_std(xj, mj)),
            (tfit.compress(xt, mt)[0][:mask.sum()],
             jfit.compress(xj, mj)[0][:mask.sum()]),
            (torch_stack(tfit.ar1_fit(xt[:-1], xt[1:], mt[1:], 0.1, 0.9,
                                      0.01, 2.0, 0.5, 0.3)),
             jnp.stack(jfit.ar1_fit(xj[:-1], xj[1:], mj[1:], 0.1, 0.9,
                                    0.01, 2.0, 0.5, 0.3))),
            (tfit.masked_quantile(xt, torch_bool(np.zeros(500, bool)), 0.5),
             jfit.masked_quantile(xj, jnp.zeros(500, bool), 0.5)),
        ]
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-15)
        X = rng.normal(0, 1, (300, 4))
        y = X @ np.array([1.0, -2.0, 0.5, 0.0]) + rng.normal(0, 0.1, 300)
        m = rng.random(300) < 0.8
        np.testing.assert_allclose(
            tfit.ridge_solve(*tfit.to_f64(X, y, device="cpu"), torch_bool(m),
                             [1e-6, 1e-4, 1e-4, 1e-4]).numpy(),
            np.asarray(jfit.ridge_solve(*jfit.to_x64(X, y), jnp.asarray(m),
                                        [1e-6, 1e-4, 1e-4, 1e-4])),
            rtol=1e-12)


def torch_bool(a):
    return torch.as_tensor(np.asarray(a, bool))


def torch_stack(ts):
    return torch.stack(list(ts))
