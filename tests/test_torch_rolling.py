"""The port's rolling statistics and strategy signals against the JAX
package at float64.

The same [B, S] series (made with numpy from a seed, NaN-free returns)
go through ``letf_tpu.ops.rolling`` / ``letf_tpu.strategies.signals`` on
the time axis -1 and through the port on its [S, B] layout (axis 0).
Tolerance rel 1e-9: the two cumulative sums may add in a different order,
and the windowed differences of prefix sums lose ~T/w of that."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops import rolling as jrl
from letf_tpu.strategies import signals as jsig
from letf_tpu_torch.ops import rolling as rl
from letf_tpu_torch.strategies import signals as sig
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S = 64, 400
RTOL, ATOL = 1e-9, 1e-12


def _series(seed=0):
    rs = np.random.default_rng(seed)
    r = 0.0004 + 0.02 * rs.standard_t(5, (B, S))
    price = 100.0 * np.cumprod(1.0 + r, axis=1)
    return r, price


def _same(got, want):
    np.testing.assert_allclose(got.numpy().T, np.asarray(want), rtol=RTOL,
                               atol=ATOL, equal_nan=True)


CASES = {
    "rolling_sum_126": (lambda x, a: rl.rolling_sum(x, 126, 1, axis=a),
                        lambda x: jrl.rolling_sum(x, 126, 1)),
    "rolling_mean_200": (lambda x, a: rl.rolling_mean(x, 200, axis=a),
                         lambda x: jrl.rolling_mean(x, 200)),
    "rolling_mean_100_mp1": (lambda x, a: rl.rolling_mean(x, 100, 1, axis=a),
                             lambda x: jrl.rolling_mean(x, 100, 1)),
    "rolling_std_20": (lambda x, a: rl.rolling_std(x, 20, axis=a),
                       lambda x: jrl.rolling_std(x, 20)),
    "rolling_std_5_mp1": (lambda x, a: rl.rolling_std(x, 5, 1, axis=a),
                          lambda x: jrl.rolling_std(x, 5, 1)),
    "rolling_skew_60": (lambda x, a: rl.rolling_skew(x, 60, 1, axis=a),
                        lambda x: jrl.rolling_skew(x, 60, 1)),
    "shift1": (lambda x, a: rl.shift1(x, axis=a), jrl.shift1),
    "pct_change_5": (lambda x, a: rl.pct_change(x, 5, axis=a),
                     lambda x: jrl.pct_change(x, 5)),
    "window_longer_than_series": (
        lambda x, a: rl.rolling_mean(x, 2 * S, 1, axis=a),
        lambda x: jrl.rolling_mean(x, 2 * S, 1)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rolling_matches_jax(name):
    port, ref = CASES[name]
    r, _ = _series()
    _same(port(torch.as_tensor(r.T.copy()), 0), ref(jnp.asarray(r)))


@pytest.mark.parametrize("name", ["rsi", "cummax", "max_drawdown"])
def test_price_statistics_match_jax(name):
    _, price = _series(1)
    x = torch.as_tensor(price.T.copy())
    if name == "rsi":
        _same(rl.rsi(x, 14, axis=0), jrl.rsi(jnp.asarray(price), 14))
    elif name == "cummax":
        _same(rl.cummax(x, axis=0), jrl.cummax(jnp.asarray(price)))
    else:
        np.testing.assert_allclose(
            rl.max_drawdown(x, axis=0).numpy(),
            np.asarray(jrl.max_drawdown(jnp.asarray(price))), rtol=RTOL)


def test_compute_signals_matches_jax():
    rs = np.random.default_rng(2)
    etf = np.clip(0.0005 + 0.03 * rs.standard_t(4, (B, S, 6)), -0.9, 2.0)
    ref = jsig.compute_signals(types.SimpleNamespace(
        etf_ret=jnp.asarray(etf)))
    got = sig.compute_signals(types.SimpleNamespace(
        etf_ret=torch.as_tensor(etf.transpose(2, 1, 0).copy())))
    assert set(got._fields) == set(ref._fields)
    for f in ref._fields:
        g, w = getattr(got, f), np.asarray(getattr(ref, f))
        if f == "prices":
            np.testing.assert_allclose(g.numpy().transpose(2, 1, 0), w,
                                       rtol=RTOL)
        else:
            _same(g, w)
