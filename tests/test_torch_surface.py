"""The port's library surface against the JAX package's, on the CPU:
``utils/finance.get_max_underwater_days``, ``income.get_year_income`` and
``simulate_income_trajectory`` (equal for the same seed),
``income.simulate_income_paths`` against ``simulate_income_paths_jax``
(its uniforms bit for bit, its normals within the samplers' bounds of
tests/test_torch_rng_samplers.py, 2e-6 relative plus 1e-6 in float32 and
4e-14 plus 1e-15 in float64; the paths in the JAX suite's float64 within
1e-12 relative over 20 years), ``utils/profiling``
(``StepTimer``'s output equal, ``device_trace`` writing a Chrome trace
with ``annotate``'s range in it) and the TQQQ flow (``tqqq.main``) at a
small size."""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from letf_tpu import income as jincome
from letf_tpu.utils import finance as jfinance
from letf_tpu.utils import profiling as jprofiling
from letf_tpu_torch import income, tqqq
from letf_tpu_torch.ops import rng
from letf_tpu_torch.utils import finance, profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("curve", [
    [], [1.0], [1.0, 2.0, 3.0], [3.0, 2.0, 1.0], [1.0, 0.5, 0.7, 1.2, 1.1,
                                                  1.0, 1.3, 0.2, 0.3],
    list(np.cumprod(1 + np.random.default_rng(3).normal(0, 0.02, 2000)))])
def test_max_underwater_days_equals_jax(curve):
    assert finance.get_max_underwater_days(curve) == \
        jfinance.get_max_underwater_days(curve)


@pytest.mark.parametrize("stage, aggressive, seed", [
    ("early", True, 1), ("mid", True, 3), ("late", False, 9)])
def test_income_trajectory_equals_jax(stage, aggressive, seed):
    kw = dict(num_simulations=40, career_stage=stage, aggressive=aggressive,
              seed=seed)
    got = income.simulate_income_trajectory(150_000, 20, **kw)
    ref = jincome.simulate_income_trajectory(150_000, 20, **kw)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for year in (0, 7, 20, 21, 30):
        assert income.get_year_income(got["p50"], year) == \
            jincome.get_year_income(ref["p50"], year)


@pytest.mark.parametrize("dtype, rtol, atol", [
    (np.float32, 2e-6, 1e-6), (np.float64, 4e-14, 1e-15)])
def test_income_paths_draws_equal_jax(dtype, rtol, atol):
    """Year k's three draws, as the JAX function takes them."""
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    for k_port, k_jax in zip(rng.split(rng.key(0), 3),
                             jax.random.split(jax.random.key(0), 3)):
        kz, kr, kb = rng.split(k_port, 3)
        jz, jr, jb = jax.random.split(k_jax, 3)
        for a, b in ((kr, jr), (kb, jb)):
            np.testing.assert_array_equal(
                rng.uniform(a, 500, tdt).numpy(),
                np.asarray(jax.random.uniform(b, (500,), dtype)))
        np.testing.assert_allclose(
            rng.normal(kz, 500, tdt).numpy(),
            np.asarray(jax.random.normal(jz, (500,), dtype)),
            rtol=rtol, atol=atol)


@pytest.mark.parametrize("stage, aggressive", [("mid", True),
                                               ("early", False)])
def test_income_paths_equal_jax(stage, aggressive):
    got = income.simulate_income_paths(rng.key(0), 150_000.0, 20, 2000,
                                       stage, aggressive,
                                       dtype=torch.float64).numpy()
    ref = np.asarray(jincome.simulate_income_paths_jax(
        jax.random.key(0), 150_000.0, 20, 2000, stage, aggressive))
    assert got.shape == ref.shape == (2000, 21)
    assert got.dtype == ref.dtype == np.float64      # the suite's x64
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)
    assert got.min() >= 75_000 and got.max() <= 750_000


def test_step_timer_equals_jax(monkeypatch):
    clock = iter([10.0, 11.0, 13.5, 20.0] * 2)
    monkeypatch.setattr(profiling.time, "time", lambda: next(clock))
    outs = []
    for mod in (profiling, jprofiling):
        if mod is jprofiling:
            monkeypatch.setattr(jprofiling.time, "time", lambda: next(clock))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            t = mod.StepTimer()
            t.step("a")
            t.step("b")
            t.summary()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "TIMING SUMMARY" in outs[0]


def test_device_trace_and_annotate(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        with profiling.device_trace(str(tmp_path)) as prof:
            with profiling.annotate("letf_block"):
                torch.ones(64).cumsum(0)
    assert prof is not None
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "letf_block" in names


def test_tqqq_flow_small():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = tqqq.main(device="cpu", years=2, sims=16)
    text = buf.getvalue()
    assert "Leverage-consistency analysis" in text
    assert set(out["cagrs"]) == {"SPY", "SSO", "TQQQ"}
    for c in out["cagrs"].values():
        assert c.shape == (16,) and np.isfinite(c).all()
    assert out["ordered"] == (out["spread"]["SPY"] < out["spread"]["SSO"]
                              < out["spread"]["TQQQ"])
