#!/usr/bin/env python3
"""Reference numbers of the full analysis for ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 -m tools.analysis_reference > out.py

Prints, as Python source, the constants of the smoke's analysis phase
(``ANALYSIS_*``), from the JAX package on the CPU in float32 (JAX's
default mode, as the card runs the port), over the committed fits and
history (``letf_tpu_cache_v1/``):

- the results list of ``runner.run``'s first horizon: ``run_monte_carlo``
  on the model of the committed fits, 200 trials (``cfg.NUM_SIMULATIONS``)
  x 10 years, seed 0, through the package's production route
  (``ops/slab_chunk.py``: the joint, window and compose-strategies Pallas
  kernels in interpret mode; the package takes that route only on a TPU
  and for a multiple of 1,024 trials, so the backend check is answered
  "tpu" and the first 200 trials of a 1,024-trial run are kept: every
  trial replays from (seed, trial id)), as ``parallel_monte_carlo_fixed``
  runs it: each trial's start offset and regime-1 days, and the median
  final wealth of S1-S3;
- ``historical.backtest_strategies_on_history`` on the committed history
  (pandas) at 10, 20 and 30 years: the window count, the regime-1 window
  days in all, and each strategy's median window CAGR;
- ``validation.run_institutional_sanity_checks`` on the committed fits and
  ``validation.run_rolling_oos_calibration_backtest`` on the committed
  history.

Takes a few minutes and a few GiB on the CPU.
"""

from __future__ import annotations

import functools
import pickle
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from letf_tpu import historical, validation  # noqa: E402
from letf_tpu.models.params import build_sim_model  # noqa: E402
from letf_tpu.ops import pallas_joint, pallas_strategies, pallas_window  # noqa: E402
from letf_tpu.parallel import mc_runner  # noqa: E402
from letf_tpu.parallel.mesh import trial_mesh  # noqa: E402
from letf_tpu.strategies import engine  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / "letf_tpu_cache_v1"
FITS = ("regime_model", "joint_return_model", "funding_spread_model",
        "stress_state_model", "tracking_residual_model")
N, YEARS, SEED = 200, 10, 0


def committed_model():
    """The calibration dict ``calibrate_all`` returns, from the committed
    fits, as ``runner.run`` threads it."""
    load = {n: pickle.loads((CACHE / f"{n}.pkl").read_bytes()) for n in FITS}
    model = dict(load["regime_model"])
    model["joint_return_model"] = load["joint_return_model"]
    model["funding_model"] = load["funding_spread_model"]
    model["stress_state_model"] = load["stress_state_model"]
    model["tracking_residual_model"] = load["tracking_residual_model"]
    return model


def results_list(model):
    patched = {}
    for mod, name in ((pallas_joint, "pallas_joint_generate"),
                      (pallas_window, "window_offsets_slab"),
                      (pallas_strategies, "pallas_compose_strategies_run")):
        patched[mod, name] = getattr(mod, name)
        setattr(mod, name, functools.partial(getattr(mod, name),
                                             interpret=True))
    backend = jax.default_backend
    jax.default_backend = lambda: "tpu"
    a = mc_runner.run_monte_carlo(
        build_sim_model(model), YEARS, num_simulations=1024, seed=SEED,
        chunk_size=1024, mesh=trial_mesh(jax.devices()[:1]), progress=False)
    jax.default_backend = backend
    for (mod, name), fn in patched.items():
        setattr(mod, name, fn)
    return a


def backtests(df):
    """{horizon: (windows, regime-1 window days, {sid: median CAGR})}."""
    seen = {}
    inner = engine.run_strategies_batch

    def spy(path, sig, **kw):
        seen["regime_days"] = int(np.asarray(path.regime).sum())
        return inner(path, sig, **kw)

    engine.run_strategies_batch = spy
    out = {}
    for h in (10, 20, 30):
        seen.clear()
        bt = historical.backtest_strategies_on_history(df, h)
        wins = len(bt["S1"]) if bt else 0
        out[h] = (wins, seen.get("regime_days", 0),
                  {sid: float(np.median(v)) for sid, v in bt.items()
                   if len(v)})
    engine.run_strategies_batch = inner
    return out


def main():
    model = committed_model()
    df = pd.read_pickle(CACHE / "historical_data.pkl")
    a = results_list(model)
    fw = np.asarray(a.final_wealth)[:N]
    assert fw.dtype == np.float32, fw.dtype
    print(f"ANALYSIS_START_OFFSETS = {tuple(int(v) for v in np.asarray(a.start_offset)[:N])}")
    print(f"ANALYSIS_REGIME_HIGH_DAYS = {tuple(int(v) for v in np.asarray(a.regime_high_days)[:N])}")
    print("ANALYSIS_S123_P50 = "
          f"{tuple(float(np.median(fw[:, k].astype(np.float64))) for k in range(3))}")
    print("ANALYSIS_BACKTEST = {")
    for h, (w, rd, med) in backtests(df).items():
        print(f"    {h}: ({w}, {rd}, {med!r}),")
    print("}")
    sanity = validation.run_institutional_sanity_checks(
        model, model["funding_model"], model["tracking_residual_model"])
    print(f"ANALYSIS_SANITY = {sanity!r}")
    oos = validation.run_rolling_oos_calibration_backtest(df)
    print(f"ANALYSIS_ROLLING_OOS = {oos!r}")


if __name__ == "__main__":
    main()
