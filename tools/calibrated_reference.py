#!/usr/bin/env python3
"""Reference numbers of the calibrated report for ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 -m tools.calibrated_reference > out.py

Prints, as Python source, the constants of the smoke's calibrated phase
(``HISTORY_*`` and ``JAX_CAL_*``):

- per column of the committed ``letf_tpu_cache_v1/historical_data.pkl``
  (read with pandas): a digest of its bytes, its NaN count and its sum
  over the non-NaN days, so that the smoke can hold the port's frame to it
  on a machine without pandas;
- the JAX package's ``run_monte_carlo`` on the model built from the
  committed fits (``letf_tpu_cache_v1/*_model.pkl``, ``correlations.pkl``):
  1,024 trials x 30 years, seed 2, one chunk of 1,024, float32 (JAX's
  default mode, as the card runs the port), through the package's
  production route (``ops/slab_chunk.py``: the joint, window and
  compose-strategies Pallas kernels, here in interpret mode on the CPU;
  the package takes that route only on a TPU, so the backend check is
  answered "tpu" for the run). Summarised as S1's final wealth per trial,
  the trade counts summed per strategy, the median final wealth per
  strategy, and integer sums of the start offsets, regime-1 days, jump
  days and valid flags.

Takes ~10 minutes and a few GiB on the CPU.
"""

from __future__ import annotations

import functools
import hashlib
import pickle
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from letf_tpu.models.params import build_sim_model  # noqa: E402
from letf_tpu.ops import pallas_joint, pallas_strategies, pallas_window  # noqa: E402
from letf_tpu.parallel import mc_runner  # noqa: E402
from letf_tpu.parallel.mesh import trial_mesh  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / "letf_tpu_cache_v1"
FITS = ("regime_model", "joint_return_model", "funding_spread_model",
        "stress_state_model", "tracking_residual_model")


def digest(a: np.ndarray) -> str:
    """First 16 hex digits of the SHA-256 of a column's bytes (the same
    function as ``chip_smoke.digest``)."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def committed_model():
    """The calibration dict ``calibrate_all`` returns, from the committed
    fits, as ``runner.run_report`` threads it."""
    load = {n: pickle.loads((CACHE / f"{n}.pkl").read_bytes()) for n in FITS}
    model = dict(load["regime_model"])
    model["joint_return_model"] = load["joint_return_model"]
    model["funding_model"] = load["funding_spread_model"]
    model["stress_state_model"] = load["stress_state_model"]
    model["tracking_residual_model"] = load["tracking_residual_model"]
    return model


def history_constants():
    df = pd.read_pickle(CACHE / "historical_data.pkl")
    cols = {}
    for c in df.columns:
        a = df[c].to_numpy()
        if a.dtype == object or str(a.dtype) == "str" or a.dtype.kind in "OUS":
            cols[c] = ("str", sorted(set(a.tolist())))
            continue
        f = a.astype(np.float64)
        cols[c] = (digest(a), int(np.isnan(f).sum()),
                   float(np.nansum(f)))
    return (len(df), str(df.index[0].date()), str(df.index[-1].date()),
            cols)


def run_reference():
    for mod, name in ((pallas_joint, "pallas_joint_generate"),
                      (pallas_window, "window_offsets_slab"),
                      (pallas_strategies, "pallas_compose_strategies_run")):
        setattr(mod, name, functools.partial(getattr(mod, name),
                                             interpret=True))
    jax.default_backend = lambda: "tpu"
    model = build_sim_model(committed_model())
    return mc_runner.run_monte_carlo(
        model, 30, num_simulations=1024, seed=2, chunk_size=1024,
        mesh=trial_mesh(jax.devices()[:1]), progress=False)


def main():
    n, first, last, cols = history_constants()
    print(f"HISTORY_SHAPE = ({n}, {len(cols)})")
    print(f"HISTORY_SPAN = ({first!r}, {last!r})")
    print("HISTORY_COLUMNS = {")
    for c, v in cols.items():
        print(f"    {c!r}: {v!r},")
    print("}")
    a = run_reference()
    fw = np.asarray(a.final_wealth)
    assert fw.dtype == np.float32, fw.dtype
    print("JAX_CAL_S1_WEALTH = (")
    vals = [repr(float(np.float32(v))) for v in fw[:, 0]]
    for i in range(0, len(vals), 5):
        print("    " + ", ".join(vals[i:i + 5]) + ",")
    print(")")
    print(f"JAX_CAL_TRADE_SUMS = {tuple(int(v) for v in np.asarray(a.num_trades).sum(0))}")
    print(f"JAX_CAL_WEALTH_P50 = {tuple(float(np.float32(v)) for v in np.median(fw.astype(np.float64), 0))}")
    ints = {"start_offset": int(np.asarray(a.start_offset).sum()),
            "regime_high_days": int(np.asarray(a.regime_high_days).sum()),
            "jump_days": int(np.asarray(a.jump_days).sum()),
            "valid": int(np.asarray(a.valid).sum())}
    print(f"JAX_CAL_INT_SUMS = {ints!r}")


if __name__ == "__main__":
    main()
