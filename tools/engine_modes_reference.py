#!/usr/bin/env python3
"""Reference numbers of the engine-modes phase for ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 -m tools.engine_modes_reference > out.py

Prints, as Python source, the constants of the smoke's engine-modes phase
(``ENGINE_*``), from the JAX package on the CPU in float32 (JAX's default
mode, as the card runs the port), on ``default_sim_model()`` and the block
bootstrap pools of the committed history
(``letf_tpu_cache_v1/historical_data.pkl``, which the port's offline
history equals bit for bit), seed 2:

- the pools: the first 16 hex digits of the SHA-256 of each array's
  bytes;
- ``legacy_hybrid``: ``run_monte_carlo`` of the first 1,024 trials x 30
  years (one chunk; every trial replays from (seed, trial id), so they are
  the first 1,024 of the smoke's 16,384): the start offsets' and regime-1
  days' sums, and S1-S3's median final wealth;
- each day's chosen block row in both pools for trial ids 0..127 (the even
  rows; an antithetic pair shares its draws): the trial's regime path and
  mode key from ``draw_innovations``, then ``sample_bootstrap_returns``
  without its noise blend on pools whose free columns (A's IRX, B's TLT)
  carry regime * 1e6 + block * 1000 + row, reduced to one checksum a pool
  (``plan_checksum``);
- the per-trial institutional engine, ``generate_paths_batch(model, key,
  ids, anti, 7,560)`` (the reference-shaped call), and the fast route
  over 10 years (``generate_paths_batched``, which on the CPU is the
  port's ``joint_kernel="off"``), trial rows 0..7: each asset's log-growth
  and the VIX sum over the first 150 days;
- ``diagnose_pipeline``, ``diagnose_letf_drag`` and
  ``diagnose_tqqq_detailed`` at tests/test_aux.py:58's sizes.

Takes several minutes and a few GiB on the CPU.

    JAX_PLATFORMS=cpu python3 -m tools.engine_modes_reference --controls

prints, as one JSON line, the control readings that the smoke's bounds
must stay below, in the statistics the smoke checks (the largest over
S1-S3, or over the 8 trials and 6 assets), in float32: how far the S1-S3
medians of the 1,024 legacy trials move when one trial next to the median
changes rank (``one_trial``, what a single float32 tie flip can move them)
and when the draws change (seed 3, ``seed_3``), and how far the per-trial
and ``joint_kernel="off"`` paths' first 150 days move without moment
matching (``no_moment_matching``, a fault of one small term) and when the
150 days start one day later (``one_day_later``, an off-by-one window).
"""

from __future__ import annotations

import contextlib
import functools
import hashlib
import json
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", False)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402

from letf_tpu import config as cfg  # noqa: E402
from letf_tpu import diagnose  # noqa: E402
from letf_tpu.models import bootstrap  # noqa: E402
from letf_tpu.models.params import default_sim_model  # noqa: E402
from letf_tpu.ops import path_batched, path_engine  # noqa: E402
from letf_tpu.parallel import mc_runner  # noqa: E402
from letf_tpu.parallel.mesh import trial_mesh  # noqa: E402

CACHE = Path(__file__).resolve().parents[1] / "letf_tpu_cache_v1"
SEED, YEARS, N_LEGACY, N_PLAN, N_PATH, DAYS = 2, 30, 1024, 128, 8, 150
OFF_YEARS = 10
DIAG_KW = {"pipeline": dict(years=1, n_trials=8),
           "letf_drag": dict(years=2), "tqqq_detailed": dict(years=1)}


def plan_checksum(codes) -> int:
    """One integer of a trial's [T] day codes: sum(code * (t % 1009 + 1))
    mod 2**31 - 1, in int64."""
    c = np.asarray(codes).astype(np.int64)
    w = np.arange(c.shape[-1]) % 1009 + 1
    return int((c * w).sum(-1) % (2 ** 31 - 1))


def pool_digests(pools) -> dict:
    return {f: hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()[:16] for f, a in zip(pools._fields, pools)}


def coded(pools):
    """The pools with A's IRX and B's TLT columns replaced by the code of
    each (regime, block, row)."""
    a, b = pools.a_data.copy(), pools.b_data.copy()
    for data, c in ((a, 3), (b, 2)):
        R, N, L = data.shape[:3]
        data[..., c] = (np.arange(R)[:, None, None] * 1e6
                        + np.arange(N)[None, :, None] * 1000
                        + np.arange(L)[None, None, :])
    return pools._replace(a_data=a, b_data=b)


def legacy_run(model, pools, seed=SEED):
    return mc_runner.run_monte_carlo(
        model, YEARS, num_simulations=N_LEGACY, seed=seed,
        chunk_size=N_LEGACY, mesh=trial_mesh(jax.devices()[:1]),
        engine_mode="legacy_hybrid", bootstrap_pools=pools, progress=False)


def legacy(model, pools):
    a = legacy_run(model, pools)
    p50 = np.median(a.final_wealth[:, :3].astype(np.float64), 0)
    return ({"start_offset": int(a.start_offset.sum()),
             "regime_high_days": int(a.regime_high_days.sum())},
            [float(v) for v in p50])


def plans(model, pools):
    sim, buf = YEARS * cfg.TRADING_DAYS, 5 * cfg.TRADING_DAYS
    cp = coded(pools)
    stitch = functools.partial(bootstrap.sample_bootstrap_returns.__wrapped__,
                               add_noise=False)

    def one(i):
        inn = path_engine.draw_innovations(model, jax.random.key(SEED), i,
                                           jnp.bool_(False), sim, buf)
        k_boot, _ = jax.random.split(inn.mode_key)
        s = stitch(cp, inn.regime_full, k_boot, n_days=sim + buf)
        return s["IRX"], s["TLT_Ret"]

    a, b = jax.jit(jax.vmap(one))(jnp.arange(N_PLAN, dtype=jnp.int32))
    return ([plan_checksum(r) for r in np.asarray(a)],
            [plan_checksum(r) for r in np.asarray(b)])


def path_stats(p, first=0):
    """[trial][asset] log-growth and [trial] VIX sums over DAYS days of a
    [B, S, A] path, from day ``first``."""
    etf = np.asarray(p.etf_ret, np.float64)[:, first:first + DAYS]
    vix = np.asarray(p.vix, np.float64)[:, first:first + DAYS]
    return (np.log1p(etf).sum(1).tolist(), vix.sum(1).tolist())


def paths(model, moment_matching=True, first=0):
    rows = jnp.arange(N_PATH)
    ids, anti = rows // 2, rows % 2 == 1
    sim = YEARS * cfg.TRADING_DAYS
    per_trial = path_engine.generate_paths_batch(
        model, jax.random.key(SEED), ids, anti, sim,
        moment_matching=moment_matching)
    fast = jax.jit(lambda: path_batched.generate_paths_batched(
        model, jax.random.key(SEED), ids, anti,
        sim_days=OFF_YEARS * cfg.TRADING_DAYS,
        moment_matching=moment_matching))()
    return path_stats(per_trial, first), path_stats(fast, first)


def path_diffs(got, ref):
    """(max |log-growth difference|, max VIX-sum relative difference) of
    path_stats ``got`` from ``ref``, as the smoke measures them."""
    return (float(np.abs(np.asarray(got[0]) - np.asarray(ref[0])).max()),
            float(np.abs(np.asarray(got[1]) / np.asarray(ref[1]) - 1).max()))


def median_moves(fw, other):
    """(one_trial, other): the largest relative move over S1-S3 of the
    median of ``fw`` [n, >=3] when one trial next to it changes rank, and
    the relative difference from the median of ``other``."""
    one, far = [], []
    for s in range(3):
        x = np.sort(fw[:, s].astype(np.float64))
        k = len(x) // 2
        med = 0.5 * (x[k - 1] + x[k])
        one.append(max(abs(0.5 * (x[k - 2] + x[k - 1]) - med),
                       abs(0.5 * (x[k] + x[k + 1]) - med)) / med)
        far.append(abs(np.median(other[:, s].astype(np.float64)) / med - 1))
    return max(one), max(far)


def controls(model, pools):
    """The control readings (module docstring), as a dict."""
    ref = paths(model)
    without, later = paths(model, moment_matching=False), paths(model,
                                                                first=1)
    out = {name: {"no_moment_matching": path_diffs(without[i], ref[i]),
                  "one_day_later": path_diffs(later[i], ref[i])}
           for i, name in enumerate(("per_trial", "off"))}
    fw2 = np.asarray(legacy_run(model, pools).final_wealth)
    fw3 = np.asarray(legacy_run(model, pools, seed=3).final_wealth)
    out["p50"] = dict(zip(("one_trial", "seed_3"), median_moves(fw2, fw3)))
    return out


def main():
    model = default_sim_model()
    pools = bootstrap.build_bootstrap_pools(
        pd.read_pickle(CACHE / "historical_data.pkl"))
    if "--controls" in sys.argv:
        print(json.dumps(controls(model, pools)))
        return
    ints, p50 = legacy(model, pools)
    plan_a, plan_b = plans(model, pools)
    per_trial, fast = paths(model)
    with contextlib.redirect_stdout(sys.stderr):
        diag = {name: getattr(diagnose, f"diagnose_{name}")(**kw)
                for name, kw in DIAG_KW.items()}
    print(f"ENGINE_POOL_DIGESTS = {pool_digests(pools)!r}")
    print(f"ENGINE_LEGACY_INT_SUMS = {ints!r}")
    print(f"ENGINE_LEGACY_S123_P50 = {tuple(p50)!r}")
    print(f"ENGINE_PLAN_A = {tuple(plan_a)!r}")
    print(f"ENGINE_PLAN_B = {tuple(plan_b)!r}")
    print(f"ENGINE_PER_TRIAL_LOG_GROWTH = {per_trial[0]!r}")
    print(f"ENGINE_PER_TRIAL_VIX_SUM = {per_trial[1]!r}")
    print(f"ENGINE_OFF_LOG_GROWTH = {fast[0]!r}")
    print(f"ENGINE_OFF_VIX_SUM = {fast[1]!r}")
    print(f"ENGINE_DIAGNOSE = {diag!r}")


if __name__ == "__main__":
    main()
