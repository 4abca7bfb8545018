#!/usr/bin/env python3
"""How far the JAX package's channel-mode strategies drift from its
ring-signal strategies over a long window, on the same paths.

    JAX_PLATFORMS=cpu python3 -m tools.channel_signal_drift [--trials 1024]
        [--years 30] [--seed 11]

The strategy kernel (``letf_tpu/ops/pallas_strategies.py``) has two ways to
get its 16 rolling signals. In channel mode it reads them from
``compute_signals`` (float32 cumsum differences over the whole window); in
fused-signals mode, and in the slab path's fused compose kernel, it sums
each window exactly in a ring buffer. Both modes run here in interpret mode
on one float32 general path (``generate_paths_batched``, offset starts,
5-year buffer) and are compared with the statistics that ``chip_smoke.py``
applies to the port's general path against its slab path: median relative
final-wealth error, share of cells above 1e-3, share of trade counts that
differ, and the largest relative gap of the p10/p50/p90 fans. Prints one
JSON object. 1,024 trials (the kernel's smallest tile) x 30 years take a
few minutes and a few GiB on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops.pallas_strategies import channels_from, pallas_strategies_run
from letf_tpu.ops.path_batched import generate_paths_batched
from letf_tpu.strategies.signals import compute_signals


def drift_stats(fw, nt, ref_fw, ref_nt):
    """chip_smoke.general_vs_slab_stats without its bounds: ``fw``/``nt``
    the channel mode's, ``ref_*`` the ring-signal run's, [B, 19]."""
    rel = np.abs(ref_fw - fw) / np.maximum(np.abs(fw), 1.0)
    fan = [np.abs(np.percentile(ref_fw, q, axis=0)
                  - np.percentile(fw, q, axis=0))
           / np.maximum(np.abs(np.percentile(fw, q, axis=0)), 1.0)
           for q in (10, 50, 90)]
    return dict(median_rel=float(np.median(rel)),
                frac_rel_gt_1e3=float((rel > 1e-3).mean()),
                trades_mismatch=float((ref_nt != nt).mean()),
                fan_max_rel=float(np.max(fan)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=1024)
    ap.add_argument("--years", type=int, default=30)
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args()
    B, S = args.trials, args.years * 252

    t0 = time.perf_counter()
    path = generate_paths_batched(
        default_sim_model(), jax.random.key(args.seed),
        jnp.arange(B, dtype=jnp.int32) // 2, (jnp.arange(B) % 2).astype(bool),
        sim_days=S, buffer_days=5 * 252, random_start_method="offset")
    chans = channels_from(path, compute_signals(path))
    chans = [jnp.asarray(c, jnp.float32) for c in chans]
    runs = {}
    for fused in (False, True):
        fw, nt, _ = pallas_strategies_run(chans[:7] if fused else chans,
                                          apply_costs=True, interpret=True,
                                          fused_signals=fused)
        runs[fused] = (np.asarray(fw), np.asarray(nt))
    stats = drift_stats(*runs[False], *runs[True])
    per_strategy = (runs[False][1] != runs[True][1]).mean(axis=0)
    print(json.dumps(dict(
        trials=B, days=S, seed=args.seed, dtype=str(chans[0].dtype),
        channel_vs_ring_signals=stats,
        trades_mismatch_by_strategy=[round(float(v), 4)
                                     for v in per_strategy],
        seconds=round(time.perf_counter() - t0, 1))))


if __name__ == "__main__":
    main()
