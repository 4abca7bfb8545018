#!/usr/bin/env python3
"""Reference numbers of the envelope phase for ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python3 -m tools.long_horizon_reference > out.py

Prints, as Python source, the constants of the smoke's envelope phase
(``ENVELOPE_*``): the JAX package's ``run_monte_carlo`` on
``default_sim_model()`` at the TPU record's long-horizon configuration
(``bench.py:522-560``: 50 years, key 9, trial rows r with base id r // 2
and antithetic when odd, the ``offset`` start with a 1,260-day buffer,
costs on), float32 (JAX's default mode, as the card runs the port),
through the package's production route (``ops/slab_chunk.py``: the joint,
window and compose-strategies Pallas kernels in interpret mode on the
CPU; the package takes that route only on a TPU, so the backend check is
answered "tpu"). The route needs whole tiles of 1,024 trials, so it runs
the record's first 1,024 trials; the constants are those of the first
``N`` = 128: the sums of the start offsets and of the regime-1 days, and
S1's final wealth on each even row (an antithetic pair shares S1's
path).

    JAX_PLATFORMS=cpu python3 -m tools.long_horizon_reference --controls

prints, as one JSON line, the control readings the smoke's S1 bound must
stay below, in the statistic the smoke reads (S1's per-trial relative
difference over the 64 even rows, median and max): the same run without
moment matching (``no_moment_matching``, a fault of one small term) and
without trading costs (``no_costs``).

Each run takes ~10-15 minutes and a few GiB on the CPU.
"""

from __future__ import annotations

import functools
import json
import sys

import jax

jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402

from letf_tpu.models.params import default_sim_model  # noqa: E402
from letf_tpu.ops import pallas_joint, pallas_strategies, pallas_window  # noqa: E402
from letf_tpu.parallel import mc_runner  # noqa: E402
from letf_tpu.parallel.mesh import trial_mesh  # noqa: E402

YEARS, SEED, B, N = 50, 9, 1024, 128


def slab_route():
    """The package's slab chain in interpret mode on the CPU."""
    for mod, name in ((pallas_joint, "pallas_joint_generate"),
                      (pallas_window, "window_offsets_slab"),
                      (pallas_strategies, "pallas_compose_strategies_run")):
        setattr(mod, name, functools.partial(getattr(mod, name),
                                             interpret=True))
    jax.default_backend = lambda: "tpu"


def run(apply_costs=True, moment_matching=True):
    """The record's first B trials; S1 of the first N rows and the
    integer sums over them."""
    if moment_matching:
        a = mc_runner.run_monte_carlo(
            default_sim_model(), YEARS, num_simulations=B, seed=SEED,
            chunk_size=B, mesh=trial_mesh(jax.devices()[:1]),
            use_antithetic=True, random_start_method="offset",
            apply_costs=apply_costs, progress=False)
        s = {k: np.asarray(getattr(a, k)) for k in
             ("final_wealth", "start_offset", "regime_high_days")}
    else:
        import jax.numpy as jnp

        from letf_tpu.ops.path_batched import plan_max_spells

        rows = jnp.arange(B)
        s, _ = mc_runner._mc_chunk(
            jax.tree.map(jnp.asarray, default_sim_model()),
            jax.random.key(SEED), (rows // 2).astype(jnp.int32),
            rows % 2 == 1, YEARS * 252, 1260,
            random_start_method="offset", apply_costs=apply_costs,
            moment_matching=False,
            max_spells=plan_max_spells(default_sim_model(), YEARS * 252
                                       + 1260))
        s = {k: np.asarray(v) for k, v in s.items()}
    fw = s["final_wealth"][:N]
    assert fw.dtype == np.float32, fw.dtype
    return (fw[0::2, 0].astype(np.float64),
            {"start_offset": int(s["start_offset"][:N].sum()),
             "regime_high_days": int(s["regime_high_days"][:N].sum())})


def rel(a, b):
    r = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
    return [float(np.median(r)), float(r.max())]


def main():
    slab_route()
    s1, ints = run()
    if "--controls" in sys.argv:
        print(json.dumps({
            "no_moment_matching": rel(run(moment_matching=False)[0], s1),
            "no_costs": rel(run(apply_costs=False)[0], s1)}))
        return
    print(f"ENVELOPE_INT_SUMS = {ints!r}")
    print("ENVELOPE_S1_WEALTH = (")
    vals = [repr(float(np.float32(v))) for v in s1]
    for i in range(0, len(vals), 4):
        print("    " + ", ".join(vals[i:i + 4]) + ",")
    print(")")


if __name__ == "__main__":
    main()
