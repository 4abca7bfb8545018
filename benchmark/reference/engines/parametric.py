"""The plain parametric engine: the per-trial engine's draws and day scans
in the parametric mode, the rolling signals and the channels, in NumPy as
the JAX package states them (``np_parametric.py``, written from its
source, not from the port's), then the 19 strategies over the channels
(NumPy's K4 day loop in float32; the frozen PyTorch one in a lowered
precision), for chosen report rows. Antithetic pairs share every draw of
this mode, so each base trial is computed once."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import np_loops
from benchmark.reference import np_parametric as npp
from benchmark.reference import precision
from benchmark.reference import strategies as k4
from benchmark.reference.engines import common


def summaries(rows, seed: int, horizon_years: float, config: dict,
              glue: torch.dtype = torch.float32, device="cpu",
              numpy_loops: bool = True) -> dict:
    """Per-row summaries as host arrays, as the institutional engine's.
    ``glue``: the path's precision (float64 as the port's CPU glue); the
    strategies run in float32, as K4 does. ``device`` is not used: the
    whole engine runs on the host."""
    dtype = np.float64 if glue == torch.float64 else np.float32
    m = npp._tables(common.model(config), dtype)
    sim, buf = common.days(config, horizon_years)
    ids, _ = common.layout(rows, config["antithetic"])
    uid, inv = np.unique(ids, return_inverse=True)
    with np.errstate(all="ignore"):
        dr = npp.draws(m, npp.key(seed), uid, sim, buf,
                       config["random_start_method"], dtype)
        path = npp.path(m, dr, sim, dtype)
        chans = [c[:, inv] for c in npp.channels(path)]
        if numpy_loops and precision.F == torch.float32:
            fw, nt, mdd = np_loops.strategies_plain(
                chans, apply_costs=config["apply_costs"])
        else:
            fw, nt, mdd = (common.host_one(x) for x in k4.strategies_plain(
                [torch.from_numpy(c).to(precision.F) for c in chans],
                apply_costs=config["apply_costs"]))
    flags = {k: np.asarray(path[k])[inv]
             for k in ("valid", "repaired", "path_finite", "vix_ok")}
    return dict(final_wealth=np.asarray(fw), num_trades=np.asarray(nt),
                max_dd=np.asarray(mdd), **flags)
