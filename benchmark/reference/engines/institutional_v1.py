"""The plain institutional engine: the production chunk of the
institutional_v1 mode (start conditions and regime spells, the joint
generation, the moment-matching bias, the random-start window, the
composition with the 16 signals and the 19 strategies) for chosen report
rows, each day a step over [B] arrays. A run computes the start offsets
and spells in NumPy as the JAX package states them (``np_spells.py``) and
the kernels' plain day loops in NumPy float32 (``np_loops.py``); the
control runs the frozen PyTorch chain in a lowered precision."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import compose_strategies as k3
from benchmark.reference import np_loops
from benchmark.reference import np_parametric as npp
from benchmark.reference import np_spells
from benchmark.reference import params as tparams
from benchmark.reference import path_batched as pb
from benchmark.reference import precision
from benchmark.reference import rng
from benchmark.reference.engines import common
from benchmark.reference.reductions import day_mean
from benchmark.reference.window import window_plain


def _chain_np(m, mt, seed, ids, anti, sim, buf, config, max_spells):
    """``path_batched.windowed_chain`` with the start offsets and regime
    spells in NumPy as the JAX package states them (``np_spells.py``) and
    K1's day loop in NumPy: the start conditions, the regime spells, K1,
    the moment-matching bias and the window; returns (int32 ids, seed
    words, [S, B] float32 channels)."""
    T = sim + buf
    dtype = np.float64 if mt.regime.p_stay.dtype == torch.float64 \
        else np.float32
    reg = npp._tables(m, dtype).regime
    key = npp.key(seed)
    ids_np = ids.numpy()
    offset = torch.from_numpy(np_spells.start_offsets(
        key, ids_np, buf, config["random_start_method"], dtype))
    regime = torch.from_numpy(np_spells.regime_paths(
        reg, key, ids_np, T, max_spells).T.astype(np.float32).copy())
    seed_words = [int(v) for v in key]
    signs = torch.where(anti, -1.0, 1.0).to(torch.float32)
    ids32 = ids.to(torch.int32)
    xs = [torch.from_numpy(x) for x in np_loops.joint_plain(
        tparams.pack_joint_params(mt).numpy(),
        mt.joint.chi_cheb.to(torch.float32).numpy(), regime.numpy(),
        ids32.numpy(), signs.numpy(), seed_words)]
    biases = []
    if config["moment_matching"]:
        theo = mt.joint.theo_mean.to(torch.float32)
        biases = [(theo[c] - day_mean(xs[c])) * 0.1 for c in range(3)]
    chans = window_plain(xs + [regime], offset, sim, biases + [None] * 3)
    return ids32, seed_words, [c.numpy() for c in chans]


def summaries(rows, seed: int, horizon_years: float, config: dict,
              glue: torch.dtype = torch.float32, device="cpu",
              numpy_loops: bool = True) -> dict:
    """Per-row summaries as host arrays: final_wealth, num_trades, max_dd
    [n, 19]; valid, repaired, path_finite, vix_ok [n].
    ``numpy_loops=False`` runs the frozen PyTorch day loops in float32
    too."""
    m = common.model(config)
    sim, buf = common.days(config, horizon_years)
    ids, anti = common.tensors(*common.layout(rows, config["antithetic"]),
                               device)
    mt = tparams.from_numpy(m, torch.device(device), glue)
    key = rng.key(seed, device)
    spells = np_spells.plan_max_spells(m.regime, sim + buf)
    with torch.inference_mode(), np.errstate(all="ignore"):
        sp = tparams.pack_stress_params(mt)
        ap = tparams.pack_asset_params(mt)
        if numpy_loops and precision.F == torch.float32:
            ids32, seed_words, chans = _chain_np(m, mt, seed, ids, anti,
                                                 sim, buf, config, spells)
            out = np_loops.compose_strategies_plain(
                sp.numpy(), ap.numpy(), ids32.numpy(), seed_words, *chans,
                apply_costs=config["apply_costs"])
        else:
            _, ids32, seed_words, chans = pb.windowed_chain(
                mt, key, ids, anti, sim, buf, config["random_start_method"],
                None, config["moment_matching"], spells)
            out = k3.compose_strategies_plain(
                sp, ap, ids32, seed_words, *chans,
                apply_costs=config["apply_costs"])
        (fw, nt, mdd, path_finite, _jc, _ls, _cs, vix_min, vix_max,
         _rh) = (np.asarray(common.host_one(x)) for x in out)
    vix_ok = (vix_min >= 5.0) & (vix_max <= 120.0)
    return dict(final_wealth=fw, num_trades=nt, max_dd=mdd, valid=vix_ok,
                repaired=~(path_finite & vix_ok), path_finite=path_finite,
                vix_ok=vix_ok)
