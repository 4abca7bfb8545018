"""Frozen copy of
``letf_tpu_torch/ops/path_batched.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Path generation: start conditions, regime paths, and the general path.

Ports of ``letf_tpu/ops/path_batched.py``:

- ``start_offsets_only`` (``:395``) and ``start_conditions`` (the start-
  condition part of ``draw_innovations_fast``, ``:410-467``): threefry
  draws, bit-exact with JAX.
- ``plan_max_spells`` (``:236``): host-side spell-count bound.
- ``simulate_regime_paths_spell`` (``:285``): scan-free two-regime spell
  paths. The dwell draws come from the murmur counter expansion; the
  per-day parity of completed spells is an integer scatter of the spell
  ends plus a cumsum (the JAX version's bf16 bucket einsum was a TPU matrix
  unit trick). A path that needs more than ``max_spells`` spells keeps its
  final regime, as in JAX.
- ``windowed_chain``: the chain both chunk formulations share --
  start conditions and regime spells, kernel K1 (joint), moment matching,
  and the random-start window (kernel K2/K2', ``window_series``).
- The XLA-only routes, batch last as the rest of the port:
  ``chi2_from_normal`` (``:86``), ``t_int_df`` (``:112``),
  ``draw_innovations_fast`` (``:410``, the fast samplers: chi-square from
  one normal by its log-quantile Chebyshev fit, integer-df Student-t from
  uniforms and normals, the spell regime paths) and
  ``draw_innovations_batched`` (``:40``, the per-trial engine's draws);
  ``simulate_regime_paths_batched``, ``simulate_joint_and_vix_batched``,
  ``simulate_stress_batched`` and ``simulate_tracking_error_batched``
  (``:120``, ``:613``, ``:772``, ``:814``) are the per-trial engine's
  batched day loops (``ops/path_engine.py``), which already hold their
  state as ``[B]`` components; ``path_from_innovations_batched``
  (``:853``).
- ``generate_paths_batched`` (``:992``): the kernel route
  (``joint_kernel="auto"``, ``:1025-1072``): the chain, then kernel K5
  (compose) and ``_finish_path`` (``:962``). The draws are the counter
  draws of the kernels on every device, keyed by the base trial id, so a
  replayed trial is the trial whose wealth the report sampled; the TPU's
  padding of the batch to a multiple of 1024 is not needed (one thread
  per trial). Without the funding model or the stress channels, K5 gives
  way to the glue composition on the fast samplers' draws, as the
  reference's compose kernel does. ``joint_kernel="off"`` runs the fast
  draws and the torch joint scan; ``fast_draws=False`` the per-trial
  engine's draws and scan.

Glue runs in the dtype of the converted model tables (utils/device.py);
the kernels and the path's per-day series are float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import config as cfg
from benchmark.reference import params as tparams
from benchmark.reference import precision
from benchmark.reference import rng
from benchmark.reference.joint import joint_generate
from benchmark.reference.reductions import day_mean
from benchmark.reference.window import window_offsets
from benchmark.reference.device import index_dtype

class StartConditions(NamedTuple):
    start_offset: torch.Tensor     # [B] int (int64 with f64 glue)
    start_regime: torch.Tensor     # [B] int32
    initial_vix: torch.Tensor      # [B] glue dtype


def _start_keys(run_key, trial_ids):
    tks = rng.trial_key(run_key, trial_ids)
    return tks, rng.split(rng.stream(tks, rng.START), 3)      # [B, 3, 2]


def start_conditions(model, run_key, trial_ids, buffer_days: int = 0,
                     random_start_method: str = "offset", anchors=None,
                     dtype: torch.dtype = torch.float32) -> StartConditions:
    """Random start conditions per trial (draw_innovations_fast's start
    block): offset, start regime and initial VIX."""
    _, ks = _start_keys(run_key, trial_ids)
    k_off, k_reg, k_vix0 = ks[:, 0], ks[:, 1], ks[:, 2]
    B = trial_ids.shape[0]
    dev = trial_ids.device
    idt = index_dtype(dtype)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    idx = None
    if random_start_method == "offset" and buffer_days > 0:
        min_offset = min(50, buffer_days // 4)
        start_offset = rng.randint(k_off, min_offset, buffer_days, idt)
        start_regime = zeros
    elif random_start_method == "regime_only" or (
            random_start_method == "historical_anchor" and anchors is None):
        start_offset = zeros
        probs = model.regime.start_probs.to(dtype)
        uu = rng.uniform(k_reg, 1, dtype)[:, 0]
        cum = torch.cumsum(probs / probs.sum(), 0)
        start_regime = (cum[None, :] < uu[:, None]).sum(1).to(torch.int32)
    elif random_start_method == "historical_anchor":
        anchor_regimes, anchor_vix = (torch.as_tensor(a, device=dev)
                                      for a in anchors)
        idx = rng.randint(k_reg, 0, anchor_regimes.shape[0], idt).long()
        start_offset = zeros
        start_regime = anchor_regimes[idx].to(torch.int32)
    else:
        start_offset = zeros
        start_regime = zeros
    vr = torch.as_tensor([cfg.INITIAL_VIX_RANGE[r]
                          for r in range(cfg.N_REGIMES)],
                         dtype=torch.float64, device=dev).to(dtype)
    lo = vr[start_regime.long(), 0]
    hi = vr[start_regime.long(), 1]
    u0 = rng.uniform(k_vix0, 1, dtype)[:, 0]
    initial_vix = lo + u0 * (hi - lo)
    if idx is not None:
        initial_vix = anchor_vix[idx].to(dtype)
    return StartConditions(start_offset, start_regime, initial_vix)


def plan_max_spells(model, total_days: int, sigmas: float = 8.0) -> int:
    """Static spell-count bound for ``simulate_regime_paths_spell``
    (path_batched.plan_max_spells): the smallest pair count n with
    n*mu_pair - sigmas*sqrt(n*var_pair) >= T, clamped to [64, T/12] and
    rounded up to a multiple of 8. Host-side, from numpy or torch leaves."""

    def host(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                          np.float64)

    reg = model.regime
    default = max(64, total_days // 12)
    means, variances = [], []
    for r in range(2):
        if float(host(reg.has_dwell)[r]) > 0:
            cdf = host(reg.dwell_cdf)[r]
            val = host(reg.dwell_values)[r]
            p = np.clip(np.diff(cdf, prepend=0.0), 0.0, None)
            tot = p.sum()
            if tot <= 0:
                return default
            p /= tot
            m = float((p * val).sum())
            v = float((p * val * val).sum() - m * m)
        else:
            ps = min(max(float(host(reg.p_stay)[r]), 0.0), 1.0 - 1e-9)
            m = 1.0 / (1.0 - ps)
            v = ps / (1.0 - ps) ** 2
        means.append(max(m, 1.0))
        variances.append(max(v, 0.0))
    mu_p = means[0] + means[1]
    var_p = variances[0] + variances[1]
    x = (sigmas * var_p ** 0.5
         + (sigmas * sigmas * var_p + 4.0 * mu_p * total_days) ** 0.5
         ) / (2.0 * mu_p)
    k = 2 * (int(x * x) + 1) + 2
    return min(max(64, -(-k // 8) * 8), default)


def simulate_regime_paths_spell(model, keys, start_regime, total_days: int,
                                max_spells: int | None = None,
                                out_dtype: torch.dtype = torch.int32):
    """Two-regime semi-Markov paths, ``[T, B]`` in ``out_dtype`` (0/1).

    keys: [B, 2] REGIME-stream threefry keys; start_regime: [B] int.
    Spell k has regime start ^ (k % 2) and an inverse-CDF dwell (empirical
    table) or a geometric dwell ceil(log1p(-u) / log p_stay); day t's
    regime is start ^ parity(#spells ending at or before t)."""
    reg = model.regime
    B = keys.shape[0]
    if max_spells is None:
        max_spells = max(64, total_days // 12)
    K = max_spells
    u = rng.counter_uniforms(keys, K)                               # [B, K]
    gdt = reg.dwell_cdf.dtype
    start = start_regime.to(torch.int64)
    parity = torch.arange(K, device=keys.device) % 2
    spell_regime = start[:, None] ^ parity[None, :]
    lg = torch.log1p(-u).to(gdt)
    dwells = []
    for r in range(2):
        cdf = reg.dwell_cdf[r].contiguous()
        D = cdf.shape[0]
        idx = torch.searchsorted(cdf, u.to(gdt)).clamp_max(D - 1)
        emp = reg.dwell_values[r][idx]
        geo = torch.clamp_min(torch.ceil(lg / torch.log(reg.p_stay[r])), 1.0)
        dwells.append(torch.where(reg.has_dwell[r] > 0, emp, geo))
    dwell = torch.where(spell_regime == 0, dwells[0], dwells[1])
    # A counter uniform of exactly 1.0 (float32 rounds 1 - 2**-25 up; one
    # draw in 2**24) gives an infinite geometric dwell: that spell outlasts
    # the horizon, as in the reference, whose spell-end buckets ignore ends
    # past it. Bounding the dwell at T + 1 keeps the int32 spell ends from
    # overflowing into negative scatter indices.
    ends = torch.cumsum(torch.ceil(dwell).clamp_max(total_days + 1)
                        .to(torch.int32), 1, dtype=torch.int32)     # [B, K]
    counts = torch.zeros((total_days + 1, B), dtype=torch.int32,
                         device=keys.device)
    counts.scatter_add_(0, ends.clamp_max(total_days).t().long(),
                        torch.ones((K, B), dtype=torch.int32,
                                   device=keys.device))
    completed = torch.cumsum(counts[:total_days], 0, dtype=torch.int32)
    del counts
    completed.bitwise_and_(1).bitwise_xor_(start.to(torch.int32)[None, :])
    return completed.to(out_dtype)


def window_series(chans, start_offset, sim_days: int, biases=()):
    """The random-start window out[s, b] = x[s + start_offset[b], b]
    (+ bias[b]) of [T, B] channels: the slab chunk's K2 and the general
    path's K2' (``path_batched.window_series`` on ``window_offsets_pallas``)
    are the one kernel ``window_offsets``; no window when T == sim_days
    (every offset is 0 then)."""
    biases = list(biases) + [None] * (len(chans) - len(biases))
    if chans[0].shape[0] == sim_days:
        return [c if b is None else c + b[None, :]
                for c, b in zip(chans, biases)]
    return window_offsets(list(chans), start_offset.to(torch.int32),
                          sim_days, biases=biases)


def windowed_chain(model, run_key, trial_ids, antithetic, sim_days: int,
                   buffer_days: int = 0, random_start_method: str = "offset",
                   anchors=None, moment_matching: bool = True,
                   max_spells: int | None = None):
    """Start conditions, regime spells, K1 (joint), the moment-matching
    bias 0.1 * (theoretical mean - the trial's mean over all T days) and
    the K2 window. ``model``: the port's torch SimModel on the device of
    ``trial_ids``; ``run_key``: a threefry key. Returns (StartConditions,
    int32 ids, seed words, windowed [spy, qqq, tlt, vix, irx, regime]
    [S, B] float32)."""
    T = sim_days + buffer_days
    gdt = model.regime.p_stay.dtype
    sc = start_conditions(model, run_key, trial_ids, buffer_days,
                          random_start_method, anchors, gdt)
    regime = simulate_regime_paths_spell(
        model, rng.stream(rng.trial_key(run_key, trial_ids), rng.REGIME),
        sc.start_regime, T, max_spells=max_spells, out_dtype=precision.F)
    seed_words = [int(v) for v in run_key.tolist()]
    signs = torch.where(antithetic, -1.0, 1.0).to(precision.F)
    ids32 = trial_ids.to(torch.int32)
    x0, x1, x2, vix_full, irx_full = joint_generate(
        tparams.pack_joint_params(model),
        model.joint.chi_cheb.to(precision.F), regime, ids32, signs,
        seed_words)
    biases = []
    if moment_matching:
        theo = model.joint.theo_mean.to(precision.F)
        biases = [(theo[c] - day_mean(xc)) * 0.1
                  for c, xc in enumerate((x0, x1, x2))]
    chans = window_series([x0, x1, x2, vix_full, irx_full, regime],
                          sc.start_offset, sim_days, biases)
    return sc, ids32, seed_words, chans
