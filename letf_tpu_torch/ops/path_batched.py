"""Path generation: start conditions, regime paths, and the general path.

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

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.compose import compose_generate
from letf_tpu_torch.ops.joint import joint_generate
from letf_tpu_torch.ops.window import window_offsets
from letf_tpu_torch.utils.device import index_dtype


class StartConditions(NamedTuple):
    start_offset: torch.Tensor     # [B] int (int64 with f64 glue)
    start_regime: torch.Tensor     # [B] int32
    initial_vix: torch.Tensor      # [B] glue dtype


def _start_keys(run_key, trial_ids):
    tks = rng.trial_key(run_key, trial_ids)
    return tks, rng.split(rng.stream(tks, rng.START), 3)      # [B, 3, 2]


def start_offsets_only(run_key, trial_ids, buffer_days: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 'offset' random-start draw alone, bitwise the ``start_offset``
    of ``start_conditions`` for the same inputs."""
    _, ks = _start_keys(run_key, trial_ids)
    min_offset = min(50, buffer_days // 4)
    return rng.randint(ks[:, 0], min_offset, buffer_days,
                       index_dtype(dtype))


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


def day_mean(x):
    """The mean over days (dim 0) of ``x`` [T, B], summed pairwise in an
    order that depends on T alone: halving steps of elementwise adds (an
    odd row carried to the next step). torch's own reductions pick their
    order by the whole shape, so a trial's mean would depend on how many
    trials share its batch; this one is the same bits in any chunk or
    shard, on the CPU and on the card."""
    s = x
    n = x.shape[0]
    while s.shape[0] > 1:
        m = s.shape[0]
        h = s[0:m - 1:2] + s[1:m:2]
        s = torch.cat([h, s[m - 1:]]) if m % 2 else h
    return s[0] / n


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
        sc.start_regime, T, max_spells=max_spells, out_dtype=torch.float32)
    seed_words = [int(v) for v in run_key.tolist()]
    signs = torch.where(antithetic, -1.0, 1.0).to(torch.float32)
    ids32 = trial_ids.to(torch.int32)
    x0, x1, x2, vix_full, irx_full = joint_generate(
        tparams.pack_joint_params(model),
        model.joint.chi_cheb.to(torch.float32), regime, ids32, signs,
        seed_words)
    biases = []
    if moment_matching:
        theo = model.joint.theo_mean.to(torch.float32)
        biases = [(theo[c] - day_mean(xc)) * 0.1
                  for c, xc in enumerate((x0, x1, x2))]
    chans = window_series([x0, x1, x2, vix_full, irx_full, regime],
                          sc.start_offset, sim_days, biases)
    return sc, ids32, seed_words, chans


class PathOutputs(NamedTuple):
    """The general path's outputs (path_engine.PathOutputs), ``[S, B]``
    per-day series and ``[B]`` per-trial fields."""
    etf_ret: torch.Tensor       # [A, S, B] repaired net ETF returns
    tlt_ret: torch.Tensor
    spy_ret: torch.Tensor       # jump-adjusted
    qqq_ret: torch.Tensor
    vix: torch.Tensor
    regime: torch.Tensor        # int32
    cash_ret: torch.Tensor
    risk_free: torch.Tensor
    start_offset: torch.Tensor
    start_regime: torch.Tensor
    initial_vix: torch.Tensor
    jump_days: torch.Tensor     # int32
    liq_mean: torch.Tensor
    credit_mean: torch.Tensor
    valid: torch.Tensor         # bool
    repaired: torch.Tensor
    path_finite: torch.Tensor
    vix_ok: torch.Tensor


def finish_path(etf_ret, tlt, spy, qqq, vix, regime, cash_ret, risk_free,
                sc: StartConditions, jump_days, liq_mean,
                cred_mean) -> PathOutputs:
    """Validity checks, the repair pass (bound and zero non-finite
    returns; VIX is not repaired) and PathOutputs assembly (_finish_path)."""
    finite_pre = (torch.isfinite(etf_ret).all(dim=0).all(dim=0)
                  & torch.isfinite(tlt).all(dim=0)
                  & torch.isfinite(vix).all(dim=0))
    vix_ok = (torch.isfinite(vix).all(dim=0)
              & (vix.amin(dim=0) >= 5.0) & (vix.amax(dim=0) <= 120.0))
    etf_ret = torch.clamp(torch.where(torch.isfinite(etf_ret), etf_ret, 0.0),
                          -0.999, 10.0)
    tlt = torch.clamp(torch.where(torch.isfinite(tlt), tlt, 0.0), -0.999,
                      10.0)
    return PathOutputs(
        etf_ret=etf_ret, tlt_ret=tlt, spy_ret=spy, qqq_ret=qqq, vix=vix,
        regime=regime, cash_ret=cash_ret, risk_free=risk_free,
        start_offset=sc.start_offset, start_regime=sc.start_regime,
        initial_vix=sc.initial_vix, jump_days=jump_days, liq_mean=liq_mean,
        credit_mean=cred_mean, valid=vix_ok, repaired=~(finite_pre & vix_ok),
        path_finite=finite_pre, vix_ok=vix_ok)


def _clenshaw(t, c):
    """Chebyshev series sum c[k] T_k(t) by Clenshaw's recurrence."""
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * t * b1 - b2, b1
    return c[0] + t * b1 - b2


def chi2_from_normal(z, cheb_coeffs):
    """Chi-square(nu) draw from one standard normal: exp(cheb(z / zmax)),
    the Chebyshev fit of log chi2_ppf(Phi(z), nu)
    (params.chi2_log_quantile_cheb)."""
    t = torch.clamp(z / tparams.CHI_CHEB_ZMAX, -1.0, 1.0)
    return torch.exp(_clenshaw(t, cheb_coeffs.to(z.dtype)))


def _chisq_int(keys, df: int, n: int, dtype):
    """Exact chi-square with integer df per key [B, 2]: -2 log of the
    product of df // 2 uniforms on [1e-12, 1), plus a squared normal for
    odd df. Returns [B, n]."""
    k_u, k_n = rng.split(keys, 2).unbind(1)
    out = torch.zeros((keys.shape[0], n), dtype=dtype, device=keys.device)
    k_even = df // 2
    if k_even > 0:
        u = rng.uniform(k_u, k_even * n, dtype, minval=1e-12)
        out = -2.0 * torch.log(u).reshape(-1, k_even, n).sum(1)
    if df % 2 == 1:
        z = rng.normal(k_n, n, dtype)
        out = out + z * z
    return out


def t_int_df(keys, df: int, n: int, dtype=torch.float32):
    """Student-t with integer df per key [B, 2]: z / sqrt(chisq_df / df),
    ``[B, n]`` (path_batched.t_int_df)."""
    k_z, k_c = rng.split(keys, 2).unbind(1)
    z = rng.normal(k_z, n, dtype)
    c = _chisq_int(k_c, df, n, dtype)
    return z * torch.sqrt(df / torch.clamp_min(c, 1e-12))


def draw_innovations_fast(model, run_key, trial_ids, antithetic,
                          sim_days: int, buffer_days: int = 0,
                          random_start_method: str = "offset",
                          anchors=None, joint_draws: bool = True,
                          aux_draws: bool = True,
                          max_spells: int | None = None):
    """The fast route's draws (path_batched.draw_innovations_fast), the
    port's batch-last ``Innovations``: the start conditions, the spell
    regime paths, and the same streams as the per-trial engine through
    cheaper samplers: chi-square from one normal a day
    (``chi2_from_normal`` of the regime's coefficients), integer-df
    Student-t for the jump sizes and the tracking error (``t_int_df``).
    ``joint_draws=False`` leaves the joint fields None (K1 draws them) and
    ``aux_draws=False`` the stress and tracking-error fields (K5 does)."""
    from letf_tpu_torch.ops.path_engine import Innovations

    dt = model.regime.p_stay.dtype
    T = sim_days + buffer_days
    B = trial_ids.shape[0]
    tk = rng.trial_key(run_key, trial_ids)
    sc = start_conditions(model, run_key, trial_ids, buffer_days,
                          random_start_method, anchors, dt)
    regime_full = simulate_regime_paths_spell(
        model, rng.stream(tk, rng.REGIME), sc.start_regime, T,
        max_spells=max_spells)
    eps = u_chi = vix_noise = irx_noise = None
    if joint_draws:
        sign = torch.where(antithetic, -1.0, 1.0).to(dt)
        eps = (sign[:, None] * rng.normal(rng.stream(tk, rng.JOINT_EPS),
                                          3 * T, dt)).reshape(
            B, T, 3).permute(2, 1, 0).contiguous()
        z_chi = rng.normal(rng.stream(tk, rng.JOINT_CHI), T, dt).t()
        chi = torch.stack([chi2_from_normal(z_chi, c)
                           for c in model.joint.chi_cheb])
        u_chi = chi.gather(0, regime_full.long()[None])[0]
        vix_noise = rng.normal(rng.stream(tk, rng.VIX_NOISE), T,
                               dt).t().contiguous()
        irx_noise = rng.normal(rng.stream(tk, rng.IRX_NOISE), T,
                               dt).t().contiguous()
    stress_norms = u_jump = t_abs = jump_sign = te_draws = None
    if aux_draws:
        stress_norms = rng.normal(
            rng.stream(tk, rng.STRESS_NORM), 2 * sim_days, dt).reshape(
            B, sim_days, 2).permute(2, 1, 0).contiguous()
        kj = rng.split(rng.stream(tk, rng.STRESS_JUMP), 3)
        u_jump = rng.uniform(kj[:, 0], sim_days, dt).t().contiguous()
        t_abs = torch.abs(t_int_df(kj[:, 1], 5, sim_days,
                                   dt)).t().contiguous()
        jump_sign = torch.where(rng.uniform(kj[:, 2], sim_days, dt) < 0.5,
                                -1.0, 1.0).to(dt).t().contiguous()
        k_te = rng.stream(tk, rng.TRACKING)
        static_dfs = cfg.asset_table().te_df
        te = [None] * cfg.N_ASSETS
        for df in sorted(set(int(v) for v in static_dfs)):
            cols = [a for a in range(cfg.N_ASSETS) if static_dfs[a] == df]
            d = t_int_df(rng.fold_in(k_te, df), df, sim_days * len(cols),
                         dt).reshape(B, sim_days, len(cols))
            for j, a in enumerate(cols):
                te[a] = d[:, :, j].t()
        te_draws = torch.stack(te).contiguous()
    return Innovations(
        start_offset=sc.start_offset, start_regime=sc.start_regime,
        initial_vix=sc.initial_vix, regime_full=regime_full, eps=eps,
        u_chi=u_chi, vix_noise=vix_noise, irx_noise=irx_noise,
        stress_norms=stress_norms, u_jump=u_jump, t_abs=t_abs,
        jump_sign=jump_sign, te_draws=te_draws,
        mode_key=rng.stream(tk, rng.BOOTSTRAP))


def draw_innovations_batched(model, run_key, trial_ids, antithetic,
                             sim_days: int, buffer_days: int = 0,
                             random_start_method: str = "offset",
                             anchors=None):
    """The per-trial engine's draws of the batch (the JAX version's vmap of
    path_engine.draw_innovations)."""
    from letf_tpu_torch.ops import path_engine

    return path_engine.draw_innovations(
        model, run_key, trial_ids, antithetic, sim_days, buffer_days,
        random_start_method, anchors, engine_mode="institutional_v1")


def simulate_regime_paths_batched(model, keys, start_regime,
                                  total_days: int):
    """[T, B] regime paths of the dwell scan: the candidates of every day
    precomputed, the loop only selects (path_engine.simulate_regime_path,
    which the batched formulation is)."""
    from letf_tpu_torch.ops import path_engine

    return path_engine.simulate_regime_path(model, keys, start_regime,
                                            total_days)


def simulate_joint_and_vix_batched(model, regime, eps, u_chi, vix_noise,
                                   moment_matching: bool = True):
    """path_engine.simulate_joint_and_vix: its state is already ``[B]``
    components (regime [T, B], eps [3, T, B])."""
    from letf_tpu_torch.ops import path_engine

    return path_engine.simulate_joint_and_vix(model, regime, eps, u_chi,
                                              vix_noise, moment_matching)


def simulate_stress_batched(model, regime, vix, norms, u_jump, t_abs):
    """path_engine.simulate_stress ([S, B] day loop)."""
    from letf_tpu_torch.ops import path_engine

    return path_engine.simulate_stress(model, regime, vix, norms, u_jump,
                                       t_abs)


def simulate_tracking_error_batched(model, regime, vix, underlying,
                                    t_draws):
    """path_engine.simulate_tracking_error ([A, S, B] day loop)."""
    from letf_tpu_torch.ops import path_engine

    return path_engine.simulate_tracking_error(model, regime, vix,
                                               underlying, t_draws)


def path_from_innovations_batched(model, innov, sim_days: int,
                                  moment_matching: bool = True,
                                  use_funding_model: bool = True,
                                  use_stress: bool = True) -> PathOutputs:
    """The institutional path of batch-last innovations
    (path_batched.path_from_innovations_batched): ``path_engine``'s stages,
    the joint scan (``mode_returns``), the IRX, the random-start window
    (``window_series``, the K2' kernel on the card) and ``compose_path``.
    The reference's ``counter_ctx`` (its TPU compose kernel) is
    ``generate_paths_batched``'s kernel route here."""
    from letf_tpu_torch.ops import path_engine

    regime_full = innov.regime_full
    spy, qqq, tlt, vix_full = path_engine.mode_returns(
        model, innov, "institutional_v1", moment_matching=moment_matching)
    irx_full = torch.clamp(model.irx_base[regime_full.long()]
                           + 0.5 * innov.irx_noise, 0.0, 15.0)
    chans = window_series([spy, qqq, tlt, vix_full, irx_full,
                           regime_full.to(spy.dtype)], innov.start_offset,
                          sim_days)
    return path_engine.compose_path(model, innov, *chans[:5],
                                    chans[5].to(torch.int32),
                                    use_funding_model, use_stress)


def generate_paths_batched(model, run_key, trial_ids, antithetic,
                           sim_days: int, buffer_days: int = 0,
                           random_start_method: str = "offset",
                           moment_matching: bool = True,
                           use_funding_model: bool = True,
                           use_stress: bool = True,
                           fast_draws: bool = True, anchors=None,
                           joint_kernel: str = "auto",
                           max_spells: int | None = None) -> PathOutputs:
    """The general [S, B] path (institutional_v1). ``joint_kernel="auto"``:
    ``windowed_chain`` (K1, K2'), then kernel K5 (stress, funding, leverage
    and tracking error for all six assets) and ``finish_path``; without
    the funding model or the stress channels, the glue composition on the
    fast samplers' stress and tracking-error draws. ``"off"``: the fast
    draws and the torch joint scan. ``fast_draws=False``: the per-trial
    engine's draws and scan, equal to ``path_engine.generate_paths_batch``
    of the institutional mode."""
    if joint_kernel not in ("auto", "off"):
        raise ValueError(f"joint_kernel must be 'auto' or 'off', got "
                         f"{joint_kernel!r}")
    if not fast_draws:
        innov = draw_innovations_batched(model, run_key, trial_ids,
                                         antithetic, sim_days, buffer_days,
                                         random_start_method, anchors)
        return path_from_innovations_batched(model, innov, sim_days,
                                             moment_matching,
                                             use_funding_model, use_stress)
    if joint_kernel == "off":
        innov = draw_innovations_fast(model, run_key, trial_ids, antithetic,
                                      sim_days, buffer_days,
                                      random_start_method, anchors,
                                      max_spells=max_spells)
        return path_from_innovations_batched(model, innov, sim_days,
                                             moment_matching,
                                             use_funding_model, use_stress)
    sc, ids32, seed_words, chans = windowed_chain(
        model, run_key, trial_ids, antithetic, sim_days, buffer_days,
        random_start_method, anchors, moment_matching, max_spells)
    _, _, tlt, vix, irx, regime = chans
    if not (use_stress and use_funding_model):
        from letf_tpu_torch.ops import path_engine

        innov = draw_innovations_fast(model, run_key, trial_ids, antithetic,
                                      sim_days, buffer_days,
                                      random_start_method, anchors,
                                      joint_draws=False,
                                      max_spells=max_spells)
        return path_engine.compose_path(model, innov, *chans[:5],
                                        regime.to(torch.int32),
                                        use_funding_model, use_stress)
    etf, spy_a, qqq_a, cash, jc, ls, cs = compose_generate(
        tparams.pack_stress_params(model), tparams.pack_asset_params(model),
        ids32, seed_words, *chans)
    risk_free = torch.clamp(irx, 0.0, 20.0) / 100.0
    return finish_path(etf, tlt, spy_a, qqq_a, vix, regime.to(torch.int32),
                       cash, risk_free, sc, jc.to(torch.int32),
                       ls / sim_days, cs / sim_days)
