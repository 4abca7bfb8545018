"""The per-trial path engine in the parametric mode, batched.

Port of ``letf_tpu/ops/path_engine.py`` (the JAX version vmaps one trial's
scans over the batch; here the batch is the last axis, ``[T, B]``):

- ``draw_innovations``: every random input a trial consumes, from its
  threefry streams (``ops/rng.py``, the ``jax.random`` samplers). Only the
  streams the requested mode consumes are drawn; streams are keyed by
  ``fold_in`` of the stream id, so skipping the joint model's normals and
  chi-square draws (parametric mode) changes no other draw.
- ``simulate_regime_path``: the semi-Markov dwell scan (``:116-134``), one
  day step over the batch.
- ``generate_returns_parametric`` (``:474-491``),
  ``simulate_vix_given_returns`` (``:449-471``), ``simulate_stress``,
  ``borrow_spread_series``, ``compose_letf_returns`` and
  ``simulate_tracking_error`` (``:214-316``), and ``path_from_innovations``
  (``:518-622``), which takes an ``Innovations`` so tests can feed both
  packages the same draws.
- ``generate_paths_batch``: draws + path.

None of these is a TPU kernel in the JAX package (they are XLA scans); here
they are torch day loops whose per-day work is only the true recurrence,
everything else computed for all days at once. The per-trial institutional
mode (``simulate_joint_and_vix`` with chi-square mixing) and the block
bootstrap raise, naming their ROADMAP items; the production institutional
path is ``ops/path_batched.py``.

Glue runs in the dtype of the converted model tables (float64 on the CPU,
float32 on the card), as the JAX version runs in the ambient precision.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_batched import (
    PathOutputs,
    StartConditions,
    finish_path,
    start_conditions,
)

_A = cfg.N_ASSETS
# Cholesky factors of the parametric mode's regime correlations
# (path_engine.py:479-482).
CHOL_LOW = np.linalg.cholesky(np.array(
    [[1.0, 0.85, -0.15], [0.85, 1.0, -0.10], [-0.15, -0.10, 1.0]]))
CHOL_HIGH = np.linalg.cholesky(np.array(
    [[1.0, 0.92, -0.45], [0.92, 1.0, -0.30], [-0.45, -0.30, 1.0]]))


def _unported(engine_mode: str, pools) -> Optional[str]:
    if engine_mode == "institutional_v1":
        return ("the per-trial institutional mode (simulate_joint_and_vix "
                "with chi-square mixing) is not ported; the production "
                "institutional path is ops/path_batched.py (ROADMAP "
                "section 1, item 11)")
    if engine_mode == "legacy_hybrid" and pools is not None:
        return ("legacy_hybrid with bootstrap pools is the block bootstrap, "
                "ROADMAP section 1 item 15, not ported yet")
    if engine_mode not in ("parametric", "legacy_hybrid"):
        return f"unknown engine_mode {engine_mode!r}"
    return None


class Innovations(NamedTuple):
    """Every draw of a batch, batch last. ``eps``/``u_chi`` (the joint
    model's) stay None in the parametric mode."""
    start_offset: torch.Tensor    # [B]
    start_regime: torch.Tensor    # [B] int32
    initial_vix: torch.Tensor     # [B]
    regime_full: torch.Tensor     # [T, B] int32
    eps: Optional[torch.Tensor]   # [3, T, B]
    u_chi: Optional[torch.Tensor]  # [T, B]
    vix_noise: torch.Tensor       # [T, B]
    irx_noise: torch.Tensor       # [T, B]
    stress_norms: torch.Tensor    # [2, S, B]
    u_jump: torch.Tensor          # [S, B]
    t_abs: torch.Tensor           # [S, B]
    jump_sign: torch.Tensor       # [S, B]
    te_draws: torch.Tensor        # [A, S, B]
    mode_key: torch.Tensor        # [B, 2] threefry key


# ---------------------------------------------------------------------------
# Regime path
# ---------------------------------------------------------------------------

def _draw_dwell(model, r: int, u):
    """Dwell of regime r for uniforms u: the empirical table's inverse CDF
    (count of cdf < u) or the geometric ceil(log1p(-u) / log p_stay)."""
    reg = model.regime
    cdf = reg.dwell_cdf[r].contiguous()
    idx = torch.searchsorted(cdf, u.contiguous()).clamp_max(cdf.shape[0] - 1)
    emp = reg.dwell_values[r][idx]
    geo = torch.clamp_min(torch.ceil(torch.log1p(-u)
                                     / torch.log(reg.p_stay[r])), 1.0)
    return torch.where(reg.has_dwell[r] > 0, emp, geo)


def _draw_next_regime(model, r: int, u):
    """Next regime from row r's off-diagonal transition mass."""
    row = model.regime.transition[r]
    R = row.shape[0]
    row = row * (torch.arange(R, device=row.device) != r)
    rs = row.sum()
    probs = torch.where(rs > 0, row / torch.clamp_min(rs, 1e-30), 0.0)
    cum = torch.cumsum(probs, 0).contiguous()
    nxt = torch.searchsorted(cum, u.contiguous()).clamp_max(R - 1)
    return torch.where(rs > 0, nxt, r)


def simulate_regime_path(model, keys, start_regime, total_days: int):
    """[T, B] int32 regime paths (path_engine.simulate_regime_path): the
    uniforms u [T+1, 2] of each REGIME-stream key, the first dwell from
    u[0, 0], then one day step: the dwell counts down, and when it runs out
    the next regime (from u[t, 1]) and its dwell (from u[t, 0]) take
    over. The candidate regime and dwell are drawn for every regime and
    day at once; the loop only selects."""
    dt = model.regime.p_stay.dtype
    B = keys.shape[0]
    u = rng.uniform(keys, 2 * (total_days + 1), dt).reshape(
        B, total_days + 1, 2).permute(1, 2, 0)               # [T+1, 2, B]
    R = model.regime.transition.shape[0]
    start = start_regime.to(torch.int64)
    dw_first = torch.stack([_draw_dwell(model, r, u[0, 0][None])[0]
                            for r in range(R)])              # [R, B]
    rem = dw_first.gather(0, start[None])[0]
    us = u[1:]
    nxt_r = torch.stack([_draw_next_regime(model, r, us[:, 1])
                         for r in range(R)])                  # [R, T, B]
    dwl_r = torch.stack([_draw_dwell(model, r, us[:, 0])
                         for r in range(R)])                  # [R, T, B]
    cur = start
    path = torch.empty((total_days, B), dtype=torch.int32, device=keys.device)
    for t in range(total_days):
        path[t] = cur
        rem = rem - 1.0
        need = rem <= 0.0
        nxt = nxt_r[:, t].gather(0, cur[None])[0]
        ndw = dwl_r[:, t].gather(0, nxt[None])[0]
        cur = torch.where(need, nxt, cur)
        rem = torch.where(need, ndw, rem)
    return path


# ---------------------------------------------------------------------------
# Innovations
# ---------------------------------------------------------------------------

def _te_draws(k_te, sim_days: int, dt):
    """Tracking-error t draws [A, S, B]: one sampler per distinct static
    df, keyed fold_in(k_te, df), its columns the assets of that df."""
    static_dfs = cfg.asset_table().te_df
    B = k_te.shape[0]
    out = [None] * _A
    for df in sorted(set(static_dfs.tolist())):
        cols = [a for a in range(_A) if static_dfs[a] == df]
        d = rng.t(rng.fold_in(k_te, int(df)), float(df),
                  sim_days * len(cols), dt).reshape(B, sim_days, len(cols))
        for j, a in enumerate(cols):
            out[a] = d[:, :, j].t()
    return torch.stack(out)


def draw_innovations(model, run_key, trial_ids, antithetic, sim_days: int,
                     buffer_days: int = 0,
                     random_start_method: str = "offset", anchors=None,
                     engine_mode: str = "parametric",
                     bootstrap_pools=None) -> Innovations:
    """The draws of trials ``trial_ids`` [B] (path_engine.draw_innovations)
    for ``engine_mode``. ``model``: the port's torch SimModel on the
    trials' device."""
    why = _unported(engine_mode, bootstrap_pools)
    if why:
        raise NotImplementedError(why)
    dt = model.regime.p_stay.dtype
    T = sim_days + buffer_days
    tk = rng.trial_key(run_key, trial_ids)
    sc = start_conditions(model, run_key, trial_ids, buffer_days,
                          random_start_method, anchors, dt)
    regime_full = simulate_regime_path(model, rng.stream(tk, rng.REGIME),
                                       sc.start_regime, T)
    B = trial_ids.shape[0]
    vix_noise = rng.normal(rng.stream(tk, rng.VIX_NOISE), T, dt).t()
    irx_noise = rng.normal(rng.stream(tk, rng.IRX_NOISE), T, dt).t()
    stress_norms = rng.normal(rng.stream(tk, rng.STRESS_NORM), 2 * sim_days,
                              dt).reshape(B, sim_days, 2).permute(2, 1, 0)
    kj = rng.split(rng.stream(tk, rng.STRESS_JUMP), 3)
    u_jump = rng.uniform(kj[:, 0], sim_days, dt).t()
    t_abs = torch.abs(rng.t(kj[:, 1], 5.0, sim_days, dt)).t()
    jump_sign = torch.where(rng.uniform(kj[:, 2], sim_days, dt) < 0.5,
                            -1.0, 1.0).to(dt).t()
    te_draws = _te_draws(rng.stream(tk, rng.TRACKING), sim_days, dt)
    return Innovations(
        start_offset=sc.start_offset, start_regime=sc.start_regime,
        initial_vix=sc.initial_vix, regime_full=regime_full, eps=None,
        u_chi=None, vix_noise=vix_noise.contiguous(),
        irx_noise=irx_noise.contiguous(),
        stress_norms=stress_norms.contiguous(), u_jump=u_jump.contiguous(),
        t_abs=t_abs.contiguous(), jump_sign=jump_sign.contiguous(),
        te_draws=te_draws.contiguous(),
        mode_key=rng.stream(tk, rng.BOOTSTRAP))


# ---------------------------------------------------------------------------
# Returns and VIX
# ---------------------------------------------------------------------------

def generate_returns_parametric(model, regime_path, key):
    """Regime-conditional correlated Student-t(STUDENT_T_DF) draws [T, 3]
    per trial (t of the mode key), the regime's Cholesky factor applied,
    SPY = mean + std * x0, QQQ and TLT as SPY loadings plus noise. Returns
    (spy, qqq, tlt) [T, B]."""
    dt = model.regime.p_stay.dtype
    T, B = regime_path.shape
    z = rng.t(key, float(cfg.STUDENT_T_DF), 3 * T, dt).reshape(B, T, 3)
    z = z.permute(2, 1, 0)                                     # [3, T, B]
    high = regime_path != 0
    lo_c, hi_c = (torch.as_tensor(c, device=z.device).to(dt)
                  for c in (CHOL_LOW, CHOL_HIGH))
    x = []
    for i in range(3):
        acc = None
        for j in range(3):
            term = torch.where(high, hi_c[i, j], lo_c[i, j]) * z[j]
            acc = term if acc is None else acc + term
        x.append(acc)
    reg = regime_path.long()
    std = model.regime.daily_std[reg]
    mu = model.regime.daily_mean[reg]
    spy = mu + std * x[0]
    qqq = 1.15 * spy + 0.006 * x[1]
    tlt = -0.12 * spy + 0.004 * x[2]
    return spy, qqq, tlt


def simulate_vix_given_returns(model, regime_path, spy_returns, vix_noise):
    """VIX AR(1) + downside jump recursion [T, B] (engine.py:99-115): day 0
    is the regime's base level, then max(10, phi*v + (1-phi)*target + jump
    + noise). The jump and noise terms are formed for all days at once."""
    V, reg = model.vix, model.regime
    r = regime_path.long()
    denom = torch.clamp_min(reg.daily_std[r], 1e-4)
    shock = torch.clamp_min(-spy_returns, 0.0) / denom
    vjump = V.jump_scale[r] * torch.clamp_min(shock - V.jump_threshold[r],
                                              0.0)
    phi = V.phi[r]
    mean_term = (1 - phi) * V.target[r]
    noise = V.noise_std[r] * vix_noise
    out = torch.empty_like(spy_returns)
    v = V.base[r[0]]
    out[0] = v
    for t in range(1, spy_returns.shape[0]):
        v = torch.clamp_min(phi[t] * v + mean_term[t] + vjump[t] + noise[t],
                            10.0)
        out[t] = v
    return out


# ---------------------------------------------------------------------------
# Stress, funding, composition, tracking error
# ---------------------------------------------------------------------------

def simulate_stress(model, regime_path, vix, norms, u_jump, t_abs):
    """Liquidity and credit AR(1) stress (clipped to [0, 3], day 0 at the
    regime means) and Bernoulli-t crisis jumps (none on day 0). Returns
    (liq, cred, jump) [S, B]."""
    S = model.stress
    r = regime_path.long()
    lmu, cmu = S.liq_mu[r], S.credit_mu[r]
    lphi, cphi = S.liq_phi[r], S.credit_phi[r]
    lsn, csn = S.liq_sigma[r] * norms[0], S.credit_sigma[r] * norms[1]
    liq_all = torch.empty_like(vix)
    cred_all = torch.empty_like(vix)
    liq, cred = lmu[0], cmu[0]
    liq_all[0], cred_all[0] = liq, cred
    for t in range(1, vix.shape[0]):
        liq = torch.clamp(lmu[t] + lphi[t] * (liq - lmu[t]) + lsn[t], 0.0, 3.0)
        cred = torch.clamp(cmu[t] + cphi[t] * (cred - cmu[t]) + csn[t],
                           0.0, 3.0)
        liq_all[t], cred_all[t] = liq, cred
    vix_amp = torch.clamp_min((vix - 25.0) / 30.0, 0.0)
    p = torch.clamp(S.jump_base_prob[r] + 0.008 * vix_amp + 0.003 * liq_all,
                    0.0, 0.01)
    fire = u_jump < p
    fire[0] = False
    jump = torch.where(fire, t_abs * S.jump_scale[r], 0.0)
    return liq_all, cred_all, jump


def borrow_spread_series(model, vix, risk_free, liq, cred,
                         use_funding_model: bool = True):
    """State-linked annual borrow spread [S, B] (None without the funding
    model)."""
    if not use_funding_model:
        return None
    F = model.funding
    term_spread = 1.25 - 1.1 * torch.clamp(cred, 0.0, 3.0)
    inv_curve = torch.clamp_min(-term_spread, 0.0)
    stress_v = torch.clamp_min(vix - 20.0, 0.0)
    spread = (F.base + F.beta_vix * stress_v + F.beta_inv_curve * inv_curve
              + F.beta_liquidity * torch.clamp(liq, 0.0, 3.0)
              + F.beta_credit * torch.clamp(cred, 0.0, 3.0))
    return torch.minimum(torch.maximum(spread, F.min_spread), F.max_spread)


def compose_letf_returns(model, underlying, risk_free, spread):
    """Leverage + expense + state-linked financing for every asset:
    ``underlying`` [A, S, B] -> [A, S, B] before tracking error."""
    P = model.assets
    lev = P.leverage.to(underlying.dtype)[:, None, None]
    sp = (P.fallback_spread.to(underlying.dtype)[:, None, None]
          if spread is None else spread[None])
    borrow = (torch.clamp_min(lev - 1.0, 0.0)
              * torch.clamp_min(risk_free[None] + sp, 0.0) / 252.0)
    expense = (P.expense_ratio.to(underlying.dtype) / 252.0)[:, None, None]
    return lev * underlying - expense - borrow


def simulate_tracking_error(model, regime_path, vix, underlying, t_draws):
    """AR(1) tracking residual with fat tails and downside asymmetry, EMA
    de-biased (half-life ~126 days), then tanh-saturated: [A, S, B]. The
    innovation terms are formed for all days at once; the loop carries
    (te, bias) for every asset."""
    Tk = model.tracking
    dt = vix.dtype
    rho = Tk.rho.to(dt)[:, None]
    sq = torch.sqrt(torch.clamp_min(1.0 - rho ** 2, 1e-6))
    te_scale = Tk.te_scale.to(dt)[:, None, None]
    downside = Tk.downside_mult.to(dt)[:, None, None]
    ema = 2.0 / (126 + 1)
    vix_mult = torch.clamp((vix / 20.0) ** 0.5, 0.5, 1.5)
    regime_mult = torch.where(regime_path == 0, 1.0,
                              torch.full_like(vix, 1.15))
    move = ((1.0 + 0.3 * torch.abs(underlying))
            * torch.where(underlying < 0, downside, 0.98))
    innov = t_draws * te_scale * (vix_mult * regime_mult)[None]
    step = sq[:, :, None] * innov * move                      # [A, S, B]
    out = torch.empty_like(underlying)
    te = torch.zeros_like(underlying[:, 0])
    bias = torch.zeros_like(te)
    for t in range(vix.shape[0]):
        te = rho * te + step[:, t] if t > 0 else torch.zeros_like(te)
        bias = ema * te + (1 - ema) * bias
        out[:, t] = te - bias
    cap = Tk.clip_limit.to(dt)[:, None, None]
    return torch.where(cap > 0, cap * torch.tanh(out / cap), out)


# ---------------------------------------------------------------------------
# The path
# ---------------------------------------------------------------------------

def _window(a, offsets, sim_days: int):
    """a[off_b + s, b] for s < sim_days (lax.dynamic_slice per trial)."""
    idx = offsets.long()[None, :] + torch.arange(
        sim_days, device=a.device)[:, None]
    return torch.gather(a, 0, idx)


def path_from_innovations(model, innov: Innovations, sim_days: int,
                          use_funding_model: bool = True,
                          use_stress: bool = True,
                          engine_mode: str = "parametric",
                          bootstrap_pools=None) -> PathOutputs:
    """Deterministic path math given the draws (path_engine.
    path_from_innovations): returns, VIX and IRX over all T days, the
    random-start window, stress and signed jumps, funding, leverage and
    tracking error, then the validity checks and repair (finish_path)."""
    why = _unported(engine_mode, bootstrap_pools)
    if why:
        raise NotImplementedError(why)
    regime_full = innov.regime_full
    spy_f, qqq_f, tlt_f = generate_returns_parametric(model, regime_full,
                                                      innov.mode_key)
    vix_full = simulate_vix_given_returns(model, regime_full, spy_f,
                                          innov.vix_noise)
    irx_full = torch.clamp(model.irx_base[regime_full.long()]
                           + 0.5 * innov.irx_noise, 0.0, 15.0)

    off = innov.start_offset
    regime = _window(regime_full, off, sim_days)
    vix, irx = _window(vix_full, off, sim_days), _window(irx_full, off,
                                                         sim_days)
    spy, qqq, tlt = (_window(a, off, sim_days) for a in (spy_f, qqq_f, tlt_f))

    if use_stress:
        liq, cred, jump = simulate_stress(model, regime, vix,
                                          innov.stress_norms, innov.u_jump,
                                          innov.t_abs)
        signed_jump = jump * innov.jump_sign
        spy = torch.clamp(spy - signed_jump, -0.95, 3.0)
        qqq = torch.clamp(qqq - 1.12 * signed_jump, -0.95, 4.0)
        jump_days = (jump > 0).sum(0, dtype=torch.int32)
        liq_mean, cred_mean = liq.mean(0), cred.mean(0)
    else:
        liq = cred = torch.zeros_like(vix)
        jump_days = torch.zeros(vix.shape[1], dtype=torch.int32,
                                device=vix.device)
        liq_mean = cred_mean = torch.zeros_like(vix[0])
    risk_free = torch.clamp(irx, 0.0, 20.0) / 100.0

    streams = (spy, qqq, tlt)
    P = model.assets
    beta = P.beta.to(vix.dtype)
    underlying = torch.stack([streams[int(P.underlying[a])] * beta[a]
                              for a in range(_A)])
    spread = borrow_spread_series(model, vix, risk_free, liq, cred,
                                  use_funding_model)
    lev_ret = compose_letf_returns(model, underlying, risk_free, spread)
    te = simulate_tracking_error(model, regime, vix, underlying,
                                 innov.te_draws)
    etf_ret = torch.clamp(lev_ret + te, -0.999, 10.0)
    cash_ret = model.cash_rate.to(vix.dtype)[regime.long()] / 252.0
    sc = StartConditions(innov.start_offset, innov.start_regime,
                         innov.initial_vix)
    return finish_path(etf_ret, tlt, spy, qqq, vix, regime, cash_ret,
                       risk_free, sc, jump_days, liq_mean, cred_mean)


def generate_paths_batch(model, run_key, trial_ids, antithetic,
                         sim_days: int, buffer_days: int = 0,
                         random_start_method: str = "offset",
                         use_funding_model: bool = True,
                         use_stress: bool = True,
                         engine_mode: str = "parametric",
                         bootstrap_pools=None, anchors=None) -> PathOutputs:
    """Trials ``trial_ids`` [B] through ``draw_innovations`` and
    ``path_from_innovations`` (path_engine.generate_paths_batch). The
    parametric mode draws no joint normals, so an antithetic pair's two
    trials are the same path, as in the JAX package."""
    innov = draw_innovations(model, run_key, trial_ids, antithetic, sim_days,
                             buffer_days, random_start_method, anchors,
                             engine_mode, bootstrap_pools)
    return path_from_innovations(model, innov, sim_days, use_funding_model,
                                 use_stress, engine_mode, bootstrap_pools)
