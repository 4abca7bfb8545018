"""The per-trial path engine, batched: every engine mode.

Port of ``letf_tpu/ops/path_engine.py`` (the JAX version vmaps one trial's
scans over the batch; here the batch is the last axis, ``[T, B]``):

- ``draw_innovations``: every random input a trial consumes, from its
  threefry streams (``ops/rng.py``, the ``jax.random`` samplers), for the
  engine mode (keyword ``engine_mode``, default the reference's
  ``institutional_v1``, which draws every stream). Streams are keyed by
  ``fold_in`` of the stream id, so skipping the joint model's normals and
  chi-square draws (the parametric and legacy modes) changes no other draw.
- ``simulate_regime_path``: the semi-Markov dwell scan (``:116-134``), one
  day step over the batch.
- ``simulate_joint_and_vix`` (``:141-211``): the institutional model's
  multivariate-t with GARCH/DCC-lite, a closed-form 3x3 Cholesky and the
  chi-square scale, fused with the VIX recursion; a torch day loop over
  ``[3, T, B]`` with every day's parameters gathered beforehand.
- ``generate_returns_parametric`` (``:474-491``), ``blend_engine_noise``
  (``:494``) on the block bootstrap's series (``models/bootstrap.py``,
  ``legacy_hybrid`` with pools), ``simulate_vix_given_returns``
  (``:449-471``), ``simulate_stress``, ``borrow_spread_series``,
  ``compose_letf_returns`` and ``simulate_tracking_error`` (``:214-316``),
  and ``path_from_innovations`` (``:518-622``), which takes an
  ``Innovations`` so tests can feed both packages the same draws.
- ``generate_path`` (one trial), ``generate_paths_batch`` (draws + path),
  and ``draw_innovations_jit`` / ``path_from_innovations_jit``, the
  reference's names for the two halves.

None of these is a TPU kernel in the JAX package (they are XLA scans); here
they are torch day loops whose per-day work is only the true recurrence,
everything else computed for all days at once. The production
institutional path is ``ops/path_batched.py``'s kernel route.

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
ENGINE_MODES = ("institutional_v1", "legacy_hybrid", "parametric")
# Cholesky factors of the parametric mode's regime correlations
# (path_engine.py:479-482) and of the engine's bootstrap noise blend
# (:502-505).
CHOL_LOW = np.linalg.cholesky(np.array(
    [[1.0, 0.85, -0.15], [0.85, 1.0, -0.10], [-0.15, -0.10, 1.0]]))
CHOL_HIGH = np.linalg.cholesky(np.array(
    [[1.0, 0.92, -0.45], [0.92, 1.0, -0.30], [-0.45, -0.30, 1.0]]))
CHOL_BLEND_LOW = np.linalg.cholesky(np.array(
    [[1.0, 0.88, -0.18], [0.88, 1.0, -0.12], [-0.18, -0.12, 1.0]]))
CHOL_BLEND_HIGH = np.linalg.cholesky(np.array(
    [[1.0, 0.94, -0.42], [0.94, 1.0, -0.30], [-0.42, -0.30, 1.0]]))


def _check_mode(engine_mode: str) -> None:
    if engine_mode not in ENGINE_MODES:
        raise ValueError(f"engine_mode must be one of {ENGINE_MODES}, got "
                         f"{engine_mode!r}")


class Innovations(NamedTuple):
    """Every draw of a batch, batch last. ``eps``/``u_chi`` (the joint
    model's) stay None outside the institutional mode; the fast route
    leaves the fields None that a kernel draws in-kernel
    (``path_batched.draw_innovations_fast``)."""
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


def _chi_draws(model, k_chi, regime_full, T: int, dt):
    """Chi-square(nu_r) mixing draws [T, B]: 2 * gamma(nu_r / 2) of the key
    fold_in(k_chi, r) for every regime r, picked by the regime path."""
    nus = model.joint.nu.tolist()
    chis = torch.stack([
        2.0 * rng.gamma(rng.fold_in(k_chi, r), nus[r] / 2.0, T, dt).t()
        for r in range(len(nus))])                             # [R, T, B]
    return chis.gather(0, regime_full.long()[None])[0]


def draw_innovations(model, run_key, trial_id, antithetic, sim_days: int,
                     buffer_days: int = 0,
                     random_start_method: str = "offset", anchors=None, *,
                     engine_mode: str = "institutional_v1") -> Innovations:
    """The draws of the trials ``trial_id`` [B] and ``antithetic`` [B]
    (path_engine.draw_innovations, batched) for ``engine_mode``: the
    institutional mode's joint normals (negated for antithetic trials) and
    chi-square draws only in that mode. ``model``: the port's torch
    SimModel on the trials' device."""
    _check_mode(engine_mode)
    trial_ids = trial_id
    dt = model.regime.p_stay.dtype
    T = sim_days + buffer_days
    tk = rng.trial_key(run_key, trial_ids)
    sc = start_conditions(model, run_key, trial_ids, buffer_days,
                          random_start_method, anchors, dt)
    regime_full = simulate_regime_path(model, rng.stream(tk, rng.REGIME),
                                       sc.start_regime, T)
    B = trial_ids.shape[0]
    eps = u_chi = None
    if engine_mode == "institutional_v1":
        sign = torch.where(antithetic, -1.0, 1.0).to(dt)
        eps = (sign[:, None] * rng.normal(rng.stream(tk, rng.JOINT_EPS),
                                          3 * T, dt)).reshape(
            B, T, 3).permute(2, 1, 0).contiguous()
        u_chi = _chi_draws(model, rng.stream(tk, rng.JOINT_CHI), regime_full,
                           T, dt).contiguous()
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
        initial_vix=sc.initial_vix, regime_full=regime_full, eps=eps,
        u_chi=u_chi, vix_noise=vix_noise.contiguous(),
        irx_noise=irx_noise.contiguous(),
        stress_norms=stress_norms.contiguous(), u_jump=u_jump.contiguous(),
        t_abs=t_abs.contiguous(), jump_sign=jump_sign.contiguous(),
        te_draws=te_draws.contiguous(),
        mode_key=rng.stream(tk, rng.BOOTSTRAP))


def _chol3(c00, c01, c02, c11, c12, c22):
    """Closed-form lower Cholesky factor of a 3x3 SPD matrix, componentwise
    (path_engine._chol3): (l00, l10, l20, l11, l21, l22)."""
    eps = 1e-18
    l00 = torch.sqrt(torch.clamp_min(c00, eps))
    l10 = c01 / l00
    l20 = c02 / l00
    l11 = torch.sqrt(torch.clamp_min(c11 - l10 * l10, eps))
    l21 = (c12 - l20 * l10) / l11
    l22 = torch.sqrt(torch.clamp_min(c22 - l20 * l20 - l21 * l21, eps))
    return l00, l10, l20, l11, l21, l22


_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def simulate_joint_and_vix(model, regime_path, eps, u_chi, vix_noise,
                           moment_matching: bool = True):
    """The institutional model's returns and VIX (path_engine.
    simulate_joint_and_vix): regime-conditional multivariate-t with a GARCH
    variance and a DCC-lite correlation per stream (reset to the regime's
    long-run values on day 0, blended 10/90 on a regime switch), the
    covariance's closed-form Cholesky factor times the day's normals, the
    chi-square scale sqrt(nu / u), returns clipped to [-0.95, 4]; the VIX
    AR(1) with downside jumps on the same day's SPY shock. ``regime_path``
    [T, B], ``eps`` [3, T, B], ``u_chi`` and ``vix_noise`` [T, B]. Returns
    (x [3, T, B], vix [T, B]); moment matching moves each stream's mean 10%
    of the way to the regime-average theoretical mean."""
    J, V, reg = model.joint, model.vix, model.regime
    r = regime_path.long()
    T = r.shape[0]
    # Every day's parameters, gathered once: [T, B] (and [3, T, B]).
    mu = J.mu[r].permute(2, 0, 1)
    lv = J.long_var[r].permute(2, 0, 1)
    rb = [J.rbar[:, i, j][r] for i, j in _PAIRS]
    alpha, beta = J.garch_alpha[r], J.garch_beta[r]
    one_ab = 1 - alpha - beta
    ad, bd = J.dcc_a[r], J.dcc_b[r]
    one_abd = 1 - ad - bd
    scale = torch.sqrt(J.nu[r] / torch.clamp_min(u_chi, 1e-12))
    denom = torch.clamp_min(reg.daily_std[r], 1e-4)
    vphi, vthr, vjs = V.phi[r], V.jump_threshold[r], V.jump_scale[r]
    vmean = (1 - vphi) * V.target[r]
    vnoise = V.noise_std[r] * vix_noise
    switch = torch.zeros_like(r, dtype=torch.bool)
    switch[1:] = r[1:] != r[:-1]

    x = torch.empty_like(eps)
    vix = torch.empty_like(vix_noise)
    h = q = z = v = None
    for t in range(T):
        if t == 0:
            h = lv[:, 0]
            q = [c[0] for c in rb]
        else:
            zz = [z[i] * z[j] for i, j in _PAIRS]
            g = torch.clamp_min(one_ab[t] * lv[:, t]
                                + alpha[t] * (z * z) * h + beta[t] * h,
                                1e-10)
            h = torch.where(switch[t], 0.10 * lv[:, t] + 0.90 * h, g)
            q = [torch.where(switch[t], 0.10 * c[t] + 0.90 * qk,
                             one_abd[t] * c[t] + ad[t] * zk + bd[t] * qk)
                 for c, qk, zk in zip(rb, q, zz)]
        d = [torch.sqrt(torch.clamp_min(q[k], 1e-12)) for k in (0, 3, 5)]
        sh = torch.sqrt(h)
        cov = [(sh[i] * sh[j]) * (q[k] / (d[i] * d[j]))
               for k, (i, j) in enumerate(_PAIRS)]
        l00, l10, l20, l11, l21, l22 = _chol3(*cov)
        e = eps[:, t]
        zc = torch.stack([l00 * e[0], l10 * e[0] + l11 * e[1],
                          l20 * e[0] + l21 * e[1] + l22 * e[2]])
        xt = torch.clamp(mu[:, t] + zc * scale[t], -0.95, 4.0)
        z = (xt - mu[:, t]) / torch.sqrt(torch.clamp_min(h, 1e-10))
        x[:, t] = xt
        if t == 0:
            v = V.base[r[0]]
        else:
            shock = torch.clamp_min(-xt[0], 0.0) / denom[t]
            vjump = vjs[t] * torch.clamp_min(shock - vthr[t], 0.0)
            v = torch.clamp_min(vphi[t] * v + vmean[t] + vjump + vnoise[t],
                                10.0)
        vix[t] = v
    if moment_matching:
        theo = J.theo_mean.to(x.dtype)[:, None, None]
        x = x + (theo - x.mean(dim=1, keepdim=True)) * 0.1
    return x, vix


# ---------------------------------------------------------------------------
# Returns and VIX
# ---------------------------------------------------------------------------

def cholesky_mix(z, high, chol_low, chol_high):
    """Day-wise correlation of independent draws z [3, T, B]: x_i = sum_j
    C[i, j] z_j with C the regime's Cholesky factor (``high`` [T, B]
    selects ``chol_high``), the einsum "tij,tj->ti" of the JAX package."""
    lo, hi = (torch.as_tensor(c, device=z.device).to(z.dtype)
              for c in (chol_low, chol_high))
    out = []
    for i in range(3):
        acc = None
        for j in range(3):
            term = torch.where(high, hi[i, j], lo[i, j]) * z[j]
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def generate_returns_parametric(model, regime_path, key):
    """Regime-conditional correlated Student-t(STUDENT_T_DF) draws [T, 3]
    per trial (t of the mode key), the regime's Cholesky factor applied,
    SPY = mean + std * x0, QQQ and TLT as SPY loadings plus noise. Returns
    (spy, qqq, tlt) [T, B]."""
    dt = model.regime.p_stay.dtype
    T, B = regime_path.shape
    z = rng.t(key, float(cfg.STUDENT_T_DF), 3 * T, dt).reshape(B, T, 3)
    x = cholesky_mix(z.permute(2, 1, 0), regime_path != 0, CHOL_LOW,
                     CHOL_HIGH)
    reg = regime_path.long()
    std = model.regime.daily_std[reg]
    mu = model.regime.daily_mean[reg]
    spy = mu + std * x[0]
    qqq = 1.15 * spy + 0.006 * x[1]
    tlt = -0.12 * spy + 0.004 * x[2]
    return spy, qqq, tlt


def blend_engine_noise(model, regime_path, spy, qqq, tlt, key):
    """The engine's bootstrap noise blend (path_engine.blend_engine_noise):
    correlated Student-t draws (t of ``key``) scaled by the regime's
    volatility, weighted twice by 1 - BOOTSTRAP_WEIGHT as the reference
    weights them (the noise carries the factor, then the blend applies it
    again). [T, B] in and out."""
    dt = spy.dtype
    T, B = regime_path.shape
    w = float(np.clip(cfg.BOOTSTRAP_WEIGHT, 0.0, 1.0))
    noise_w = 1.0 - w
    z = rng.t(key, float(cfg.STUDENT_T_DF), 3 * T, dt).reshape(B, T, 3)
    x = cholesky_mix(z.permute(2, 1, 0), regime_path != 0, CHOL_BLEND_LOW,
                     CHOL_BLEND_HIGH)
    spy_std = model.regime.daily_std[regime_path.long()]
    spy_noise = noise_w * spy_std * 0.55 * x[0]
    qqq_noise = noise_w * 1.35 * spy_std * 0.45 * x[1]
    tlt_noise = noise_w * 0.55 * spy_std * 0.35 * x[2]
    return (w * spy + (1 - w) * (spy + spy_noise),
            w * qqq + (1 - w) * (qqq + qqq_noise),
            w * tlt + (1 - w) * (tlt + tlt_noise))


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


def mode_returns(model, innov: Innovations, engine_mode: str,
                 bootstrap_pools=None, moment_matching: bool = True):
    """SPY/QQQ/TLT returns and VIX [T, B] over all T days of the engine
    mode (path_from_innovations' first stage): the joint scan
    (institutional_v1), the block bootstrap blended with the engine's
    noise (legacy_hybrid with pools: ``bootstrap.sample_bootstrap_returns``
    of the first key of split(mode key), the blend of the second), or the
    parametric Student-t draws; the last two through the standalone VIX
    recursion."""
    regime_full = innov.regime_full
    if engine_mode == "institutional_v1":
        if innov.eps is None:
            raise ValueError("the institutional mode needs the joint draws: "
                             "draw_innovations(..., engine_mode="
                             "'institutional_v1')")
        x, vix = simulate_joint_and_vix(model, regime_full, innov.eps,
                                        innov.u_chi, innov.vix_noise,
                                        moment_matching)
        return x[0], x[1], x[2], vix
    if engine_mode == "legacy_hybrid" and bootstrap_pools is not None:
        from letf_tpu_torch.models import bootstrap

        pools = bootstrap.pools_on(bootstrap_pools, regime_full.device,
                                   model.regime.p_stay.dtype)
        k_boot, k_blend = rng.split(innov.mode_key, 2).unbind(1)
        s = bootstrap.sample_bootstrap_returns(pools, regime_full, k_boot,
                                               regime_full.shape[0])
        spy, qqq, tlt = blend_engine_noise(model, regime_full, s["SPY_Ret"],
                                           s["QQQ_Ret"], s["TLT_Ret"],
                                           k_blend)
    else:
        spy, qqq, tlt = generate_returns_parametric(model, regime_full,
                                                    innov.mode_key)
    vix = simulate_vix_given_returns(model, regime_full, spy,
                                     innov.vix_noise)
    return spy, qqq, tlt, vix


def compose_path(model, innov: Innovations, spy, qqq, tlt, vix, irx, regime,
                 use_funding_model: bool = True,
                 use_stress: bool = True) -> PathOutputs:
    """The windowed [S, B] streams to a path: stress and signed jumps,
    funding, leverage and tracking error of all six assets, then the
    validity checks and repair (finish_path)."""
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


def path_from_innovations(model, innov: Innovations, sim_days: int,
                          moment_matching: bool = True,
                          use_funding_model: bool = True,
                          use_stress: bool = True,
                          engine_mode: str = "institutional_v1",
                          bootstrap_pools=None) -> PathOutputs:
    """Deterministic path math given the draws (path_engine.
    path_from_innovations): the mode's returns and VIX and the IRX over
    all T days, the random-start window, then ``compose_path``.
    ``legacy_hybrid`` without pools is the parametric model, as in the
    reference."""
    _check_mode(engine_mode)
    regime_full = innov.regime_full
    spy_f, qqq_f, tlt_f, vix_full = mode_returns(
        model, innov, engine_mode, bootstrap_pools, moment_matching)
    irx_full = torch.clamp(model.irx_base[regime_full.long()]
                           + 0.5 * innov.irx_noise, 0.0, 15.0)
    off = innov.start_offset
    chans = [_window(a, off, sim_days)
             for a in (spy_f, qqq_f, tlt_f, vix_full, irx_full, regime_full)]
    return compose_path(model, innov, *chans, use_funding_model, use_stress)


def _squeeze(path: PathOutputs) -> PathOutputs:
    return PathOutputs(*(a[..., 0] for a in path))


def generate_path(model, run_key, trial_id, antithetic, sim_days: int,
                  buffer_days: int = 0, random_start_method: str = "offset",
                  moment_matching: bool = True,
                  use_funding_model: bool = True, use_stress: bool = True,
                  engine_mode: str = "institutional_v1",
                  bootstrap_pools=None, anchors=None) -> PathOutputs:
    """One trial (path_engine.generate_path): ``generate_paths_batch`` of
    the single trial id, its batch axis dropped (``etf_ret`` [A, S],
    series [S], per-trial fields 0-d)."""
    ids = torch.as_tensor(trial_id, device=run_key.device).reshape(1)
    anti = torch.as_tensor(antithetic, device=run_key.device).reshape(1)
    return _squeeze(generate_paths_batch(
        model, run_key, ids, anti, sim_days, buffer_days,
        random_start_method, moment_matching, use_funding_model, use_stress,
        engine_mode, bootstrap_pools, anchors))


def generate_paths_batch(model, run_key, trial_ids, antithetic,
                         sim_days: int, buffer_days: int = 0,
                         random_start_method: str = "offset",
                         moment_matching: bool = True,
                         use_funding_model: bool = True,
                         use_stress: bool = True,
                         engine_mode: str = "institutional_v1",
                         bootstrap_pools=None, anchors=None) -> PathOutputs:
    """Trials ``trial_ids`` [B] through ``draw_innovations`` and
    ``path_from_innovations`` (path_engine.generate_paths_batch, whose
    keywords are generate_path's). In the parametric and legacy modes no
    joint normals are drawn, so an antithetic pair's two trials are the
    same path, as in the JAX package."""
    innov = draw_innovations(model, run_key, trial_ids, antithetic, sim_days,
                             buffer_days, random_start_method, anchors,
                             engine_mode=engine_mode)
    return path_from_innovations(model, innov, sim_days, moment_matching,
                                 use_funding_model, use_stress, engine_mode,
                                 bootstrap_pools)


# The reference's jitted single-trial wrappers; torch runs them eagerly.
draw_innovations_jit = draw_innovations
path_from_innovations_jit = path_from_innovations
