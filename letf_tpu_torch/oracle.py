"""NumPy reference oracle ("slow mode") for per-path parity testing.

Port of ``letf_tpu/oracle.py`` on the port's model tree
(``letf_tpu_torch/models/params.SimModel``, numpy arrays). It implements
the same stochastic recursions as the per-trial engine
(``letf_tpu_torch.ops.path_engine``) in straightforward float64 NumPy
loops, consuming the SAME pre-drawn innovation arrays (one trial of an
``Innovations``, each field a host array in the per-trial layout: days
first, components last). Engine vs. oracle agreement validates the day
scans against plain sequential math. It needs no torch: a caller copies
one trial's innovations to the host first.
"""

from __future__ import annotations

import numpy as np

from letf_tpu_torch.models.params import SimModel


def oracle_regime_path(model: SimModel, uniforms, start_regime: int,
                       total_days: int) -> np.ndarray:
    """Semi-Markov regime path from [T+1, 2] uniforms (dwell, next)."""
    reg = model.regime
    u = np.asarray(uniforms, np.float64)

    def draw_dwell(r, uu):
        if reg.has_dwell[r] > 0:
            idx = min(int(np.sum(reg.dwell_cdf[r] < uu)),
                      reg.dwell_cdf.shape[-1] - 1)
            return float(reg.dwell_values[r, idx])
        return max(1.0, np.ceil(np.log1p(-uu) / np.log(reg.p_stay[r])))

    def draw_next(r, uu):
        row = reg.transition[r].copy()
        row[r] = 0.0
        rs = row.sum()
        if rs <= 0:
            return r
        probs = row / rs
        return min(int(np.sum(np.cumsum(probs) < uu)), len(row) - 1)

    path = np.zeros(total_days, np.int64)
    cur = int(start_regime)
    rem = draw_dwell(cur, u[0, 0])
    for t in range(total_days):
        path[t] = cur
        rem -= 1.0
        if rem <= 0:
            nxt = draw_next(cur, u[t + 1, 1])
            rem = draw_dwell(nxt, u[t + 1, 0])
            cur = nxt
    return path


def _chol3_np(c):
    eps = 1e-18
    l11 = np.sqrt(max(c[0, 0], eps))
    l21 = c[1, 0] / l11
    l31 = c[2, 0] / l11
    l22 = np.sqrt(max(c[1, 1] - l21 * l21, eps))
    l32 = (c[2, 1] - l31 * l21) / l22
    l33 = np.sqrt(max(c[2, 2] - l31 * l31 - l32 * l32, eps))
    return np.array([[l11, 0, 0], [l21, l22, 0], [l31, l32, l33]])


def oracle_joint_and_vix(model: SimModel, regime_path, eps, u_chi, vix_noise,
                         moment_matching: bool = True):
    """Sequential multivariate-t + GARCH/DCC + VIX recursion (f64)."""
    J, V, reg = model.joint, model.vix, model.regime
    T = len(regime_path)
    x_out = np.zeros((T, 3))
    vix_out = np.zeros(T)

    h = np.zeros(3)
    Q = np.zeros((3, 3))
    prev_z = np.zeros(3)
    prev_r = int(regime_path[0])
    vix_prev = 0.0

    for t in range(T):
        r = int(regime_path[t])
        mu = J.mu[r]
        alpha, beta = J.garch_alpha[r], J.garch_beta[r]
        a_dcc, b_dcc = J.dcc_a[r], J.dcc_b[r]
        long_var, rbar = J.long_var[r], J.rbar[r]

        if t == 0:
            h = long_var.copy()
            Q = rbar.copy()
        elif r != prev_r:
            h = 0.10 * long_var + 0.90 * h
            Q = 0.10 * rbar + 0.90 * Q
        else:
            h = np.clip((1 - alpha - beta) * long_var
                        + alpha * prev_z ** 2 * h + beta * h, 1e-10, None)
            Q = (1 - a_dcc - b_dcc) * rbar + a_dcc * np.outer(prev_z, prev_z) + b_dcc * Q

        d = np.sqrt(np.clip(np.diag(Q), 1e-12, None))
        R_t = Q / np.outer(d, d)
        sh = np.sqrt(h)
        cov_t = np.outer(sh, sh) * R_t
        L = _chol3_np(cov_t)
        z = L @ eps[t]
        scale = np.sqrt(J.nu[r] / max(u_chi[t], 1e-12))
        x = np.clip(mu + z * scale, -0.95, 4.0)
        prev_z = (x - mu) / np.sqrt(np.clip(h, 1e-10, None))
        prev_r = r
        x_out[t] = x

        denom = max(reg.daily_std[r], 1e-4)
        shock = max(-x[0], 0.0) / denom
        vjump = V.jump_scale[r] * max(0.0, shock - V.jump_threshold[r])
        if t == 0:
            vix_out[t] = V.base[r]
        else:
            vix_out[t] = max(10.0, V.phi[r] * vix_prev
                             + (1 - V.phi[r]) * V.target[r]
                             + vjump + V.noise_std[r] * vix_noise[t])
        vix_prev = vix_out[t]

    if moment_matching:
        x_out = x_out + (J.theo_mean - x_out.mean(axis=0)) * 0.1
    return x_out, vix_out


def oracle_stress(model: SimModel, regime_path, vix, norms, u_jump, t_abs):
    S = model.stress
    n = len(regime_path)
    liq = np.zeros(n)
    cred = np.zeros(n)
    jump = np.zeros(n)
    for t in range(n):
        r = int(regime_path[t])
        if t == 0:
            liq[t] = S.liq_mu[r]
            cred[t] = S.credit_mu[r]
            continue
        liq[t] = np.clip(S.liq_mu[r] + S.liq_phi[r] * (liq[t - 1] - S.liq_mu[r])
                         + S.liq_sigma[r] * norms[t, 0], 0.0, 3.0)
        cred[t] = np.clip(S.credit_mu[r] + S.credit_phi[r] * (cred[t - 1] - S.credit_mu[r])
                          + S.credit_sigma[r] * norms[t, 1], 0.0, 3.0)
        vix_amp = max((vix[t] - 25.0) / 30.0, 0.0)
        p = np.clip(S.jump_base_prob[r] + 0.008 * vix_amp + 0.003 * liq[t],
                    0.0, 0.01)
        if u_jump[t] < p:
            jump[t] = t_abs[t] * S.jump_scale[r]
    return liq, cred, jump


def oracle_tracking(model: SimModel, regime_path, vix, underlying, t_draws):
    """AR(1) TE + EMA de-bias + tanh clip, per asset (f64)."""
    Tk = model.tracking
    n, a = underlying.shape
    out = np.zeros((n, a))
    for j in range(a):
        rho = Tk.rho[j]
        sq = np.sqrt(max(1 - rho ** 2, 1e-6))
        te = np.zeros(n)
        for t in range(1, n):
            vix_mult = np.clip((vix[t] / 20.0) ** 0.5, 0.5, 1.5)
            regime_mult = 1.0 if regime_path[t] == 0 else 1.15
            innov = t_draws[t, j] * Tk.te_scale[j] * vix_mult * regime_mult
            ds = Tk.downside_mult[j] if underlying[t, j] < 0 else 0.98
            move = (1.0 + 0.3 * abs(underlying[t, j])) * ds
            te[t] = rho * te[t - 1] + sq * innov * move
        alpha = 2.0 / (126 + 1)
        bias = 0.0
        for t in range(n):
            bias = alpha * te[t] + (1 - alpha) * bias
            te[t] -= bias
        cap = Tk.clip_limit[j]
        out[:, j] = cap * np.tanh(te / cap) if cap > 0 else te
    return out


def oracle_path(model: SimModel, innov, sim_days: int,
                moment_matching: bool = True,
                use_funding_model: bool = True,
                use_stress: bool = True):
    """Full oracle path from one trial's innovations (host arrays)."""
    F = model.funding
    P = model.assets

    regime_full = np.asarray(innov.regime_full)
    x_full, vix_full = oracle_joint_and_vix(
        model, regime_full, np.asarray(innov.eps, np.float64),
        np.asarray(innov.u_chi, np.float64),
        np.asarray(innov.vix_noise, np.float64),
        moment_matching=moment_matching)
    irx_full = np.clip(model.irx_base[regime_full]
                       + 0.5 * np.asarray(innov.irx_noise, np.float64), 0.0, 15.0)

    off = int(innov.start_offset)
    sl = slice(off, off + sim_days)
    regime = regime_full[sl]
    x = x_full[sl]
    vix = vix_full[sl]
    irx = irx_full[sl]
    spy, qqq, tlt = x[:, 0].copy(), x[:, 1].copy(), x[:, 2].copy()

    if use_stress:
        liq, cred, jump = oracle_stress(
            model, regime, vix, np.asarray(innov.stress_norms, np.float64),
            np.asarray(innov.u_jump, np.float64),
            np.asarray(innov.t_abs, np.float64))
        sj = jump * np.asarray(innov.jump_sign, np.float64)
        spy = np.clip(spy - sj, -0.95, 3.0)
        qqq = np.clip(qqq - 1.12 * sj, -0.95, 4.0)
    else:
        liq = cred = np.zeros_like(vix)

    risk_free = np.clip(irx, 0.0, 20.0) / 100.0

    streams = np.stack([spy, qqq, tlt], axis=-1)
    underlying = streams[:, P.underlying] * P.beta[None, :]

    if use_funding_model:
        term_spread = 1.25 - 1.1 * np.clip(cred, 0.0, 3.0)
        inv_curve = np.maximum(-term_spread, 0.0)
        spread = (F.base + F.beta_vix * np.maximum(vix - 20.0, 0.0)
                  + F.beta_inv_curve * inv_curve
                  + F.beta_liquidity * np.clip(liq, 0, 3)
                  + F.beta_credit * np.clip(cred, 0, 3))
        spread = np.clip(spread, F.min_spread, F.max_spread)[:, None]
    else:
        spread = np.broadcast_to(P.fallback_spread[None, :],
                                 underlying.shape)

    borrow_daily = (np.maximum(P.leverage - 1.0, 0.0)[None, :]
                    * np.maximum(risk_free[:, None] + spread, 0.0) / 252.0)
    lev_ret = (P.leverage[None, :] * underlying
               - P.expense_ratio[None, :] / 252.0 - borrow_daily)

    te = oracle_tracking(model, regime, vix, underlying,
                         np.asarray(innov.te_draws, np.float64))
    etf_ret = np.clip(lev_ret + te, -0.999, 10.0)

    cash_ret = model.cash_rate[regime] / 252.0
    return {
        "etf_ret": etf_ret, "tlt_ret": tlt, "spy_ret": spy, "qqq_ret": qqq,
        "vix": vix, "regime": regime, "cash_ret": cash_ret,
        "risk_free": risk_free,
    }
