"""Fitting primitives of the calibration layer, in torch float64.

The port's copy of ``letf_tpu/ops/fitting.py:24-200``: masked quantiles,
medians, means and standard deviations, the AR(1) slope fit, the stable
compression (dropna), the masked ridge solve, and the three fit cores
(funding spread, one regime's stress channels, one asset's tracking
residual). Every function takes an explicit validity mask instead of
dropping NaNs and computes in float64 on the device of its inputs. The
JAX package pins these fits to XLA:CPU only because the TPU has no
float64; the H100 has it, so ``to_f64`` stages them on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def _masked_sort(x, mask):
    """Sort with invalid entries pushed to +inf; returns (sorted, n_valid)."""
    big = torch.where(mask, x, torch.inf)
    return torch.sort(big).values, mask.sum()


def masked_quantile(x, mask, q):
    """Linear-interpolation quantile of the masked entries (numpy
    'linear' method); q may be a vector. Returns NaN when nothing valid."""
    s, n = _masked_sort(x, mask)
    q = torch.atleast_1d(torch.as_tensor(q, dtype=s.dtype, device=s.device))
    pos = q * (n - 1).to(s.dtype)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, x.shape[0] - 1)
    hi = torch.clamp(lo + 1, 0, x.shape[0] - 1)
    frac = pos - lo.to(s.dtype)
    val = s[lo] * (1.0 - frac) + s[hi] * frac
    return torch.where(n > 0, val, torch.nan)


def masked_median(x, mask):
    return masked_quantile(x, mask, 0.5)[0]


def masked_mean(x, mask):
    n = mask.sum()
    return torch.where(n > 0, torch.where(mask, x, 0.0).sum() / n,
                       torch.nan)


def masked_std(x, mask):
    """Population std of masked entries (numpy nanstd semantics)."""
    m = masked_mean(x, mask)
    d = torch.where(mask, x - m, 0.0)
    n = mask.sum()
    return torch.where(n > 0, torch.sqrt((d * d).sum() / n), torch.nan)


def ar1_fit(x, y, mask, lo_phi, hi_phi, lo_sig, hi_sig,
            default_phi, default_sigma):
    """AR(1) slope through the origin of (x -> y) over masked pairs:
    phi = <x, y> / <x, x> clipped to [lo_phi, hi_phi]; sigma = std of the
    residual y - phi x (population), clipped. Falls back to the defaults
    when <x, x> is non-positive."""
    xm = torch.where(mask, x, 0.0)
    ym = torch.where(mask, y, 0.0)
    denom = (xm * xm).sum()
    phi_raw = (xm * ym).sum() / torch.where(denom > 0, denom, 1.0)
    phi = torch.where(denom > 0, torch.clamp(phi_raw, lo_phi, hi_phi),
                      default_phi)
    resid = y - phi * x
    sigma_raw = masked_std(resid, mask)
    sigma = torch.where(denom > 0, torch.clamp(sigma_raw, lo_sig, hi_sig),
                        default_sigma)
    return phi, sigma


def compress(x, mask):
    """dropna-equivalent: valid entries first in original order (stable),
    garbage tail after. Returns (compressed, n_valid). Pairing a compressed
    series reproduces the reference's dropna-then-lag AR(1) semantics
    (pairs may straddle invalid gaps)."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return x[order], mask.sum()


def ridge_solve(X, y, mask, reg_diag):
    """Masked ridge regression beta = (X'X + diag(reg))^-1 X'y over the
    valid rows (dropna + np.linalg.solve). Invalid rows are zeroed in both
    operands (NaN-safe)."""
    Xm = torch.where(mask[:, None], X, 0.0)
    ym = torch.where(mask, y, 0.0)
    A = Xm.T @ Xm + torch.diag(torch.as_tensor(reg_diag, dtype=X.dtype,
                                               device=X.device))
    b = Xm.T @ ym
    return torch.linalg.solve(A, b)


def funding_fit_device(target, stress, inv_curve, liquidity, credit):
    """Core of the funding-spread calibration: winsorize the implied
    spread at [P1, P99], masked ridge on the 5 covariates (non-negative
    slope clip), and the [P1, P99.5] spread bounds of the fitted series.

    Returns (beta [5], min_spread, max_spread, n_valid)."""
    n = target.shape[0]
    finite_t = torch.isfinite(target)
    lohi = masked_quantile(target, finite_t, [0.01, 0.99])
    n_fin = finite_t.sum()
    tgt = torch.where(n_fin > 20, torch.clamp(target, lohi[0], lohi[1]),
                      target)
    med = masked_median(target, finite_t)
    tgt = torch.where(torch.isfinite(tgt), tgt,
                      torch.where(n_fin > 0, med, 0.0060))

    X = torch.stack([torch.ones(n, dtype=tgt.dtype, device=tgt.device),
                     stress, inv_curve, torch.clamp(liquidity, 0.0, 3.0),
                     torch.clamp(credit, 0.0, 3.0)], dim=1)
    mask = torch.isfinite(tgt) & torch.isfinite(X).all(dim=1)
    beta = ridge_solve(X, tgt, mask, [1e-6, 1e-4, 1e-4, 1e-4, 1e-4])
    beta = torch.cat([beta[:1], torch.clamp(beta[1:], min=0.0)])

    predicted = X @ beta
    fin_p = torch.isfinite(predicted)
    qs = masked_quantile(predicted, fin_p, [0.01, 0.995])
    min_spread = torch.clamp(qs[0], min=0.0025)
    max_spread = torch.clamp(qs[1], max=0.0300)
    max_spread = torch.where(max_spread <= min_spread, min_spread + 0.005,
                             max_spread)
    enough = fin_p.sum() > 10
    min_spread = torch.where(enough, min_spread, 0.0030)
    max_spread = torch.where(enough, max_spread, 0.0300)
    return beta, min_spread, max_spread, mask.sum()


def _lag_pairs(x, mask):
    """Compress (dropna) then lag: returns (prev, nxt, pair_mask, n) where
    pairs are adjacent in the COMPRESSED series (reference dropna-then-lag
    semantics: pairs straddle invalid gaps)."""
    c, n = compress(x, mask)
    pos = torch.arange(x.shape[0] - 1, device=x.device)
    pair = pos < (n - 1)
    return c[:-1], c[1:], pair, n


def stress_channel_fit_device(liq, cred, rv, mask):
    """Core of one regime's stress-state fit: medians of the two channels,
    demeaned AR(1) per channel (dropna-then-lag pairing), and the
    excess-realized-vol jump intensity. Returns the 8 regime params plus
    n_valid."""
    liq_mu = masked_median(liq, mask)
    cred_mu = masked_median(cred, mask)

    lp, ln, lpair, n = _lag_pairs(liq, mask)
    # The reference's ar1() centers on the median of the compressed series
    # (the masked median's value) and falls back below 20 samples.
    liq_phi, liq_sigma = ar1_fit(lp - liq_mu, ln - liq_mu, lpair,
                                 0.50, 0.98, 0.01, 0.30, 0.90, 0.08)
    cp, cn, cpair, _ = _lag_pairs(cred, mask)
    cred_phi, cred_sigma = ar1_fit(cp - cred_mu, cn - cred_mu, cpair,
                                   0.50, 0.98, 0.01, 0.30, 0.88, 0.07)
    few = n < 20
    liq_phi = torch.where(few, 0.90, liq_phi)
    liq_sigma = torch.where(few, 0.08, liq_sigma)
    cred_phi = torch.where(few, 0.88, cred_phi)
    cred_sigma = torch.where(few, 0.07, cred_sigma)

    excess_rv = masked_mean(torch.clamp(rv - 0.25, min=0.0), mask)
    jump_p = torch.clamp(0.0002 + 0.003 * excess_rv, 0.0002, 0.003)
    jump_s = torch.clamp(0.0005 + 0.002 * excess_rv, 0.0005, 0.0025)
    return (liq_mu, liq_phi, liq_sigma, cred_mu, cred_phi, cred_sigma,
            jump_p, jump_s, n)


def tracking_residual_fit_device(residual, mask, lo_scale: float,
                                 hi_scale: float):
    """Core of one asset's tracking-residual fit: AR(1) rho of the
    compressed residual, innovation scale, downside asymmetry, and the
    P99.5 tanh clip limit. Returns (rho, scale, downside_mult, clip_limit,
    n_valid, n_innov)."""
    prev, nxt, pair, n = _lag_pairs(residual, mask)
    xm = torch.where(pair, prev, 0.0)
    ym = torch.where(pair, nxt, 0.0)
    denom = (xm * xm).sum()
    rho_raw = (xm * ym).sum() / torch.where(denom > 0, denom, 1.0)
    rho = torch.where(denom > 0, torch.clamp(rho_raw, 0.0, 0.7), 0.25)

    innov = nxt - rho * prev
    scale = torch.clamp(masked_std(innov, pair), lo_scale, hi_scale)
    neg = pair & (innov < 0)
    pos = pair & (innov >= 0)
    down = torch.where(neg.any(), masked_mean(innov.abs(), neg), scale)
    up = torch.where(pos.any(), masked_mean(innov.abs(), pos), scale)
    downside_mult = torch.clamp(down / torch.clamp(up, min=1e-9), 1.0, 2.0)

    n_innov = n - 1
    p995 = masked_quantile(innov.abs(), pair, 0.995)[0] * 1.35
    clip_limit = torch.clamp(torch.where(n_innov > 30, p995, 0.15),
                             0.08, 0.35)
    return rho, scale, downside_mult, clip_limit, n, n_innov


def to_f64(*arrays, device):
    """Host -> device float64 staging of the calibration fits' inputs."""
    return tuple(torch.as_tensor(np.asarray(a, np.float64), device=device)
                 for a in arrays)
