"""Frozen copy of ``letf_tpu_torch/ops/compose.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Cost composition: stress, funding, leverage and tracking error (kernel K5).

Port of ``letf_tpu/ops/pallas_compose.py``: its draw helpers and constants
(``_stream_bits``, ``_normals``, ``_uniforms``, ``_t_polar``, ``_STRESS_IDX``,
``_TE_IDX``, ``_TE_DFS``, ``_EMA_ALPHA``), its parameter-row layout, and the
kernel ``_compose_kernel`` (entry ``pallas_compose_generate``) of the general
path.

The day math lives once per route: ``stress_day`` / ``asset_day`` here for
the plain versions of K5 (``compose_plain``) and K3
(``compose_strategies.compose_strategies_plain``), and
``csrc/compose_day.cuh`` for both CUDA kernels. ``compose_generate`` launches
``csrc/compose.cu`` on CUDA tensors and runs ``compose_plain`` on CPU ones.

Layout ``[S, B]`` in; ``etf`` out is ``[6, S, B]`` (one plane per asset).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import config as cfg
from benchmark.reference import precision
from benchmark.reference import rng
from benchmark.reference.joint import box_muller


# Draw-stream indices: the joint kernel uses 1..6; stress draws start at 16
# and tracking-error draws at 32, so no (trial, day) counter collides.
STRESS_IDX = 16
TE_IDX = 32
EMA_ALPHA = 2.0 / (126 + 1)
TE_DFS = np.asarray(cfg.asset_table().te_df)
UND_IDX = tuple(int(i) for i in cfg.asset_table().underlying)
NA = cfg.N_ASSETS
_TWO_PI = 2.0 * math.pi

# Stress-table rows (pack_stress_params) and asset-table rows
# (pack_asset_params).
(LIQ_MU, LIQ_PHI, LIQ_SIG, CRED_MU, CRED_PHI, CRED_SIG,
 JP_BASE, JP_SCALE, CASH_RATE) = range(9)
(F_BASE, F_BVIX, F_BINV, F_BLIQ, F_BCRED, F_MIN, F_MAX) = range(9, 16)
(C_LEV, C_ER, C_BETA, C_FSPREAD, C_RHO, C_SQ, C_TE_SCALE,
 C_DOWNSIDE, C_CLIP) = range(9)


def uniforms(day_key, idx0: int, n: int):
    return [rng.bits_to_unit(rng.stream_bits(day_key, idx0 + i))
            for i in range(n)]


def normals(day_key, idx0: int, n: int):
    """n standard normals from draw indices idx0, idx0+1, ... (Box-Muller
    pairs)."""
    return box_muller(uniforms(day_key, idx0, 2 * ((n + 1) // 2)))[:n]


def t_polar(day_key, idx0: int, df: float):
    """One exact Student-t(df) draw from two uniform streams (Bailey's polar
    method): sqrt(df * (u1^(-2/df) - 1)) * cos(2*pi*u2)."""
    u1, u2 = uniforms(day_key, idx0, 2)
    w = torch.exp(torch.log(u1) * (-2.0 / df)) - 1.0
    return torch.sqrt(df * w) * torch.cos(_TWO_PI * u2)


class Draws(NamedTuple):
    """Every stress and tracking-error draw of a window, [S, B] each."""
    n_liq: torch.Tensor
    n_cred: torch.Tensor
    u_jump: torch.Tensor
    t5: torch.Tensor
    t_te: dict            # asset -> [S, B]


def draws(ids, seed_words, S: int, assets) -> Draws:
    """The counter draws of days 0..S-1 (pure functions of (trial, day)),
    tracking-error draws for ``assets`` only."""
    lane_key = rng.lane_keys(ids, seed_words)
    dk = rng.day_keys(lane_key, torch.arange(S, device=ids.device),
                      seed_words)
    n_liq, n_cred = normals(dk, STRESS_IDX, 2)
    (u_jump,) = uniforms(dk, STRESS_IDX + 4, 1)
    t5 = t_polar(dk, STRESS_IDX + 2, 5.0)
    t_te = {a: t_polar(dk, TE_IDX + 2 * a, float(TE_DFS[a])) for a in assets}
    return Draws(n_liq, n_cred, u_jump, t5, t_te)


def _f(mask):
    return mask.to(precision.F)


class DayStress(NamedTuple):
    liq_n: torch.Tensor
    cred_n: torch.Tensor
    jump_on: torch.Tensor
    spy_a: torch.Tensor
    qqq_a: torch.Tensor
    risk_free: torch.Tensor
    spread: torch.Tensor
    vix_mult: torch.Tensor
    regime_mult: torch.Tensor


def stress_day(spa, spd, dr: Draws, t: int, liq, cred, spy_w, qqq_w, vx,
               ir, reg) -> DayStress:
    """Stress + crisis jump + funding spread of day t (compose_day.cuh's
    ``stress_day``). ``spa``/``spd``: the stress table's regime-0 column
    and its regime-1 minus regime-0 difference; ``liq``/``cred``: the
    previous day's levels."""

    def g2(i):
        return spa[i] + spd[i] * reg

    first = t == 0
    lmu, cmu = g2(LIQ_MU), g2(CRED_MU)
    if first:
        liq_n, cred_n = lmu, cmu
        jump_on = torch.zeros_like(vx)
    else:
        liq_n = torch.clamp(lmu + g2(LIQ_PHI) * (liq - lmu)
                            + g2(LIQ_SIG) * dr.n_liq[t], 0.0, 3.0)
        cred_n = torch.clamp(cmu + g2(CRED_PHI) * (cred - cmu)
                             + g2(CRED_SIG) * dr.n_cred[t], 0.0, 3.0)
    vix_amp = torch.clamp_min((vx - 25.0) / 30.0, 0.0)
    pjump = torch.clamp(g2(JP_BASE) + 0.008 * vix_amp + 0.003 * liq_n,
                        0.0, 0.01)
    if not first:
        jump_on = _f(dr.u_jump[t] < pjump)
    signed_jump = jump_on * dr.t5[t] * g2(JP_SCALE)
    spy_a = torch.clamp(spy_w - signed_jump, -0.95, 3.0)
    qqq_a = torch.clamp(qqq_w - 1.12 * signed_jump, -0.95, 4.0)

    risk_free = torch.clamp(ir, 0.0, 20.0) / 100.0
    term = 1.25 - 1.1 * torch.clamp(cred_n, 0.0, 3.0)
    inv_curve = torch.clamp_min(-term, 0.0)
    stress_v = torch.clamp_min(vx - 20.0, 0.0)
    spread = (spa[F_BASE] + spa[F_BVIX] * stress_v
              + spa[F_BINV] * inv_curve
              + spa[F_BLIQ] * torch.clamp(liq_n, 0.0, 3.0)
              + spa[F_BCRED] * torch.clamp(cred_n, 0.0, 3.0))
    spread = torch.minimum(torch.maximum(spread, spa[F_MIN]), spa[F_MAX])
    vix_mult = torch.clamp(torch.sqrt(vx / 20.0), 0.5, 1.5)
    regime_mult = 1.0 + 0.15 * reg
    return DayStress(liq_n, cred_n, jump_on, spy_a, qqq_a, risk_free,
                     spread, vix_mult, regime_mult)


def asset_day(ap, a: int, src, d: DayStress, t_te, first: bool, te, bias):
    """Asset a's unbounded net return of the day, and its new tracking-
    error and EMA-bias carries (compose_day.cuh's ``asset_day``). ``src``:
    the return of the asset's underlying stream; ``t_te``: the day's
    tracking-error draw."""
    und = src * ap[C_BETA, a]
    lev = ap[C_LEV, a]
    borrow = (torch.clamp_min(lev - 1.0, 0.0)
              * torch.clamp_min(d.risk_free + d.spread, 0.0) / 252.0)
    lev_ret = lev * und - ap[C_ER, a] / 252.0 - borrow
    negu = _f(und < 0)
    move = ((1.0 + 0.3 * torch.abs(und))
            * (ap[C_DOWNSIDE, a] * negu + 0.98 * (1.0 - negu)))
    innov_te = t_te * ap[C_TE_SCALE, a] * d.vix_mult * d.regime_mult
    if first:
        te_n = torch.zeros_like(und)
    else:
        te_n = ap[C_RHO, a] * te + ap[C_SQ, a] * innov_te * move
    bias_n = EMA_ALPHA * te_n + (1.0 - EMA_ALPHA) * bias
    cap = ap[C_CLIP, a]
    safe = torch.clamp_min(cap, 1e-6)
    raw = te_n - bias_n
    mclip = _f(cap > 0)
    te_out = mclip * (safe * torch.tanh(raw / safe)) + (1.0 - mclip) * raw
    return lev_ret + te_out, te_n, bias_n


def underlying(d: DayStress, tlt_w, a: int):
    """The return stream asset a is levered on (SPY, QQQ after the jump, or
    TLT)."""
    return (d.spy_a, d.qqq_a, tlt_w)[UND_IDX[a]]
