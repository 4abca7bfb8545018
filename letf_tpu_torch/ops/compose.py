"""Cost composition: stress, funding, leverage and tracking error (kernel K5).

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

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import _build
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.joint import box_muller

LAUNCHES = 0            # kernel launches by compose_generate on CUDA tensors

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
    return mask.to(torch.float32)


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


def compose_plain(sp, ap, ids, seed_words, spy, qqq, tlt, vix, irx, regime):
    """Plain PyTorch K5: the kernel's day loop, one [B] tensor per value.
    Returns (etf [6, S, B], spy_adj, qqq_adj, cash [S, B], jump_count,
    liq_sum, cred_sum [B]), all float32."""
    S, B = spy.shape
    dr = draws(ids, seed_words, S, range(NA))
    spa, spd = sp[:, 0], sp[:, 1] - sp[:, 0]
    f32 = dict(dtype=torch.float32, device=spy.device)
    etf = torch.empty((NA, S, B), **f32)
    spy_adj, qqq_adj, cash = (torch.empty((S, B), **f32) for _ in range(3))
    zeros = torch.zeros(B, **f32)
    liq = cred = jc = ls = cs = zeros
    te = [zeros] * NA
    bias = [zeros] * NA
    for t in range(S):
        reg = regime[t]
        d = stress_day(spa, spd, dr, t, liq, cred, spy[t], qqq[t], vix[t],
                       irx[t], reg)
        jc = jc + d.jump_on
        ls = ls + d.liq_n
        cs = cs + d.cred_n
        liq, cred = d.liq_n, d.cred_n
        for a in range(NA):
            e, te[a], bias[a] = asset_day(ap, a, underlying(d, tlt[t], a), d,
                                          dr.t_te[a][t], t == 0, te[a],
                                          bias[a])
            etf[a, t] = torch.clamp(e, -0.999, 10.0)
        spy_adj[t] = d.spy_a
        qqq_adj[t] = d.qqq_a
        cash[t] = (spa[CASH_RATE] + spd[CASH_RATE] * reg) / 252.0
    return etf, spy_adj, qqq_adj, cash, jc, ls, cs


def kernel_consts(device) -> torch.Tensor:
    """Float table of the constants csrc/compose.cu reads, in its enum's
    order; formed in float64 and rounded once, as the plain version's
    Python scalars are."""
    vals = [EMA_ALPHA, 1.0 - EMA_ALPHA, *UND_IDX,
            *(float(d) for d in TE_DFS), *(-2.0 / float(d) for d in TE_DFS)]
    return torch.tensor(vals, dtype=torch.float64).to(device=device,
                                                      dtype=torch.float32)


def compose_generate(sp, ap, ids, seed_words, spy, qqq, tlt, vix, irx,
                     regime):
    """K5 on the device of the inputs: the CUDA kernel for CUDA tensors
    (ids int32), ``compose_plain`` for CPU tensors. Same returns as
    ``compose_plain``."""
    global LAUNCHES
    if spy.device.type == "cpu":
        return compose_plain(sp, ap, ids, seed_words, spy, qqq, tlt, vix,
                             irx, regime)
    S, B = spy.shape
    dev = spy.device
    chans = dict(spy=spy, qqq=qqq, tlt=tlt, vix=vix, irx=irx, regime=regime)
    for k, v in chans.items():
        if v.shape != (S, B):
            raise ValueError(f"compose_generate: {k} {tuple(v.shape)}")
    if sp.shape != (16, 2) or ap.shape != (9, NA) or ids.shape != (B,):
        raise ValueError("compose_generate: sp [16, 2], ap [9, A], ids [B]")
    _build.check_cuda("compose_generate", dev,
                      sp=(sp, torch.float32), ap=(ap, torch.float32),
                      ids=(ids, torch.int32),
                      **{k: (v, torch.float32) for k, v in chans.items()})
    kc = kernel_consts(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    etf = torch.empty((NA, S, B), **f32)
    spy_adj, qqq_adj, cash = (torch.empty((S, B), **f32) for _ in range(3))
    sums = torch.empty((3, B), **f32)
    rc = _build.library().letf_compose(
        sp.data_ptr(), ap.data_ptr(), kc.data_ptr(), ids.data_ptr(),
        int(seed_words[0]) & rng.MASK32, int(seed_words[1]) & rng.MASK32,
        *(v.data_ptr() for v in chans.values()), S, B, etf.data_ptr(),
        spy_adj.data_ptr(), qqq_adj.data_ptr(), cash.data_ptr(),
        sums.data_ptr(), _build.stream_of(spy))
    _build.check(rc, "letf_compose")
    LAUNCHES += 1
    return etf, spy_adj, qqq_adj, cash, sums[0], sums[1], sums[2]
