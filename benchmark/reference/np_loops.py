"""The reference's day loops in NumPy: K1's joint generation, K3's
composition with signals and strategies, and K4's strategies over signal
channels, each day a step over [B] float32 arrays.

They are the frozen PyTorch day loops of ``joint.py``, ``compose.py``,
``compose_strategies.py`` and ``strategies.py`` with each ``torch`` call
replaced by its NumPy counterpart (``clamp`` by ``clip``, ``clamp_min`` by
``maximum``; both keep NaN), so that a day costs NumPy's per-call overhead
rather than torch's: the comparison of a run recomputes 30-year trials
day by day on the host. The counter draws are drawn for all days at once
by the frozen PyTorch code. ``test_bench_reference.py`` holds these loops
to the PyTorch ones; the control (``precision.lowered``) runs the PyTorch
ones in bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import compose as _cp
from benchmark.reference.compose import (
    C_BETA, C_CLIP, C_DOWNSIDE, C_ER, C_LEV, C_RHO, C_SQ, C_TE_SCALE,
    CASH_RATE, CRED_MU, CRED_PHI, CRED_SIG, EMA_ALPHA, F_BASE, F_BCRED,
    F_BINV, F_BLIQ, F_BVIX, F_MAX, F_MIN, JP_BASE, JP_SCALE, LIQ_MU,
    LIQ_PHI, LIQ_SIG, UND_IDX, Draws)
from benchmark.reference.compose_strategies import (
    FLT_MIN, NS, POS_CASH, POS_RISKY, POS_SAFE, RW_P, RW_S20, RW_SPY, RW_X,
    SIGNALS, SPREAD, SQ252, SUMS, TURNOVER_EPS, W6A, W6B, _needed, consts)
from benchmark.reference.joint import (
    ALPHA, BETA, DCC_A, DCC_B, DSTD, IRXB, LV0, LV1, LV2, MU0, MU1, MU2, NU,
    RB00, RB01, RB02, RB11, RB12, RB22, VBASE, VJSCL, VJTHR, VNOISE, VPHI,
    VTGT, six_normals)
from benchmark.reference import rng
from benchmark.reference.strategies import N_FUSED


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def draws(ids, seed_words, S: int, assets) -> Draws:
    """``compose.draws`` of days 0..S-1 as float32 arrays."""
    dr = _cp.draws(torch.as_tensor(_np(ids)), seed_words, S, assets)
    return Draws(*(_np(x).astype(np.float32) for x in dr[:4]),
                 {a: _np(x).astype(np.float32) for a, x in dr.t_te.items()})


def joint_draws(ids, signs, seed_words, T: int):
    """K1's six counter normals of every (day, trial), [T, B] float32 each,
    the joint normals signed for antithetic trials."""
    ids_t = torch.as_tensor(_np(ids))
    dk = rng.day_keys(rng.lane_keys(ids_t, seed_words), torch.arange(T),
                      seed_words)
    out = [_np(x).astype(np.float32) for x in six_normals(dk)]
    s = _np(signs).astype(np.float32)[None, :]
    return [x * s if c < 3 else x for c, x in enumerate(out)]


class DayStress(NamedTuple):
    liq_n: np.ndarray
    cred_n: np.ndarray
    jump_on: np.ndarray
    spy_a: np.ndarray
    qqq_a: np.ndarray
    risk_free: np.ndarray
    spread: np.ndarray
    vix_mult: np.ndarray
    regime_mult: np.ndarray


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
        jump_on = np.zeros_like(vx)
    else:
        liq_n = _clip(lmu + g2(LIQ_PHI) * (liq - lmu)
                            + g2(LIQ_SIG) * dr.n_liq[t], 0.0, 3.0)
        cred_n = _clip(cmu + g2(CRED_PHI) * (cred - cmu)
                             + g2(CRED_SIG) * dr.n_cred[t], 0.0, 3.0)
    vix_amp = np.maximum((vx - 25.0) / 30.0, 0.0)
    pjump = _clip(g2(JP_BASE) + 0.008 * vix_amp + 0.003 * liq_n,
                        0.0, 0.01)
    if not first:
        jump_on = _f(dr.u_jump[t] < pjump)
    signed_jump = jump_on * dr.t5[t] * g2(JP_SCALE)
    spy_a = _clip(spy_w - signed_jump, -0.95, 3.0)
    qqq_a = _clip(qqq_w - 1.12 * signed_jump, -0.95, 4.0)

    risk_free = _clip(ir, 0.0, 20.0) / 100.0
    term = 1.25 - 1.1 * _clip(cred_n, 0.0, 3.0)
    inv_curve = np.maximum(-term, 0.0)
    stress_v = np.maximum(vx - 20.0, 0.0)
    spread = (spa[F_BASE] + spa[F_BVIX] * stress_v
              + spa[F_BINV] * inv_curve
              + spa[F_BLIQ] * _clip(liq_n, 0.0, 3.0)
              + spa[F_BCRED] * _clip(cred_n, 0.0, 3.0))
    spread = np.minimum(np.maximum(spread, spa[F_MIN]), spa[F_MAX])
    vix_mult = _clip(np.sqrt(vx / 20.0), 0.5, 1.5)
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
    borrow = (np.maximum(lev - 1.0, 0.0)
              * np.maximum(d.risk_free + d.spread, 0.0) / 252.0)
    lev_ret = lev * und - ap[C_ER, a] / 252.0 - borrow
    negu = _f(und < 0)
    move = ((1.0 + 0.3 * np.abs(und))
            * (ap[C_DOWNSIDE, a] * negu + 0.98 * (1.0 - negu)))
    innov_te = t_te * ap[C_TE_SCALE, a] * d.vix_mult * d.regime_mult
    if first:
        te_n = np.zeros_like(und)
    else:
        te_n = ap[C_RHO, a] * te + ap[C_SQ, a] * innov_te * move
    bias_n = EMA_ALPHA * te_n + (1.0 - EMA_ALPHA) * bias
    cap = ap[C_CLIP, a]
    safe = np.maximum(cap, 1e-6)
    raw = te_n - bias_n
    mclip = _f(cap > 0)
    te_out = mclip * (safe * np.tanh(raw / safe)) + (1.0 - mclip) * raw
    return lev_ret + te_out, te_n, bias_n


def underlying(d: DayStress, tlt_w, a: int):
    """The return stream asset a is levered on (SPY, QQQ after the jump, or
    TLT)."""
    return (d.spy_a, d.qqq_a, tlt_w)[UND_IDX[a]]


def _f(mask):
    return mask.astype(np.float32)


def _asel(m, a, b):
    """Arithmetic select for finite operands: m*a + (1-m)*b."""
    return m * a + (1.0 - m) * b


def _bsel(m, a, b):
    """Bitwise select (NaN-safe), m a 0/1 mask."""
    return np.where(m != 0, a, b)


def _guard(v, eps, default):
    m = _f(v >= eps)
    return m, _bsel(m, v, np.float32(default))


def _rdiv(c: float, x):
    """c / x correctly rounded: torch computes a Python scalar divided by a
    tensor as a reciprocal times the scalar (two roundings), the kernels
    and the reference divide."""
    return np.float32(c) / x


def _clip(x, lo, hi):
    """np.clip in two ufunc calls (NaN passes through both)."""
    return np.minimum(np.maximum(x, lo), hi)


def _ruin_floor(e):
    """Equity below float32's smallest normal is ruin (0). The reference
    runs with subnormals flushed to zero (TPU and XLA:CPU alike), so an
    equity that underflows there is 0 for good; IEEE arithmetic would keep
    a subnormal equity that later recovers. NaN passes through."""
    return np.where(e < FLT_MIN, np.zeros_like(e), e)


class SignalCarry:
    """The fused signal pass's carries: running window sums and the rings
    (x 64, spy 128, price 256, std20 8 days), [B] / [W, B] float32."""

    def __init__(self, B):
        zeros = np.zeros(B, np.float32)
        self.sums = {k: zeros for k in SUMS}
        self.ring_x = np.zeros((RW_X, B), np.float32)
        self.ring_spy = np.zeros((RW_SPY, B), np.float32)
        self.ring_p = np.zeros((RW_P, B), np.float32)
        self.ring_s20 = np.zeros((RW_S20, B), np.float32)


def signals_step(sc: SignalCarry, t: int, prev_price, r_tqqq, r_spy):
    """Today's 16 signals {name: [B]} (SIGNALS) from today's TQQQ and SPY
    returns, ``prev_price`` yesterday's SPY price signal (csrc/
    strategies_day.cuh::signals_day); updates the sums and rings."""
    first = t == 0
    nan_t = np.full_like(r_spy, math.nan)
    if first:
        price = np.float32(100.0) * (1.0 + r_spy)
    else:
        price = prev_price * (1.0 + r_spy)
    x = r_tqqq
    neg = np.minimum(x, 0.0)

    def rd(ring, W, lag):
        return ring[(t - lag) & (W - 1)]

    def leave(lag):
        return 1.0 if t >= lag else 0.0

    x5, x10, x20, x60 = (rd(sc.ring_x, RW_X, L) for L in (5, 10, 20, 60))
    spy126 = rd(sc.ring_spy, RW_SPY, 126)
    p100, p200 = rd(sc.ring_p, RW_P, 100), rd(sc.ring_p, RW_P, 200)
    p14, p15 = rd(sc.ring_p, RW_P, 14), rd(sc.ring_p, RW_P, 15)
    s20l5 = rd(sc.ring_s20, RW_S20, 5)
    sums = sc.sums

    def upd(name, add, sub_v, lag):
        sums[name] = sums[name] + add - leave(lag) * sub_v
        return sums[name]

    s1_5 = upd("s1_5", x, x5, 5)
    s2_5 = upd("s2_5", x * x, x5 * x5, 5)
    s1_10 = upd("s1_10", x, x10, 10)
    s2_10 = upd("s2_10", x * x, x10 * x10, 10)
    s1_20 = upd("s1_20", x, x20, 20)
    s2_20 = upd("s2_20", x * x, x20 * x20, 20)
    s1_60 = upd("s1_60", x, x60, 60)
    s2_60 = upd("s2_60", x * x, x60 * x60, 60)
    s3_60 = upd("s3_60", x * x * x, x60 * x60 * x60, 60)
    ng20 = np.minimum(x20, 0.0)
    n1_20 = upd("n1_20", neg, ng20, 20)
    n2_20 = upd("n2_20", neg * neg, ng20 * ng20, 20)
    spy1_126 = upd("spy1_126", r_spy, spy126, 126)
    p1_100 = upd("p1_100", price, p100, 100)
    p1_200 = upd("p1_200", price, p200, 200)
    delta = np.zeros_like(price) if first else price - prev_price
    sub_d = leave(15) * (p14 - p15)
    g1_14 = upd("g1_14", np.maximum(delta, 0.0),
                np.maximum(sub_d, 0.0), 0)
    l1_14 = upd("l1_14", np.maximum(-delta, 0.0),
                np.maximum(-sub_d, 0.0), 0)

    tn = float(t) + 1.0

    def nn(w):
        return min(tn, float(w))

    def gate(min_t, v):
        """min_periods gate: v from day min_t on, NaN before."""
        return v if t >= min_t else nan_t

    def wstd(s1, s2, w, min_t):
        n = nn(w)
        mean = s1 / n
        var = (np.maximum(s2 - n * mean * mean, 0.0)
               / max(n - 1.0, 1.0))
        return gate(min_t, np.sqrt(var) * SQ252)

    cur = {"spy_price": price}
    cur["std5"] = wstd(s1_5, s2_5, 5, 1)
    cur["std10"] = wstd(s1_10, s2_10, 10, 1)
    cur["std20"] = wstd(s1_20, s2_20, 20, 1)
    cur["std60"] = wstd(s1_60, s2_60, 60, 1)
    cur["std20_mp20"] = wstd(s1_20, s2_20, 20, 19)
    cur["dstd20"] = wstd(n1_20, n2_20, 20, 1)
    cur["dstd20_mp20"] = wstd(n1_20, n2_20, 20, 19)
    n60 = nn(60)
    mean60 = s1_60 / n60
    cur["mean60"] = mean60 * 252.0
    m2 = np.maximum(s2_60 - n60 * mean60 * mean60, 0.0)
    m3 = (s3_60 - 3.0 * mean60 * s2_60
          + 2.0 * n60 * mean60 * mean60 * mean60)
    var60 = m2 / max(n60 - 1.0, 1.0)
    sd60 = np.sqrt(var60)
    denom = (max(n60 - 1.0, 1.0) * max(n60 - 2.0, 1.0)
             * sd60 * sd60 * sd60)
    skew_ok = (1.0 if t >= 2 else 0.0) * _f(sd60 > 0.0)
    cur["skew60"] = _bsel(
        skew_ok, n60 * m3 / np.maximum(denom, 1e-37), nan_t)
    cur["volmom5"] = gate(5, cur["std20"] / s20l5 - 1.0)
    cur["sum126"] = spy1_126
    cur["sma200_mp1"] = p1_200 / nn(200)
    cur["sma200"] = gate(199, p1_200 / nn(200))
    cur["sma100_mp1"] = p1_100 / nn(100)
    rs = g1_14 / l1_14
    cur["rsi14"] = gate(13, 100.0 - _rdiv(100.0, 1.0 + rs))

    sc.ring_x[t & (RW_X - 1)] = x
    sc.ring_spy[t & (RW_SPY - 1)] = r_spy
    sc.ring_p[t & (RW_P - 1)] = price
    sc.ring_s20[t & (RW_S20 - 1)] = cur["std20"]
    return cur


class StrategyCarry:
    """The 19 strategies' carries, [B] float32 each (equity, previous
    allocation, trade counts, running max, max drawdown per strategy; the
    S4/S5/S8 positions, S6's sleeves and embedded leverages; yesterday's VIX
    and signals)."""

    def __init__(self, B):
        C = consts()
        IC = C["initial_capital"]
        zeros = np.zeros(B, np.float32)
        nan_t = np.full(B, np.nan, np.float32)
        self.eq = [zeros + IC for _ in range(NS)]
        self.pa = [zeros for _ in range(NS)]
        self.tr = [zeros for _ in range(NS)]
        self.rm = [zeros + IC for _ in range(NS)]
        self.dd = [zeros for _ in range(NS)]
        self.pos4 = self.pos5 = zeros
        self.pos8 = zeros + POS_CASH
        self.s6p0, self.s6p1 = zeros + IC * W6A, zeros + IC * W6B
        self.s6e0 = zeros + C["s6_lev_a"]
        self.s6e1 = zeros + C["s6_lev_b"]
        self.pvix = nan_t
        self.psig = {k: nan_t for k in SIGNALS}

    def summary(self):
        """(final_wealth [B, 19], num_trades [B, 19] int32, max_dd)."""
        return (np.stack(self.eq, 1),
                np.stack(self.tr, 1).astype(np.int32),
                np.stack(self.dd, 1))


def strategies_step(st: StrategyCarry, t: int, r_tqqq, r_spy, r_sso, r_tmf,
                    cashr, reg, vx, cur, cft, apply_costs: bool = True):
    """One day of the 19 strategies (csrc/strategies_day.cuh::
    strategies_day). ``cur``: today's signals {name: [B]} (S7 reads its vol
    signal unshifted, the others yesterday's, ``st.psig``); ``cft``: the
    day's cashflow (a float or a 0-d tensor). Rolls the shift(1) values."""
    C = consts()
    SP0, SP1 = C["spread_bps0"], C["spread_bps1"]
    RCPD, TQQQ_LEV = C["rebalance_cost"], C["tqqq_lev"]
    L6A, L6B = C["s6_lev_a"], C["s6_lev_b"]
    first = t == 0
    eq, pa, tr, rm, dd = st.eq, st.pa, st.tr, st.rm, st.dd
    pos4, pos5, pos8 = st.pos4, st.pos5, st.pos8
    s6p0, s6p1, s6e0, s6e1 = st.s6p0, st.s6p1, st.s6e0, st.s6e1
    vix_prev = st.pvix
    psig = st.psig
    pp = psig["spy_price"]                         # NaN on day 0

    def prev(name):
        return psig[name]

    rets = [None] * NS
    traded = [None] * NS
    pa_new = [None] * NS

    # ---- S1-S3 benchmarks ----
    for i, rb in enumerate((r_tqqq, r_spy, r_sso)):
        rets[i] = rb
        traded[i] = np.zeros_like(rb)
        pa_new[i] = pa[i]

    # ---- S4/S5 SMA state machines ----
    if first:
        new4, new5 = pos4, pos5
        flip4 = flip5 = np.zeros_like(pos4)
    else:
        sma1 = prev("sma200_mp1")
        buy4, sell4 = _f(pp >= sma1), _f(pp < sma1)
        new4 = _asel(_f(pos4 == 1.0), 1.0 - sell4, buy4)
        flip4 = _f(new4 != pos4)
        thresh5 = sma1 * (1.0 - 0.02)
        buy5, sell5 = _f(pp >= thresh5), _f(pp < thresh5)
        new5 = _asel(_f(pos5 == 1.0), 1.0 - sell5, buy5)
        flip5 = _f(new5 != pos5)
    sma_cost = ((SP0 + (SP1 - SP0) * reg) / 10000.0
                + RCPD * TQQQ_LEV * np.abs(r_tqqq))
    for i, (newp, flip) in enumerate(((new4, flip4), (new5, flip5))):
        ret_s = _asel(newp, r_tqqq, cashr)
        if apply_costs:
            ret_s = ret_s - flip * sma_cost
        rets[3 + i] = ret_s
        traded[3 + i] = flip
        pa_new[3 + i] = pa[3 + i]

    # ---- S6 60/40 TQQQ/TMF with leverage-drift turnover ----
    pg0 = s6p0 * (1.0 + r_tqqq)
    pg1 = s6p1 * (1.0 + r_tmf)
    u6a, u6b = r_tqqq / L6A, r_tmf / L6B
    den_a, den_b = 1.0 + L6A * u6a, 1.0 + L6B * u6b
    ma, mb = _f(np.abs(den_a) > 0.01), _f(np.abs(den_b) > 0.01)
    emb0 = _asel(ma, L6A * (1.0 + u6a)
                 / _bsel(ma, den_a, np.float32(1.0)), L6A)
    emb1 = _asel(mb, L6B * (1.0 + u6b)
                 / _bsel(mb, den_b, np.float32(1.0)), L6B)
    total6 = pg0 + pg1
    rebf = 1.0 if (t % 21 == 0 and t > 0) else 0.0
    inv_t6 = _rdiv(1.0, np.maximum(total6, 1e-30))
    cw0, cw1 = pg0 * inv_t6, pg1 * inv_t6
    w_turn = np.abs(cw0 - W6A) + np.abs(cw1 - W6B)
    lev_turn = (np.abs(emb0 - L6A) / L6A * cw0
                + np.abs(emb1 - L6B) / L6B * cw1)
    tot_turn = w_turn + lev_turn
    do_cost = (rebf * _f(tot_turn > 0.01) if apply_costs
               else np.zeros_like(tot_turn))
    total_after = _asel(do_cost, total6 * (1.0 - tot_turn * RCPD),
                        total6)
    if first:
        s6p0n, s6p1n, s6e0n, s6e1n = s6p0, s6p1, s6e0, s6e1
        equity6 = eq[5]
        traded[5] = np.zeros_like(pg0)
    else:
        s6p0n = _asel(rebf, total_after * W6A, pg0)
        s6p1n = _asel(rebf, total_after * W6B, pg1)
        s6e0n = _asel(rebf, L6A, emb0)
        s6e1n = _asel(rebf, L6B, emb1)
        equity6 = total_after
        traded[5] = np.full_like(pg0, rebf)
    rets[5] = np.zeros_like(pg0)
    pa_new[5] = pa[5]

    def vol_family(i, alloc, include_cash=True):
        turnover = np.abs(alloc - pa[i])
        trm = _f(turnover > TURNOVER_EPS)
        ret = (alloc * r_tqqq + (1.0 - alloc) * cashr if include_cash
               else alloc * r_tqqq)
        if apply_costs:
            ret = ret - trm * turnover * SPREAD
        return ret, trm

    # ---- S7 vol targeting 20% (no cash on the idle fraction) ----
    m7, v7 = _guard(cur["std20_mp20"], 0.01, 1.0)
    pos7 = _asel(m7, _clip(_rdiv(0.20, v7), 0.2, 2.0), 1.0)
    rets[6], traded[6] = vol_family(6, pos7, include_cash=False)
    pa_new[6] = pos7

    # ---- S8 composite regime (TQQQ / SPY / cash; no costs) ----
    if first:
        target8 = pos8
        rets[7] = np.zeros_like(pos8)
        traded[7] = np.zeros_like(pos8)
    else:
        rsi8 = prev("rsi14")
        sc = (_f(pp > prev("sma200")) + _f((rsi8 > 40.0) & (rsi8 < 80.0))
              + _f(vix_prev < 25.0))
        target8 = _asel(_f(sc == 3.0), POS_RISKY,
                        _asel(_f(sc == 2.0), POS_SAFE, POS_CASH))
        rets[7] = _asel(_f(target8 == POS_RISKY), r_tqqq,
                        _asel(_f(target8 == POS_SAFE), r_spy, cashr))
        traded[7] = _f(target8 != pos8)
    pa_new[7] = pa[7]

    # ---- S9 adaptive vol target (skips NaN days entirely) ----
    v9r, sma9 = prev("std20_mp20"), prev("sma200")
    ok9 = _f(v9r >= 0.001) * _f(~np.isnan(sma9))
    target_v9 = _asel(_f(pp > sma9), 0.35, 0.12)
    v9 = _bsel(ok9, v9r, np.float32(1.0))
    alloc9 = _asel(ok9, _clip(target_v9 / v9, 0.0, 1.0), pa[8])
    ret9, tr9 = vol_family(8, alloc9)
    rets[8], traded[8], pa_new[8] = ret9 * ok9, tr9 * ok9, alloc9

    # ---- S10 Sortino (downside vol target) ----
    m10, dv10 = _guard(prev("dstd20_mp20"), 0.001, 1.0)
    alloc10 = _asel(m10, _clip(_rdiv(0.15, dv10), 0.0, 1.5), 1.0)
    rets[9], traded[9] = vol_family(9, alloc10)
    pa_new[9] = alloc10

    # ---- S11 hyper-convex ----
    _, v11 = _guard(prev("std20"), 0.001, 0.5)
    alloc11 = _rdiv(0.25, v11)
    alloc11 = _asel(_f(pp > prev("sma200_mp1")), alloc11 ** 1.2, alloc11)
    alloc11 = _clip(alloc11, 0.0, 1.0)
    rets[10], traded[10] = vol_family(10, alloc11)
    pa_new[10] = alloc11

    # ---- S12 vol velocity (max of fast/slow vols) ----
    _, v12 = _guard(np.maximum(prev("std20"), prev("std5")),
                    0.001, 0.5)
    alloc12 = _clip(_rdiv(0.22, v12), 0.0, 1.0)
    rets[11], traded[11] = vol_family(11, alloc12)
    pa_new[11] = alloc12

    # ---- S13 vol-of-vol momentum ----
    _, v13 = _guard(prev("std20"), 0.001, 0.5)
    vm13 = prev("volmom5")
    alloc13 = _rdiv(0.25, v13)
    alloc13 = _asel(_f(vm13 < -0.10), alloc13 * 1.2, alloc13)
    alloc13 = _asel(_f(vm13 > 0.10), alloc13 * 0.7, alloc13)
    alloc13 = _clip(alloc13, 0.0, 1.0)
    rets[12], traded[12] = vol_family(12, alloc13)
    pa_new[12] = alloc13

    # ---- S14 skewness-adjusted convex ----
    _, v14 = _guard(prev("std20"), 0.001, 0.5)
    s14 = prev("skew60")
    alloc14 = _rdiv(0.25, v14)
    alloc14 = _asel(_f(s14 > 0.0), alloc14 ** 1.3, alloc14)
    alloc14 = _asel(_f(s14 < -0.5), alloc14 * 0.5, alloc14)
    alloc14 = _clip(alloc14, 0.0, 1.0)
    rets[13], traded[13] = vol_family(13, alloc14)
    pa_new[13] = alloc14

    # ---- S15 meta-ensemble ----
    _, dv15 = _guard(prev("dstd20"), 0.001, 0.25)
    alloc15 = _rdiv(0.28, dv15)
    alloc15 = _asel(_f(pp > prev("sma200_mp1")), alloc15 ** 1.2, alloc15)
    brake15 = _f(prev("std5") > 1.5 * prev("std20"))
    alloc15 = _asel(brake15, alloc15 * 0.5, alloc15)
    alloc15 = _clip(alloc15, 0.0, 1.0)
    rets[14], traded[14] = vol_family(14, alloc15)
    pa_new[14] = alloc15

    # ---- S16 crisis alpha (regime asymmetric) ----
    vr16 = prev("std5") / prev("std60")
    crisis16 = np.minimum(_f(vx > 25.0) + _f(vr16 > 1.5), 1.0)
    target16 = _asel(crisis16, 0.08, 0.30)
    m16, rv16 = _guard(prev("std5"), 0.001, 1.0)
    alloc16 = _asel(m16, _clip(target16 / rv16, 0.0, 1.2), 0.5)
    rets[15], traded[15] = vol_family(15, alloc16)
    pa_new[15] = alloc16

    # ---- S17 tail-risk optimizer (skew-aware Kelly) ----
    _, vol17 = _guard(prev("std20"), 0.001, 0.25)
    dvol17 = _bsel(_f(prev("dstd20") >= 0.001), prev("dstd20"),
                   vol17 * 0.6)
    skew17 = _bsel(_f(~np.isnan(prev("skew60"))), prev("skew60"),
                   np.zeros_like(vol17))
    mean17 = _bsel(_f(~np.isnan(prev("mean60"))), prev("mean60"),
                   np.float32(0.08))
    sneg5, sneg0 = _f(skew17 < -0.5), _f(skew17 < 0.0)
    spos5 = _f(skew17 > 0.5)
    eff17 = _asel(sneg5, dvol17 * 1.5,
                  _asel(sneg0, dvol17 * 1.2,
                        _asel(spos5, vol17 * 0.9, vol17)))
    pen17 = _asel(sneg5, 0.6, _asel(sneg0, 0.8, _asel(spos5, 1.2, 1.0)))
    kelly17 = _asel(_f(eff17 > 0.01),
                    _clip((mean17 - 0.03) / (eff17 * eff17) * 0.7,
                          0.2, 2.0), 1.0)
    alloc17 = _clip(_rdiv(0.30, eff17) * pen17 * (kelly17 / 1.5), 0.0, 1.5)
    rets[16], traded[16] = vol_family(16, alloc17)
    pa_new[16] = alloc17

    # ---- S18 momentum-vol convergence ----
    mom18 = _bsel(_f(~np.isnan(prev("sum126"))), prev("sum126"),
                  np.zeros_like(vx))
    _, vf18 = _guard(prev("std10"), 0.001, 0.30)
    _, vs18 = _guard(prev("std60"), 0.001, 0.25)
    mm18 = _asel(_f(mom18 > 0.05), 1.3, _asel(_f(mom18 > 0.0), 1.0, 0.5))
    vr18 = vf18 / vs18
    out_band = np.minimum(_f(vr18 < 0.8) + _f(vr18 > 1.3), 1.0)
    vm18 = _asel(_f(vr18 < 0.8), 1.2, _asel(_f(vr18 > 1.3), 0.6, 1.0))
    eff18 = _asel(out_band, vf18, vs18)
    alloc18 = _clip(0.28 * mm18 * vm18 / eff18, 0.0, 1.5)
    rets[17], traded[17] = vol_family(17, alloc18)
    pa_new[17] = alloc18

    # ---- S19 conviction compounder (5% rebalance threshold) ----
    mom19 = _bsel(_f(~np.isnan(prev("sum126"))), prev("sum126"),
                  np.zeros_like(vx))
    _, dv19 = _guard(prev("dstd20"), 0.001, 0.20)
    _, vf19 = _guard(prev("std5"), 0.001, 0.30)
    _, vs19 = _guard(prev("std60"), 0.001, 0.25)
    mom_score = _asel(_f(mom19 > 0.15), 1.0,
                      _asel(_f(mom19 > 0.05), 0.7,
                            _asel(_f(mom19 > 0.0), 0.4, 0.0)))
    trend_score = _f(pp > prev("sma100_mp1")) * 0.5
    vr19 = vf19 / vs19
    vol_score = _asel(_f(vr19 < 0.9), 0.5,
                      _asel(_f(vr19 < 1.2), 0.3, 0.0))
    conviction = mom_score + trend_score + vol_score
    cand19 = _clip(_rdiv(0.32, dv19) * (0.3 + conviction * 0.55), 0.0, 1.5)
    turn19 = np.abs(cand19 - pa[18])
    rebal19 = _f(turn19 > 0.05)
    alloc19 = _asel(rebal19, cand19, pa[18])
    ret19 = alloc19 * r_tqqq + (1.0 - alloc19) * cashr
    if apply_costs:
        ret19 = ret19 - rebal19 * turn19 * SPREAD
    rets[18], traded[18], pa_new[18] = ret19, rebal19, alloc19

    # ---- combine: equity, cashflow overlay + ruin floor, drawdown ----
    eq_new = [eq[i] if (first and i >= 3) else eq[i] * (1.0 + rets[i])
              for i in range(NS)]
    eq_new[5] = equity6
    pre5 = eq_new[5]
    eq_new = [_ruin_floor(e + cft) for e in eq_new]
    s6_scale = eq_new[5] / np.maximum(pre5, 1e-30)
    s6p0n = s6p0n * s6_scale
    s6p1n = s6p1n * s6_scale
    for i in range(NS):
        if first:
            rm[i] = eq_new[i]
            eq[i] = eq_new[i]
            continue
        tr[i] = tr[i] + (traded[i] * 2.0 if i == 5 else traded[i])
        rm_new = np.maximum(rm[i], eq_new[i])
        safe_rm = _asel(_f(rm_new > 0.0), np.maximum(rm_new, 1e-30),
                        1.0)
        ddv = (eq_new[i] - rm_new) / safe_rm
        dd[i] = np.maximum(dd[i], -ddv)
        rm[i] = rm_new
        eq[i] = eq_new[i]
        pa[i] = pa_new[i]
    if not first:
        st.pos4, st.pos5, st.pos8 = new4, new5, target8
    st.s6p0, st.s6p1, st.s6e0, st.s6e1 = s6p0n, s6p1n, s6e0n, s6e1n

    # ---- roll the shift(1) values ----
    st.pvix = vx
    st.psig = cur


def compose_strategies_plain(sp, ap, ids, seed_words, spy, qqq, tlt, vix,
                             irx, regime, cashflows=None,
                             apply_costs: bool = True):
    """Plain NumPy K3: the kernel's day body, one [B] float32 array per value:
    the composition (ops/compose.py), then ``signals_step`` and
    ``strategies_step``."""
    S, B = spy.shape
    C = consts()
    needed = _needed(C)
    zeros = np.zeros(B, np.float32)

    # Counter draws of every day at once (pure functions of (trial, day)).
    dr = draws(ids, seed_words, S, needed)
    spa, spd = sp[:, 0], sp[:, 1] - sp[:, 0]
    cf = cashflows.astype(np.float32) if cashflows is not None else None

    st = StrategyCarry(B)
    sig = SignalCarry(B)
    liq = cred = zeros
    te = {a: zeros for a in needed}
    bias = {a: zeros for a in needed}
    jc = ls = cs = zeros
    fin = zeros + 1.0
    vmin = zeros + math.inf
    vmax = zeros - math.inf
    rhi = zeros

    for t in range(S):
        first = t == 0
        spy_w, qqq_w, tlt_w = spy[t], qqq[t], tlt[t]
        vx, ir, reg = vix[t], irx[t], regime[t]
        vmin = np.minimum(vmin, vx)
        vmax = np.maximum(vmax, vx)
        rhi = rhi + reg

        # ---- stress + crisis jumps + funding (ops/compose.py) ----
        d = stress_day(spa, spd, dr, t, liq, cred, spy_w, qqq_w, vx, ir,
                          reg)
        jc = jc + d.jump_on
        ls = ls + d.liq_n
        cs = cs + d.cred_n
        liq, cred = d.liq_n, d.cred_n

        # ---- leverage / costs / tracking error, consumed assets only ----
        etf_all = {}
        fin_day = _f(np.isfinite(tlt_w)) * _f(np.isfinite(vx))
        for a in needed:
            etf, te[a], bias[a] = asset_day(
                ap, a, underlying(d, tlt_w, a), d, dr.t_te[a][t], first,
                te[a], bias[a])
            fin_a = _f(np.isfinite(etf))
            fin_day = fin_day * fin_a
            etf_all[a] = _clip(_bsel(fin_a, etf, np.zeros_like(etf)),
                               -0.999, 10.0)
        fin = fin * fin_day
        r_tqqq = etf_all[C["idx_tqqq"]]
        r_spy = etf_all[C["idx_spy"]]
        cashr = (spa[CASH_RATE] + spd[CASH_RATE] * reg) / 252.0

        cur = signals_step(sig, t, st.psig["spy_price"], r_tqqq, r_spy)
        strategies_step(st, t, r_tqqq, r_spy, etf_all[C["idx_sso"]],
                        etf_all[C["idx_tmf"]], cashr, reg, vx, cur,
                        cf[t] if cf is not None else 0.0, apply_costs)

    return (*st.summary(), fin > 0.5, jc.astype(np.int32), ls, cs, vmin,
            vmax, rhi.astype(np.int32))


def strategies_plain(channels, cashflows=None, apply_costs: bool = True,
                     fused_signals: bool = False):
    """Plain NumPy K4: the kernel's day loop, one [B] float32 array per
    value."""
    S, B = channels[0].shape
    cf = cashflows.astype(np.float32) if cashflows is not None else None
    st = StrategyCarry(B)
    sig = SignalCarry(B) if fused_signals else None
    for t in range(S):
        r_tqqq, r_spy, r_sso, r_tmf, cashr, reg, vx = (c[t] for c in
                                                       channels[:N_FUSED])
        if fused_signals:
            cur = signals_step(sig, t, st.psig["spy_price"], r_tqqq,
                                  r_spy)
        else:
            cur = {k: c[t] for k, c in zip(SIGNALS, channels[N_FUSED:])}
        strategies_step(st, t, r_tqqq, r_spy, r_sso, r_tmf, cashr, reg,
                           vx, cur, cf[t] if cf is not None else 0.0,
                           apply_costs)
    return st.summary()


def joint_plain(params, cheb, regime, ids, signs, seed_words):
    """Plain NumPy K1. params [25, 2] f32; cheb [2, K] f32; regime [T, B]
    f32 0/1; ids [B] int; signs [B] f32 +-1; seed_words two ints.
    Returns (x0, x1, x2, vix, irx), each [T, B] f32."""
    T, B = regime.shape
    draws = joint_draws(ids, signs, seed_words, T)
    e0s, e1s, e2s, zcs, vns, irxns = draws

    a = params[:, 0]
    d = params[:, 1] - params[:, 0]
    ca = cheb[0]
    cd = cheb[1] - cheb[0]
    n_cheb = cheb.shape[1]
    outs = [np.empty((T, B), np.float32)
            for _ in range(5)]
    zero = np.zeros(B, np.float32)
    (h0, h1, h2, q00, q01, q02, q11, q12, q22,
     z0, z1, z2, prev_r, vixp) = [zero] * 14

    for t in range(T):
        r = regime[t]

        def g2(i):
            return a[i] + d[i] * r

        e0, e1, e2 = e0s[t], e1s[t], e2s[t]
        zc, vn, irxn = zcs[t], vns[t], irxns[t]
        firstf = 1.0 if t == 0 else 0.0
        lv0, lv1, lv2 = g2(LV0), g2(LV1), g2(LV2)
        rb00, rb01, rb02 = g2(RB00), g2(RB01), g2(RB02)
        rb11, rb12, rb22 = g2(RB11), g2(RB12), g2(RB22)
        switch = np.abs(r - prev_r) * (1.0 - firstf)

        def sel3(lv, garch, h):
            blend = 0.10 * lv + 0.90 * h
            v = garch + switch * (blend - garch)
            return lv * firstf + v * (1.0 - firstf)

        alpha, beta = g2(ALPHA), g2(BETA)
        one_ab = 1.0 - alpha - beta
        g0 = np.maximum(one_ab * lv0 + alpha * z0 * z0 * h0
                             + beta * h0, 1e-10)
        g1 = np.maximum(one_ab * lv1 + alpha * z1 * z1 * h1
                             + beta * h1, 1e-10)
        g2_ = np.maximum(one_ab * lv2 + alpha * z2 * z2 * h2
                              + beta * h2, 1e-10)
        h0n, h1n, h2n = sel3(lv0, g0, h0), sel3(lv1, g1, h1), \
            sel3(lv2, g2_, h2)

        ad, bd = g2(DCC_A), g2(DCC_B)
        one_abd = 1.0 - ad - bd

        def qsel(rb, q, zz):
            dcc = one_abd * rb + ad * zz + bd * q
            blend = 0.10 * rb + 0.90 * q
            v = dcc + switch * (blend - dcc)
            return rb * firstf + v * (1.0 - firstf)

        q00n = qsel(rb00, q00, z0 * z0)
        q01n = qsel(rb01, q01, z0 * z1)
        q02n = qsel(rb02, q02, z0 * z2)
        q11n = qsel(rb11, q11, z1 * z1)
        q12n = qsel(rb12, q12, z1 * z2)
        q22n = qsel(rb22, q22, z2 * z2)

        d0 = np.sqrt(np.maximum(q00n, 1e-12))
        d1 = np.sqrt(np.maximum(q11n, 1e-12))
        d2 = np.sqrt(np.maximum(q22n, 1e-12))
        s0_, s1_, s2_ = np.sqrt(h0n), np.sqrt(h1n), np.sqrt(h2n)
        c00 = (q00n / (d0 * d0)) * s0_ * s0_
        c01 = (q01n / (d0 * d1)) * s0_ * s1_
        c02 = (q02n / (d0 * d2)) * s0_ * s2_
        c11 = (q11n / (d1 * d1)) * s1_ * s1_
        c12 = (q12n / (d1 * d2)) * s1_ * s2_
        c22 = (q22n / (d2 * d2)) * s2_ * s2_

        epsv = 1e-18
        l00 = np.sqrt(np.maximum(c00, epsv))
        l10 = c01 / l00
        l20 = c02 / l00
        l11 = np.sqrt(np.maximum(c11 - l10 * l10, epsv))
        l21 = (c12 - l20 * l10) / l11
        l22 = np.sqrt(np.maximum(c22 - l20 * l20 - l21 * l21, epsv))
        zz0 = l00 * e0
        zz1 = l10 * e0 + l11 * e1
        zz2 = l20 * e0 + l21 * e1 + l22 * e2

        tc = _clip(zc * (1.0 / 6.3), -1.0, 1.0)
        b1 = np.zeros_like(tc)
        b2 = np.zeros_like(tc)
        for k in range(n_cheb - 1, 0, -1):
            ck = ca[k] + cd[k] * r
            b1, b2 = ck + 2.0 * tc * b1 - b2, b1
        c0k = ca[0] + cd[0] * r
        u_chi = np.exp(c0k + tc * b1 - b2)

        scale = np.sqrt(g2(NU) / np.maximum(u_chi, 1e-12))
        mu0, mu1, mu2 = g2(MU0), g2(MU1), g2(MU2)
        x0 = _clip(mu0 + zz0 * scale, -0.95, 4.0)
        x1 = _clip(mu1 + zz1 * scale, -0.95, 4.0)
        x2 = _clip(mu2 + zz2 * scale, -0.95, 4.0)
        z0 = (x0 - mu0) / np.sqrt(np.maximum(h0n, 1e-10))
        z1 = (x1 - mu1) / np.sqrt(np.maximum(h1n, 1e-10))
        z2 = (x2 - mu2) / np.sqrt(np.maximum(h2n, 1e-10))

        shock = np.maximum(-x0, 0.0) / np.maximum(g2(DSTD), 1e-4)
        vjump = g2(VJSCL) * np.maximum(shock - g2(VJTHR), 0.0)
        phi = g2(VPHI)
        vix_ar = np.maximum(
            phi * vixp + (1.0 - phi) * g2(VTGT) + vjump + g2(VNOISE) * vn,
            10.0)
        vix_t = g2(VBASE) * firstf + vix_ar * (1.0 - firstf)
        irx_t = _clip(g2(IRXB) + 0.5 * irxn, 0.0, 15.0)

        for o, v in zip(outs, (x0, x1, x2, vix_t, irx_t)):
            o[t] = v
        h0, h1, h2 = h0n, h1n, h2n
        q00, q01, q02, q11, q12, q22 = q00n, q01n, q02n, q11n, q12n, q22n
        prev_r, vixp = r, vix_t
    return tuple(outs)
