"""Frozen copy of
``letf_tpu_torch/ops/compose_strategies.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Cost composition + rolling signals + 19 strategies (kernel K3).

Port of ``letf_tpu/ops/pallas_strategies.py::_strategy_kernel`` in
fused-compose mode (entry ``pallas_compose_strategies_run``): from the six
windowed market series to per-trial strategy summaries in one pass.

Per day and trial:
- stress + crisis jumps + funding spread + leverage/expense/financing +
  tracking error (the math of ``pallas_compose.py``) with counter draws from
  streams 16+ and 32+, TE chains for the four consumed assets only, and the
  per-day repair (bound, zero non-finite returns, path-finite flag);
- the 16 rolling signals from ring buffers and exact add/subtract window
  sums, with pandas ``min_periods`` NaN rules and ``shift(1)`` reads;
- all 19 strategies with the reference quirks (S7 earns no cash on the idle
  fraction, S8 is costless, S9 freezes on NaN-signal days, S19 rebalances
  past a 5% threshold, loop strategies start at day 1), the cashflow
  schedule and the ruin floor;
- validity accumulators (finite flag, VIX min/max, regime-1 days).

Layout ``[S, B]`` in. Returns ``(final_wealth [B, 19], num_trades [B, 19]
int32, max_dd [B, 19], path_finite [B] bool, jump_days [B] int32, liq_sum,
cred_sum, vix_min, vix_max [B] f32, regime_high [B] int32)`` as JAX does.
``compose_strategies`` launches ``csrc/compose_strategies.cu`` for CUDA
tensors and runs ``compose_strategies_plain`` for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import config as cfg
from benchmark.reference import compose as cp
from benchmark.reference import precision


NS = cfg.N_STRATEGIES
SPREAD = 0.0003
TURNOVER_EPS = 1e-4
POS_CASH, POS_SAFE, POS_RISKY = 0.0, 1.0, 2.0
SQ252 = 15.874507866387544
W6A, W6B = 0.6, 0.4
RW_X, RW_SPY, RW_P, RW_S20 = 64, 128, 256, 8
# Signals carried at shift(1), in pallas_strategies.CHANNELS[7:] order.
SIGNALS = ("spy_price", "std20_mp20", "dstd20_mp20", "std5", "std10",
           "std20", "std60", "dstd20", "skew60", "mean60", "volmom5",
           "sum126", "sma200_mp1", "sma200", "sma100_mp1", "rsi14")
FLT_MIN = float(torch.finfo(torch.float32).tiny)


def consts() -> dict:
    """Static strategy constants (pallas_strategies._consts)."""
    return dict(
        initial_capital=float(cfg.INITIAL_CAPITAL),
        spread_bps0=float(cfg.BASE_SPREAD_BPS[0]),
        spread_bps1=float(cfg.BASE_SPREAD_BPS[1]),
        rebalance_cost=float(cfg.REBALANCE_COST_PER_DOLLAR),
        tqqq_lev=float(cfg.ASSETS["TQQQ"].leverage),
        s6_lev_a=float(cfg.ASSETS["TQQQ"].leverage),
        s6_lev_b=float(cfg.ASSETS["TMF"].leverage),
        idx_tqqq=cfg.ASSET_INDEX["TQQQ"],
        idx_spy=cfg.ASSET_INDEX["SPY"],
        idx_sso=cfg.ASSET_INDEX["SSO"],
        idx_tmf=cfg.ASSET_INDEX["TMF"],
    )


def _needed(c):
    return sorted({c["idx_tqqq"], c["idx_spy"], c["idx_sso"], c["idx_tmf"]})


def _f(mask):
    return mask.to(precision.F)


def _asel(m, a, b):
    """Arithmetic select for finite operands: m*a + (1-m)*b."""
    return m * a + (1.0 - m) * b


def _bsel(m, a, b):
    """Bitwise select (NaN-safe), m a 0/1 mask."""
    return torch.where(m != 0, a, b)


def _guard(v, eps, default):
    m = _f(v >= eps)
    return m, _bsel(m, v, torch.full_like(v, default))


def _rdiv(c: float, x):
    """c / x correctly rounded: torch computes a Python scalar divided by a
    tensor as a reciprocal times the scalar (two roundings), the kernels
    and the reference divide."""
    return torch.full_like(x, c) / x


def _clip(x, lo, hi):
    return torch.clamp(x, lo, hi)


def _ruin_floor(e):
    """Equity below float32's smallest normal is ruin (0). The reference
    runs with subnormals flushed to zero (TPU and XLA:CPU alike), so an
    equity that underflows there is 0 for good; IEEE arithmetic would keep
    a subnormal equity that later recovers. NaN passes through."""
    return torch.where(e < FLT_MIN, torch.zeros_like(e), e)


SUMS = ("s1_5", "s2_5", "s1_10", "s2_10", "s1_20", "s2_20", "s1_60",
        "s2_60", "s3_60", "n1_20", "n2_20", "spy1_126", "p1_100", "p1_200",
        "g1_14", "l1_14")


class SignalCarry:
    """The fused signal pass's carries: running window sums and the rings
    (x 64, spy 128, price 256, std20 8 days), [B] / [W, B] float32."""

    def __init__(self, B, device):
        f32 = dict(dtype=precision.F, device=device)
        zeros = torch.zeros(B, **f32)
        self.sums = {k: zeros for k in SUMS}
        self.ring_x = torch.zeros((RW_X, B), **f32)
        self.ring_spy = torch.zeros((RW_SPY, B), **f32)
        self.ring_p = torch.zeros((RW_P, B), **f32)
        self.ring_s20 = torch.zeros((RW_S20, B), **f32)


def signals_step(sc: SignalCarry, t: int, prev_price, r_tqqq, r_spy):
    """Today's 16 signals {name: [B]} (SIGNALS) from today's TQQQ and SPY
    returns, ``prev_price`` yesterday's SPY price signal (csrc/
    strategies_day.cuh::signals_day); updates the sums and rings."""
    first = t == 0
    nan_t = torch.full_like(r_spy, math.nan)
    if first:
        price = torch.full_like(r_spy, 100.0) * (1.0 + r_spy)
    else:
        price = prev_price * (1.0 + r_spy)
    x = r_tqqq
    neg = torch.clamp_max(x, 0.0)

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
    ng20 = torch.clamp_max(x20, 0.0)
    n1_20 = upd("n1_20", neg, ng20, 20)
    n2_20 = upd("n2_20", neg * neg, ng20 * ng20, 20)
    spy1_126 = upd("spy1_126", r_spy, spy126, 126)
    p1_100 = upd("p1_100", price, p100, 100)
    p1_200 = upd("p1_200", price, p200, 200)
    delta = torch.zeros_like(price) if first else price - prev_price
    sub_d = leave(15) * (p14 - p15)
    g1_14 = upd("g1_14", torch.clamp_min(delta, 0.0),
                torch.clamp_min(sub_d, 0.0), 0)
    l1_14 = upd("l1_14", torch.clamp_min(-delta, 0.0),
                torch.clamp_min(-sub_d, 0.0), 0)

    tn = float(t) + 1.0

    def nn(w):
        return min(tn, float(w))

    def gate(min_t, v):
        """min_periods gate: v from day min_t on, NaN before."""
        return v if t >= min_t else nan_t

    def wstd(s1, s2, w, min_t):
        n = nn(w)
        mean = s1 / n
        var = (torch.clamp_min(s2 - n * mean * mean, 0.0)
               / max(n - 1.0, 1.0))
        return gate(min_t, torch.sqrt(var) * SQ252)

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
    m2 = torch.clamp_min(s2_60 - n60 * mean60 * mean60, 0.0)
    m3 = (s3_60 - 3.0 * mean60 * s2_60
          + 2.0 * n60 * mean60 * mean60 * mean60)
    var60 = m2 / max(n60 - 1.0, 1.0)
    sd60 = torch.sqrt(var60)
    denom = (max(n60 - 1.0, 1.0) * max(n60 - 2.0, 1.0)
             * sd60 * sd60 * sd60)
    skew_ok = (1.0 if t >= 2 else 0.0) * _f(sd60 > 0.0)
    cur["skew60"] = _bsel(
        skew_ok, n60 * m3 / torch.clamp_min(denom, 1e-37), nan_t)
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

    def __init__(self, B, device):
        C = consts()
        IC = C["initial_capital"]
        f32 = dict(dtype=precision.F, device=device)
        zeros = torch.zeros(B, **f32)
        nan_t = torch.full((B,), math.nan, **f32)
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
        return (torch.stack(self.eq, 1),
                torch.stack(self.tr, 1).to(torch.int32),
                torch.stack(self.dd, 1))


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
        traded[i] = torch.zeros_like(rb)
        pa_new[i] = pa[i]

    # ---- S4/S5 SMA state machines ----
    if first:
        new4, new5 = pos4, pos5
        flip4 = flip5 = torch.zeros_like(pos4)
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
                + RCPD * TQQQ_LEV * torch.abs(r_tqqq))
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
    ma, mb = _f(torch.abs(den_a) > 0.01), _f(torch.abs(den_b) > 0.01)
    emb0 = _asel(ma, L6A * (1.0 + u6a)
                 / _bsel(ma, den_a, torch.full_like(den_a, 1.0)), L6A)
    emb1 = _asel(mb, L6B * (1.0 + u6b)
                 / _bsel(mb, den_b, torch.full_like(den_b, 1.0)), L6B)
    total6 = pg0 + pg1
    rebf = 1.0 if (t % 21 == 0 and t > 0) else 0.0
    inv_t6 = _rdiv(1.0, torch.clamp_min(total6, 1e-30))
    cw0, cw1 = pg0 * inv_t6, pg1 * inv_t6
    w_turn = torch.abs(cw0 - W6A) + torch.abs(cw1 - W6B)
    lev_turn = (torch.abs(emb0 - L6A) / L6A * cw0
                + torch.abs(emb1 - L6B) / L6B * cw1)
    tot_turn = w_turn + lev_turn
    do_cost = (rebf * _f(tot_turn > 0.01) if apply_costs
               else torch.zeros_like(tot_turn))
    total_after = _asel(do_cost, total6 * (1.0 - tot_turn * RCPD),
                        total6)
    if first:
        s6p0n, s6p1n, s6e0n, s6e1n = s6p0, s6p1, s6e0, s6e1
        equity6 = eq[5]
        traded[5] = torch.zeros_like(pg0)
    else:
        s6p0n = _asel(rebf, total_after * W6A, pg0)
        s6p1n = _asel(rebf, total_after * W6B, pg1)
        s6e0n = _asel(rebf, torch.full_like(emb0, L6A), emb0)
        s6e1n = _asel(rebf, torch.full_like(emb1, L6B), emb1)
        equity6 = total_after
        traded[5] = torch.full_like(pg0, rebf)
    rets[5] = torch.zeros_like(pg0)
    pa_new[5] = pa[5]

    def vol_family(i, alloc, include_cash=True):
        turnover = torch.abs(alloc - pa[i])
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
        rets[7] = torch.zeros_like(pos8)
        traded[7] = torch.zeros_like(pos8)
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
    ok9 = _f(v9r >= 0.001) * _f(~torch.isnan(sma9))
    target_v9 = _asel(_f(pp > sma9), 0.35, 0.12)
    v9 = _bsel(ok9, v9r, torch.full_like(v9r, 1.0))
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
    _, v12 = _guard(torch.maximum(prev("std20"), prev("std5")),
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
    crisis16 = torch.clamp_max(_f(vx > 25.0) + _f(vr16 > 1.5), 1.0)
    target16 = _asel(crisis16, 0.08, 0.30)
    m16, rv16 = _guard(prev("std5"), 0.001, 1.0)
    alloc16 = _asel(m16, _clip(target16 / rv16, 0.0, 1.2), 0.5)
    rets[15], traded[15] = vol_family(15, alloc16)
    pa_new[15] = alloc16

    # ---- S17 tail-risk optimizer (skew-aware Kelly) ----
    _, vol17 = _guard(prev("std20"), 0.001, 0.25)
    dvol17 = _bsel(_f(prev("dstd20") >= 0.001), prev("dstd20"),
                   vol17 * 0.6)
    skew17 = _bsel(_f(~torch.isnan(prev("skew60"))), prev("skew60"),
                   torch.zeros_like(vol17))
    mean17 = _bsel(_f(~torch.isnan(prev("mean60"))), prev("mean60"),
                   torch.full_like(vol17, 0.08))
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
    mom18 = _bsel(_f(~torch.isnan(prev("sum126"))), prev("sum126"),
                  torch.zeros_like(vx))
    _, vf18 = _guard(prev("std10"), 0.001, 0.30)
    _, vs18 = _guard(prev("std60"), 0.001, 0.25)
    mm18 = _asel(_f(mom18 > 0.05), 1.3, _asel(_f(mom18 > 0.0), 1.0, 0.5))
    vr18 = vf18 / vs18
    out_band = torch.clamp_max(_f(vr18 < 0.8) + _f(vr18 > 1.3), 1.0)
    vm18 = _asel(_f(vr18 < 0.8), 1.2, _asel(_f(vr18 > 1.3), 0.6, 1.0))
    eff18 = _asel(out_band, vf18, vs18)
    alloc18 = _clip(0.28 * mm18 * vm18 / eff18, 0.0, 1.5)
    rets[17], traded[17] = vol_family(17, alloc18)
    pa_new[17] = alloc18

    # ---- S19 conviction compounder (5% rebalance threshold) ----
    mom19 = _bsel(_f(~torch.isnan(prev("sum126"))), prev("sum126"),
                  torch.zeros_like(vx))
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
    turn19 = torch.abs(cand19 - pa[18])
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
    s6_scale = eq_new[5] / torch.clamp_min(pre5, 1e-30)
    s6p0n = s6p0n * s6_scale
    s6p1n = s6p1n * s6_scale
    for i in range(NS):
        if first:
            rm[i] = eq_new[i]
            eq[i] = eq_new[i]
            continue
        tr[i] = tr[i] + (traded[i] * 2.0 if i == 5 else traded[i])
        rm_new = torch.maximum(rm[i], eq_new[i])
        safe_rm = _asel(_f(rm_new > 0.0), torch.clamp_min(rm_new, 1e-30),
                        1.0)
        ddv = (eq_new[i] - rm_new) / safe_rm
        dd[i] = torch.maximum(dd[i], -ddv)
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
    """Plain PyTorch K3: the kernel's day body, one [B] tensor per value:
    the composition (ops/compose.py), then ``signals_step`` and
    ``strategies_step``."""
    S, B = spy.shape
    dev = spy.device
    C = consts()
    needed = _needed(C)
    f32 = dict(dtype=precision.F, device=dev)
    zeros = torch.zeros(B, **f32)

    # Counter draws of every day at once (pure functions of (trial, day)).
    dr = cp.draws(ids, seed_words, S, needed)
    dr = cp.Draws(*(x.to(precision.F) for x in dr[:4]),
                  {a: x.to(precision.F) for a, x in dr.t_te.items()})
    spa, spd = sp[:, 0], sp[:, 1] - sp[:, 0]
    cf = cashflows.to(precision.F) if cashflows is not None else None

    st = StrategyCarry(B, dev)
    sig = SignalCarry(B, dev)
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
        vmin = torch.minimum(vmin, vx)
        vmax = torch.maximum(vmax, vx)
        rhi = rhi + reg

        # ---- stress + crisis jumps + funding (ops/compose.py) ----
        d = cp.stress_day(spa, spd, dr, t, liq, cred, spy_w, qqq_w, vx, ir,
                          reg)
        jc = jc + d.jump_on
        ls = ls + d.liq_n
        cs = cs + d.cred_n
        liq, cred = d.liq_n, d.cred_n

        # ---- leverage / costs / tracking error, consumed assets only ----
        etf_all = {}
        fin_day = _f(torch.isfinite(tlt_w)) * _f(torch.isfinite(vx))
        for a in needed:
            etf, te[a], bias[a] = cp.asset_day(
                ap, a, cp.underlying(d, tlt_w, a), d, dr.t_te[a][t], first,
                te[a], bias[a])
            fin_a = _f(torch.isfinite(etf))
            fin_day = fin_day * fin_a
            etf_all[a] = _clip(_bsel(fin_a, etf, torch.zeros_like(etf)),
                               -0.999, 10.0)
        fin = fin * fin_day
        r_tqqq = etf_all[C["idx_tqqq"]]
        r_spy = etf_all[C["idx_spy"]]
        cashr = (spa[cp.CASH_RATE] + spd[cp.CASH_RATE] * reg) / 252.0

        cur = signals_step(sig, t, st.psig["spy_price"], r_tqqq, r_spy)
        strategies_step(st, t, r_tqqq, r_spy, etf_all[C["idx_sso"]],
                        etf_all[C["idx_tmf"]], cashr, reg, vx, cur,
                        cf[t] if cf is not None else 0.0, apply_costs)

    return (*st.summary(), fin > 0.5, jc.to(torch.int32), ls, cs, vmin,
            vmax, rhi.to(torch.int32))


