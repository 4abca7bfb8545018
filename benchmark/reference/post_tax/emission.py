"""The plain replay of report rows with journal emission: each row's path
by the cell's plain institutional engine, composed for all six assets,
then the 19 strategies with the 13 taxable ones' daily journal.

- The path: ``engines/institutional_v1.py``'s route (start offsets and
  regime spells in NumPy as the JAX package states them, K1's and K2's
  plain day loops in NumPy float32, the model tables in the program's
  glue dtype), on which K3's plain loop gives the plain engine's final
  wealth (the report's pre-tax wealth comes from K3), then K5's plain
  day loop (``ops/compose.py::
  compose_plain`` of the port at commit dc793a5, written on
  ``np_loops.py``'s NumPy day functions) and the path's repair
  (``ops/path_batched.py::finish_path``: non-finite returns zeroed,
  returns clamped to [-0.999, 10]).
- The signals and the emitting strategies: frozen copies of the port's
  plain CPU emitting route at commit dc793a5 (``ops/rolling.py``,
  ``strategies/signals.py::compute_signals`` and the emitting branch of
  ``strategies/engine.py::run_strategies_batch``), torch on the CPU in
  the path's dtype (float32).

Under ``precision.lowered()`` (the control) the chain runs the frozen
PyTorch day loops in bfloat16, the composed returns are rounded to
bfloat16 and the signals and strategies run in bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import compose_strategies as k3_plain
from benchmark.reference import config as cfg
from benchmark.reference import np_loops
from benchmark.reference import np_spells
from benchmark.reference import params as tparams
from benchmark.reference import path_batched as pb
from benchmark.reference import precision
from benchmark.reference import rng
from benchmark.reference.compose import CASH_RATE
from benchmark.reference.engines import common
from benchmark.reference.engines import institutional_v1 as inst

NA = cfg.N_ASSETS
NS = cfg.N_STRATEGIES            # 19
N_TAX = len(cfg.TAXABLE_IDS)     # 13 (S7..S19)
TAX_OFFSET = 6
INITIAL_CAPITAL = float(cfg.INITIAL_CAPITAL)
SPREAD = 0.0003
TURNOVER_EPS = 1e-4
POS_CASH, POS_SAFE, POS_RISKY = 0, 1, 2
FLT_MIN = float(torch.finfo(torch.float32).tiny)
S6_W = (0.6, 0.4)
S6_LEV = (float(cfg.ASSETS["TQQQ"].leverage),
          float(cfg.ASSETS["TMF"].leverage))
IDX_TQQQ = cfg.ASSET_INDEX["TQQQ"]
IDX_SSO = cfg.ASSET_INDEX["SSO"]
IDX_TMF = cfg.ASSET_INDEX["TMF"]
IDX_SPY = cfg.ASSET_INDEX["SPY"]
SQ252 = float(np.sqrt(252.0))


class Path(NamedTuple):
    etf_ret: torch.Tensor       # [A, S, B] repaired net ETF returns
    vix: torch.Tensor           # [S, B]
    regime: torch.Tensor        # [S, B] int32
    cash_ret: torch.Tensor      # [S, B]
    engine_wealth: np.ndarray   # [B, 19] the plain engine's (K3's route)


class Replay(NamedTuple):
    engine_wealth: np.ndarray   # [B, 19] the plain engine's final wealth
    final_wealth: np.ndarray    # [B, 19] the emitting route's
    tj_alloc: np.ndarray        # [S, B, 13] new allocation, NaN = no trade
    tj_value: np.ndarray        # [S, B, 13] equity before the day
    tj_price: np.ndarray        # [S, B, 13] journal asset price
    tj_asset: np.ndarray        # [S, B, 13] int8 asset index


# ---- the path ----

def _compose_np(sp, ap, ids, seed_words, spy, qqq, tlt, vix, irx, regime):
    """K5's plain day loop in NumPy float32: (etf [6, S, B], cash [S, B])."""
    S, B = spy.shape
    dr = np_loops.draws(ids, seed_words, S, range(NA))
    spa, spd = sp[:, 0], sp[:, 1] - sp[:, 0]
    etf = np.empty((NA, S, B), np.float32)
    cash = np.empty((S, B), np.float32)
    zeros = np.zeros(B, np.float32)
    liq = cred = zeros
    te = [zeros] * NA
    bias = [zeros] * NA
    for t in range(S):
        reg = regime[t]
        d = np_loops.stress_day(spa, spd, dr, t, liq, cred, spy[t], qqq[t],
                                vix[t], irx[t], reg)
        liq, cred = d.liq_n, d.cred_n
        for a in range(NA):
            e, te[a], bias[a] = np_loops.asset_day(
                ap, a, np_loops.underlying(d, tlt[t], a), d, dr.t_te[a][t],
                t == 0, te[a], bias[a])
            etf[a, t] = np.clip(e, -0.999, 10.0)
        cash[t] = (spa[CASH_RATE] + spd[CASH_RATE] * reg) / 252.0
    return etf, cash


def path_rows(rows, seed: int, years: float, config: dict,
              glue: torch.dtype = torch.float32) -> Path:
    """The repaired path of report ``rows`` on the CPU."""
    m = common.model(config)
    sim, buf = common.days(config, years)
    ids, anti = common.tensors(*common.layout(rows, config["antithetic"]),
                               "cpu")
    mt = tparams.from_numpy(m, torch.device("cpu"), glue)
    spells = np_spells.plan_max_spells(m.regime, sim + buf)
    low = precision.F != torch.float32
    with torch.inference_mode(), np.errstate(all="ignore"):
        sp = tparams.pack_stress_params(mt).numpy()
        ap = tparams.pack_asset_params(mt).numpy()
        if low:
            _, ids32, seed_words, chans = pb.windowed_chain(
                mt, rng.key(seed, "cpu"), ids, anti, sim, buf,
                config["random_start_method"], None,
                config["moment_matching"], spells)
            chans = [c.float().numpy() for c in chans]
            ids32 = ids32.numpy()
        else:
            ids32, seed_words, chans = inst._chain_np(
                m, mt, seed, ids, anti, sim, buf, config, spells)
            ids32 = ids32.numpy()
        spy, qqq, tlt, vix, irx, regime = chans
        # The plain engine's own final wealth (K3's route on the same
        # channels), as ``engines/institutional_v1.summaries`` gives it.
        if low:
            k3 = k3_plain.compose_strategies_plain(
                torch.from_numpy(sp), torch.from_numpy(ap),
                torch.from_numpy(ids32), seed_words,
                *(torch.from_numpy(c) for c in chans),
                apply_costs=config["apply_costs"])
        else:
            k3 = np_loops.compose_strategies_plain(
                sp, ap, ids32, seed_words, *chans,
                apply_costs=config["apply_costs"])
        engine_wealth = common.host_one(k3[0]).astype(np.float64)
        etf, cash = _compose_np(sp, ap, ids32, seed_words, spy, qqq, tlt,
                                vix, irx, regime)
        etf = np.clip(np.where(np.isfinite(etf), etf, 0.0), -0.999, 10.0)
        etf, cash, vix = (precision.round_np(x) for x in (etf, cash, vix))
    dt = precision.F
    return Path(torch.from_numpy(etf).to(dt), torch.from_numpy(vix).to(dt),
                torch.from_numpy(regime).to(torch.int32),
                torch.from_numpy(cash).to(dt), engine_wealth)


# ---- ops/rolling.py (the functions the signals call, axis 0) ----

def _window_sum(x, window: int):
    c = torch.cumsum(x, dim=0)
    T = x.shape[0]
    if window >= T:
        return c
    return c - torch.cat([torch.zeros_like(c[:window]), c[:T - window]])


def _counts(x, window: int):
    T = x.shape[0]
    n = torch.clamp_max(torch.arange(T) + 1, window).to(x.dtype)
    return n.reshape([T] + [1] * (x.ndim - 1))


def _nan_unless(ok, v):
    return torch.where(ok, v, math.nan)


def rolling_sum(x, window: int, min_periods: int = 1):
    return _nan_unless(_counts(x, window) >= min_periods,
                       _window_sum(x, window))


def rolling_mean(x, window: int, min_periods=None):
    if min_periods is None:
        min_periods = window
    n = _counts(x, window)
    return _nan_unless(n >= min_periods, _window_sum(x, window) / n)


def rolling_std(x, window: int, min_periods=None):
    if min_periods is None:
        min_periods = window
    s1 = _window_sum(x, window)
    s2 = _window_sum(x * x, window)
    n = _counts(x, window)
    mean = s1 / n
    var = torch.clamp_min(s2 - n * mean * mean, 0.0) / torch.clamp_min(
        n - 1, 1)
    return _nan_unless((n >= min_periods) & (n >= 2), torch.sqrt(var))


def rolling_skew(x, window: int, min_periods=None):
    if min_periods is None:
        min_periods = window
    s1 = _window_sum(x, window)
    s2 = _window_sum(x * x, window)
    s3 = _window_sum(x * x * x, window)
    n = _counts(x, window)
    mean = s1 / n
    m2 = torch.clamp_min(s2 - n * mean ** 2, 0.0)
    m3 = s3 - 3.0 * mean * s2 + 2.0 * n * mean ** 3
    var = m2 / torch.clamp_min(n - 1, 1)
    s = torch.sqrt(var)
    denom = torch.clamp_min(n - 1, 1) * torch.clamp_min(n - 2, 1) * s ** 3
    g = n * m3 / _nan_unless(denom > 0, denom)
    return _nan_unless((n >= min_periods) & (n >= 3) & (s > 0), g)


def shift1(x):
    return torch.cat([torch.full_like(x[:1], math.nan), x[:-1]])


def pct_change(x, periods: int):
    prev = torch.cat([torch.full_like(x[:periods], math.nan),
                      x[:x.shape[0] - periods]])
    return x / prev - 1.0


def rsi(price, period: int = 14):
    delta = price - torch.cat([price[:1], price[:-1]])
    gain = rolling_mean(torch.where(delta > 0, delta, 0.0), period)
    loss = rolling_mean(torch.where(delta < 0, -delta, 0.0), period)
    return 100.0 - 100.0 / (1.0 + gain / loss)


# ---- strategies/signals.py ----

def signals(path: Path) -> dict:
    etf = path.etf_ret
    prices = torch.cumprod(1.0 + etf, dim=1) * 100.0
    spy_price = prices[IDX_SPY]
    r_tqqq = etf[IDX_TQQQ]
    r_spy = etf[IDX_SPY]
    neg_tqqq = torch.where(r_tqqq < 0, r_tqqq, 0.0)
    std20 = rolling_std(r_tqqq, 20, 1) * SQ252
    return dict(
        prices=prices, spy_price=spy_price,
        tqqq_std20_mp20=rolling_std(r_tqqq, 20) * SQ252,
        tqqq_dstd20_mp20=rolling_std(neg_tqqq, 20) * SQ252,
        tqqq_std5=rolling_std(r_tqqq, 5, 1) * SQ252,
        tqqq_std10=rolling_std(r_tqqq, 10, 1) * SQ252,
        tqqq_std20=std20,
        tqqq_std60=rolling_std(r_tqqq, 60, 1) * SQ252,
        tqqq_dstd20=rolling_std(neg_tqqq, 20, 1) * SQ252,
        tqqq_skew60=rolling_skew(r_tqqq, 60, 1),
        tqqq_mean60_ann=rolling_mean(r_tqqq, 60, 1) * 252.0,
        tqqq_volmom5=pct_change(std20, 5),
        spy_sum126=rolling_sum(r_spy, 126, 1),
        spy_sma200_mp1=rolling_mean(spy_price, 200, 1),
        spy_sma200=rolling_mean(spy_price, 200),
        spy_sma100_mp1=rolling_mean(spy_price, 100, 1),
        spy_rsi14=rsi(spy_price, 14))


# ---- strategies/engine.py, the emitting branch ----

def _nan_to(x, default):
    return torch.where(torch.isnan(x), default, x)


def _after_day(alloc):
    prev = torch.zeros_like(alloc)
    prev[2:] = alloc[1:-1]
    return prev


def _ffill(update, val, init: float):
    S = update.shape[0]
    days = torch.arange(S).view(S, *([1] * (val.ndim - 1)))
    upd = update.clone()
    upd[0] = False
    last = torch.cummax(torch.where(upd, days, -1), dim=0).values
    return torch.where(last >= 0, torch.gather(val, 0, last.clamp_min(0)),
                       init)


def _before(state, init: float):
    return torch.cat([torch.full_like(state[:1], init), state[:-1]])


def _vol_family(alloc, prev, r, cash, apply_costs, include_cash=True):
    turnover = torch.abs(alloc - prev)
    traded = turnover > TURNOVER_EPS
    cost = torch.where(traded, turnover * SPREAD, 0.0)
    ret = alloc * r + (1.0 - alloc) * cash if include_cash else alloc * r
    if apply_costs:
        ret = ret - cost
    return ret, traded


def _bull(p, sma):
    return torch.where(torch.isnan(p) | torch.isnan(sma), False, p > sma)


def _guard(x, eps, default):
    return torch.where(torch.isnan(x) | (x < eps), default, x)


def _ruin_floor(e):
    return torch.where(e < FLT_MIN, 0.0, e)


def strategies(path: Path, sig: dict, apply_costs: bool = True) -> Replay:
    """S1-S19 over the path with the taxable strategies' journal."""
    etf = path.etf_ret
    A, S, B = etf.shape
    dt = etf.dtype
    r_tqqq, r_spy, r_tmf = etf[IDX_TQQQ], etf[IDX_SPY], etf[IDX_TMF]
    cash = path.cash_ret
    reg1 = path.regime == 1
    vix = path.vix
    tqqq_price = sig["prices"][IDX_TQQQ]
    spy_asset_price = sig["prices"][IDX_SPY]
    first = torch.zeros((S, 1), dtype=torch.bool)
    first[0] = True

    def pick(cond, a: float, b):
        return torch.where(cond, torch.full(cond.shape, a, dtype=dt), b)

    pp = shift1(sig["spy_price"])
    sma1 = shift1(sig["spy_sma200_mp1"])
    sma200 = shift1(sig["spy_sma200"])
    s5, s10, s20, s60 = (shift1(sig[k]) for k in (
        "tqqq_std5", "tqqq_std10", "tqqq_std20", "tqqq_std60"))
    d20 = shift1(sig["tqqq_dstd20"])
    rets = [None] * NS
    traded = [None] * NS
    jr = {}

    for i, rb in enumerate((r_tqqq, r_spy, etf[IDX_SSO])):
        rets[i] = rb
        traded[i] = torch.zeros_like(rb, dtype=torch.bool)

    sma_cost = (torch.where(reg1, float(cfg.BASE_SPREAD_BPS[1]),
                            float(cfg.BASE_SPREAD_BPS[0])).to(dt) / 10000.0
                + cfg.REBALANCE_COST_PER_DOLLAR
                * cfg.ASSETS["TQQQ"].leverage * torch.abs(r_tqqq))
    for i, thresh in ((3, sma1), (4, sma1 * (1.0 - 0.02))):
        known = ~(torch.isnan(pp) | torch.isnan(thresh))
        pos = _ffill(known, (pp >= thresh).to(dt), 0.0)
        flip = pos != _before(pos, 0.0)
        ret = torch.where(pos == 1, r_tqqq, cash)
        if apply_costs:
            ret = ret - torch.where(flip, sma_cost, 0.0)
        rets[i], traded[i] = ret, flip

    emb = []
    for r6, lev in ((r_tqqq, S6_LEV[0]), (r_tmf, S6_LEV[1])):
        u = r6 / lev
        den = 1.0 + lev * u
        emb.append(torch.where(torch.abs(den) > 0.01,
                               lev * (1.0 + u) / den, lev))
    rets[5] = torch.zeros_like(r_tqqq)
    traded[5] = torch.zeros_like(r_tqqq, dtype=torch.bool)
    traded[5][1:] = (torch.arange(1, S) % 21 == 0)[:, None]

    v7 = sig["tqqq_std20_mp20"]
    pos7 = torch.where(torch.isnan(v7) | (v7 < 0.01), 1.0,
                       torch.clamp(0.20 / v7, 0.2, 2.0))
    rets[6], traded[6] = _vol_family(pos7, _after_day(pos7), r_tqqq, cash,
                                     apply_costs, include_cash=False)
    jr[0] = (traded[6], pos7, tqqq_price, IDX_TQQQ)

    rsi8, vix8 = shift1(sig["spy_rsi14"]), shift1(vix)
    sc = (_bull(pp, sma200).to(torch.int32)
          + torch.where(torch.isnan(rsi8), False,
                        (rsi8 > 40) & (rsi8 < 80)).to(torch.int32)
          + torch.where(torch.isnan(vix8), False, vix8 < 25.0).to(
              torch.int32))
    target8 = torch.where(sc == 3, POS_RISKY,
                          torch.where(sc == 2, POS_SAFE, POS_CASH))
    held8 = torch.full_like(target8, POS_CASH)
    held8[2:] = target8[1:-1]
    traded[7] = (target8 != held8) & ~first
    target8[0] = POS_CASH
    rets[7] = torch.where(target8 == POS_RISKY, r_tqqq,
                          torch.where(target8 == POS_SAFE, r_spy, cash))
    risky8 = target8 == POS_RISKY
    jr[1] = (traded[7], torch.where(target8 == POS_CASH, 0.0, 1.0).to(dt),
             torch.where(risky8, tqqq_price, spy_asset_price),
             torch.where(risky8, IDX_TQQQ, IDX_SPY).to(torch.int8))

    v9 = shift1(sig["tqqq_std20_mp20"])
    skip9 = torch.isnan(v9) | torch.isnan(sma200) | (v9 < 0.001)
    cand9 = torch.clamp(pick(pp > sma200, 0.35, 0.12)
                        / torch.where(skip9, 1.0, v9), 0.0, 1.0)
    held9 = _ffill(~skip9, cand9, 0.0)
    prev9 = _before(held9, 0.0)
    alloc9 = torch.where(skip9, prev9, cand9)
    ret9, tr9 = _vol_family(alloc9, prev9, r_tqqq, cash, apply_costs)
    rets[8] = torch.where(skip9, 0.0, ret9)
    traded[8] = tr9 & ~skip9
    jr[2] = (traded[8], alloc9, tqqq_price, IDX_TQQQ)

    dv10 = shift1(sig["tqqq_dstd20_mp20"])
    alloc = {9: torch.where(torch.isnan(dv10) | (dv10 < 0.001), 1.0,
                            torch.clamp(0.15 / dv10, 0.0, 1.5))}
    bull = _bull(pp, sma1)
    a11 = 0.25 / torch.where(_nan_to(s20, 0.5) < 0.001, 0.5,
                             _nan_to(s20, 0.5))
    alloc[10] = torch.clamp(torch.where(bull, a11 ** 1.2, a11), 0.0, 1.0)
    alloc[11] = torch.clamp(0.22 / _guard(torch.maximum(s20, s5), 0.001,
                                          0.5), 0.0, 1.0)
    v13 = _guard(s20, 0.001, 0.5)
    vm13 = shift1(sig["tqqq_volmom5"])
    a13 = 0.25 / v13
    a13 = torch.where(~torch.isnan(vm13) & (vm13 < -0.10), a13 * 1.2, a13)
    a13 = torch.where(~torch.isnan(vm13) & (vm13 > 0.10), a13 * 0.7, a13)
    alloc[12] = torch.clamp(a13, 0.0, 1.0)
    s14 = shift1(sig["tqqq_skew60"])
    a14 = 0.25 / v13
    a14 = torch.where(~torch.isnan(s14) & (s14 > 0), a14 ** 1.3, a14)
    a14 = torch.where(~torch.isnan(s14) & (s14 < -0.5), a14 * 0.5, a14)
    alloc[13] = torch.clamp(a14, 0.0, 1.0)
    a15 = 0.28 / _guard(d20, 0.001, 0.25)
    a15 = torch.where(bull, a15 ** 1.2, a15)
    brake15 = torch.where(torch.isnan(s5) | torch.isnan(s20), False,
                          s5 > 1.5 * s20)
    alloc[14] = torch.clamp(torch.where(brake15, a15 * 0.5, a15), 0.0, 1.0)
    vr16 = s5 / s60
    crisis16 = (vix > 25.0) | torch.where(torch.isnan(vr16), False,
                                          vr16 > 1.5)
    target16 = pick(crisis16, 0.08, 0.30)
    alloc[15] = torch.where(torch.isnan(s5) | (s5 < 0.001), 0.5,
                            torch.clamp(target16 / s5, 0.0, 1.2))
    vol17 = _guard(s20, 0.001, 0.25)
    dvol17 = torch.where(torch.isnan(d20) | (d20 < 0.001), vol17 * 0.6, d20)
    skew17 = _nan_to(shift1(sig["tqqq_skew60"]), 0.0)
    mean17 = _nan_to(shift1(sig["tqqq_mean60_ann"]), 0.08)
    eff17 = torch.where(skew17 < -0.5, dvol17 * 1.5,
                        torch.where(skew17 < 0, dvol17 * 1.2,
                                    torch.where(skew17 > 0.5, vol17 * 0.9,
                                                vol17)))
    pen17 = pick(skew17 < -0.5, 0.6,
                 pick(skew17 < 0, 0.8, pick(skew17 > 0.5, 1.2, 1.0)))
    kelly17 = torch.where(eff17 > 0.01,
                          torch.clamp((mean17 - 0.03) / (eff17 ** 2) * 0.7,
                                      0.2, 2.0), 1.0)
    alloc[16] = torch.clamp((0.30 / eff17) * pen17 * (kelly17 / 1.5), 0.0,
                            1.5)
    mom = _nan_to(shift1(sig["spy_sum126"]), 0.0)
    vf18 = _guard(s10, 0.001, 0.30)
    vs = _guard(s60, 0.001, 0.25)
    mm18 = pick(mom > 0.05, 1.3, pick(mom > 0, 1.0, 0.5))
    vr18 = vf18 / vs
    vm18 = pick(vr18 < 0.8, 1.2, pick(vr18 > 1.3, 0.6, 1.0))
    eff18 = torch.where((vr18 < 0.8) | (vr18 > 1.3), vf18, vs)
    alloc[17] = torch.clamp(0.28 * mm18 * vm18 / eff18, 0.0, 1.5)
    for i, a in alloc.items():
        rets[i], traded[i] = _vol_family(a, _after_day(a), r_tqqq, cash,
                                         apply_costs)
        jr[i - TAX_OFFSET] = (traded[i], a, tqqq_price, IDX_TQQQ)

    dv19 = _guard(d20, 0.001, 0.20)
    vf19 = _guard(s5, 0.001, 0.30)
    mom_score = pick(mom > 0.15, 1.0,
                     pick(mom > 0.05, 0.7, pick(mom > 0, 0.4, 0.0)))
    trend_score = pick(_bull(pp, shift1(sig["spy_sma100_mp1"])), 0.5, 0.0)
    vr19 = vf19 / vs
    vol_score = pick(vr19 < 0.9, 0.5, pick(vr19 < 1.2, 0.3, 0.0))
    conviction = mom_score + trend_score + vol_score
    cand19 = torch.clamp((0.32 / dv19) * (0.3 + conviction * 0.55), 0.0,
                         1.5)

    alloc19 = torch.empty_like(cand19)
    a19 = torch.zeros(B, dtype=dt)
    for t in range(S):
        alloc19[t] = torch.where(torch.abs(cand19[t] - a19) > 0.05,
                                 cand19[t], a19)
        if t > 0:
            a19 = alloc19[t]
    turn19 = torch.abs(cand19 - _after_day(alloc19))
    traded[18] = turn19 > 0.05
    ret19 = alloc19 * r_tqqq + (1.0 - alloc19) * cash
    if apply_costs:
        ret19 = ret19 - torch.where(traded[18], turn19 * SPREAD, 0.0)
    rets[18] = ret19
    jr[12] = (traded[18], cand19, tqqq_price, IDX_TQQQ)

    ret_all = torch.stack(rets, dim=1)                       # [S, NS, B]
    ret_all[0, 3:] = 0.0
    eq = torch.full((NS, B), INITIAL_CAPITAL, dtype=dt)
    s6 = [torch.full((B,), INITIAL_CAPITAL * w, dtype=dt) for w in S6_W]
    value = torch.empty((S, N_TAX, B), dtype=dt)
    for t in range(S):
        value[t] = eq[TAX_OFFSET:]
        pg = [s6[0] * (1.0 + r_tqqq[t]), s6[1] * (1.0 + r_tmf[t])]
        total6 = pg[0] + pg[1]
        if t > 0 and t % 21 == 0:
            inv_t6 = 1.0 / torch.clamp_min(total6, 1e-30)
            cw = [pg[0] * inv_t6, pg[1] * inv_t6]
            w_turn = torch.abs(cw[0] - S6_W[0]) + torch.abs(cw[1] - S6_W[1])
            lev_turn = (torch.abs(emb[0][t] - S6_LEV[0]) / S6_LEV[0] * cw[0]
                        + torch.abs(emb[1][t] - S6_LEV[1]) / S6_LEV[1]
                        * cw[1])
            tot_turn = w_turn + lev_turn
            total_after = total6
            if apply_costs:
                total_after = torch.where(
                    tot_turn > 0.01,
                    total6 * (1.0 - tot_turn * cfg.REBALANCE_COST_PER_DOLLAR),
                    total6)
            pg = [total_after * S6_W[0], total_after * S6_W[1]]
        else:
            total_after = total6
        if t == 0:
            pg, total_after = s6, eq[5]
        eq_new = eq * (1.0 + ret_all[t])
        eq_new[5] = total_after
        eq_cf = _ruin_floor(torch.clamp_min(eq_new, 0.0))
        scale = eq_cf[5] / torch.clamp_min(eq_new[5], 1e-30)
        s6 = [pg[0] * scale, pg[1] * scale]
        eq = eq_cf

    cols = [jr[c] for c in range(N_TAX)]
    return Replay(
        engine_wealth=path.engine_wealth,
        final_wealth=eq.t().double().numpy(),
        tj_alloc=torch.stack([torch.where(do & ~first, a, float("nan"))
                              for do, a, _, _ in cols], dim=-1).double()
        .numpy(),
        tj_value=value.permute(0, 2, 1).double().numpy(),
        tj_price=torch.stack([p for _, _, p, _ in cols], dim=-1).double()
        .numpy(),
        tj_asset=torch.stack(
            [torch.full((S, B), a, dtype=torch.int8) if isinstance(a, int)
             else a for _, _, _, a in cols], dim=-1).numpy())


def replay(rows, seed: int, years: float, config: dict,
           glue: torch.dtype = torch.float32) -> Replay:
    """Final wealth and the taxable strategies' journal of report
    ``rows``, recomputed on the host."""
    with torch.inference_mode():
        path = path_rows(rows, seed, years, config, glue)
        return strategies(path, signals(path), config["apply_costs"])
