"""The emitting engine's day loop: S19's threshold, S6's sleeves, the
equities (the emitting day kernel, ``csrc/emit_days.cu``).

``strategies/engine.py::run_strategies_batch(emit_trades=True)`` computes
every allocation that depends on the signals alone for all days at once;
what is truly sequential comes here: S19's thresholded allocation (hence
its turnover, trade flags and returns), and the equities of the 19
strategies with the cashflow overlay, the ruin floor, S6's two sleeves
(21-day rebalance, embedded-leverage turnover), the running maxima and
drawdowns, and the journal's equity before each day. The JAX package runs
this as part of its emitting XLA scan (``letf_tpu/strategies/engine.py``);
no Pallas kernel stands for it.

``emit_days`` launches the kernel for CUDA tensors (float32, one thread a
trial and strategy, bitwise ``emit_days_plain`` on the card) and runs the
twin ``emit_days_plain``, the torch day loops, for CPU tensors, in their
dtype. Both return ``(equity [NS, B], max_dd [NS, B], value [S, N_TAX,
B], traded19 [S, B] bool)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import _build
from letf_tpu_torch.utils import profiling

NS = cfg.N_STRATEGIES          # 19
N_TAX = len(cfg.TAXABLE_IDS)   # 13 (S7..S19)
TAX_OFFSET = 6                 # taxable strategies start at column 6 (S7)
S6, S19 = 5, 18                # the columns whose returns the loop makes
INITIAL_CAPITAL = float(cfg.INITIAL_CAPITAL)
SPREAD = 0.0003
FLT_MIN = float(torch.finfo(torch.float32).tiny)
S6_W = (0.6, 0.4)
S6_LEV = (float(cfg.ASSETS["TQQQ"].leverage), float(cfg.ASSETS["TMF"].leverage))
CHANNELS = ("cand19", "r_tqqq", "r_tmf", "cash", "emb0", "emb1")

LAUNCHES = 0      # csrc/emit_days.cu launches by emit_days


def _ruin_floor(e):
    return torch.where(e < FLT_MIN, 0.0, e)


def emit_days_plain(ret_all, cand19, r_tqqq, r_tmf, cash, emb0, emb1, cf,
                    apply_costs: bool = True):
    """The torch day loops: ``ret_all`` [S, NS, B] (columns S6 and S19
    are made here), the six CHANNELS [S, B], ``cf`` [S] or None."""
    S, _, B = ret_all.shape
    dt, dev = ret_all.dtype, ret_all.device
    alloc19 = torch.empty_like(cand19)
    a19 = torch.zeros(B, dtype=dt, device=dev)
    for t in range(S):
        alloc19[t] = torch.where(torch.abs(cand19[t] - a19) > 0.05,
                                 cand19[t], a19)
        if t > 0:
            a19 = alloc19[t]
    # The carried allocation before each day: 0 before days 0 and 1.
    carried19 = torch.zeros_like(alloc19)
    carried19[2:] = alloc19[1:-1]
    turn19 = torch.abs(cand19 - carried19)
    traded19 = turn19 > 0.05
    ret19 = alloc19 * r_tqqq + (1.0 - alloc19) * cash
    if apply_costs:
        ret19 = ret19 - torch.where(traded19, turn19 * SPREAD, 0.0)
    ret_all = ret_all.clone()
    ret_all[:, S19] = ret19
    ret_all[0, 3:] = 0.0
    if cf is None:
        cf = torch.zeros(S, dtype=dt, device=dev)
    eq = torch.full((NS, B), INITIAL_CAPITAL, dtype=dt, device=dev)
    run_max = eq.clone()
    mdd = torch.zeros_like(eq)
    s6 = [torch.full((B,), INITIAL_CAPITAL * w, dtype=dt, device=dev)
          for w in S6_W]
    value = torch.empty((S, N_TAX, B), dtype=dt, device=dev)
    for t in range(S):
        value[t] = eq[TAX_OFFSET:]
        pg = [s6[0] * (1.0 + r_tqqq[t]), s6[1] * (1.0 + r_tmf[t])]
        total6 = pg[0] + pg[1]
        if t > 0 and t % 21 == 0:
            inv_t6 = 1.0 / torch.clamp_min(total6, 1e-30)
            cw = [pg[0] * inv_t6, pg[1] * inv_t6]
            w_turn = torch.abs(cw[0] - S6_W[0]) + torch.abs(cw[1] - S6_W[1])
            lev_turn = (torch.abs(emb0[t] - S6_LEV[0]) / S6_LEV[0] * cw[0]
                        + torch.abs(emb1[t] - S6_LEV[1]) / S6_LEV[1] * cw[1])
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
            pg, total_after = s6, eq[S6]
        eq_new = eq * (1.0 + ret_all[t])
        eq_new[S6] = total_after
        eq_cf = _ruin_floor(torch.clamp_min(eq_new + cf[t], 0.0))
        scale = eq_cf[S6] / torch.clamp_min(eq_new[S6], 1e-30)
        s6 = [pg[0] * scale, pg[1] * scale]
        run_max = eq_cf if t == 0 else torch.maximum(run_max, eq_cf)
        dd = (eq_cf - run_max) / torch.where(run_max > 0, run_max, 1.0)
        mdd = torch.maximum(mdd, -dd)
        eq = eq_cf
    return eq, mdd, value, traded19


def _consts() -> list:
    """csrc/emit_days.cu's Args constants, in its order (ctypes rounds
    each to float32 as torch rounds a Python scalar)."""
    return [INITIAL_CAPITAL, *(INITIAL_CAPITAL * w for w in S6_W), *S6_W,
            *S6_LEV,
            # torch divides a CUDA tensor by a Python scalar as a multiply
            # by the scalar's float32 reciprocal.
            *(float(np.float32(1.0) / np.float32(lev)) for lev in S6_LEV),
            float(cfg.REBALANCE_COST_PER_DOLLAR), SPREAD]


def emit_days(ret_all, cand19, r_tqqq, r_tmf, cash, emb0, emb1,
              cashflows=None, apply_costs: bool = True):
    """The day loops of the emitting engine on the device of ``ret_all``
    [S, NS, B] (the strategies' day returns; S6's and S19's columns are
    made here): the kernel for CUDA tensors (float32), ``emit_days_plain``
    for CPU tensors. The six CHANNELS are [S, B]: S19's candidate
    allocation, TQQQ's and TMF's returns, cash, and S6's embedded leverage
    of TQQQ and of TMF; ``cashflows`` optional [S] dollar flows. Shapes
    are checked before any launch. Counts ``fused_emit_rows`` (B) on the
    kernel, ``plain_emit_rows`` on the twin."""
    global LAUNCHES
    if ret_all.ndim != 3 or ret_all.shape[1] != NS or ret_all.shape[0] < 1:
        raise ValueError(f"emit_days: ret_all {tuple(ret_all.shape)}, "
                         f"expected [S >= 1, {NS}, B]")
    S, _, B = ret_all.shape
    chans = dict(zip(CHANNELS, (cand19, r_tqqq, r_tmf, cash, emb0, emb1)))
    for name, c in chans.items():
        if tuple(c.shape) != (S, B):
            raise ValueError(f"emit_days: {name} {tuple(c.shape)}, "
                             f"expected {(S, B)}")
    dt, dev = ret_all.dtype, ret_all.device
    cf = (None if cashflows is None
          else torch.as_tensor(cashflows, dtype=dt, device=dev))
    if cf is not None and tuple(cf.shape) != (S,):
        raise ValueError(f"emit_days: cashflows {tuple(cf.shape)}, "
                         f"expected {(S,)}")
    if dev.type == "cpu":
        profiling.count("plain_emit_rows", B)
        return emit_days_plain(ret_all, *chans.values(), cf, apply_costs)
    ins = dict(ret_all=ret_all.contiguous(),
               **{k: c.contiguous() for k, c in chans.items()})
    cf = cf.contiguous() if cf is not None else None
    _build.check_cuda("emit_days", dev,
                      **{k: (c, torch.float32) for k, c in ins.items()},
                      **({} if cf is None else
                         {"cashflows": (cf, torch.float32)}))
    eq = torch.empty((NS, B), dtype=torch.float32, device=dev)
    mdd = torch.empty_like(eq)
    value = torch.empty((S, N_TAX, B), dtype=torch.float32, device=dev)
    traded19 = torch.empty((S, B), dtype=torch.bool, device=dev)
    ptrs = (ctypes.c_void_p * 8)(*[c.data_ptr() for c in ins.values()],
                                 cf.data_ptr() if cf is not None else None)
    kc = (ctypes.c_float * 11)(*_consts())
    rc = _build.library().letf_emit_days(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(kc, ctypes.c_void_p),
        S, B, int(apply_costs), eq.data_ptr(), mdd.data_ptr(),
        value.data_ptr(), traded19.data_ptr(), _build.stream_of(eq))
    _build.check(rc, "letf_emit_days")
    LAUNCHES += 1
    profiling.count("fused_emit_rows", B)
    return eq, mdd, value, traded19
