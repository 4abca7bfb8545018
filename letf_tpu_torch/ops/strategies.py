"""The 19 strategies over precomputed channels (kernel K4).

Port of ``letf_tpu/ops/pallas_strategies.py::_strategy_kernel`` in its
channel modes (entry ``pallas_strategies_run``) and of ``channels_from``:

- channel mode: 23 ``[S, B]`` channels in ``CHANNELS`` order (the path's
  TQQQ/SPY/SSO/TMF returns, cash, regime, VIX, then the 16 signals); the
  strategies read the signals at shift(1), S7 today's;
- fused-signals mode: only the first 7 channels; the 16 signals are
  computed day by day from ring buffers, as kernel K3 computes them.

The day math is ``compose_strategies.signals_step`` / ``strategies_step``
in the plain version and ``csrc/strategies_day.cuh`` in the kernel, each
shared with K3. Returns ``(final_wealth [B, 19], num_trades [B, 19] int32,
max_dd [B, 19])`` float32. ``strategies_run`` launches
``csrc/strategies.cu`` for CUDA tensors (any trial count) and runs
``strategies_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import _build
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.strategies.signals import (
    IDX_SPY,
    IDX_SSO,
    IDX_TMF,
    IDX_TQQQ,
)

LAUNCHES = 0      # kernel launches by strategies_run on CUDA tensors

NS = cfg.N_STRATEGIES
CHANNELS = ("r_tqqq", "r_spy", "r_sso", "r_tmf", "cash", "regime", "vix",
            *k3.SIGNALS)
NCH = len(CHANNELS)          # 23
N_FUSED = 7                  # channels read in fused-signals mode


def channels_from(path, sig) -> list:
    """The CHANNELS-ordered [S, B] float32 channels of a path batch (the
    port's PathOutputs, ``etf_ret`` [A, S, B]) and its SignalSet
    (pallas_strategies.channels_from)."""
    etf = path.etf_ret
    chans = [etf[IDX_TQQQ], etf[IDX_SPY], etf[IDX_SSO], etf[IDX_TMF],
             path.cash_ret, path.regime, path.vix, sig.spy_price,
             sig.tqqq_std20_mp20, sig.tqqq_dstd20_mp20, sig.tqqq_std5,
             sig.tqqq_std10, sig.tqqq_std20, sig.tqqq_std60,
             sig.tqqq_dstd20, sig.tqqq_skew60, sig.tqqq_mean60_ann,
             sig.tqqq_volmom5, sig.spy_sum126, sig.spy_sma200_mp1,
             sig.spy_sma200, sig.spy_sma100_mp1, sig.spy_rsi14]
    return [c.to(torch.float32).contiguous() for c in chans]


def strategies_plain(channels, cashflows=None, apply_costs: bool = True,
                     fused_signals: bool = False):
    """Plain PyTorch K4: the kernel's day loop, one [B] tensor per value."""
    S, B = channels[0].shape
    dev = channels[0].device
    cf = cashflows.to(torch.float32) if cashflows is not None else None
    st = k3.StrategyCarry(B, dev)
    sig = k3.SignalCarry(B, dev) if fused_signals else None
    for t in range(S):
        r_tqqq, r_spy, r_sso, r_tmf, cashr, reg, vx = (c[t] for c in
                                                       channels[:N_FUSED])
        if fused_signals:
            cur = k3.signals_step(sig, t, st.psig["spy_price"], r_tqqq,
                                  r_spy)
        else:
            cur = {k: c[t] for k, c in zip(k3.SIGNALS, channels[N_FUSED:])}
        k3.strategies_step(st, t, r_tqqq, r_spy, r_sso, r_tmf, cashr, reg,
                           vx, cur, cf[t] if cf is not None else 0.0,
                           apply_costs)
    return st.summary()


def strategies_run(channels, cashflows=None, apply_costs: bool = True,
                   fused_signals: bool = False):
    """K4 on the device of the channels: the CUDA kernel for CUDA tensors,
    ``strategies_plain`` for CPU tensors. ``channels``: the 23 (or, fused,
    the first 7) CHANNELS as [S, B] float32; ``cashflows``: optional [S]."""
    global LAUNCHES
    n = N_FUSED if fused_signals else NCH
    if len(channels) != n:
        raise ValueError(f"strategies_run: {n} channels expected, got "
                         f"{len(channels)}")
    channels = list(channels)
    if channels[0].device.type == "cpu":
        return strategies_plain(channels, cashflows, apply_costs,
                                fused_signals)
    S, B = channels[0].shape
    dev = channels[0].device
    for name, c in zip(CHANNELS, channels):
        if c.shape != (S, B):
            raise ValueError(f"strategies_run: {name} {tuple(c.shape)}")
    _build.check_cuda("strategies_run", dev,
                      **{k: (c, torch.float32)
                         for k, c in zip(CHANNELS, channels)})
    cf = (cashflows.to(device=dev, dtype=torch.float32).contiguous()
          if cashflows is not None else None)
    if cf is not None and cf.shape != (S,):
        raise ValueError(f"strategies_run: cashflows {tuple(cf.shape)}")
    kc = torch.tensor(k3.strategy_consts(), dtype=torch.float64).to(
        device=dev, dtype=torch.float32)
    # The channel pointers go in by value (a host array; the kernel takes
    # them as launch arguments).
    ptrs = (ctypes.c_void_p * n)(*[c.data_ptr() for c in channels])
    rings = (torch.empty((k3.RING_ROWS, B), dtype=torch.float32, device=dev)
             if fused_signals else None)
    out = torch.empty((3 * NS, B), dtype=torch.float32, device=dev)
    rc = _build.library().letf_strategies(
        cf.data_ptr() if cf is not None else None, kc.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p),
        rings.data_ptr() if rings is not None else None,
        S, B, int(apply_costs), int(cf is not None), int(fused_signals),
        out.data_ptr(), _build.stream_of(channels[0]))
    _build.check(rc, "letf_strategies")
    LAUNCHES += 1
    return (out[:NS].t(), out[NS:2 * NS].t().to(torch.int32),
            out[2 * NS:].t())
