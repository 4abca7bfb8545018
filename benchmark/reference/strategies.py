"""Frozen copy of ``letf_tpu_torch/ops/strategies.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

The 19 strategies over precomputed channels (kernel K4).

Port of ``letf_tpu/ops/pallas_strategies.py::_strategy_kernel`` in its
channel modes (entry ``pallas_strategies_run``):

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

from benchmark.reference import compose_strategies as k3
from benchmark.reference import precision


CHANNELS = ("r_tqqq", "r_spy", "r_sso", "r_tmf", "cash", "regime", "vix",
            *k3.SIGNALS)
N_FUSED = 7                  # channels read in fused-signals mode


def strategies_plain(channels, cashflows=None, apply_costs: bool = True,
                     fused_signals: bool = False):
    """Plain PyTorch K4: the kernel's day loop, one [B] tensor per value."""
    S, B = channels[0].shape
    dev = channels[0].device
    cf = cashflows.to(precision.F) if cashflows is not None else None
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
