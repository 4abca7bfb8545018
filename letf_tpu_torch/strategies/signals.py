"""Shared rolling signals of the strategy engine (plain PyTorch).

Port of ``letf_tpu/strategies/signals.py::compute_signals``: per-asset
price paths and the 15 windowed TQQQ/SPY statistics the 19 strategies read,
computed once per path batch. Layout ``[S, B]`` (``prices`` ``[A, S, B]``);
signals are stored unshifted, the engine reads them at day t-1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import rolling as rl

SQ252 = float(np.sqrt(252.0))

IDX_TQQQ = cfg.ASSET_INDEX["TQQQ"]
IDX_SSO = cfg.ASSET_INDEX["SSO"]
IDX_TMF = cfg.ASSET_INDEX["TMF"]
IDX_SPY = cfg.ASSET_INDEX["SPY"]


class SignalSet(NamedTuple):
    prices: torch.Tensor          # [A, S, B] cumprod(1 + r) * 100
    spy_price: torch.Tensor       # [S, B]
    tqqq_std20_mp20: torch.Tensor
    tqqq_dstd20_mp20: torch.Tensor
    tqqq_std5: torch.Tensor       # min_periods=1 unless _mp noted
    tqqq_std10: torch.Tensor
    tqqq_std20: torch.Tensor
    tqqq_std60: torch.Tensor
    tqqq_dstd20: torch.Tensor
    tqqq_skew60: torch.Tensor
    tqqq_mean60_ann: torch.Tensor
    tqqq_volmom5: torch.Tensor    # pct_change(5) of tqqq_std20
    spy_sum126: torch.Tensor
    spy_sma200_mp1: torch.Tensor
    spy_sma200: torch.Tensor      # min_periods=200
    spy_sma100_mp1: torch.Tensor
    spy_rsi14: torch.Tensor


def compute_signals(path) -> SignalSet:
    """``path.etf_ret`` is ``[A, S, B]`` (the port's PathOutputs)."""
    etf = path.etf_ret
    prices = torch.cumprod(1.0 + etf, dim=1) * 100.0
    spy_price = prices[IDX_SPY]
    r_tqqq = etf[IDX_TQQQ]
    r_spy = etf[IDX_SPY]
    neg_tqqq = torch.where(r_tqqq < 0, r_tqqq, 0.0)
    std20 = rl.rolling_std(r_tqqq, 20, 1, axis=0) * SQ252
    return SignalSet(
        prices=prices,
        spy_price=spy_price,
        tqqq_std20_mp20=rl.rolling_std(r_tqqq, 20, axis=0) * SQ252,
        tqqq_dstd20_mp20=rl.rolling_std(neg_tqqq, 20, axis=0) * SQ252,
        tqqq_std5=rl.rolling_std(r_tqqq, 5, 1, axis=0) * SQ252,
        tqqq_std10=rl.rolling_std(r_tqqq, 10, 1, axis=0) * SQ252,
        tqqq_std20=std20,
        tqqq_std60=rl.rolling_std(r_tqqq, 60, 1, axis=0) * SQ252,
        tqqq_dstd20=rl.rolling_std(neg_tqqq, 20, 1, axis=0) * SQ252,
        tqqq_skew60=rl.rolling_skew(r_tqqq, 60, 1, axis=0),
        tqqq_mean60_ann=rl.rolling_mean(r_tqqq, 60, 1, axis=0) * 252.0,
        tqqq_volmom5=rl.pct_change(std20, 5, axis=0),
        spy_sum126=rl.rolling_sum(r_spy, 126, 1, axis=0),
        spy_sma200_mp1=rl.rolling_mean(spy_price, 200, 1, axis=0),
        spy_sma200=rl.rolling_mean(spy_price, 200, axis=0),
        spy_sma100_mp1=rl.rolling_mean(spy_price, 100, 1, axis=0),
        spy_rsi14=rl.rsi(spy_price, 14, axis=0),
    )
