"""Levered GBM buy-and-hold: the headline path (kernel K6).

Port of ``letf_tpu/ops/pallas_path.py``:

- ``gbm_buyhold`` (<- ``gbm_buyhold_pallas``): final wealth multiple and
  max drawdown [N] float32 of N trials of a daily-rebalanced L-times GBM
  over ``n_days``: the reference's log-wealth sum of
  ``log1p(max(L*r - cost, -0.999))``, computed as products of the daily
  growth factors over blocks of ``block_pairs`` day pairs, one log a
  block (csrc/gbm.cu says why, and why it is exact in range). It
  launches ``csrc/gbm.cu`` for a CUDA device and runs ``gbm_plain`` for the
  CPU. The TPU kernel's hardware PRNG cannot be reproduced: both draw
  their normals by Box-Muller from a murmur3 counter generator keyed by
  (seed words, trial, day pair), bit for bit the same uniforms; the seed
  words are a threefry hash of the seed, so adjacent seeds give unrelated
  streams. Against the JAX package the kernel agrees in distribution.
- ``gbm_buyhold_xla`` (<- ``gbm_buyhold_xla``): the XLA twin, a day loop
  with ``jax.random.normal`` draws of split(key, n_days) (ops/rng.py).
- ``gbm_percentile_report``: the headline report (percentile fan, CAGR
  fan, CVaR(5%), median max drawdown), reduced on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from letf_tpu_torch.ops import _build, rng
from letf_tpu_torch.ops.reductions import PERCENTILES
from letf_tpu_torch.utils.device import resolve_device

LAUNCHES = 0      # kernel launches by gbm_buyhold on a CUDA device

_TWO_PI = 2.0 * math.pi
_SEED_STREAM = 0x6B6      # fold_in data of the seed words
_Z_MAX = 5.9              # |z| bound of the counter Box-Muller normals
_G_FLOOR = 1.0 - float(np.float32(0.999))     # 1 + max(net, -0.999)'s floor
_MAX_BLOCK_PAIRS = 1 << 20


def seed_words(seed: int):
    """The two 32-bit words keying the counter generator: the threefry key
    data of fold_in(key(seed), 0x6B6)."""
    k = rng.fold_in(rng.key(seed), _SEED_STREAM)
    return [int(v) for v in k.tolist()]


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def block_pairs(mu: float, sigma: float, leverage: float,
                daily_cost: float) -> int:
    """Day pairs a block of K6's linear-domain compounding may span
    (csrc/gbm.cu): the most pairs whose product of daily growth factors g
    stays a normal float32 for every draw. With |z| <= 5.9 (a 24-bit unit
    uniform is >= 2^-25, so sqrt(-2 ln u1) <= 5.887), g lies in [gmin,
    gmax] = [max(1 + L mu - |L| 5.9 sigma - cost, 1 - 0.999), 1 + L mu +
    |L| 5.9 sigma - cost]; 2 kp days keep gmin^(2 kp) >= e^-87 and
    gmax^(2 kp) <= e^88 (float32's normal range is e^-87.3 .. e^88.7).
    Raises ValueError for non-finite parameters or where even one pair
    cannot hold."""
    mu, sigma, lev, cost = (float(np.float32(v)) for v in
                            (mu, sigma, leverage, daily_cost))
    if not all(math.isfinite(v) for v in (mu, sigma, lev, cost)):
        raise ValueError(f"gbm: non-finite parameters mu {mu}, sigma "
                         f"{sigma}, leverage {lev}, cost {cost}")
    spread = abs(lev) * _Z_MAX * abs(sigma)
    gmin = max(1.0 + lev * mu - spread - cost, _G_FLOOR)
    gmax = 1.0 + lev * mu + spread - cost
    days = _MAX_BLOCK_PAIRS * 2.0
    if gmin < 1.0:
        days = min(days, 87.0 / -math.log(gmin))
    if gmax > 1.0:
        days = min(days, 88.0 / math.log(gmax))
    kp = int(days // 2)
    if kp < 1:
        raise ValueError(f"gbm: a daily growth factor in [{gmin}, {gmax}] "
                         "overflows float32 over one day pair")
    return kp


def pair_normals(lane, i: int, w, dev):
    """Day pair i's two normals [N] (rad * cos, rad * sin) from the trials'
    lane keys: the kernel's counter bits and Box-Muller."""
    pk = rng.day_keys(lane, torch.tensor([i], device=dev), w)[0]
    u1 = rng.bits_to_unit(rng.stream_bits(pk, 0))
    u2 = rng.bits_to_unit(rng.stream_bits(pk, 1))
    rad = torch.sqrt(-2.0 * torch.log(u1))
    ang = _f32(_TWO_PI).to(dev) * u2
    return rad * torch.cos(ang), rad * torch.sin(ang)


def gbm_plain(seed: int, n_trials: int, n_days: int, mu: float, sigma: float,
              leverage: float = 3.0, daily_cost: float = 0.0,
              device="cpu"):
    """Plain PyTorch K6: the kernel's loop over day pairs, one [N] tensor
    per value, the same counter bits and float32 operations in the same
    order: g = 1 + max(net, -0.999) compounded in blocks of
    ``block_pairs`` pairs, the log of each block's product summed, the
    drawdown 1 - min(W_t / max_{s<=t} W_s)."""
    dev = torch.device(device)
    kp = block_pairs(mu, sigma, leverage, daily_cost)
    w = seed_words(seed)
    lane = rng.lane_keys(torch.arange(n_trials, device=dev), w)
    mu_t, sig_t, lev_t, cost_t = (_f32(v).to(dev) for v in
                                  (mu, sigma, leverage, daily_cost))
    ones = torch.ones(n_trials, dtype=torch.float32, device=dev)
    acc = torch.zeros_like(ones)
    wb, d, mn = ones, ones, ones

    def day(wb, d, mn, z):
        net = lev_t * (mu_t + sig_t * z) - cost_t
        g = 1.0 + torch.clamp_min(net, -0.999)
        d = torch.clamp_max(d * g, 1.0)
        return wb * g, d, torch.minimum(mn, d)

    n_pairs = n_days // 2
    for i0 in range(0, n_pairs, kp):
        for i in range(i0, min(i0 + kp, n_pairs)):
            z1, z2 = pair_normals(lane, i, w, dev)
            wb, d, mn = day(wb, d, mn, z1)
            wb, d, mn = day(wb, d, mn, z2)
        acc = acc + torch.log(wb)
        wb = ones
    if n_days % 2 == 1:
        z1, _ = pair_normals(lane, n_pairs, w, dev)
        wb, d, mn = day(wb, d, mn, z1)
        acc = acc + torch.log(wb)
    return torch.exp(acc), 1.0 - mn


def gbm_buyhold(seed: int, n_trials: int, n_days: int, mu: float,
                sigma: float, leverage: float = 3.0, daily_cost: float = 0.0,
                device="cuda"):
    """K6 on ``device``: the CUDA kernel on a card, ``gbm_plain`` on the
    CPU. Returns (final wealth multiple [N], max drawdown [N]) float32;
    any trial count (the TPU's 1,024-trial tile is gone)."""
    global LAUNCHES
    dev = resolve_device(device)
    if dev.type == "cpu":
        return gbm_plain(seed, n_trials, n_days, mu, sigma, leverage,
                         daily_cost, dev)
    if n_trials < 0 or n_days < 0 or n_trials >= 2 ** 31:
        raise ValueError(f"gbm_buyhold: n_trials {n_trials}, n_days "
                         f"{n_days}")
    kp = block_pairs(mu, sigma, leverage, daily_cost)
    w = seed_words(seed)
    out_w = torch.empty(n_trials, dtype=torch.float32, device=dev)
    out_mdd = torch.empty_like(out_w)
    rc = _build.library().letf_gbm(
        w[0], w[1], n_trials, n_days, kp, *(float(np.float32(v)) for v in
                                        (mu, sigma, leverage, daily_cost)),
        out_w.data_ptr(), out_mdd.data_ptr(), _build.stream_of(out_w))
    _build.check(rc, "letf_gbm")
    LAUNCHES += 1
    return out_w, out_mdd


def gbm_buyhold_xla(key, n_trials: int, n_days: int, mu: float,
                    sigma: float, leverage: float = 3.0,
                    daily_cost: float = 0.0):
    """The XLA twin (pallas_path.gbm_buyhold_xla): day t's normals are
    ``jax.random.normal(split(key, n_days)[t], (N,), float32)``; the carry
    is (log-wealth, peak, max drawdown) [N] float32. ``key``: a threefry
    key (ops/rng.key) on the device to run on."""
    keys = rng.split(key, n_days)
    dev = key.device
    mu_t, sig_t, lev_t, cost_t = (_f32(v).to(dev) for v in
                                  (mu, sigma, leverage, daily_cost))
    acc = torch.zeros(n_trials, dtype=torch.float32, device=dev)
    peak = torch.zeros_like(acc)
    mdd = torch.zeros_like(acc)
    for t in range(n_days):
        z = rng.normal(keys[t], n_trials, torch.float32)
        net = lev_t * (mu_t + sig_t * z) - cost_t
        acc = acc + torch.log1p(torch.clamp_min(net, -0.999))
        peak = torch.maximum(peak, acc)
        mdd = torch.maximum(mdd, peak - acc)
    return torch.exp(acc), 1.0 - torch.exp(-mdd)


def gbm_percentile_report(seed: int, n_trials: int, years: int,
                          annual_mu: float = 0.10, annual_sigma: float = 0.24,
                          leverage: float = 3.0,
                          expense_ratio: float = 0.0086,
                          borrow_annual: float = 0.0, use_kernel: bool = True,
                          device="cuda"):
    """The buy-and-hold headline (pallas_path.gbm_percentile_report): a
    TQQQ-style fan of wealth and CAGR percentiles, CVaR(5%) (the mean of
    the worst 5% of final wealth) and the median max drawdown, reduced on
    the device. ``use_kernel``: K6 (``gbm_buyhold``), else the XLA twin."""
    dev = resolve_device(device)
    n_days = years * 252
    mu = annual_mu / 252.0
    sigma = annual_sigma / math.sqrt(252.0)
    daily_cost = (expense_ratio / 252.0
                  + max(leverage - 1.0, 0.0) * borrow_annual / 252.0)
    if use_kernel:
        w, mdd = gbm_buyhold(seed, n_trials, n_days, mu, sigma, leverage,
                             daily_cost, dev)
    else:
        w, mdd = gbm_buyhold_xla(rng.key(seed, dev), n_trials, n_days, mu,
                                 sigma, leverage, daily_cost)
    q = torch.tensor(PERCENTILES, dtype=torch.float32, device=dev) / 100.0
    wp = torch.quantile(w, q, interpolation="linear").cpu().numpy()
    n_tail = max(1, int(n_trials * 0.05))
    cvar = -torch.topk(-w, n_tail).values.mean()
    return {
        "percentiles": {f"p{int(p)}": float(v)
                        for p, v in zip(PERCENTILES, wp)},
        "cagr_percentiles": {f"p{int(p)}": float(v ** (1.0 / years) - 1.0)
                             for p, v in zip(PERCENTILES, wp)},
        "cvar_5pct_wealth": float(cvar),
        "median_max_drawdown": float(torch.quantile(mdd, 0.5)),
        "n_trials": n_trials,
        "years": years,
        "engine": "kernel" if use_kernel else "xla",
    }
