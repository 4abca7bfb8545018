"""Block bootstrap: stitched historical blocks for the ``legacy_hybrid``
engine mode.

Port of ``letf_tpu/models/bootstrap.py``:

- ``build_bootstrap_pools`` (``:49``): overlapping 168-day blocks (stride
  21) of the history, split by regime (block VIX median >= 25), into two
  padded pools: A "economy" [SPY, TLT, VIX, IRX] over all history, B
  "tech" [SPY, QQQ, TLT, VIX, IRX] over the real-QQQ era (from
  1999-03-10), each with its blocks' SPY returns. The same numpy
  operations on the port's day frame (``utils/frame.Frame``), so the pools
  are the JAX package's bit for bit.
- ``create_bootstrap_sampler`` (``:139``): build and cache in the port's
  cache directory (``config.BOOTSTRAP_CACHE``).
- ``sample_bootstrap_returns`` (``:186``) for a batch of trials, batch
  last: segment lengths are geometric draws clipped to [21, 168]; a loop
  over segments (``n_days // 21 + 2`` steps, all trials at once) carries
  the momentum state and picks each pool's block by Gumbel-top-1 over
  sign-masked, kernel-weighted candidates (``_pick_block``, ``:157``);
  then one gather maps each day to its segment and stitches the series,
  and the sampler's Student-t noise blend is elementwise. The threefry
  draws are the JAX package's (``jax.random.split`` into 3, then 6 a
  segment; ``uniform``, ``gumbel``, ``randint`` with a per-trial bound,
  ``t``), so the chosen blocks and offsets are its own up to float
  near-ties (the Gumbel logs are torch's, an ulp from XLA's). The Gumbel
  draws, ``[B, N]`` a pool, are made one segment at a time.

None of this is a TPU kernel in the JAX package (an XLA scan and gathers);
here it is torch glue in the dtype of the pools (float64 on the CPU,
float32 on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_engine import cholesky_mix
from letf_tpu_torch.utils.cache import load_cache, save_cache
from letf_tpu_torch.utils.device import index_dtype

L = cfg.BOOTSTRAP_BLOCK_SIZE          # 168 rows per stored block
_STRIDE = 21
REAL_QQQ_START = np.datetime64("1999-03-10", "D")


class BootstrapPools(NamedTuple):
    """Padded per-regime block pools (numpy, or tensors from ``pools_on``)."""
    a_data: np.ndarray    # [R, N, L, 4]  SPY, TLT, VIX, IRX
    a_ret: np.ndarray     # [R, N] block SPY return
    a_count: np.ndarray   # [R]
    b_data: np.ndarray    # [R, N, L, 5]  SPY, QQQ, TLT, VIX, IRX
    b_ret: np.ndarray     # [R, N]
    b_count: np.ndarray   # [R]


def build_bootstrap_pools(df) -> BootstrapPools:
    """Overlapping regime-labelled blocks of the history ``df`` (a
    ``Frame``: SPY_Ret, VIX and, where present, QQQ_Ret, TLT_Ret, IRX)."""
    vix = np.asarray(df["VIX"], float)
    spy = np.asarray(df["SPY_Ret"], float)
    qqq = (np.asarray(df["QQQ_Ret"], float) if "QQQ_Ret" in df
           else spy * 1.25)
    tlt = (np.asarray(df["TLT_Ret"], float) if "TLT_Ret" in df
           else spy * -0.25)
    irx = (np.asarray(df["IRX"], float) if "IRX" in df
           else np.full(len(df), 4.5))
    has_real_qqq = np.asarray(df.index, "datetime64[D]") >= REAL_QQQ_START

    a_blocks, a_rets = {0: [], 1: []}, {0: [], 1: []}
    b_blocks, b_rets = {0: [], 1: []}, {0: [], 1: []}
    for start in range(0, len(df) - L + 1, _STRIDE):
        end = start + L
        block_vix = vix[start:end]
        regime = 0 if np.nanmedian(block_vix) < 25 else 1
        block_spy = spy[start:end]
        if np.isnan(block_spy).sum() > L // 4:
            continue
        block_ret = float(np.prod(1 + np.nan_to_num(block_spy)) - 1)
        a_blocks[regime].append(np.column_stack([
            np.nan_to_num(block_spy),
            np.nan_to_num(tlt[start:end]),
            np.nan_to_num(block_vix, nan=20.0),
            np.nan_to_num(irx[start:end], nan=4.5),
        ]))
        a_rets[regime].append(block_ret)
        if bool(np.all(has_real_qqq[start:end])):
            b_blocks[regime].append(np.column_stack([
                np.nan_to_num(block_spy),
                np.nan_to_num(qqq[start:end]),
                np.nan_to_num(tlt[start:end]),
                np.nan_to_num(block_vix, nan=20.0),
                np.nan_to_num(irx[start:end], nan=4.5),
            ]))
            b_rets[regime].append(block_ret)

    def synthetic_block(regime: int, cols: int, seed: int) -> np.ndarray:
        """Stand-in block of an empty pool (reference bootstrap.py:273-301)."""
        g = np.random.default_rng(seed)
        std, vix_base, irx_base = ((0.011, 15.0, 3.5) if regime == 0
                                   else (0.035, 40.0, 1.5))
        s = g.standard_t(cfg.STUDENT_T_DF, L) * std
        rows = [s, s * 1.25, -s * 0.25,
                np.full(L, vix_base) + g.normal(0, 3, L),
                np.clip(np.full(L, irx_base) + g.normal(0, 0.5, L), 0, 15)]
        if cols == 4:
            rows = [rows[0], rows[2], rows[3], rows[4]]
        return np.column_stack(rows)

    def pad(blocks, rets, cols):
        n_max = max(1, max(len(blocks[r]) for r in range(2)))
        data = np.zeros((2, n_max, L, cols))
        ret = np.zeros((2, n_max))
        count = np.zeros(2, np.int32)
        for r in range(2):
            if not blocks[r]:
                data[r, 0] = synthetic_block(r, cols, seed=1000 + r)
                ret[r, 0] = float(np.prod(1 + data[r, 0, :, 0]) - 1)
                count[r] = 1
                continue
            for i, b in enumerate(blocks[r]):
                data[r, i] = b
                ret[r, i] = rets[r][i]
            count[r] = len(blocks[r])
            # The tail repeats the last block so gathers stay in bounds.
            data[r, count[r]:] = data[r, count[r] - 1]
            ret[r, count[r]:] = ret[r, count[r] - 1]
        return data, ret, count

    a_data, a_ret, a_count = pad(a_blocks, a_rets, 4)
    b_data, b_ret, b_count = pad(b_blocks, b_rets, 5)
    return BootstrapPools(a_data=a_data, a_ret=a_ret, a_count=a_count,
                          b_data=b_data, b_ret=b_ret, b_count=b_count)


def create_bootstrap_sampler(df) -> BootstrapPools:
    """The pools of ``df``, from the port's cache when it holds them."""
    cached = load_cache(cfg.BOOTSTRAP_CACHE)
    if cached is not None:
        print("[OK] Using cached bootstrap pools")
        return cached
    print("  Building block bootstrap pools from historical data...")
    pools = build_bootstrap_pools(df)
    cfg.init_cache()
    save_cache(pools, cfg.BOOTSTRAP_CACHE)
    return pools


def pools_on(pools: BootstrapPools, device, dtype) -> BootstrapPools:
    """The pools as tensors on ``device``: data and returns in ``dtype``,
    counts as int64 (a no-op for pools already there)."""
    def conv(a, dt):
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, device=device).to(dt)

    return BootstrapPools(*(conv(a, torch.int64 if f.endswith("count")
                                 else dtype)
                            for f, a in zip(BootstrapPools._fields, pools)))


def _pick_block(ret_table, count, regime, last, have_sign, bias, target,
                use_kernel: bool, u_bias, gumbel):
    """Gumbel-top-1 block of each trial [B] (bootstrap.py:157): candidates
    are the regime's valid blocks, restricted to the momentum sign of
    ``last`` with probability ``bias`` once a sign exists; with
    ``use_kernel`` and more than five candidates, log-weights of a Gaussian
    kernel around ``target`` (sigma the candidates' return std)."""
    N = ret_table.shape[1]
    valid = (torch.arange(N, device=regime.device)[None, :]
             < count[regime][:, None])
    rets = ret_table[regime]                                     # [B, N]
    same_sign = torch.where((last >= 0)[:, None], rets >= 0, rets < 0)
    sign_ok = have_sign & (u_bias < bias) & (same_sign & valid).any(1)
    cand = valid & torch.where(sign_ok[:, None], same_sign, True)
    score = gumbel
    if use_kernel:
        n_cand = cand.sum(1)
        denom = n_cand.clamp_min(1).to(rets.dtype)[:, None]
        mean_c = torch.where(cand, rets, 0.0).sum(1, keepdim=True) / denom
        var_c = (torch.where(cand, (rets - mean_c) ** 2, 0.0)
                 .sum(1, keepdim=True) / denom)
        sigma = torch.sqrt(torch.clamp_min(var_c, 0.0))
        sigma = torch.where(sigma < 1e-8, 0.05, sigma)
        logw = -0.5 * ((rets - target[:, None]) / sigma) ** 2
        score = torch.where((n_cand > 5)[:, None], logw, 0.0) + gumbel
    return torch.where(cand, score, -torch.inf).argmax(1)


def _sub_return(block, off, slen):
    """expm1 of the log-growth of rows [off, off + slen) of ``block`` [B,
    L], from its prefix sums of log1p as the JAX version forms it."""
    lc = torch.cat([torch.zeros_like(block[:, :1]),
                    torch.cumsum(torch.log1p(block), 1)], 1)
    return torch.expm1(lc.gather(1, (off + slen)[:, None])[:, 0]
                       - lc.gather(1, off[:, None])[:, 0])


class BootstrapPlan(NamedTuple):
    """Each trial's stitching: [max_seg, B] per segment."""
    lengths: torch.Tensor       # int64, drawn (before the horizon cut)
    seg_regime: torch.Tensor    # int64 majority regime
    seg_len: torch.Tensor       # int64, cut at n_days
    blk_a: torch.Tensor
    off_a: torch.Tensor
    blk_b: torch.Tensor
    off_b: torch.Tensor


def bootstrap_plan(pools: BootstrapPools, regime_path, k_len, k_sel,
                   n_days: int) -> BootstrapPlan:
    """Segment lengths, regimes and the chosen (block, offset) of both
    pools for every segment of every trial: ``pools`` from ``pools_on``,
    ``regime_path`` [n_days, B], ``k_len``/``k_sel`` [B, 2] keys."""
    dt = pools.a_ret.dtype
    dev = regime_path.device
    idt = index_dtype(dt)
    B = regime_path.shape[1]
    max_seg = n_days // cfg.BOOTSTRAP_BLOCK_MIN + 2

    u_len = rng.uniform(k_len, max_seg, dt).t()                  # [M, B]
    p_stay = 1.0 - 1.0 / cfg.BOOTSTRAP_BLOCK_MEAN
    lengths = torch.clamp(
        torch.ceil(torch.log1p(-u_len)
                   / torch.log(torch.tensor(p_stay, dtype=dt, device=dev))),
        cfg.BOOTSTRAP_BLOCK_MIN, cfg.BOOTSTRAP_BLOCK_MAX).to(torch.int64)
    ends = torch.cumsum(lengths, 0)
    starts = ends - lengths
    seg_end = torch.clamp_max(ends, n_days)
    seg_len = torch.clamp_min(seg_end - starts, 0)
    # Majority regime of each segment from the regime path's prefix sums;
    # high days / max(len, 1) >= 0.5 is 2 * high >= max(len, 1) exactly.
    csum = torch.cat([torch.zeros_like(regime_path[:1], dtype=torch.int64),
                      torch.cumsum(regime_path.to(torch.int64), 0)])
    high = (csum.gather(0, seg_end.clamp(0, n_days))
            - csum.gather(0, starts.clamp(0, n_days)))
    seg_regime = (2 * high >= seg_len.clamp_min(1)).to(torch.int64)

    bias_tab = torch.tensor([cfg.BOOTSTRAP_MOMENTUM_BIAS_BY_REGIME[r]
                             for r in range(2)], dtype=dt, device=dev)
    ks = rng.split(k_sel, max_seg)                                # [B, M, 2]
    last_a = torch.zeros(B, dtype=dt, device=dev)
    last_b = torch.zeros_like(last_a)
    have = torch.zeros(B, dtype=torch.bool, device=dev)
    zero = torch.zeros_like(last_a)
    cols = {k: [] for k in ("blk_a", "off_a", "blk_b", "off_b")}
    n_a, n_b = pools.a_ret.shape[1], pools.b_ret.shape[1]
    for s in range(max_seg):
        k6 = rng.split(ks[:, s], 6)                               # [B, 6, 2]
        regime, slen = seg_regime[s], seg_len[s]
        bias = bias_tab[regime]
        hi = (L - slen + 1).to(idt)
        blk_a = _pick_block(pools.a_ret, pools.a_count, regime, last_a, have,
                            bias, zero, False,
                            rng.uniform(k6[:, 0], 1, dt)[:, 0],
                            rng.gumbel(k6[:, 1], n_a, dt))
        off_a = rng.randint(k6[:, 2], 0, hi, idt).to(torch.int64)
        spy_ret_a = _sub_return(pools.a_data[regime, blk_a, :, 0], off_a,
                                slen)
        blk_b = _pick_block(pools.b_ret, pools.b_count, regime, last_b, have,
                            bias, spy_ret_a, True,
                            rng.uniform(k6[:, 3], 1, dt)[:, 0],
                            rng.gumbel(k6[:, 4], n_b, dt))
        off_b = rng.randint(k6[:, 5], 0, hi, idt).to(torch.int64)
        last_b = _sub_return(pools.b_data[regime, blk_b, :, 1], off_b, slen)
        last_a = spy_ret_a
        have = torch.ones_like(have)
        for k, v in (("blk_a", blk_a), ("off_a", off_a), ("blk_b", blk_b),
                     ("off_b", off_b)):
            cols[k].append(v)
    return BootstrapPlan(lengths, seg_regime, seg_len,
                         *(torch.stack(cols[k]) for k in
                           ("blk_a", "off_a", "blk_b", "off_b")))


def stitch(pools: BootstrapPools, plan: BootstrapPlan, n_days: int):
    """The stitched [n_days, B] series of a plan: day t of a trial lies in
    the segment whose drawn ends it has not reached, at row offset +
    (t - segment start) of the segment's block. Returns (SPY, TLT, VIX,
    IRX of pool A; QQQ, TLT of pool B)."""
    M, B = plan.lengths.shape
    dev = plan.lengths.device
    ends = torch.cumsum(plan.lengths, 0)
    # seg[t] = #{segments whose end <= t} (searchsorted "right"), from a
    # scatter of the ends and a cumsum over days.
    counts = torch.zeros((n_days + 1, B), dtype=torch.int32, device=dev)
    counts.scatter_add_(0, ends.clamp_max(n_days),
                        torch.ones((M, B), dtype=torch.int32, device=dev))
    seg = torch.cumsum(counts[:n_days], 0).clamp_max(M - 1).to(torch.int64)
    del counts
    day = torch.arange(n_days, device=dev)[:, None]
    within = day - (ends - plan.lengths).gather(0, seg)
    r_d = plan.seg_regime.gather(0, seg)
    out = []
    for data, blk, off, cs in ((pools.a_data, plan.blk_a, plan.off_a,
                                (0, 2, 3)),
                               (pools.b_data, plan.blk_b, plan.off_b,
                                (1, 2))):
        N = data.shape[1]
        flat = ((r_d * N + blk.gather(0, seg)) * L
                + off.gather(0, seg) + within)
        rows = data.reshape(-1, data.shape[-1])
        out.extend(rows[:, c][flat] for c in cs)
    return out


def sample_bootstrap_returns(pools: BootstrapPools, regime_path, key,
                             n_days: int, add_noise: bool = True):
    """Stitched [n_days, B] series of each trial from the two pools:
    ``pools`` from ``pools_on``, ``regime_path`` [n_days, B] int, ``key``
    [B, 2] threefry keys. Returns {SPY_Ret, QQQ_Ret, TLT_Ret, VIX, IRX};
    with ``add_noise``, the sampler's Cholesky Student-t blend with its
    mean-preserving drift correction (weight 0.85)."""
    k_len, k_sel, k_noise = rng.split(key, 3).unbind(1)
    plan = bootstrap_plan(pools, regime_path, k_len, k_sel, n_days)
    spy, vix, irx, qqq, tlt = stitch(pools, plan, n_days)
    if add_noise:
        dt = spy.dtype
        B = spy.shape[1]
        w = 0.85
        noise_w = 1.0 - w
        low = regime_path == 0
        scale_spy = torch.where(low, torch.tensor(0.007, dtype=dt,
                                                  device=spy.device), 0.022)
        z = rng.t(k_noise, float(cfg.STUDENT_T_DF), 3 * n_days, dt).reshape(
            B, n_days, 3).permute(2, 1, 0)
        cz = cholesky_mix(z, ~low, CHOL_NOISE_LOW, CHOL_NOISE_HIGH)
        spy_n = cz[0] * scale_spy
        qqq_n = cz[1] * scale_spy * 1.35
        tlt_n = cz[2] * scale_spy * 0.5
        spy = w * spy + noise_w * (spy_n + spy.mean(0))
        qqq = w * qqq + noise_w * (qqq_n + qqq.mean(0))
        tlt = w * tlt + noise_w * (tlt_n + tlt.mean(0))
    return {"SPY_Ret": spy, "QQQ_Ret": qqq, "TLT_Ret": tlt, "VIX": vix,
            "IRX": irx}


# Cholesky factors of the sampler's noise correlations (bootstrap.py:268-271).
CHOL_NOISE_LOW = np.linalg.cholesky(np.array(
    [[1.0, 0.835, -0.207], [0.835, 1.0, -0.150], [-0.207, -0.150, 1.0]]))
CHOL_NOISE_HIGH = np.linalg.cholesky(np.array(
    [[1.0, 0.950, -0.447], [0.950, 1.0, -0.400], [-0.447, -0.400, 1.0]]))
