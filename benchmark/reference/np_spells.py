"""The institutional chain's start offsets and regime spells in NumPy,
written from the JAX package's source, not from the port's
(``letf_tpu/ops/path_batched.py``: ``start_offsets_only``,
``counter_uniforms``, ``plan_max_spells``, ``simulate_regime_paths_spell``;
the threefry keys are ``np_parametric``'s).

With two regimes the spell sequence alternates from the start regime, so
only the dwell lengths are drawn: one murmur-expanded uniform a spell,
each dwell ceil'd to whole days, and day t's regime is the start regime
flipped once per spell that ended on or before t."""

from __future__ import annotations

import numpy as np

from benchmark.reference import np_parametric as npp

U32 = np.uint32
M1, M2 = U32(0x85EBCA6B), U32(0xC2B2AE35)
GOLD, CTR = U32(0x9E3779B9), U32(0x7FEB352D)


def _mix(x: np.ndarray) -> np.ndarray:
    """The murmur3 finalizer on uint32."""
    with np.errstate(over="ignore"):
        x = x ^ (x >> U32(16))
        x = x * M1
        x = x ^ (x >> U32(13))
        x = x * M2
        return x ^ (x >> U32(16))


def counter_uniforms(keys: np.ndarray, n: int) -> np.ndarray:
    """[B, 2] threefry keys -> [B, n] float32 uniforms in (0, 1): the key
    words hashed with a counter, the top 24 bits and a half-ulp offset."""
    with np.errstate(over="ignore"):
        lane = _mix((keys[:, 0] * GOLD) ^ keys[:, 1])
        ctr = np.arange(n, dtype=U32) * CTR
    bits = _mix(_mix(lane[:, None] ^ ctr[None, :]))
    return ((bits >> U32(8)).astype(np.float32)
            * np.float32(1.0 / 16777216.0) + np.float32(0.5 / 16777216.0))


def plan_max_spells(reg, total_days: int, sigmas: float = 8.0) -> int:
    """The spell count drawn a trial: the least n whose pair count covers
    ``total_days`` at ``sigmas`` standard deviations of the dwell tables,
    clamped to [64, max(64, T // 12)] and rounded up to a multiple of 8."""
    default = max(64, total_days // 12)
    means, variances = [], []
    for r in range(2):
        if float(reg.has_dwell[r]) > 0:
            cdf = np.asarray(reg.dwell_cdf[r], np.float64)
            val = np.asarray(reg.dwell_values[r], np.float64)
            p = np.clip(np.diff(cdf, prepend=0.0), 0.0, None)
            if p.sum() <= 0:
                return default
            p /= p.sum()
            m = float((p * val).sum())
            v = float((p * val * val).sum() - m * m)
        else:
            ps = min(max(float(reg.p_stay[r]), 0.0), 1.0 - 1e-9)
            m = 1.0 / (1.0 - ps)
            v = ps / (1.0 - ps) ** 2
        means.append(max(m, 1.0))
        variances.append(max(v, 0.0))
    mu, var = means[0] + means[1], variances[0] + variances[1]
    x = (sigmas * var ** 0.5
         + (sigmas * sigmas * var + 4.0 * mu * total_days) ** 0.5) / (2 * mu)
    k = 2 * (int(x * x) + 1) + 2
    return min(max(64, -(-k // 8) * 8), default)


def start_offsets(run_key: np.ndarray, ids, buffer_days: int,
                  method: str, dtype) -> np.ndarray:
    """The random-start offsets of trials ``ids`` (start regime 0)."""
    if method == "offset" and buffer_days > 0:
        tk = npp.fold_in(run_key[None, :], ids)
        k_off = npp.split(npp.fold_in(tk, npp.START), 3)[:, 0]
        return npp.randint(k_off, min(50, buffer_days // 4), buffer_days,
                           dtype)
    if method in ("offset", "none"):
        return np.zeros(len(ids), np.int64)
    raise ValueError(f"no plain start method {method!r}")


def regime_paths(reg, run_key: np.ndarray, ids, total_days: int,
                 max_spells: int) -> np.ndarray:
    """[B, T] int32 regime paths from start regime 0; a path needing more
    than ``max_spells`` spells keeps its last regime."""
    keys = npp.fold_in(npp.fold_in(run_key[None, :], ids), npp.REGIME)
    u = counter_uniforms(keys, max_spells)                     # [B, K]
    spell_regime = np.arange(max_spells) % 2                   # from 0
    D = reg.dwell_cdf.shape[1]
    dwells = []
    for r in range(2):
        idx = np.minimum((reg.dwell_cdf[r][None, None, :]
                          < u[..., None]).sum(-1), D - 1)
        emp = reg.dwell_values[r][idx]
        geo = npp.geometric_dwell(u, reg.p_stay[r])
        dwells.append(np.where(reg.has_dwell[r] > 0, emp, geo))
    dwell = np.where(spell_regime[None, :] == 0, dwells[0], dwells[1])
    ends = np.cumsum(np.ceil(dwell).astype(np.int32), axis=1)
    days = np.arange(total_days)
    done = np.stack([np.searchsorted(e, days, side="right") for e in ends])
    return (done % 2).astype(np.int32)
