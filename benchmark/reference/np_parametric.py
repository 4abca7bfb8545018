"""The parametric per-trial engine in NumPy, written from the JAX package's
source, not from the port's: ``letf_tpu/ops/path_engine.py``
(``draw_innovations`` and ``path_from_innovations`` in the parametric
mode), ``letf_tpu/ops/rng.py``'s streams, ``letf_tpu/strategies/signals.py``
and ``letf_tpu/ops/rolling.py``, and ``jax.random``'s threefry samplers in
its partitionable mode (``fold_in``, ``split``, 32- and 64-bit ``bits``,
``uniform``, ``randint``, ``normal``, ``gamma``, ``t``). Batched over
trials; each ``lax.scan`` is a day loop over [B] arrays.

``dtype`` is the JAX package's ambient precision: float32, as on the card,
or float64, its x64 mode (64-bit uniform and integer draws), as the port's
glue on the CPU. Under ``precision.lowered()`` (the control) every drawn
series, every day's carry and every stored series is rounded to bfloat16;
the regime path and the draws' bits are as before.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import special

from benchmark.reference import config as cfg
from benchmark.reference import precision

U32, U64 = np.uint32, np.uint64
MASK32 = 0xFFFFFFFF

# Stream ids (letf_tpu/ops/rng.py).
START, REGIME, VIX_NOISE, IRX_NOISE = 0, 1, 4, 5
STRESS_NORM, STRESS_JUMP, TRACKING, BOOTSTRAP = 6, 7, 8, 9

# generate_returns_parametric's regime correlations (path_engine.py:514).
CORR_LOW = ((1.0, 0.85, -0.15), (0.85, 1.0, -0.10), (-0.15, -0.10, 1.0))
CORR_HIGH = ((1.0, 0.92, -0.45), (0.92, 1.0, -0.30), (-0.45, -0.30, 1.0))

IDX = cfg.ASSET_INDEX
SQ252 = float(np.sqrt(252.0))


# ---- threefry2x32 and jax.random's key and bit functions ----

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, on uint32 arrays broadcast together (in
    place on the counter words' copies)."""
    k1, k2, x1, x2 = np.broadcast_arrays(
        *(np.asarray(v, U32) for v in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ U32(0x1BD11BDA))
    x1, x2 = x1 + ks[0], x2 + ks[1]
    t = np.empty_like(x2)
    for i in range(5):
        for r in _ROT[i % 2]:
            np.add(x1, x2, out=x1)
            np.left_shift(x2, U32(r), out=t)
            np.right_shift(x2, U32(32 - r), out=x2)
            np.bitwise_or(x2, t, out=x2)
            np.bitwise_xor(x2, x1, out=x2)
        np.add(x1, ks[(i + 1) % 3], out=x1)
        np.add(x2, ks[(i + 2) % 3], out=x2)
        np.add(x2, U32(i + 1), out=x2)
    return x1, x2


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data (x64): [seed >> 32, seed & mask]."""
    s = int(seed)
    return np.array([(s >> 32) & MASK32, s & MASK32], U32)


def fold_in(keys: np.ndarray, data) -> np.ndarray:
    """Keys [..., 2] folded with ``data`` (broadcast against keys[..., 0]):
    the hash of the counter (0, data)."""
    d = np.asarray(data).astype(np.int64).astype(U32)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], np.zeros_like(d), d)
    return np.stack([b1, b2], -1)


def split(keys: np.ndarray, num: int) -> np.ndarray:
    """Partitionable ``split``: [..., num, 2], key i the hash of (0, i)."""
    return _pairs_as_keys(keys, num)


def _pairs(keys: np.ndarray, n: int):
    """Both threefry words of the flat counters 0..n-1 (high word 0) under
    each key: ([..., n], [..., n])."""
    i = np.arange(n, dtype=U32)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None],
                        np.zeros_like(i), i)


def _pairs_as_keys(keys, n):
    b1, b2 = _pairs(keys, n)
    return np.stack([b1, b2], -1)


def bits32(keys, n):
    b1, b2 = _pairs(keys, n)
    return b1 ^ b2


def bits64(keys, n):
    b1, b2 = _pairs(keys, n)
    return (b1.astype(U64) << U64(32)) | b2.astype(U64)


def uniform(keys, n, dtype, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(k, (n,), dtype, minval, maxval)`` per key."""
    if dtype == np.float32:
        f = (((bits32(keys, n) >> U32(9)) | U32(0x3F800000))
             .view(np.float32) - np.float32(1.0))
    else:
        f = (((bits64(keys, n) >> U64(12)) | U64(0x3FF0000000000000))
             .view(np.float64) - 1.0)
    lo, hi = dtype(minval), dtype(maxval)
    return np.maximum(lo, f * (hi - lo) + lo)


def randint(keys, minval: int, maxval: int, dtype) -> np.ndarray:
    """``jax.random.randint(k, (), minval, maxval)`` per key: int32 draws
    in float32 mode, int64 draws (two 64-bit words) in x64 mode."""
    ks = split(keys, 2)
    wide = dtype == np.float64
    ut = U64 if wide else U32
    hi_b = (bits64 if wide else bits32)(ks[..., 0, :], 1)[..., 0]
    lo_b = (bits64 if wide else bits32)(ks[..., 1, :], 1)[..., 0]
    span = ut(maxval - minval) if maxval > minval else ut(1)
    with np.errstate(over="ignore"):
        mult = ut(2 ** (32 if wide else 16)) % span
        mult = (mult * mult) % span
        off = ((hi_b % span) * mult + lo_b % span) % span
    return minval + off.astype(np.int64)


def _erf_inv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv (M. Giles, "Approximating the erfinv
    function", single precision): w = -log1p(-x^2), one of two degree-8
    fits by w < 5."""
    small = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
             -4.39150654e-06, 0.00021858087, -0.00125372503,
             -0.00417768164, 0.246640727, 1.50140941)
    big = (-0.000200214257, 0.000100950558, 0.00134934322,
           -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
           1.00167406, 2.83297682)
    w = -np.log1p(-x * x)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
    p = np.where(lt, np.float32(small[0]), np.float32(big[0]))
    for a, b in zip(small[1:], big[1:]):
        p = np.where(lt, np.float32(a), np.float32(b)) + p * w
    with np.errstate(invalid="ignore"):
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)


def normal(keys, n, dtype) -> np.ndarray:
    """``jax.random.normal(k, (n,), dtype)`` per key: sqrt(2) erf_inv of a
    uniform on (nextafter(-1, 0), 1)."""
    lo = np.nextafter(dtype(-1.0), dtype(0.0))
    u = uniform(keys, n, dtype, lo, 1.0)
    if dtype == np.float32:
        return np.float32(np.sqrt(2.0)) * _erf_inv32(u)
    return np.sqrt(2.0) * special.erfinv(u)


def _gamma_one(keys: np.ndarray, alpha: float, dtype) -> np.ndarray:
    """``jax._src.random._gamma_one`` for element keys [M, 2] (Marsaglia
    and Tsang): (key, subkey) = split(key); each rejection round takes
    split(key, 3) -> (key, x key, U key), redraws x by split(x key) while
    v = 1 + c x <= 0, and stops once U < 1 - 0.0331 x^4 or
    log U < x^2 / 2 + d (1 - v^3 + log v^3). alpha < 1 is boosted."""
    one = dtype(1.0)
    boost = alpha >= 1.0
    a = dtype(alpha) if boost else dtype(alpha) + one
    d = a - dtype(1.0 / 3.0)
    c = dtype(1.0 / 3.0) / np.sqrt(d)
    sp = split(keys, 2)
    k, sub = sp[:, 0].copy(), sp[:, 1]
    M = keys.shape[0]
    X = np.zeros(M, dtype)
    V = np.ones(M, dtype)
    active = np.ones(M, bool)
    with np.errstate(divide="ignore", invalid="ignore"):
        while active.any():
            i = np.nonzero(active)[0]
            s3 = split(k[i], 3)
            k[i] = s3[:, 0]
            xk = s3[:, 1].copy()
            x = np.zeros(len(i), dtype)
            v = np.full(len(i), -1.0, dtype)
            need = v <= 0
            while need.any():
                j = np.nonzero(need)[0]
                s2 = split(xk[j], 2)
                xk[j] = s2[:, 0]
                x[j] = normal(s2[:, 1], 1, dtype)[:, 0]
                v[j] = one + x[j] * c
                need = v <= 0
            Xi, Vi = x * x, v * v * v
            Ui = uniform(s3[:, 2], 1, dtype)[:, 0]
            X[i], V[i] = Xi, Vi
            active[i] = ((Ui >= one - dtype(0.0331) * (Xi * Xi))
                         & (np.log(Ui) >= Xi * dtype(0.5)
                            + d * ((one - Vi) + np.log(Vi))))
    out = d * V
    if not boost:
        out = out * (one - uniform(sub, 1, dtype)[:, 0]) ** (one / dtype(alpha))
    return out


def gamma(keys, alpha: float, n: int, dtype) -> np.ndarray:
    """``jax.random.gamma(k, alpha, (n,), dtype)`` per key [B, 2]:
    element i samples under split(k, n)[i]. Returns [B, n]."""
    ek = split(keys, n)
    return _gamma_one(ek.reshape(-1, 2), alpha, dtype).reshape(ek.shape[:-1])


def student_t(keys, df: float, n: int, dtype) -> np.ndarray:
    """``jax.random.t(k, df, (n,), dtype)`` per key:
    (key_n, key_g) = split(k); normal(key_n) * sqrt((df/2) / gamma(key_g,
    df/2))."""
    ks = split(keys, 2)
    z = normal(ks[..., 0, :], n, dtype)
    half = dtype(df) / dtype(2.0)
    g = gamma(ks[..., 1, :], float(half), n, dtype)
    return z * np.sqrt(half / g)


# ---- the path (path_engine.py, parametric mode) ----

def geometric_dwell(u: np.ndarray, p_stay) -> np.ndarray:
    """max(ceil(log1p(-u) / log p_stay), 1) with float32 uniforms ``u``.
    The two logs are torch's, on the host: the ceil turns a one-ulp
    difference between libm's float32 log1p and torch's (which the card's
    agrees with) into a shift of every later regime boundary by a day."""
    lg = torch.log1p(-torch.from_numpy(np.ascontiguousarray(u))).numpy()
    lp = torch.log(torch.as_tensor(np.asarray(p_stay))).numpy()
    return np.maximum(np.ceil(lg / lp), 1.0)


def _tables(model, dtype):
    """The model's float leaves in ``dtype`` (as jnp.asarray under the
    ambient precision), integer leaves as they are."""
    def conv(x):
        x = np.asarray(x)
        return x.astype(dtype) if x.dtype.kind == "f" else x
    return type(model)(*(type(part)(*(conv(f) for f in part))
                         if isinstance(part, tuple) else conv(part)
                         for part in model))


def _regime_path(m, keys, start_regime, T: int, dtype) -> np.ndarray:
    """simulate_regime_path: [B, T] int32, one day a step; the dwell and
    next-state draws of both candidate regimes are taken for every day
    first (they do not depend on the path)."""
    reg = m.regime
    B = keys.shape[0]
    u = uniform(keys, 2 * (T + 1), dtype).reshape(B, T + 1, 2)
    R = reg.transition.shape[0]
    D = reg.dwell_cdf.shape[1]

    def dwell(r, uu):
        idx = np.minimum((reg.dwell_cdf[r][..., None, :]
                          < uu[..., None]).sum(-1), D - 1)
        emp = reg.dwell_values[r][idx]
        geo = geometric_dwell(uu, reg.p_stay[r])
        return np.where(reg.has_dwell[r] > 0, emp, geo).astype(dtype)

    def nxt(r, uu):
        row = reg.transition[r] * (np.arange(R) != r)
        rs = row.sum()
        probs = np.where(rs > 0, row / np.maximum(rs, dtype(1e-30)),
                         dtype(0.0))
        k = np.minimum((np.cumsum(probs) < uu[..., None]).sum(-1), R - 1)
        return np.where(rs > 0, k, r).astype(np.int32)

    nx = np.stack([nxt(r, u[:, :, 1]) for r in range(R)])       # [R, B, T+1]
    dw = np.stack([dwell(r, u[:, :, 0]) for r in range(R)])
    rows = np.arange(B)
    cur = np.full(B, start_regime, np.int32)
    rem = dw[cur, rows, 0]
    path = np.empty((B, T), np.int32)
    for t in range(T):
        path[:, t] = cur
        rem = rem - dtype(1.0)
        need = rem <= 0
        n_t = nx[cur, rows, t + 1]
        d_t = dw[n_t, rows, t + 1]
        cur = np.where(need, n_t, cur)
        rem = np.where(need, d_t, rem)
    return path


def draws(m, run_key, ids, sim: int, buf: int, method: str, dtype) -> dict:
    """The draws of draw_innovations that the parametric mode consumes,
    for trials ``ids`` [B]."""
    q = precision.round_np
    T = sim + buf
    tk = fold_in(run_key[None, :], ids)
    B = len(ids)
    if method == "offset" and buf > 0:
        k_off = split(fold_in(tk, START), 3)[:, 0]
        offset = randint(k_off, min(50, buf // 4), buf, dtype)
    elif method in ("offset", "none"):
        offset = np.zeros(B, np.int64)
    else:
        raise ValueError(f"no plain start method {method!r}")
    regime = _regime_path(m, fold_in(tk, REGIME), 0, T, dtype)
    kj = split(fold_in(tk, STRESS_JUMP), 3)
    te_df = cfg.asset_table().te_df
    te = np.empty((B, sim, len(te_df)), dtype)
    k_te = fold_in(tk, TRACKING)
    for df in sorted(set(te_df.tolist())):
        cols = [a for a in range(len(te_df)) if te_df[a] == df]
        d = student_t(fold_in(k_te, int(df)), float(df), sim * len(cols),
                      dtype)
        te[:, :, cols] = d.reshape(B, sim, len(cols))
    return dict(
        offset=offset, regime=regime,
        z=q(student_t(fold_in(tk, BOOTSTRAP), float(cfg.STUDENT_T_DF),
                      3 * T, dtype).reshape(B, T, 3)),
        vix_noise=q(normal(fold_in(tk, VIX_NOISE), T, dtype)),
        irx_noise=q(normal(fold_in(tk, IRX_NOISE), T, dtype)),
        stress_norms=q(normal(fold_in(tk, STRESS_NORM), 2 * sim, dtype)
                       .reshape(B, sim, 2)),
        u_jump=uniform(kj[:, 0], sim, dtype),
        t_abs=q(np.abs(student_t(kj[:, 1], 5.0, sim, dtype))),
        jump_sign=np.where(uniform(kj[:, 2], sim, dtype) < 0.5,
                           dtype(-1.0), dtype(1.0)),
        te=q(te))


def _window(a, offset, sim):
    idx = offset[:, None] + np.arange(sim)[None, :]
    return np.take_along_axis(a, idx.reshape(idx.shape + (1,) * (a.ndim - 2)),
                              axis=1)


def path(m, dr: dict, sim: int, dtype) -> dict:
    """path_from_innovations in the parametric mode, with the stress
    channels and the funding model: [B, S(, A)] arrays and the flags."""
    q = precision.round_np
    f = dtype
    reg, V, S_, F, Tk, P = (m.regime, m.vix, m.stress, m.funding,
                            m.tracking, m.assets)
    regime_full = dr["regime"]
    B, T = regime_full.shape
    # generate_returns_parametric
    chol = np.stack([np.linalg.cholesky(np.array(CORR_LOW)),
                     np.linalg.cholesky(np.array(CORR_HIGH))]).astype(f)
    c = chol[np.where(regime_full == 0, 0, 1)]                  # [B, T, 3, 3]
    z = dr["z"]
    x0 = c[..., 0, 0] * z[..., 0]
    x1 = c[..., 1, 0] * z[..., 0] + c[..., 1, 1] * z[..., 1]
    x2 = (c[..., 2, 0] * z[..., 0] + c[..., 2, 1] * z[..., 1]
          + c[..., 2, 2] * z[..., 2])
    spy = q(reg.daily_mean[regime_full] + reg.daily_std[regime_full] * x0)
    qqq = q(f(1.15) * spy + f(0.006) * x1)
    tlt = q(f(-0.12) * spy + f(0.004) * x2)

    # simulate_vix_given_returns
    r = regime_full
    shock = np.maximum(-spy, f(0.0)) / np.maximum(reg.daily_std[r], f(1e-4))
    vjump = V.jump_scale[r] * np.maximum(f(0.0), shock - V.jump_threshold[r])
    phi = V.phi[r]
    tgt = (f(1.0) - phi) * V.target[r]
    noise = V.noise_std[r] * dr["vix_noise"]
    vix_full = np.empty((B, T), f)
    prev = V.base[r[:, 0]]
    vix_full[:, 0] = prev
    for t in range(1, T):
        a = phi[:, t] * prev + tgt[:, t]
        a = a + vjump[:, t]
        prev = q(np.maximum(f(10.0), a + noise[:, t]))
        vix_full[:, t] = prev

    irx_full = np.clip(m.irx_base[r] + f(0.5) * dr["irx_noise"], f(0.0),
                       f(15.0))
    off = dr["offset"]
    regime = _window(regime_full, off, sim)
    vix = _window(vix_full, off, sim)
    irx = _window(irx_full, off, sim)
    spy, qqq, tlt = (_window(a, off, sim) for a in (spy, qqq, tlt))

    # simulate_stress
    n2 = dr["stress_norms"]
    liq = np.empty((B, sim), f)
    cred = np.empty((B, sim), f)
    lmu, lphi, lsig = S_.liq_mu[regime], S_.liq_phi[regime], \
        S_.liq_sigma[regime]
    cmu, cphi, csig = S_.credit_mu[regime], S_.credit_phi[regime], \
        S_.credit_sigma[regime]
    lp, cp = lmu[:, 0], cmu[:, 0]
    liq[:, 0], cred[:, 0] = lp, cp
    for t in range(1, sim):
        lp = q(np.clip(lmu[:, t] + lphi[:, t] * (lp - lmu[:, t])
                       + lsig[:, t] * n2[:, t, 0], f(0.0), f(3.0)))
        cp = q(np.clip(cmu[:, t] + cphi[:, t] * (cp - cmu[:, t])
                       + csig[:, t] * n2[:, t, 1], f(0.0), f(3.0)))
        liq[:, t], cred[:, t] = lp, cp
    vix_amp = np.maximum((vix - f(25.0)) / f(30.0), f(0.0))
    p = np.clip(S_.jump_base_prob[regime] + f(0.008) * vix_amp
                + f(0.003) * liq, f(0.0), f(0.01))
    first = np.arange(sim)[None, :] == 0
    jump = np.where((dr["u_jump"] < p) & ~first,
                    dr["t_abs"] * S_.jump_scale[regime], f(0.0))
    signed = jump * dr["jump_sign"]
    spy = q(np.clip(spy - signed, f(-0.95), f(3.0)))
    qqq = q(np.clip(qqq - f(1.12) * signed, f(-0.95), f(4.0)))
    risk_free = np.clip(irx, f(0.0), f(20.0)) / f(100.0)

    # borrow_spread_series, compose_letf_returns
    streams = np.stack([spy, qqq, tlt], -1)                      # [B, S, 3]
    und = streams[:, :, P.underlying] * P.beta                   # [B, S, A]
    cc = np.clip(cred, f(0.0), f(3.0))
    inv_curve = np.maximum(-(f(1.25) - f(1.1) * cc), f(0.0))
    spread = (F.base + F.beta_vix * np.maximum(vix - f(20.0), f(0.0))
              + F.beta_inv_curve * inv_curve
              + F.beta_liquidity * np.clip(liq, f(0.0), f(3.0))
              + F.beta_credit * cc)
    spread = np.clip(spread, F.min_spread, F.max_spread)
    lev = P.leverage
    borrow = (np.maximum(lev - f(1.0), f(0.0))
              * np.maximum(risk_free[..., None] + spread[..., None], f(0.0))
              / f(252.0))
    lev_ret = q(lev * und - P.expense_ratio / f(252.0) - borrow)

    # simulate_tracking_error
    rho = Tk.rho
    sq = np.sqrt(np.maximum(f(1.0) - rho * rho, f(1e-6)))
    ema = f(2.0 / (126 + 1))
    ema1 = f(1 - 2.0 / (126 + 1))
    vix_mult = np.clip(np.sqrt(vix / f(20.0)), f(0.5), f(1.5))
    regime_mult = np.where(regime == 0, f(1.0), f(1.15))
    move = ((f(1.0) + f(0.3) * np.abs(und))
            * np.where(und < 0, Tk.downside_mult, f(0.98)))
    innov = dr["te"] * Tk.te_scale * (vix_mult * regime_mult)[..., None]
    inc = sq * innov * move
    te = np.empty_like(inc)
    cur = np.zeros(inc[:, 0].shape, f)
    bias = np.zeros_like(cur)
    for t in range(sim):
        cur = q(rho * cur + inc[:, t]) if t else np.zeros_like(cur)
        bias = q(ema * cur + ema1 * bias)
        te[:, t] = cur - bias
    cap = Tk.clip_limit
    with np.errstate(divide="ignore", invalid="ignore"):
        te = np.where(cap > 0, cap * np.tanh(te / cap), te)
    etf = q(np.clip(lev_ret + te, f(-0.999), f(10.0)))
    cash = m.cash_rate[regime] / f(252.0)

    finite_pre = (np.isfinite(etf).all((1, 2)) & np.isfinite(tlt).all(1)
                  & np.isfinite(vix).all(1))
    vix_ok = (np.isfinite(vix).all(1) & (vix.min(1) >= 5.0)
              & (vix.max(1) <= 120.0))
    etf = np.clip(np.where(np.isfinite(etf), etf, f(0.0)), f(-0.999),
                  f(10.0))
    return dict(etf_ret=etf, cash_ret=cash, regime=regime, vix=vix,
                valid=vix_ok, repaired=~(finite_pre & vix_ok),
                path_finite=finite_pre, vix_ok=vix_ok)


# ---- rolling statistics (rolling.py) and signals (signals.py) ----

def _wsum(x, w):
    c = np.cumsum(x, -1, dtype=x.dtype)
    T = x.shape[-1]
    if w >= T:
        return c
    lag = np.concatenate([np.zeros_like(c[..., :w]), c[..., :T - w]], -1)
    return c - lag


def _n(x, w):
    return np.minimum(np.arange(x.shape[-1]) + 1, w).astype(x.dtype)


def rolling_sum(x, w, mp=1):
    return np.where(_n(x, w) >= mp, _wsum(x, w), np.nan).astype(x.dtype)


def rolling_mean(x, w, mp=None):
    mp = w if mp is None else mp
    n = _n(x, w)
    return np.where(n >= mp, _wsum(x, w) / n, np.nan).astype(x.dtype)


def rolling_std(x, w, mp=None):
    mp = w if mp is None else mp
    n = _n(x, w)
    mean = _wsum(x, w) / n
    var = (np.maximum(_wsum(x * x, w) - n * mean * mean, 0)
           / np.maximum(n - 1, 1))
    return np.where((n >= mp) & (n >= 2), np.sqrt(var),
                    np.nan).astype(x.dtype)


def rolling_skew(x, w, mp=None):
    mp = w if mp is None else mp
    f = x.dtype.type
    n = _n(x, w)
    s1, s2, s3 = _wsum(x, w), _wsum(x * x, w), _wsum(x * x * x, w)
    mean = s1 / n
    m2 = np.maximum(s2 - n * (mean * mean), 0)
    m3 = s3 - f(3.0) * mean * s2 + f(2.0) * n * (mean * mean * mean)
    s = np.sqrt(m2 / np.maximum(n - 1, 1))
    denom = np.maximum(n - 1, 1) * np.maximum(n - 2, 1) * (s * s * s)
    g = n * m3 / np.where(denom > 0, denom, np.nan)
    return np.where((n >= mp) & (n >= 3) & (s > 0), g,
                    np.nan).astype(x.dtype)


def pct_change(x, p):
    prev = np.concatenate([np.full(x.shape[:-1] + (p,), np.nan, x.dtype),
                           x[..., :-p]], -1)
    return x / prev - x.dtype.type(1.0)


def rsi(price, period=14):
    delta = price - np.concatenate([price[..., :1], price[..., :-1]], -1)
    zero = price.dtype.type(0.0)
    gain = rolling_mean(np.where(delta > 0, delta, zero), period)
    loss = rolling_mean(np.where(delta < 0, -delta, zero), period)
    f = price.dtype.type
    return f(100.0) - f(100.0) / (f(1.0) + gain / loss)


def channels(p: dict) -> list:
    """compute_signals then pallas_strategies.channels_from: the 23 K4
    channels, each [S, B] float32."""
    q = precision.round_np
    etf = p["etf_ret"]
    f = etf.dtype.type
    prices = np.cumprod(f(1.0) + etf, axis=1, dtype=etf.dtype) * f(100.0)
    spy_price = prices[:, :, IDX["SPY"]]
    r_tqqq = etf[:, :, IDX["TQQQ"]]
    r_spy = etf[:, :, IDX["SPY"]]
    neg = np.where(r_tqqq < 0, r_tqqq, f(0.0))
    sq = f(SQ252)
    std20 = rolling_std(r_tqqq, 20, 1) * sq
    out = [r_tqqq, r_spy, etf[:, :, IDX["SSO"]], etf[:, :, IDX["TMF"]],
           p["cash_ret"], p["regime"].astype(etf.dtype), p["vix"],
           spy_price,
           rolling_std(r_tqqq, 20) * sq, rolling_std(neg, 20) * sq,
           rolling_std(r_tqqq, 5, 1) * sq, rolling_std(r_tqqq, 10, 1) * sq,
           std20, rolling_std(r_tqqq, 60, 1) * sq,
           rolling_std(neg, 20, 1) * sq, rolling_skew(r_tqqq, 60, 1),
           rolling_mean(r_tqqq, 60, 1) * f(252.0), pct_change(std20, 5),
           rolling_sum(r_spy, 126, 1), rolling_mean(spy_price, 200, 1),
           rolling_mean(spy_price, 200), rolling_mean(spy_price, 100, 1),
           rsi(spy_price, 14)]
    return [q(np.ascontiguousarray(c.T, np.float32)) for c in out]
