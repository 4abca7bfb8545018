"""Frozen copy of ``letf_tpu_torch/models/params.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Model tables of the port: the ``SimModel`` tree, its defaults, and the
float32 parameter tables the kernels read.

The port's own copy of ``letf_tpu/models/params.py`` (same NamedTuple and
field names, same derivations): ``SimModel`` and its parts,
``default_sim_model``, ``build_sim_model`` (a calibration dict densified
into the tree) and ``nearest_psd_matrix`` (``letf_tpu/utils/psd.py``).
Leaves are numpy arrays.

- ``from_jax_model`` carries a model across from the JAX package: it takes
  that package's ``SimModel`` (a tree of numpy arrays) and returns the
  port's, matched field by field.
- ``from_numpy`` turns the port's tree into torch tensors on one device in
  the glue dtype.
- The three packers return the float32 tables of the kernels, built by the
  same float32 operations as their JAX counterparts:
  ``pack_joint_params`` <- ``pallas_joint._pack_params`` [25, 2],
  ``pack_stress_params`` <- ``pallas_compose._pack_stress_params`` [16, 2],
  ``pack_asset_params`` <- ``pallas_compose._pack_asset_params`` [9, A].
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from benchmark.reference import config as cfg


def nearest_psd_matrix(corr_matrix: np.ndarray) -> np.ndarray:
    """Eigen-clip to 1e-8 and renormalize to unit diagonal."""
    w, v = np.linalg.eigh(np.asarray(corr_matrix, dtype=np.float64))
    w = np.maximum(w, 1e-8)
    m = (v * w) @ v.T
    d = np.sqrt(np.diag(m))
    return m / np.outer(d, d)


R = cfg.N_REGIMES
K = 3          # joint underlyings: SPY, QQQ, TLT
A = cfg.N_ASSETS
D = cfg.MAX_DWELL_SAMPLES


class RegimeParams(NamedTuple):
    transition: np.ndarray      # [R, R] row-stochastic
    dwell_values: np.ndarray    # [R, D] empirical dwell lengths (padded)
    dwell_cdf: np.ndarray       # [R, D] cumulative probabilities
    has_dwell: np.ndarray       # [R] 1.0 if empirical table is valid
    p_stay: np.ndarray          # [R] clip(diag, 0.80, 0.995) geometric fallback
    daily_std: np.ndarray       # [R] SPY daily std (VIX shock normalization)
    daily_mean: np.ndarray      # [R]
    start_probs: np.ndarray     # [R] regime_only start probabilities


class JointParams(NamedTuple):
    mu: np.ndarray              # [R, K]
    nu: np.ndarray              # [R]
    garch_alpha: np.ndarray     # [R]
    garch_beta: np.ndarray      # [R] stationarity-capped
    dcc_a: np.ndarray           # [R]
    dcc_b: np.ndarray           # [R]
    long_var: np.ndarray        # [R, K] t-scaled unconditional variances
    rbar: np.ndarray            # [R, K, K] PSD unconditional correlation
    theo_mean: np.ndarray       # [K] plain average of mu over regimes
    chi_cheb: np.ndarray        # [R, CHI_CHEB_DEG+1] Chebyshev coeffs of
                                # log chi2_ppf(Phi(z), nu) on z/CHI_CHEB_ZMAX
                                # (fast chi-square sampler, see chi2_from_normal)


class VixParams(NamedTuple):
    phi: np.ndarray             # [R]
    noise_std: np.ndarray       # [R]
    jump_threshold: np.ndarray  # [R] sigma units
    jump_scale: np.ndarray      # [R]
    target: np.ndarray          # [R]
    base: np.ndarray            # [R] initial VIX level per start regime


class StressParams(NamedTuple):
    liq_mu: np.ndarray          # [R]
    liq_phi: np.ndarray
    liq_sigma: np.ndarray
    credit_mu: np.ndarray
    credit_phi: np.ndarray
    credit_sigma: np.ndarray
    jump_base_prob: np.ndarray
    jump_scale: np.ndarray


class FundingParams(NamedTuple):
    base: np.ndarray            # scalars (0-d arrays)
    beta_vix: np.ndarray
    beta_inv_curve: np.ndarray
    beta_liquidity: np.ndarray
    beta_credit: np.ndarray
    min_spread: np.ndarray
    max_spread: np.ndarray


class TrackingParams(NamedTuple):
    rho: np.ndarray             # [A]
    downside_mult: np.ndarray   # [A] capped at 1.10 (execution-noise only)
    clip_limit: np.ndarray      # [A] tanh saturation cap; <=0 disables
    te_scale: np.ndarray        # [A] config tracking_error_base
    te_df: np.ndarray           # [A]


class AssetParams(NamedTuple):
    leverage: np.ndarray        # [A]
    expense_ratio: np.ndarray   # [A]
    underlying: np.ndarray      # [A] int32 index into (SPY, QQQ, TLT)
    beta: np.ndarray            # [A] multiplier on the underlying stream
    fallback_spread: np.ndarray # [A] borrow spread when no funding model


class SimModel(NamedTuple):
    regime: RegimeParams
    joint: JointParams
    vix: VixParams
    irx_base: np.ndarray        # [R]
    stress: StressParams
    funding: FundingParams
    tracking: TrackingParams
    assets: AssetParams
    cash_rate: np.ndarray       # [R] annual cash rate by regime


# ---------------------------------------------------------------------------
# Derivation helpers
# ---------------------------------------------------------------------------

# Fast chi-square sampler table: a degree-13 Chebyshev fit of
# log chi2_ppf(Phi(z), nu) over z in [-CHI_CHEB_ZMAX, CHI_CHEB_ZMAX] turns
# one standard normal into an (approximate to <5e-5 relative on the
# quantile) chi-square(nu) draw with 13 FMAs + one exp — replacing the
# gamma rejection sampler on the production fast path. f32 Box-Muller /
# threefry normals never exceed ~6 sigma, so the fit range covers every
# representable draw.
CHI_CHEB_DEG = 13
CHI_CHEB_ZMAX = 6.3


def chi2_log_quantile_cheb(nu: float, deg: int = CHI_CHEB_DEG,
                           zmax: float = CHI_CHEB_ZMAX) -> np.ndarray:
    """Chebyshev coefficients (on t = z/zmax) of log chi2_ppf(Phi(z), nu)."""
    from scipy import stats

    z = np.linspace(-zmax, zmax, 8001)
    y = np.log(stats.chi2.ppf(stats.norm.cdf(z), float(nu)))
    return np.polynomial.chebyshev.chebfit(z / zmax, y, deg)


def derive_joint_params(mu, cov, nu, alpha, beta, dcc_a, dcc_b) -> JointParams:
    """Precompute scan-ready joint-model arrays from per-regime (mu, cov, nu,
    GARCH/DCC) parameters. All inputs are [R, ...] stacked."""
    mu = np.asarray(mu, np.float64)
    cov = np.asarray(cov, np.float64)
    nu = np.asarray(nu, np.float64)
    alpha = np.asarray(alpha, np.float64)
    beta = np.asarray(beta, np.float64).copy()
    dcc_a = np.asarray(dcc_a, np.float64)
    dcc_b = np.asarray(dcc_b, np.float64)

    t_scale = np.where(nu > 2.0, (nu - 2.0) / nu, 0.5)
    long_var = np.clip(np.einsum("rkk->rk", cov) * t_scale[:, None], 1e-8, None)

    eff_alpha = np.where(nu > 2.0, alpha * nu / (nu - 2.0), alpha * 2.0)
    cap = eff_alpha + beta >= 1.0
    beta = np.where(cap, np.maximum(0.70, 0.98 - eff_alpha), beta)

    d = np.sqrt(np.einsum("rkk->rk", cov))
    rbar = cov / (d[:, :, None] * d[:, None, :])
    rbar = np.stack([nearest_psd_matrix(rbar[r]) for r in range(rbar.shape[0])])

    chi_cheb = np.stack([chi2_log_quantile_cheb(float(n)) for n in nu])

    return JointParams(
        mu=mu, nu=nu, garch_alpha=alpha, garch_beta=beta,
        dcc_a=dcc_a, dcc_b=dcc_b, long_var=long_var, rbar=rbar,
        theo_mean=mu.mean(axis=0), chi_cheb=chi_cheb)


def build_dwell_tables(duration_samples: Optional[Dict[int, list]]) -> tuple:
    """Pad per-regime empirical dwell samples into fixed [R, D] tables with a
    uniform CDF over the recorded samples (matching rng.choice semantics)."""
    values = np.ones((R, D), np.float64)
    cdf = np.tile((np.arange(D) + 1) / D, (R, 1))
    has = np.zeros(R, np.float64)
    if duration_samples:
        for r in range(R):
            samples = duration_samples.get(r, [])
            if len(samples) > 0:
                s = np.asarray(samples, np.float64)
                if len(s) > D:
                    # Keep the empirical distribution by quantile-resampling.
                    s = np.quantile(s, (np.arange(D) + 0.5) / D)
                n = len(s)
                values[r, :n] = s
                values[r, n:] = s[-1]
                cdf[r] = np.minimum((np.arange(D) + 1) / n, 1.0)
                has[r] = 1.0
    return values, cdf, has


# ---------------------------------------------------------------------------
# Defaults (reference fallback parameterization)
# ---------------------------------------------------------------------------

def default_joint_params() -> JointParams:
    mu = np.array([[0.08, 0.10, 0.03], [0.08, 0.10, 0.03]]) / 252.0
    vol = np.array([[0.16, 0.24, 0.12], [0.28, 0.42, 0.16]])
    corr = np.array([
        [[1.0, 0.90, -0.20], [0.90, 1.0, -0.18], [-0.20, -0.18, 1.0]],
        [[1.0, 0.96, -0.05], [0.96, 1.0, -0.03], [-0.05, -0.03, 1.0]],
    ])
    dvol = vol / np.sqrt(252.0)
    cov = dvol[:, :, None] * dvol[:, None, :] * corr
    return derive_joint_params(
        mu=mu, cov=cov, nu=[5.0, 4.0], alpha=[0.06, 0.09], beta=[0.90, 0.86],
        dcc_a=[0.02, 0.04], dcc_b=[0.95, 0.90])


def default_regime_params() -> RegimeParams:
    transition = np.array([[0.99, 0.01], [0.03, 0.97]])
    dwell_values, dwell_cdf, has_dwell = build_dwell_tables(None)
    return RegimeParams(
        transition=transition,
        dwell_values=dwell_values, dwell_cdf=dwell_cdf, has_dwell=has_dwell,
        p_stay=np.clip(np.diag(transition), 0.80, 0.995),
        daily_std=np.array([0.008, 0.022]),
        daily_mean=np.array([0.0005, -0.0005]),
        start_probs=np.array([cfg.START_REGIME_PROBABILITIES[r]
                              for r in range(R)]))


def default_vix_params() -> VixParams:
    return VixParams(
        phi=np.array([0.90, 0.90]),
        noise_std=np.array([1.25, 1.25]),
        jump_threshold=np.array([2.0, 2.0]),
        jump_scale=np.array([6.0, 9.0]),
        target=np.array([15.0, 35.0]),
        base=np.array([15.0, 35.0]))


def default_stress_params() -> StressParams:
    return StressParams(
        liq_mu=np.array([0.10, 0.35]), liq_phi=np.array([0.90, 0.90]),
        liq_sigma=np.array([0.08, 0.08]),
        credit_mu=np.array([0.05, 0.25]), credit_phi=np.array([0.88, 0.88]),
        credit_sigma=np.array([0.07, 0.07]),
        jump_base_prob=np.array([0.0002, 0.001]),
        jump_scale=np.array([0.0005, 0.002]))


def default_funding_params() -> FundingParams:
    return FundingParams(
        base=np.float64(0.0050), beta_vix=np.float64(0.00035),
        beta_inv_curve=np.float64(0.0014), beta_liquidity=np.float64(0.0010),
        beta_credit=np.float64(0.0014), min_spread=np.float64(0.0030),
        max_spread=np.float64(0.0450))


def default_tracking_params() -> TrackingParams:
    table = cfg.asset_table()
    return TrackingParams(
        rho=np.full(A, 0.25),
        downside_mult=np.full(A, 1.10),   # min(calibrated 1.25, cap 1.10)
        clip_limit=np.full(A, 0.15),
        te_scale=table.te_base.copy(),
        te_df=table.te_df.copy())


def default_asset_params() -> AssetParams:
    table = cfg.asset_table()
    return AssetParams(
        leverage=table.leverage, expense_ratio=table.expense_ratio,
        underlying=table.underlying, beta=table.beta,
        fallback_spread=table.borrow_spread)


def default_sim_model() -> SimModel:
    return SimModel(
        regime=default_regime_params(),
        joint=default_joint_params(),
        vix=default_vix_params(),
        irx_base=np.array([3.5, 1.5]),
        stress=default_stress_params(),
        funding=default_funding_params(),
        tracking=default_tracking_params(),
        assets=default_asset_params(),
        cash_rate=np.array([cfg.CASH_RATE_BY_REGIME[r] for r in range(R)]))


def from_numpy(model: SimModel, device, dtype: torch.dtype) -> SimModel:
    """Every leaf of ``model`` as a torch tensor on ``device``: floating
    leaves in ``dtype``, integer leaves as int64."""

    def conv(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.as_tensor(a.astype(np.int64), device=device)
        return torch.as_tensor(a.astype(np.float64), device=device).to(dtype)

    def walk(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v) for v in node))
        return conv(node)

    return walk(model)


def _f32(a) -> torch.Tensor:
    return a.to(torch.float32) if isinstance(a, torch.Tensor) \
        else torch.as_tensor(np.asarray(a, np.float64)).to(torch.float32)


def pack_joint_params(model: SimModel) -> torch.Tensor:
    """[25, 2] f32 per-regime table, rows as pallas_joint._joint_kernel."""
    J, V = model.joint, model.vix
    mu, lv, rb = _f32(J.mu), _f32(J.long_var), _f32(J.rbar)
    rows = [mu[:, 0], mu[:, 1], mu[:, 2], lv[:, 0], lv[:, 1], lv[:, 2],
            _f32(J.garch_alpha), _f32(J.garch_beta), _f32(J.dcc_a),
            _f32(J.dcc_b), _f32(J.nu),
            rb[:, 0, 0], rb[:, 0, 1], rb[:, 0, 2],
            rb[:, 1, 1], rb[:, 1, 2], rb[:, 2, 2],
            _f32(V.phi), _f32(V.target), _f32(V.noise_std),
            _f32(V.jump_threshold), _f32(V.jump_scale), _f32(V.base),
            _f32(model.regime.daily_std), _f32(model.irx_base)]
    return torch.stack(rows).contiguous()


def pack_stress_params(model: SimModel) -> torch.Tensor:
    """[16, 2] f32: stress/cash per-regime rows + funding scalars."""
    S, F = model.stress, model.funding

    def two(v):
        return torch.stack([_f32(v).reshape(())] * 2)

    rows = [_f32(S.liq_mu), _f32(S.liq_phi), _f32(S.liq_sigma),
            _f32(S.credit_mu), _f32(S.credit_phi), _f32(S.credit_sigma),
            _f32(S.jump_base_prob), _f32(S.jump_scale),
            _f32(model.cash_rate),
            two(F.base), two(F.beta_vix), two(F.beta_inv_curve),
            two(F.beta_liquidity), two(F.beta_credit),
            two(F.min_spread), two(F.max_spread)]
    return torch.stack(rows).contiguous()


def pack_asset_params(model: SimModel) -> torch.Tensor:
    """[9, A] f32 per-asset rows."""
    P, Tk = model.assets, model.tracking
    rho = _f32(Tk.rho)
    sq = torch.sqrt(torch.clamp_min(1.0 - rho ** 2, 1e-6))
    return torch.stack([_f32(P.leverage), _f32(P.expense_ratio),
                        _f32(P.beta), _f32(P.fallback_spread), rho, sq,
                        _f32(Tk.te_scale), _f32(Tk.downside_mult),
                        _f32(Tk.clip_limit)]).contiguous()
