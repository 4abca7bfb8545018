"""Frozen copy of ``letf_tpu_torch/config.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Configuration of the PyTorch port: the constants it reads.

The port's own copy of ``letf_tpu/config.py`` (same names, same values):
the asset table, transaction costs and cash rates, the Monte Carlo and
regime parameters, the engine mode, random-start settings and the strategy
table, the date ranges and horizons, the cache paths and the banner. The
port imports nothing of the JAX package; ``tests/test_torch_params.py``
holds this copy equal to the original.

One deliberate difference: ``CACHE_DIR`` is the port's own directory. The
JAX package's ``letf_tpu_cache_v1/`` holds its committed fits, and a port
that read them would never calibrate; nothing of the port writes there.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

# Date and capital constants.
DATA_START_DATE = "1926-07-01"
DATA_END_DATE = "2025-12-31"
INITIAL_CAPITAL = 10_000.0

ANALYSIS_START_DATE = "1926-07-01"
ANALYSIS_END_DATE = "2025-12-31"

FAMA_FRENCH_END_DATE = "1949-12-31"
YFINANCE_START_DATE = "1950-01-01"

TIME_HORIZONS = [1, 2, 5, 10, 20, 30, 40, 50]

START_DATE_OPTIONS = {
    1: {"date": "1926-07-01", "name": "Full History",
        "description": "Includes Great Depression, WWII, all major events"},
    2: {"date": "1950-01-01", "name": "Post-WWII",
        "description": "More reliable data, excludes pre-war period"},
    3: {"date": "1980-01-01", "name": "Modern Era",
        "description": "After stagflation, more relevant to today"},
    4: {"date": "2000-01-01", "name": "21st Century",
        "description": "Includes dot-com crash, 2008 crisis, COVID"},
    5: {"date": "2010-01-01", "name": "Post-Crisis",
        "description": "TQQQ real data begins, bull market era"},
    6: {"date": "2015-01-01", "name": "Recent History",
        "description": "Last 10 years only"},
}

TRADING_DAYS = 252

# Underlying index streams of the joint return model.
UNDERLYING_SPY = 0
UNDERLYING_QQQ = 1
UNDERLYING_TLT = 2
UNDERLYING_NAMES = ("SPY_Ret", "QQQ_Ret", "TLT_Ret")


@dataclasses.dataclass(frozen=True)
class AssetConfig:
    name: str
    long_name: str
    inception: str
    leverage: float
    expense_ratio: float
    underlying: int          # index into UNDERLYING_NAMES
    beta_to_spy: float
    tracking_error_base: float
    tracking_error_df: float
    borrow_spread: float


# Order matters: it defines the asset axis of every per-asset tensor.
ASSETS: Dict[str, AssetConfig] = {
    "TQQQ": AssetConfig("TQQQ", "3x NASDAQ-100", "2010-02-11", 3.0, 0.0086,
                        UNDERLYING_QQQ, 1.0, 0.0002, 5.0, 0.0075),
    "UPRO": AssetConfig("UPRO", "3x S&P 500", "2009-06-25", 3.0, 0.0091,
                        UNDERLYING_SPY, 1.0, 0.00015, 5.0, 0.0060),
    "SSO": AssetConfig("SSO", "2x S&P 500", "2006-07-11", 2.0, 0.0089,
                       UNDERLYING_SPY, 1.0, 0.0001, 5.0, 0.0050),
    "TMF": AssetConfig("TMF", "3x 20Y Treasury", "2009-04-16", 3.0, 0.0108,
                       UNDERLYING_TLT, -0.3, 0.0003, 5.0, 0.0040),
    "SPY": AssetConfig("SPY", "S&P 500 (No Leverage)", "1993-01-29", 1.0,
                       0.000945, UNDERLYING_SPY, 1.0, 0.00005, 10.0, 0.0),
    "QQQ": AssetConfig("QQQ", "NASDAQ-100 (No Leverage)", "1999-03-10", 1.0,
                       0.0020, UNDERLYING_QQQ, 1.0, 0.00005, 10.0, 0.0),
}

ASSET_NAMES: Tuple[str, ...] = tuple(ASSETS.keys())
ASSET_INDEX: Dict[str, int] = {name: i for i, name in enumerate(ASSET_NAMES)}
N_ASSETS = len(ASSET_NAMES)

# The reference's name for the asset table (letf_tpu/config.py:96).
LETF_CONFIGS = ASSETS


@dataclasses.dataclass(frozen=True)
class AssetTable:
    """Struct-of-arrays view of ASSETS. TMF passes TLT through unscaled;
    the equity assets scale their underlying by ``beta_to_spy``."""
    leverage: np.ndarray
    expense_ratio: np.ndarray
    borrow_spread: np.ndarray
    te_base: np.ndarray
    te_df: np.ndarray
    underlying: np.ndarray
    beta: np.ndarray


def asset_table() -> AssetTable:
    cfgs = list(ASSETS.values())
    beta = [1.0 if c.underlying == UNDERLYING_TLT else c.beta_to_spy
            for c in cfgs]
    return AssetTable(
        leverage=np.array([c.leverage for c in cfgs], np.float64),
        expense_ratio=np.array([c.expense_ratio for c in cfgs], np.float64),
        borrow_spread=np.array([c.borrow_spread for c in cfgs], np.float64),
        te_base=np.array([c.tracking_error_base for c in cfgs], np.float64),
        te_df=np.array([c.tracking_error_df for c in cfgs], np.float64),
        underlying=np.array([c.underlying for c in cfgs], np.int32),
        beta=np.array(beta, np.float64),
    )


# Transaction costs / cash.
BASE_SPREAD_BPS = {0: 2.0, 1: 8.0}
REBALANCE_COST_PER_DOLLAR = 0.0001
CASH_RATE_BY_REGIME = {0: 0.010, 1: -0.020}

# Monte Carlo parameters.
NUM_SIMULATIONS = 200
USE_ANTITHETIC_VARIATES = True
USE_MOMENT_MATCHING = True
# Trials per device chunk.
DEVICE_CHUNK_TRIALS = 16384

# Regimes.
N_REGIMES = 2
REGIME_NAMES = {0: "Low Vol", 1: "High Vol"}
MIN_REGIME_DURATION = {0: 60, 1: 20}
MAX_DWELL_SAMPLES = 256

# Cache: the port's own directory (see the module docstring).
CACHE_DIR = Path("letf_tpu_torch_cache")

DATA_CACHE = CACHE_DIR / "historical_data.pkl"
REGIME_MODEL_CACHE = CACHE_DIR / "regime_model.pkl"
CORRELATION_CACHE = CACHE_DIR / "correlations.pkl"
VALIDATION_RESULTS = CACHE_DIR / "validation_results.json"
JOINT_RETURN_MODEL_CACHE = CACHE_DIR / "joint_return_model.pkl"
FUNDING_MODEL_CACHE = CACHE_DIR / "funding_spread_model.pkl"
TRACKING_RESIDUAL_CACHE = CACHE_DIR / "tracking_residual_model.pkl"
STRESS_STATE_CACHE = CACHE_DIR / "stress_state_model.pkl"
BOOTSTRAP_CACHE = CACHE_DIR / "bootstrap_data.pkl"


# Block bootstrap, engine mode and the parametric generator.
BOOTSTRAP_BLOCK_MIN = 21
BOOTSTRAP_BLOCK_MAX = 168
BOOTSTRAP_BLOCK_MEAN = 84
BOOTSTRAP_BLOCK_SIZE = BOOTSTRAP_BLOCK_MAX
BOOTSTRAP_MOMENTUM_BIAS_BY_REGIME = {0: 0.54, 1: 0.505}
STUDENT_T_DF = 5
BOOTSTRAP_WEIGHT = 0.80
USE_BLOCK_BOOTSTRAP = True
SIM_ENGINE_MODE = "institutional_v1"


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """The engine configuration in one object (reference config.py:270-284)."""
    engine_mode: str
    use_block_bootstrap: bool
    bootstrap_weight: float


# Random start.
USE_RANDOM_START = True
RANDOM_START_METHOD = "offset"   # 'regime_only' | 'offset' | 'historical_anchor'
START_REGIME_PROBABILITIES = {0: 0.80, 1: 0.20}
RANDOM_START_BUFFER_YEARS = 5
MIN_HISTORY_FOR_ANCHOR = 2
RANDOMIZE_INITIAL_VIX = True
INITIAL_VIX_RANGE = {0: (12.0, 20.0), 1: (25.0, 45.0)}

# Strategies S1-S19 (names and parameters; the engine reads the ids).
STRATEGIES = {
    "S1": {"name": "TQQQ Buy Hold", "type": "benchmark", "asset": "TQQQ"},
    "S2": {"name": "SPY Buy Hold", "type": "benchmark", "asset": "SPY"},
    "S3": {"name": "SSO BuyHold (2x)", "type": "benchmark", "asset": "SSO"},
    "S4": {"name": "200-SMA Simple", "type": "sma", "asset": "TQQQ",
           "sma_period": 200},
    "S5": {"name": "SMA +/-2% Band", "type": "sma_band", "asset": "TQQQ",
           "sma_period": 200, "band": 0.02},
    "S6": {"name": "60/40 TQQQ/TMF", "type": "portfolio",
           "assets": {"TQQQ": 0.6, "TMF": 0.4}, "rebalance_freq": 21},
    "S7": {"name": "Vol Targeting (20%)", "type": "vol_targeting",
           "asset": "TQQQ", "target_vol": 0.20, "lookback": 20},
    "S8": {"name": "Composite Regime", "type": "composite", "asset": "TQQQ",
           "defensive_asset": "SPY", "sma_period": 200, "rsi_period": 14,
           "vix_threshold": 25.0},
    "S9": {"name": "Adaptive Vol Target", "type": "adaptive_vol",
           "asset": "TQQQ", "bull_target": 0.35, "bear_target": 0.12,
           "lookback": 20, "sma_period": 200},
    "S10": {"name": "Sortino Optimize", "type": "downside_vol",
            "asset": "TQQQ", "target_downside_vol": 0.15, "lookback": 20},
    "S11": {"name": "Hyper-Convex", "type": "convex_vol", "asset": "TQQQ",
            "target_vol": 0.25, "power": 1.2, "sma_period": 200},
    "S12": {"name": "Vol-Velocity", "type": "vol_velocity", "asset": "TQQQ",
            "target_vol": 0.22},
    "S13": {"name": "VoV Momentum", "type": "vol_mom", "asset": "TQQQ",
            "target_vol": 0.25},
    "S14": {"name": "Skewness-Adjusted", "type": "skew_convex",
            "asset": "TQQQ", "target_vol": 0.25},
    "S15": {"name": "Meta-Ensemble", "type": "meta_ensemble",
            "asset": "TQQQ", "target_vol": 0.28},
    "S16": {"name": "Crisis Alpha", "type": "regime_asymmetric",
            "asset": "TQQQ", "base_target_vol": 0.30,
            "crisis_target_vol": 0.08, "vix_alarm_level": 25,
            "vol_expansion_threshold": 1.5, "lookback_fast": 5,
            "lookback_slow": 60},
    "S17": {"name": "Tail Risk Optimizer", "type": "skew_kelly",
            "asset": "TQQQ", "base_target_vol": 0.30, "skew_lookback": 60,
            "vol_lookback": 20, "kelly_fraction": 0.7},
    "S18": {"name": "Mom. Vol Conv.", "type": "mom_vol_convergence",
            "asset": "TQQQ", "base_target_vol": 0.28,
            "momentum_lookback": 126, "vol_fast": 10, "vol_slow": 60,
            "momentum_threshold": 0.05},
    "S19": {"name": "Conviction Compounder", "type": "conviction_compounder",
            "asset": "TQQQ", "base_target_vol": 0.32,
            "momentum_lookback": 126, "vol_lookback": 20, "trend_sma": 100,
            "rebalance_threshold": 0.05},
}

STRATEGY_IDS: Tuple[str, ...] = tuple(STRATEGIES.keys())
STRATEGY_INDEX: Dict[str, int] = {sid: i for i, sid in enumerate(STRATEGY_IDS)}
N_STRATEGIES = len(STRATEGY_IDS)

ROTH_IDS = ["S1", "S2", "S3", "S4", "S5", "S6"]
TAXABLE_IDS = ["S7", "S8", "S9", "S10", "S11", "S12", "S13", "S14", "S15",
               "S16", "S17", "S18", "S19"]


