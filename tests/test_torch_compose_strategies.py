"""Kernel K3 (compose + signals + 19 strategies): the port's plain PyTorch
version against the Pallas ``pallas_compose_strategies_run`` in interpret
mode: with and without a DCA cashflow schedule, with and without costs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as cfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops.pallas_compose import (
    _pack_asset_params,
    _pack_stress_params,
)
from letf_tpu.ops.pallas_strategies import pallas_compose_strategies_run
from letf_tpu.strategies.engine import dca_schedule
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.utils.device import slab_to_tb, tb_to_slab
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def market_inputs(B, S, seed):
    """Windowed market series [S, B] f32 of the kind the chain produces:
    fat-ish daily returns, a VIX that moves with SPY, regime spells."""
    rs = np.random.default_rng(seed)
    spy = (0.0003 + 0.012 * rs.standard_t(5, (S, B))).astype(np.float32)
    qqq = (1.2 * spy + 0.004 * rs.standard_normal((S, B))).astype(np.float32)
    tlt = (-0.2 * spy + 0.006 * rs.standard_normal((S, B))).astype(
        np.float32)
    vix = np.clip(20.0 - 300.0 * np.cumsum(spy - 0.0003, 0) * 0.1
                  + 3.0 * rs.standard_normal((S, B)), 9.0, 80.0).astype(
        np.float32)
    irx = np.clip(3.0 + 0.3 * rs.standard_normal((S, B)), 0.0, 15.0).astype(
        np.float32)
    regime = (np.cumsum(rs.random((S, B)) < 0.05, 0) % 2).astype(np.float32)
    return spy, qqq, tlt, vix, irx, regime


def compare_k3(got, ref):
    """K3's parity bounds (``compose_strategies.check_parity``; VIX range,
    regime days and the finite flag exact) and the drawdown and stress
    sums."""
    got, ref = dict(zip(k3.OUTPUTS, got)), dict(zip(k3.OUTPUTS, ref))
    assert np.isfinite(got["final_wealth"]).all()
    k3.check_parity(got, ref, exact=("vix_min", "vix_max",
                                     "regime_high_days", "path_finite"))
    mdd, rmdd = got["max_dd"], ref["max_dd"]
    mrel = np.abs(mdd - rmdd) / np.maximum(np.abs(rmdd), 1e-3)
    assert float(np.median(mrel)) < 1e-4
    np.testing.assert_allclose(got["liq_sum"], ref["liq_sum"], atol=1e-4)
    np.testing.assert_allclose(got["cred_sum"], ref["cred_sum"], atol=1e-4)


def run_both(model, chans, ids, seed, cf=None, apply_costs=True, sub=8):
    """The Pallas kernel in interpret mode and the port's K3 on the CPU on
    the same [S, B] inputs; both as lists of numpy arrays."""
    S = chans[0].shape[0]
    mj = jax.tree.map(jnp.asarray, model)
    sp, ap = _pack_stress_params(mj), _pack_asset_params(mj)
    ref = pallas_compose_strategies_run(
        sp, ap, jnp.asarray(ids), jnp.asarray(seed),
        *(jnp.asarray(tb_to_slab(c, sub)) for c in chans), sim_days=S,
        cashflows=None if cf is None else jnp.asarray(cf),
        apply_costs=apply_costs, interpret=True)
    ref = [np.asarray(r) for r in ref]

    tsp = tparams.pack_stress_params(model)
    tap = tparams.pack_asset_params(model)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(tap.numpy(), np.asarray(ap))
    got = k3.compose_strategies(
        tsp, tap, torch.from_numpy(ids), seed.tolist(),
        *(torch.from_numpy(c) for c in chans),
        cashflows=None if cf is None else torch.from_numpy(cf),
        apply_costs=apply_costs)
    assert k3.LAUNCHES == 0              # CPU tensors run the plain version
    return [g.numpy() for g in got], ref


@pytest.mark.parametrize("with_cashflows,apply_costs",
                         [(False, True), (True, True), (False, False)])
def test_compose_strategies_plain_matches_pallas_interpret(with_cashflows,
                                                           apply_costs):
    """1024 trials x 126 days, held to ``compose_strategies.check_parity``
    (borderline compares flip on f32 ulps between XLA:CPU and torch: libm
    and summation order differ); VIX range, regime days and the finite
    flag exact."""
    model = default_sim_model()
    B, S = 1024, 126
    chans = market_inputs(B, S, seed=5)
    ids = (np.arange(B) // 2).astype(np.int32)
    seed = np.asarray([9, 11], np.int32)
    cf = (np.asarray(dca_schedule(S, 750.0), np.float32) if with_cashflows
          else None)
    got, ref = run_both(model, chans, ids, seed, cf, apply_costs)
    assert got[0].shape == (B, k3.NS) and got[1].dtype == np.int32
    compare_k3(got, ref)
    # The inputs round-trip the slab layout helpers exactly.
    np.testing.assert_array_equal(slab_to_tb(tb_to_slab(chans[0])),
                                  chans[0])


def test_compose_strategies_plain_matches_pallas_long_window_and_ruin():
    """320 days: the 126- and 200-day window sums lose their oldest day,
    the SMA200 gate opens at day 199 and the 128- and 256-row rings wrap,
    as over the 30-year main path. The first 16 trials crash for 14 days
    (SPY and QQQ -50% a day, so TQQQ and SSO lose 99.9% a day): their
    S1/S3 equity falls below float32's smallest normal, which the
    reference's flush-to-zero arithmetic makes 0 for good; check_parity
    holds S1-S3's ruin flags exact. One 128-trial tile (sub=1) keeps
    the interpret run short."""
    model = default_sim_model()
    B, S = 128, 320
    chans = market_inputs(B, S, seed=5)
    for c in chans[:2]:
        c[20:34, :16] = -0.5
    ids = (np.arange(B) // 2).astype(np.int32)
    seed = np.asarray([9, 11], np.int32)
    got, ref = run_both(model, chans, ids, seed, sub=1)
    compare_k3(got, ref)
    s1 = cfg.STRATEGY_INDEX["S1"]
    assert (ref[0][:16, s1] == 0).all() and (got[0][:16, s1] == 0).all()
    assert (ref[0][16:, s1] > 0).all()
