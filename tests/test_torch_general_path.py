"""The port's general path (K1, K2', K5, signals, emitting strategy engine)
against the JAX package's kernel route, and against the port's slab chunk.

On the CPU the JAX general path does not take its kernel route (it draws
with jax.random), so the reference is built by hand from the JAX pieces as
``generate_paths_batched:1048-1067`` chains them on the TPU:
``draw_innovations_fast(joint_draws=False, aux_draws=False)``,
``pallas_joint_generate``, moment matching, ``window_offsets_pallas``,
``pallas_compose_generate`` (Pallas in interpret mode) and
``_finish_path``; then ``compute_signals`` and
``run_strategies_batch(emit_trades=True)``. B = 1,024 trials, a 126-day
window and a 126-day buffer, ``jax.random.key(7)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as cfg
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import pallas_compose as pc
from letf_tpu.ops import path_batched as jpb
from letf_tpu.ops.pallas_joint import _pack_params, pallas_joint_generate
from letf_tpu.ops.pallas_window import window_offsets_pallas
from letf_tpu.strategies import engine as jeng
from letf_tpu.strategies.engine import run_strategies_batch as jax_engine
from letf_tpu.strategies.signals import compute_signals as jax_signals
from letf_tpu_torch.models.params import from_numpy
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.path_batched import generate_paths_batched
from letf_tpu_torch.ops.slab_chunk import slab_chunk_summaries
from letf_tpu_torch.strategies import engine as teng
from letf_tpu_torch.strategies.engine import run_strategies_batch
from letf_tpu_torch.strategies.signals import compute_signals
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, SIM, BUF, SEED = 1024, 126, 126, 7


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.fixture(scope="module")
def jax_ref(model):
    """The JAX kernel route, Pallas in interpret mode."""
    m = jax.tree.map(jnp.asarray, model)
    key = jax.random.key(SEED)
    ids = jnp.arange(B, dtype=jnp.int32) // 2
    anti = (jnp.arange(B) % 2) == 1
    T = SIM + BUF
    innov = jpb.draw_innovations_fast(
        m, key, ids, anti, SIM, BUF, "offset", joint_draws=False,
        aux_draws=False, max_spells=jpb.plan_max_spells(model, T))
    seed_words = jax.lax.bitcast_convert_type(
        jax.random.key_data(key).reshape(-1)[:2], jnp.int32)
    signs = jnp.where(anti, -1.0, 1.0).astype(jnp.float32)
    x, vix, irx = pallas_joint_generate(
        _pack_params(model), jnp.asarray(model.joint.chi_cheb, jnp.float32),
        innov.regime_full, ids, signs, seed_words, T, interpret=True)
    theo = jnp.asarray(model.joint.theo_mean, x.dtype)
    x = x + (theo[None, None, :] - x.mean(axis=1, keepdims=True)) * 0.1
    packed = jnp.stack([x[..., 0], x[..., 1], x[..., 2], vix, irx,
                        innov.regime_full.astype(x.dtype)]).transpose(0, 2, 1)
    w = window_offsets_pallas(packed, innov.start_offset.astype(jnp.int32),
                              SIM, interpret=True)               # [6, S, B]
    spy, qqq, tlt, vix_w, irx_w = (w[c].T for c in range(5))
    regime = w[5].T.astype(jnp.int32)
    etf, spy_a, qqq_a, cash, jc, ls, cs = pc.pallas_compose_generate(
        pc._pack_stress_params(m), pc._pack_asset_params(m), ids,
        seed_words, spy, qqq, tlt, vix_w, irx_w, regime, sim_days=SIM,
        interpret=True)
    path = jpb._finish_path(m, innov, etf, tlt, spy_a, qqq_a, vix_w, regime,
                            cash, jnp.clip(irx_w, 0.0, 20.0) / 100.0,
                            jc.astype(jnp.int32), ls / SIM, cs / SIM)
    res = jax_engine(path, jax_signals(path), emit_trades=True)
    return ({k: np.asarray(getattr(path, k)) for k in path._fields},
            {k: None if v is None else np.asarray(v)
             for k, v in res._asdict().items()}, path)


@pytest.fixture(scope="module")
def port_run(model):
    mt = from_numpy(model, "cpu", torch.float64)
    rows = torch.arange(B)
    path = generate_paths_batched(
        mt, rng.key(SEED), rows // 2, rows % 2 == 1, sim_days=SIM,
        buffer_days=BUF, max_spells=jpb.plan_max_spells(model, SIM + BUF))
    res = run_strategies_batch(path, compute_signals(path), emit_trades=True)
    return mt, path, res


def test_general_path_matches_jax_kernel_route(jax_ref, port_run):
    """Start conditions, regimes, jump days and validity flags exact; the
    series within the joint kernel's parity bounds (rtol 1e-4 / atol 1e-6,
    VIX atol 1e-3; tests/test_torch_joint.py), which the window and K5
    carry through."""
    ref, _, _ = jax_ref
    _, path, _ = port_run
    for k in ("start_offset", "start_regime", "jump_days", "valid",
              "repaired", "path_finite", "vix_ok"):
        np.testing.assert_array_equal(path._asdict()[k].numpy(), ref[k],
                                      err_msg=k)
    np.testing.assert_array_equal(path.regime.numpy().T, ref["regime"])
    np.testing.assert_allclose(path.etf_ret.numpy().transpose(2, 1, 0),
                               ref["etf_ret"], rtol=1e-4, atol=1e-6)
    for k in ("tlt_ret", "spy_ret", "qqq_ret", "cash_ret", "risk_free"):
        np.testing.assert_allclose(path._asdict()[k].numpy().T, ref[k],
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(path.vix.numpy().T, ref["vix"], rtol=0,
                               atol=1e-3)
    for k in ("liq_mean", "credit_mean"):
        np.testing.assert_allclose(path._asdict()[k].numpy(), ref[k],
                                   atol=1e-4 / SIM, err_msg=k)


def test_emitting_engine_matches_jax(jax_ref, port_run):
    """Wealth, trades and drawdown within check_parity's bounds; the
    journal's asset column exact; < 0.5% of journal cells differ (a
    borderline signal flip moves a trade by a day), NaN patterns
    included, at rtol 1e-4."""
    _, ref, _ = jax_ref
    _, _, res = port_run
    got = {k: v.numpy() for k, v in res._asdict().items()}
    k3.check_parity(dict(got, jump_days=np.zeros(B)),
                    dict(ref, jump_days=np.zeros(B)))
    np.testing.assert_allclose(got["max_dd"], ref["max_dd"], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(got["tj_asset"], ref["tj_asset"])
    assert got["tj_alloc"].shape == (SIM, B, len(cfg.TAXABLE_IDS))
    for k in ("tj_alloc", "tj_value", "tj_price"):
        a, b = got[k], ref[k]
        same = np.isclose(a, b, rtol=1e-4, atol=1e-6, equal_nan=True)
        assert 1.0 - same.mean() < 5e-3, (k, 1.0 - same.mean())
    assert (~np.isnan(got["tj_alloc"])).sum() > B * SIM * 0.1


def test_general_path_matches_slab_chunk(model, port_run):
    """The two chunk formulations compose the same kernels' draws: the
    bounds of tests/test_path_batched.py:380-392 (the JAX package's
    hardware-only test of the same property)."""
    mt, path, res = port_run
    rows = torch.arange(B)
    sm = slab_chunk_summaries(mt, rng.key(SEED), rows // 2, rows % 2 == 1,
                              sim_days=SIM, buffer_days=BUF,
                              max_spells=jpb.plan_max_spells(model,
                                                             SIM + BUF))
    fw, nt = sm["final_wealth"].numpy(), sm["num_trades"].numpy()
    rw, rt = res.final_wealth.numpy(), res.num_trades.numpy()
    rel = np.abs(fw - rw) / np.maximum(np.abs(rw), 1.0)
    assert float(np.median(rel)) < 1e-5
    assert float((rel > 1e-3).mean()) < 0.01
    assert float((nt != rt).mean()) < 0.05
    for q in (10, 50, 90):
        np.testing.assert_allclose(np.percentile(fw, q, axis=0),
                                   np.percentile(rw, q, axis=0), rtol=5e-3,
                                   atol=1e-2)
    np.testing.assert_array_equal(sm["valid"].numpy(), path.valid.numpy())
    np.testing.assert_array_equal(sm["jump_days"].numpy(),
                                  path.jump_days.numpy())
    np.testing.assert_allclose(sm["liq_mean"].numpy(), path.liq_mean.numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("schedule", ["dca", "withdrawal"])
def test_engine_cashflow_overlays_match_jax(jax_ref, port_run, schedule):
    """DCA contributions and monthly withdrawals (BASELINE configs #4/#5)
    on the same paths: the schedules equal, the overlay's floors and S6
    sleeve scaling within check_parity's bounds."""
    _, _, jpath = jax_ref
    _, path, _ = port_run
    if schedule == "dca":
        cf, ref_cf = (m.dca_schedule(SIM, 500.0) for m in (teng, jeng))
    else:
        cf, ref_cf = (m.withdrawal_schedule(SIM, 30000.0)
                      for m in (teng, jeng))
    np.testing.assert_array_equal(cf, ref_cf)
    ref = jax_engine(jpath, jax_signals(jpath), emit_trades=True,
                     cashflows=jnp.asarray(cf, jnp.float32))
    got = run_strategies_batch(path, compute_signals(path), emit_trades=True,
                               cashflows=cf)
    g = {k: v.numpy() for k, v in got._asdict().items()}
    r = {k: np.asarray(v) for k, v in ref._asdict().items()}
    k3.check_parity(dict(g, jump_days=np.zeros(B)),
                    dict(r, jump_days=np.zeros(B)))
    np.testing.assert_array_equal(g["tj_asset"], r["tj_asset"])
    if schedule == "withdrawal":
        assert (g["final_wealth"] == 0).any()      # withdrawals ruin some
