"""The port's parametric path engine against ``letf_tpu/ops/path_engine.py``.

Both packages draw the innovations of 48 trials (24 antithetic pairs, 126
days + a 126-day buffer, seed 3) in float64; the port's draws are held to
the JAX ones (start conditions and regime paths exactly, the samplers'
draws within tests/test_torch_rng_samplers.py's bounds). Then both run the
path math on the SAME innovations (JAX's, carried across), which isolates
the recursions from the samplers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import path_engine as jpe
from letf_tpu_torch.data import generate_synthetic_history
from letf_tpu_torch.models.bootstrap import build_bootstrap_pools
from letf_tpu_torch.models.params import from_jax_model, from_numpy
from letf_tpu_torch.ops import path_engine as tpe
from letf_tpu_torch.ops import rng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S, BUF, SEED = 48, 126, 126, 3


@pytest.fixture(scope="module")
def models():
    jm = default_sim_model()
    return jm, from_numpy(from_jax_model(jm), "cpu", torch.float64)


@pytest.fixture(scope="module")
def jax_innov(models):
    jm, _ = models
    ids = jnp.arange(B) // 2
    anti = jnp.arange(B) % 2 == 1
    return jax.vmap(lambda i, a: jpe.draw_innovations(
        jm, jax.random.key(SEED), i, a, S, BUF))(ids, anti)


def carried(ji) -> tpe.Innovations:
    """JAX innovations [B, ...] in the port's batch-last layout."""
    def tn(a):
        return torch.as_tensor(np.array(a))

    def tb(a):
        return tn(a).t().contiguous()

    return tpe.Innovations(
        start_offset=tn(ji.start_offset), start_regime=tn(ji.start_regime),
        initial_vix=tn(ji.initial_vix),
        regime_full=tb(ji.regime_full), eps=None, u_chi=None,
        vix_noise=tb(ji.vix_noise), irx_noise=tb(ji.irx_noise),
        stress_norms=tn(ji.stress_norms).permute(2, 1, 0).contiguous(),
        u_jump=tb(ji.u_jump), t_abs=tb(ji.t_abs), jump_sign=tb(ji.jump_sign),
        te_draws=tn(ji.te_draws).permute(2, 1, 0).contiguous(),
        mode_key=torch.as_tensor(np.asarray(
            jax.random.key_data(ji.mode_key)).astype(np.int64)))


def close(got, ref, rtol, atol=0.0, name=""):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


def test_draw_innovations_match_jax(models, jax_innov):
    _, mt = models
    ids = torch.arange(B) // 2
    got = tpe.draw_innovations(mt, rng.key(SEED), ids, torch.arange(B) % 2
                               == 1, S, BUF, engine_mode="parametric")
    ref = carried(jax_innov)
    for k in ("start_offset", "start_regime", "regime_full", "u_jump",
              "jump_sign", "mode_key", "initial_vix"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(ref, k).numpy(), err_msg=k)
    assert 0 < got.regime_full.float().mean() < 1          # both regimes
    for k in ("vix_noise", "irx_noise", "stress_norms", "t_abs",
              "te_draws"):
        close(getattr(got, k).numpy(), getattr(ref, k).numpy(), 4e-14,
              1e-15, k)
    assert got.eps is None and got.u_chi is None


def test_path_from_innovations_matches_jax(models, jax_innov):
    jm, mt = models
    jp = jax.vmap(lambda inn: jpe.path_from_innovations(
        jm, inn, S, engine_mode="parametric"))(jax_innov)
    tp = tpe.path_from_innovations(mt, carried(jax_innov), S,
                                   engine_mode="parametric")
    close(tp.etf_ret.numpy().transpose(2, 1, 0), jp.etf_ret, 1e-12, 1e-15,
          "etf_ret")
    for k in ("tlt_ret", "spy_ret", "qqq_ret", "vix", "cash_ret",
              "risk_free"):
        close(getattr(tp, k).numpy().T, getattr(jp, k), 1e-12, 1e-15, k)
    np.testing.assert_array_equal(tp.regime.numpy().T, jp.regime)
    for k in ("jump_days", "valid", "repaired", "path_finite", "vix_ok",
              "start_offset", "start_regime"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)
    for k in ("liq_mean", "credit_mean", "initial_vix"):
        close(getattr(tp, k).numpy(), getattr(jp, k), 1e-13, 0.0, k)
    # An antithetic pair is one path in this mode (no joint normals).
    np.testing.assert_array_equal(tp.etf_ret[:, :, 0].numpy(),
                                  tp.etf_ret[:, :, 1].numpy())


def test_generate_paths_batch_is_draws_then_path(models, jax_innov):
    _, mt = models
    rows = torch.arange(8)
    a = tpe.generate_paths_batch(mt, rng.key(SEED), rows // 2, rows % 2 == 1,
                                 S, BUF, engine_mode="legacy_hybrid")
    jp = jax.vmap(lambda i, an: jpe.generate_path(
        models[0], jax.random.key(SEED), i, an, S, BUF,
        engine_mode="parametric"))(jnp.arange(8) // 2, jnp.arange(8) % 2 == 1)
    close(a.etf_ret.numpy().transpose(2, 1, 0), jp.etf_ret, 1e-9, 1e-12)


def test_unported_modes_raise(models):
    """Every engine mode of the JAX package runs (the institutional mode
    and legacy_hybrid with pools: tests/test_torch_engine_modes.py and
    tests/test_torch_bootstrap.py); an unknown engine mode raises."""
    _, mt = models
    ids = torch.arange(4)
    pools = build_bootstrap_pools(
        generate_synthetic_history("2015-01-01", "2025-12-31"))
    for kw in (dict(engine_mode="institutional_v1"),
               dict(engine_mode="parametric"),
               dict(engine_mode="legacy_hybrid", bootstrap_pools=pools)):
        p = tpe.generate_paths_batch(mt, rng.key(0), ids, ids < 0, 21, **kw)
        assert p.etf_ret.shape == (6, 21, 4)
        assert bool(torch.isfinite(p.etf_ret).all()), kw
    with pytest.raises(ValueError, match="engine_mode"):
        tpe.generate_paths_batch(mt, rng.key(0), ids, ids < 0, 21,
                                 engine_mode="bootstrap")
