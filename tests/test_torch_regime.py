"""Start conditions and regime spells of the port against
``letf_tpu.ops.path_batched``: start offsets, start conditions and regime
paths exactly equal; ``plan_max_spells`` equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as cfg
from letf_tpu.models.params import build_dwell_tables, default_sim_model
from letf_tpu.ops import path_batched as jpb
from letf_tpu.ops import rng as jrng
from letf_tpu_torch.models.params import from_numpy
from letf_tpu_torch.ops import path_batched as tpb
from letf_tpu_torch.ops import rng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 1024


def empirical_model():
    """Default model with empirical dwell tables (the compare-only
    inverse-CDF branch)."""
    m = default_sim_model()
    dv, dc, hd = build_dwell_tables({0: [5, 20, 40, 100, 33, 250],
                                     1: [3, 7, 11, 2]})
    return m._replace(regime=m.regime._replace(
        dwell_values=dv, dwell_cdf=dc, has_dwell=hd))


def jax_keys(seed, ids):
    k = jax.random.key(seed)
    tks = jax.vmap(lambda t: jrng.trial_key(k, t))(jnp.asarray(ids,
                                                                jnp.int32))
    return k, jax.vmap(lambda kk: jrng.stream(kk, jrng.REGIME))(tks)


@pytest.mark.parametrize("which", ["default", "empirical"])
@pytest.mark.parametrize("total_days", [252, 2520])
def test_regime_paths_exact(which, total_days):
    """The default model takes the geometric-dwell branch
    (ceil(log1p(-u) / log p_stay)); the empirical tables the inverse-CDF
    branch. Both must give the JAX paths exactly, including the
    max_spells overflow rule (the final regime holds)."""
    model = default_sim_model() if which == "default" else empirical_model()
    assert float(model.regime.has_dwell.max()) == (which == "empirical")
    ids = np.arange(B) // 2
    rs = np.random.default_rng(total_days)
    start = rs.integers(0, 2, B).astype(np.int32)
    k = jpb.plan_max_spells(model, total_days)
    assert tpb.plan_max_spells(model, total_days) == k
    for max_spells in (k, 16):              # 16 spells overflow 2520 days
        _, rk = jax_keys(3, ids)
        ref = np.asarray(jpb.simulate_regime_paths_spell(
            jax.tree.map(jnp.asarray, model), rk, jnp.asarray(start),
            total_days, max_spells=max_spells))
        got = tpb.simulate_regime_paths_spell(
            from_numpy(model, "cpu", torch.float64),
            rng.stream(rng.trial_key(rng.key(3), torch.as_tensor(ids)),
                       rng.REGIME),
            torch.from_numpy(start), total_days, max_spells=max_spells)
        assert got.shape == (total_days, B)
        np.testing.assert_array_equal(got.numpy().T, ref)
    assert 0.0 < ref.mean() < 1.0


def test_start_offsets_and_conditions_exact():
    model = default_sim_model()
    mj = jax.tree.map(jnp.asarray, model)
    mt = from_numpy(model, "cpu", torch.float64)
    ids = np.arange(B) // 2
    k = jax.random.key(11)
    tk = rng.key(11)
    tids = torch.as_tensor(ids)
    for buf in (126, 1260):
        ref = np.asarray(jpb.start_offsets_only(k, jnp.asarray(ids,
                                                               jnp.int32),
                                                buf))
        got = tpb.start_offsets_only(tk, tids, buf, torch.float64).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype == np.int64        # x64 suite
        assert got.min() >= min(50, buf // 4) and got.max() < buf
    anchors = (np.arange(400) % 2, 15.0 + (np.arange(400) % 20))
    for method, anc in (("offset", None), ("regime_only", None),
                        ("historical_anchor", anchors), ("none", None)):
        ref = jpb.draw_innovations_fast(
            mj, k, jnp.asarray(ids, jnp.int32), jnp.zeros(B, bool), 63,
            126, method, anchors=None if anc is None else tuple(
                jnp.asarray(a) for a in anc),
            joint_draws=False, aux_draws=False)
        got = tpb.start_conditions(mt, tk, tids, 126, method, anc,
                                   torch.float64)
        np.testing.assert_array_equal(got.start_offset.numpy(),
                                      np.asarray(ref.start_offset))
        np.testing.assert_array_equal(got.start_regime.numpy(),
                                      np.asarray(ref.start_regime))
        np.testing.assert_array_equal(got.initial_vix.numpy(),
                                      np.asarray(ref.initial_vix))
    assert cfg.N_REGIMES == 2


def test_unit_uniform_spell_outlasts_the_horizon(monkeypatch):
    """A counter uniform of exactly 1.0 (float32 rounds 1 - 2**-25 up,
    once in 2**24 draws; ~18 times in a 1,048,576-trial 30-year report)
    gives an infinite geometric dwell. The reference's spell-end buckets
    ignore the overflowed ends, so that spell holds to the horizon; the
    port once scattered them at negative rows (a device-side assert on the
    card). Both packages' expansions are forced to 1.0 on one spell of
    some trials. (A second infinite dwell in the same trial, ~3e-10 per
    trial, brings the reference's wrapping int32 spell ends back into
    range; the port holds the spell.)"""
    model = default_sim_model()
    total_days, n = 2520, 256
    ids = np.arange(n)
    start = (ids % 2).astype(np.int32)
    hit = np.zeros((n, 64), bool)
    hit[0::3, 0] = hit[1::6, 2] = hit[2::6, 9] = True
    jax_cu, port_cu = jpb.counter_uniforms, rng.counter_uniforms

    def jax_unit(keys, k):
        return jnp.where(jnp.asarray(hit[:, :k]), 1.0, jax_cu(keys, k))

    def port_unit(keys, k):
        u = port_cu(keys, k)
        return torch.where(torch.as_tensor(hit[:, :k]), 1.0, u)

    monkeypatch.setattr(jpb, "counter_uniforms", jax_unit)
    monkeypatch.setattr(rng, "counter_uniforms", port_unit)
    _, rk = jax_keys(5, ids)
    ref = np.asarray(jpb.simulate_regime_paths_spell(
        jax.tree.map(jnp.asarray, model), rk, jnp.asarray(start),
        total_days, max_spells=64))
    got = tpb.simulate_regime_paths_spell(
        from_numpy(model, "cpu", torch.float64),
        rng.stream(rng.trial_key(rng.key(5), torch.as_tensor(ids)),
                   rng.REGIME),
        torch.from_numpy(start), total_days, max_spells=64)
    np.testing.assert_array_equal(got.numpy().T, ref)
    # A first spell that never ends: the start regime holds throughout.
    assert (got.numpy().T[::3] == start[::3, None]).all()
