"""Model tables of the port: its own SimModel, defaults, calibration
densifier and configuration equal the JAX package's leaf by leaf;
``from_jax_model`` carries the JAX package's SimModel across; ``from_numpy``
converts it; the three packers equal the JAX packers' output."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as jcfg
from letf_tpu.models.params import build_sim_model, default_sim_model
from letf_tpu.utils.psd import nearest_psd_matrix
from letf_tpu.ops.pallas_compose import (
    _pack_asset_params,
    _pack_stress_params,
)
from letf_tpu.ops.pallas_joint import _pack_params
from letf_tpu_torch import config as tcfg
from letf_tpu_torch.models import params as tparams
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CALIBRATION = {
    "transition_matrix": [[0.97, 0.03], [0.05, 0.95]],
    "duration_samples": {0: [40, 80, 120, 300], 1: [10, 25, 31]},
    "regime_params": {0: {"daily_std": 0.009}, 1: {"daily_mean": -0.001}},
    "joint_return_model": {"regimes": {
        r: {"mu": [0.0004, 0.0005, 0.0001],
            "cov": (np.diag([1.0, 1.4, 0.7]) + 0.3) * (1 + r) * 1e-4,
            "nu": 5.0 - r, "garch_alpha": 0.07, "dcc_b": 0.93}
        for r in (0, 1)}},
    "vix_dynamics": {0: {"phi": 0.83, "target_vix": 14.2},
                     1: {"phi": 0.91, "noise_std": 2.1}},
    "stress_state_model": {"regimes": {1: {"liq_mu": 0.41,
                                           "jump_scale": 0.003}}},
    "funding_model": {"base": 0.0061, "beta_vix": 0.0004,
                      "beta_inv_curve": 0.0012, "min_spread": 0.0025,
                      "max_spread": 0.05},
    "tracking_residual_model": {"TQQQ": {"rho": 0.31, "clip_limit": 0.12},
                                "TMF": {"downside_mult": 1.4}},
}


def calibrated_like():
    """A non-default model (calibration-dict overrides) so the packers are
    not only checked on the reference fallbacks."""
    return build_sim_model({
        "vix_dynamics": {0: {"phi": 0.83, "target_vix": 14.2},
                         1: {"phi": 0.91, "noise_std": 2.1}},
        "stress_state_model": {"regimes": {1: {"liq_mu": 0.41,
                                               "jump_scale": 0.003}}},
        "funding_model": {"base": 0.0061, "beta_vix": 0.0004,
                          "beta_inv_curve": 0.0012, "min_spread": 0.0025,
                          "max_spread": 0.05},
        "tracking_residual_model": {"TQQQ": {"rho": 0.31,
                                             "clip_limit": 0.12}},
    })


@pytest.mark.parametrize("make", [default_sim_model, calibrated_like])
def test_packers_equal_jax(make):
    model = make()
    mj = jax.tree.map(jnp.asarray, model)
    for ours, theirs in ((tparams.pack_joint_params, _pack_params),
                         (tparams.pack_stress_params, _pack_stress_params),
                         (tparams.pack_asset_params, _pack_asset_params)):
        ref = np.asarray(theirs(mj))
        got = ours(model)
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), ref)
        # The same tables from the converted (f64, then f32) torch model.
        for dtype in (torch.float64, torch.float32):
            np.testing.assert_array_equal(
                ours(tparams.from_numpy(model, "cpu", dtype)).numpy(), ref)


def test_from_numpy_carries_every_leaf():
    model = default_sim_model()
    t64 = tparams.from_numpy(model, "cpu", torch.float64)
    t32 = tparams.from_numpy(model, "cpu", torch.float32)
    leaves = jax.tree.leaves(model)
    got64 = jax.tree.leaves(t64)
    assert type(t64) is type(model) and len(got64) == len(leaves) == len(
        jax.tree.leaves(t32))
    for a, b, c in zip(leaves, got64, jax.tree.leaves(t32)):
        a = np.asarray(a)
        assert b.shape == a.shape
        if np.issubdtype(a.dtype, np.integer):
            assert b.dtype == torch.int64
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            assert b.dtype == torch.float64 and c.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), a)
            np.testing.assert_array_equal(c.numpy(), a.astype(np.float32))


def assert_same_tree(got, ref):
    """Field names, leaf dtypes-kinds, shapes and values equal."""
    assert got._fields == ref._fields
    for f in ref._fields:
        a, b = getattr(got, f), getattr(ref, f)
        if hasattr(b, "_fields"):
            assert_same_tree(a, b)
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("calibration", [None, CALIBRATION])
def test_port_models_equal_jax(calibration):
    """default_sim_model and build_sim_model (a calibrated dict) of the
    port's own copy equal the JAX package's, leaf by leaf; from_jax_model
    returns the port's types with the same leaves."""
    ref = build_sim_model(calibration)
    got = tparams.build_sim_model(calibration)
    assert type(got) is tparams.SimModel
    assert_same_tree(got, ref)
    carried = tparams.from_jax_model(ref)
    assert type(carried) is tparams.SimModel
    assert type(carried.joint) is tparams.JointParams
    assert_same_tree(carried, ref)
    assert tparams.as_sim_model(ref) is not ref
    assert tparams.as_sim_model(got) is got
    assert_same_tree(tparams.default_sim_model(), default_sim_model())


def test_nearest_psd_matrix_equals_jax():
    rs = np.random.default_rng(3)
    for _ in range(5):
        m = rs.uniform(-1, 1, (3, 3))
        m = (m + m.T) / 2
        np.fill_diagonal(m, 1.0)
        np.testing.assert_array_equal(tparams.nearest_psd_matrix(m),
                                      nearest_psd_matrix(m))


def test_config_copy_equals_jax():
    """Every constant the port copies has the JAX package's value. The one
    exception is the cache: the port's ``CACHE_DIR`` is its own directory,
    because the JAX package's holds that package's committed fits (a port
    reading them would never calibrate, and must never write there); each
    cache file keeps the reference's name inside it."""
    names = [n for n in dir(tcfg) if n.isupper()]
    assert len(names) > 40
    assert tcfg.CACHE_DIR != jcfg.CACHE_DIR
    assert tcfg.CACHE_DIR.resolve() != jcfg.CACHE_DIR.resolve()
    for n in names:
        a, b = getattr(tcfg, n), getattr(jcfg, n)
        if n.endswith(("_CACHE", "_RESULTS")):
            assert a == tcfg.CACHE_DIR / b.name, n
            continue
        if n == "CACHE_DIR":
            continue
        if isinstance(b, dict) and b and dataclasses.is_dataclass(
                next(iter(b.values()))):
            assert {k: dataclasses.asdict(v) for k, v in a.items()} == {
                k: dataclasses.asdict(v) for k, v in b.items()}, n
        else:
            assert a == b, n
    ta, ja = tcfg.asset_table(), jcfg.asset_table()
    for f in dataclasses.fields(ja):
        np.testing.assert_array_equal(getattr(ta, f.name),
                                      getattr(ja, f.name))
    for a, b in zip(tcfg.get_cache_filenames("1950-01-01", "2025-12-31")
                    .items(), jcfg.get_cache_filenames("1950-01-01",
                                                       "2025-12-31").items()):
        assert a[0] == b[0] and a[1] == tcfg.CACHE_DIR / b[1].name
