"""The plain reference against the port at a tiny size on the CPU (where
the port runs its kernels' plain versions in float64 glue) and against the
JAX package (in a process of its own, so that no other test's process
holds JAX); and the control (the reference in bfloat16) fails the cells'
limits. The tests import what they compare; the reference itself imports
nothing of the port or the JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import checks, spec
from benchmark.reference import precision

SEED = 2**33 + 17          # a seed wider than 32 bits
ROWS = np.array([0, 1, 6, 7, 40, 61])


def config(name):
    return json.loads((spec.HERE / "configs" / f"{name}.json").read_text())


def port_rows(cfg, years):
    from letf_tpu_torch.models.params import default_sim_model
    from letf_tpu_torch.parallel import mc_runner

    run = mc_runner._Run(default_sim_model(), years, 64, SEED, 64, True,
                         "offset", True, None, None, "cpu",
                         cfg["engine_mode"])
    got = run.chunk(ROWS // 2, ROWS % 2 == 1)
    return {k: v.cpu().numpy() for k, v in got.items()}


def test_institutional_reference_equals_the_port_on_the_cpu():
    """The frozen PyTorch day loops, bit for bit the port's plain route."""
    cfg = config("institutional_30y")
    ref = spec.engine(cfg["engine_mode"]).summaries(
        ROWS, SEED, 1, cfg, glue=torch.float64, numpy_loops=False)
    got = port_rows(cfg, 1)
    for k, want in ref.items():
        assert np.array_equal(got[k], want), k


def test_parametric_reference_follows_the_port_on_the_cpu():
    """The NumPy engine written from the JAX package's source against the
    port's CPU route in float64: the same flags and trade counts, wealth
    within float32 rounding of the channels both hand to K4."""
    cfg = config("parametric")
    ref = spec.engine(cfg["engine_mode"]).summaries(ROWS, SEED, 1, cfg,
                                                    glue=torch.float64)
    got = port_rows(cfg, 1)
    nums = checks.row_numbers({k: got[k] for k in ref}, ref)
    assert nums["flag_mismatches"] == 0 and nums["trades_gap_share"] == 0
    assert nums["benchmark_wealth_max_gap"] < 1e-6, nums
    assert nums["wealth_median_gap"] < 1e-6, nums


JAX_SCRIPT = r"""
import sys
sys.path.insert(0, %(root)r)
import numpy as np
import jax
jax.config.update("jax_enable_x64", %(x64)r)
import jax.numpy as jnp
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import path_engine as pe
from letf_tpu.ops.pallas_strategies import channels_from
from letf_tpu.strategies.signals import compute_signals
from benchmark.reference import np_parametric as npp, params

ids, seed, dtype = np.array([0, 3, 20]), %(seed)d, np.%(dtype)s
sim, buf = 504, 1260
m = default_sim_model()
ref_m = params.default_sim_model()
for a, b in zip(jax.tree_util.tree_leaves(m), jax.tree_util.tree_leaves(ref_m)):
    assert np.array_equal(np.asarray(a), np.asarray(b))
path = pe.generate_paths_batch(
    m, jax.random.key(seed), jnp.asarray(ids), jnp.zeros(3, bool),
    sim_days=sim, buffer_days=buf, random_start_method="offset",
    engine_mode="parametric")
mine = npp.path(npp._tables(ref_m, dtype),
                npp.draws(npp._tables(ref_m, dtype), npp.key(seed), ids, sim,
                          buf, "offset", dtype), sim, dtype)
assert np.array_equal(mine["regime"], np.asarray(path.regime))
for k in ("valid", "repaired", "path_finite", "vix_ok"):
    assert np.array_equal(mine[k], np.asarray(getattr(path, k))), k
paths = max(float(np.abs(mine["etf_ret"] - np.asarray(path.etf_ret)).max()),
            float(np.abs(mine["vix"] - np.asarray(path.vix)).max() / 100))
gaps = []
theirs = [np.asarray(c).T for c in channels_from(path, compute_signals(path))]
for a, b in zip(npp.channels(mine), theirs):
    both = np.isnan(a) & np.isnan(b)
    assert not (np.isnan(a) != np.isnan(b)).any()
    gaps.append(float(np.max(np.where(both, 0.0, np.abs(a - b))
                             / np.maximum(np.abs(b), 1.0))))
print(paths, max(gaps))
"""


@pytest.mark.parametrize("x64, seed, dtype, tol_path, tol_channels", [
    (False, 1234567, "float32", 1e-6, 1e-2),   # x32 keys: 32-bit seeds
    (True, SEED, "float64", 1e-13, 1e-6)])
def test_parametric_reference_follows_the_jax_package(
        x64, seed, dtype, tol_path, tol_channels):
    """The JAX package's own path and channels (its model tables equal to
    the reference's): the same regime path and flags, returns and channels
    within rounding (the channels' rolling windows are differences of
    prefix sums, which float32 rounds by their length)."""
    code = JAX_SCRIPT % dict(root=str(spec.HERE.parent), x64=x64,
                             seed=seed, dtype=dtype)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    paths, channels = map(float, out.stdout.split()[-2:])
    assert paths < tol_path and channels < tol_channels, (paths, channels)


SPELLS_SCRIPT = r"""
import sys
sys.path.insert(0, %(root)r)
import numpy as np
import jax
jax.config.update("jax_enable_x64", %(x64)r)
import jax.numpy as jnp
from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import path_batched as pb, rng as rngs
from benchmark.reference import np_parametric as npp, np_spells, params

ids, seed, dtype = np.arange(0, 4000, 37), %(seed)d, np.%(dtype)s
T, buf = 8820, 1260
m = default_sim_model()
key = jax.random.key(seed)
K = pb.plan_max_spells(m, T)
reg = npp._tables(params.default_sim_model(), dtype).regime
assert K == np_spells.plan_max_spells(reg, T)
keys = jax.vmap(lambda t: rngs.stream(rngs.trial_key(key, t),
                                      rngs.REGIME))(jnp.asarray(ids))
want = pb.simulate_regime_paths_spell(m, keys, jnp.zeros(len(ids), jnp.int32),
                                      T, max_spells=K)
got = np_spells.regime_paths(reg, npp.key(seed), ids, T, K)
assert np.array_equal(got, np.asarray(want))
want = pb.start_offsets_only(key, jnp.asarray(ids), buf)
got = np_spells.start_offsets(npp.key(seed), ids, buf, "offset", dtype)
assert np.array_equal(got, np.asarray(want))
print("ok", K)
"""


@pytest.mark.parametrize("x64, seed, dtype", [
    (False, 1234567, "float32"), (True, SEED, "float64")])
def test_spells_and_offsets_follow_the_jax_package(x64, seed, dtype):
    """The institutional chain's start offsets and 30-year regime spells,
    equal to the JAX package's for 109 trials."""
    code = SPELLS_SCRIPT % dict(root=str(spec.HERE.parent), x64=x64,
                                seed=seed, dtype=dtype)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[0] == "ok"


@pytest.mark.parametrize("cell", ["inst_pretax_1m", "param_pretax_16k"])
def test_numpy_loops_follow_the_torch_loops(cell):
    """What a run computes (NumPy start offsets, spells and day loops)
    against the frozen PyTorch chain: the same operations, NumPy's float32
    exp/log/tanh/pow a few ulps off torch's."""
    c = spec.load_cell(spec.HERE.parent, cell)
    eng = spec.engine(c.config["engine_mode"])
    a = eng.summaries(ROWS, SEED, 2, c.config)
    b = eng.summaries(ROWS, SEED, 2, c.config, numpy_loops=False)
    nums = checks.row_numbers(a, b)
    assert nums["wealth_median_gap"] < 1e-6, nums
    ok, lines, _ = checks.judge(nums, c.limits)
    assert ok, lines


@pytest.mark.parametrize("cell", ["inst_pretax_1m", "param_pretax_16k"])
def test_the_control_fails_the_limits(cell):
    c = spec.load_cell(spec.HERE.parent, cell)
    eng = spec.engine(c.config["engine_mode"])
    f32 = eng.summaries(ROWS, SEED, 1, c.config)
    with precision.lowered():
        low = eng.summaries(ROWS, SEED, 1, c.config)
    ok, lines, _ = checks.judge(checks.row_numbers(low, f32), c.limits)
    assert not ok, lines
    ok, lines, _ = checks.judge(checks.row_numbers(f32, f32), c.limits)
    assert ok, lines
