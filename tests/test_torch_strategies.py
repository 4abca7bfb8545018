"""Kernel K4's plain version against the JAX package's Pallas kernel
``pallas_strategies_run`` in interpret mode, on the same channels.

The channels are the JAX general path's (B = 1,024 trials, 256 days,
regime_only starts, cast to float32) and its signals, carried across as
``[S, B]``; as tests/test_strategies.py does for the Pallas kernel against
the XLA scan:
- channel mode, with and without a DCA schedule: wealth within rtol 2e-5 /
  atol 1e-4, trade counts equal, max drawdown within 1e-5
  (tests/test_strategies.py:221-227);
- fused-signals mode, with and without a DCA schedule: median relative
  wealth error < 1e-5, < 0.1% of cells above 1e-2, < 2% of trade counts
  differ (tests/test_strategies.py:259-264).
The engine's non-emitting route is K4 (its plain version on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops.pallas_strategies import channels_from as jax_channels
from letf_tpu.ops.pallas_strategies import pallas_strategies_run
from letf_tpu.ops.path_batched import generate_paths_batched
from letf_tpu.strategies.engine import dca_schedule
from letf_tpu.strategies.signals import compute_signals
from letf_tpu_torch.ops import strategies as k4
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S = 1024, 256


@pytest.fixture(scope="module")
def channels():
    path = generate_paths_batched(
        default_sim_model(), jax.random.key(5),
        jnp.arange(B, dtype=jnp.int32) // 2, (jnp.arange(B) % 2).astype(bool),
        sim_days=S, buffer_days=0, random_start_method="regime_only")

    def to32(a):
        return a.astype(jnp.float32) if a.dtype in (jnp.float64,
                                                    jnp.float32) else a

    path32 = jax.tree.map(to32, path)
    chans = jax_channels(path32, jax.tree.map(to32, compute_signals(path32)))
    return [np.asarray(c, np.float32) for c in chans]


def port(chans):
    return [torch.from_numpy(np.ascontiguousarray(c.T)) for c in chans]


@pytest.mark.parametrize("dca", [False, True])
def test_channel_mode_matches_pallas(channels, dca):
    cf = np.asarray(dca_schedule(S, 500.0), np.float32) if dca else None
    ref = pallas_strategies_run(
        [jnp.asarray(c) for c in channels],
        cashflows=None if cf is None else jnp.asarray(cf), apply_costs=True,
        interpret=True)
    got = k4.strategies_run(port(channels),
                            None if cf is None else torch.from_numpy(cf))
    fw, nt, mdd = (g.numpy() for g in got)
    np.testing.assert_allclose(fw, np.asarray(ref[0]), rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(nt, np.asarray(ref[1]))
    np.testing.assert_allclose(mdd, np.asarray(ref[2]), rtol=1e-5, atol=1e-5)
    assert nt.dtype == np.int32 and (nt[:, 6:] > 0).any()


@pytest.mark.parametrize("dca", [False, True])
def test_fused_signals_mode_matches_pallas(channels, dca):
    cf = np.asarray(dca_schedule(S, 500.0), np.float32) if dca else None
    ref = pallas_strategies_run(
        [jnp.asarray(c) for c in channels[:7]],
        cashflows=None if cf is None else jnp.asarray(cf), apply_costs=True,
        interpret=True, fused_signals=True)
    fw, nt, _ = k4.strategies_run(port(channels[:7]),
                                  None if cf is None else torch.from_numpy(cf),
                                  fused_signals=True)
    rw, rt = np.asarray(ref[0]), np.asarray(ref[1])
    rel = np.abs(fw.numpy() - rw) / np.maximum(np.abs(rw), 1.0)
    assert float(np.median(rel)) < 1e-5
    assert float((rel > 1e-2).mean()) < 0.001
    assert float((nt.numpy() != rt).mean()) < 0.02


def test_channel_count_is_checked(channels):
    with pytest.raises(ValueError, match="23 channels"):
        k4.strategies_run(port(channels[:7]))
