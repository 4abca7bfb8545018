"""Kernel K5 (cost composition) of the port: its plain PyTorch version
against ``pallas_compose_generate`` in interpret mode.

B = 1,024 trials, S = 126 days of inputs made with numpy from a seed
(jumpy returns, a VIX path crossing the jump and funding thresholds, both
regimes). Tolerance rtol 1e-5 / atol 1e-6 on every output plane: float32
transcendentals of XLA:CPU and torch differ by ulps, which the AR(1)
tracking-error carry keeps; jump counts are exact (no jump uniform lies
within ulps of its probability at this seed)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import pallas_compose as pc
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import compose
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S = 1024, 126
SEED_WORDS = [9, 11]


def _inputs():
    rs = np.random.default_rng(3)
    spy = (0.0003 + 0.012 * rs.standard_t(4, (S, B))).astype(np.float32)
    vix = np.clip(20.0 - 30.0 * np.cumsum(spy - 0.0003, 0)
                  + 3.0 * rs.standard_normal((S, B)), 9.0, 80.0)
    regime = np.cumsum(rs.random((S, B)) < 0.05, 0) % 2
    irx = 3.0 + np.cumsum(0.05 * rs.standard_normal((S, B)), 0)
    return [np.asarray(c, np.float32) for c in
            (spy, 1.2 * spy, -0.2 * spy, vix, irx, regime)]


@pytest.fixture(scope="module")
def outputs():
    model = default_sim_model()
    chans = _inputs()
    ids = np.arange(B) // 2
    ref = pc.pallas_compose_generate(
        pc._pack_stress_params(model), pc._pack_asset_params(model),
        jnp.asarray(ids, jnp.int32), jnp.asarray(SEED_WORDS, jnp.int32),
        *[jnp.asarray(c.T) for c in chans], sim_days=S, interpret=True)
    args = (tparams.pack_stress_params(model),
            tparams.pack_asset_params(model),
            torch.as_tensor(ids, dtype=torch.int32), SEED_WORDS)
    got = compose.compose_generate(*args, *[torch.as_tensor(c)
                                            for c in chans])
    return chans, ids, args, got, [np.asarray(r) for r in ref]


def test_compose_plain_matches_pallas(outputs):
    _, _, _, got, ref = outputs
    etf = got[0].numpy().transpose(2, 1, 0)                    # [B, S, A]
    np.testing.assert_allclose(etf, ref[0], rtol=1e-5, atol=1e-6)
    for g, r in zip(got[1:4], ref[1:4]):                       # spy/qqq/cash
        np.testing.assert_allclose(g.numpy().T, r, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), ref[4])      # jump days
    assert ref[4].sum() > 0
    for g, r in zip(got[5:], ref[5:]):                         # liq/cred sums
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-6)
    assert np.isfinite(etf).all() and (etf >= -0.999).all() \
        and (etf <= 10.0).all()


def test_compose_replays_by_trial_id(outputs):
    """Counter draws: a trial's outputs do not depend on its lane (ids and
    inputs rolled by 10 lanes), bit for bit (test_path_batched.py:337)."""
    chans, ids, args, got, _ = outputs
    rolled = compose.compose_plain(
        *args[:2], torch.as_tensor(np.roll(ids, 10), dtype=torch.int32),
        args[3], *[torch.as_tensor(np.roll(c, 10, axis=1)) for c in chans])
    for a, b in zip(rolled[:4], got[:4]):
        assert torch.equal(a[..., 14], b[..., 4])
