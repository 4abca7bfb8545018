"""Kernel K1 (joint generation): the port's plain PyTorch version against
the Pallas ``pallas_joint_generate`` run in interpret mode on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops.pallas_joint import _pack_params, pallas_joint_generate
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.ops import joint
from letf_tpu_torch.utils.device import slab_to_tb
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_joint_plain_matches_pallas_interpret():
    model = default_sim_model()
    B, T = 1024, 126
    rs = np.random.default_rng(0)
    # Spells of a few days, so regime switches (and the GARCH/DCC blend
    # on a switch) happen on many trials.
    half = (np.cumsum(rs.random((B // 2, T)) < 0.15, axis=1) % 2)
    regime = np.repeat(half, 2, axis=0).astype(np.int32)   # pairs share it
    ids = (np.arange(B) // 2).astype(np.int32)
    signs = np.where(np.arange(B) % 2 == 1, -1.0, 1.0).astype(np.float32)
    seed = np.asarray([123, 456], np.int32)

    mj = jax.tree.map(jnp.asarray, model)
    ref = pallas_joint_generate(
        _pack_params(mj), jnp.asarray(model.joint.chi_cheb, jnp.float32),
        jnp.asarray(regime), jnp.asarray(ids), jnp.asarray(signs),
        jnp.asarray(seed), T, layout="slab", interpret=True)
    ref = [slab_to_tb(a) for a in ref[:5]]

    params = tparams.pack_joint_params(model)
    assert torch.equal(params, torch.from_numpy(
        np.array(_pack_params(mj))))
    cheb = torch.as_tensor(model.joint.chi_cheb).to(torch.float32)
    got = joint.joint_generate(
        params, cheb, torch.from_numpy(regime.T.astype(np.float32)).contiguous(),
        torch.from_numpy(ids), torch.from_numpy(signs), seed.tolist())
    assert joint.LAUNCHES == 0          # CPU tensors run the plain version
    got = [g.numpy() for g in got]
    for g in got:
        assert g.shape == (T, B) and np.isfinite(g).all()
    # XLA:CPU and torch use different libm implementations of log/sin/cos/
    # exp: the normals differ by ulps, and the GARCH/DCC/VIX recursions
    # carry that drift along the path, so parity is to a tolerance.
    for c in range(3):
        np.testing.assert_allclose(got[c], ref[c], rtol=1e-4, atol=1e-6,
                                   err_msg=f"x{c}")
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1e-3,
                               err_msg="vix")
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-4, atol=1e-6,
                               err_msg="irx")
    # Antithetic pairs share draws: the joint normals flip sign, so the
    # pair's day-0 returns mirror around the regime mean.
    p = params.numpy()
    mu = p[0, 0] + (p[0, 1] - p[0, 0]) * regime[:, 0].astype(np.float32)
    np.testing.assert_allclose(got[0][0] - mu,
                               -(got[0][0].reshape(-1, 2)[:, ::-1]
                                 .reshape(-1) - mu), rtol=1e-5, atol=1e-7)
