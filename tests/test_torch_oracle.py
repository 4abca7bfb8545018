"""The port's float64 NumPy path oracle (``letf_tpu_torch/oracle.py``)
against the JAX package's (``letf_tpu/oracle.py``), on the CPU.

Both run on the same host arrays: the default model (the JAX package's
tree and the port's copy of it) and one trial's innovations, drawn by the
port's per-trial engine in float64 (2 years and a 1-year buffer, seed 7).
``oracle_path`` with each switch, and ``oracle_regime_path`` on seeded
uniforms from each start regime, agree within rtol 1e-12 (both are the
same float64 NumPy loops, so in fact bit for bit)."""

import numpy as np
import pytest
import torch

from letf_tpu import oracle as joracle
from letf_tpu.models.params import default_sim_model
from letf_tpu_torch import oracle
from letf_tpu_torch.models.params import from_jax_model, from_numpy
from letf_tpu_torch.ops import path_engine as tpe
from letf_tpu_torch.ops import rng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

S, BUF = 504, 252


@pytest.fixture(scope="module")
def setup():
    jm = default_sim_model()
    pm = from_jax_model(jm)
    mt = from_numpy(pm, "cpu", torch.float64)
    innov = tpe.draw_innovations(mt, rng.key(7), torch.tensor([0, 1]),
                                 torch.tensor([False, True]), S, BUF)
    return jm, pm, innov


def one_trial(innov, b):
    """Trial b of batch-last innovations in the oracle's layout."""
    def tr(a, perm=None):
        a = a[..., b]
        return (a.permute(*perm) if perm else a).numpy()

    return tpe.Innovations(
        start_offset=innov.start_offset[b].item(),
        start_regime=innov.start_regime[b].item(),
        initial_vix=innov.initial_vix[b].item(),
        regime_full=tr(innov.regime_full), eps=tr(innov.eps, (1, 0)),
        u_chi=tr(innov.u_chi), vix_noise=tr(innov.vix_noise),
        irx_noise=tr(innov.irx_noise),
        stress_norms=tr(innov.stress_norms, (1, 0)),
        u_jump=tr(innov.u_jump), t_abs=tr(innov.t_abs),
        jump_sign=tr(innov.jump_sign), te_draws=tr(innov.te_draws, (1, 0)),
        mode_key=None)


@pytest.mark.parametrize("flags", [
    {}, dict(moment_matching=False),
    dict(use_funding_model=False, use_stress=False)],
    ids=["default", "no_moment_matching", "no_funding_no_stress"])
@pytest.mark.parametrize("b", [0, 1])
def test_oracle_path_equals_jax(setup, flags, b):
    jm, pm, innov = setup
    inn = one_trial(innov, b)
    got = oracle.oracle_path(pm, inn, S, **flags)
    ref = joracle.oracle_path(jm, inn, S, **flags)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-12,
                                   atol=0, err_msg=k)
    assert np.isfinite(got["etf_ret"]).all()


@pytest.mark.parametrize("start", [0, 1])
def test_oracle_regime_path_equals_jax(setup, start):
    jm, pm, _ = setup
    u = np.random.default_rng(start).random((S + BUF + 1, 2))
    got = oracle.oracle_regime_path(pm, u, start, S + BUF)
    ref = joracle.oracle_regime_path(jm, u, start, S + BUF)
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < len(got)       # both regimes visited
