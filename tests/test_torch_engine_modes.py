"""The port's per-trial institutional engine and the XLA-only batched routes
against ``letf_tpu/ops/path_engine.py``, ``letf_tpu/ops/path_batched.py``
and the port's float64 NumPy oracle (``letf_tpu_torch/oracle.py``, held
to the JAX package's in tests/test_torch_oracle.py), on the CPU in
float64; and the port's ``path_engine`` / ``generate_paths_batched``
signatures against the reference's.

The JAX package draws the innovations of 6 trials (3 antithetic pairs, a
90-day window and a 60-day buffer, seed 42) once. The port's draws are
held to them: start conditions and regime paths exactly, the samplers'
draws within tests/test_torch_rng_samplers.py's float64 bounds (relative
4e-14 plus 1e-15). On the same innovations the port's path equals the JAX
engine's and the oracle's within 1e-12 (the JAX package holds its own
engine to the oracle at rtol 1e-9 / atol 1e-11 over 90 days,
tests/test_path_engine.py:26). The batched routes are held to the JAX
package's at the tolerances of tests/test_path_batched.py:26 (atol 1e-10
on returns, 1e-9 on VIX, regimes and validity exactly)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import path_batched as jpb
from letf_tpu.ops import path_engine as jpe
from letf_tpu_torch import oracle
from letf_tpu_torch.models.params import from_jax_model, from_numpy
from letf_tpu_torch.ops import path_batched as tpb
from letf_tpu_torch.ops import path_engine as tpe
from letf_tpu_torch.ops import rng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B, S, BUF, SEED = 6, 90, 60, 42
IDS = np.arange(B) // 2
ANTI = np.arange(B) % 2 == 1
DRAW_RTOL, DRAW_ATOL = 4e-14, 1e-15


@pytest.fixture(scope="module")
def models():
    jm = default_sim_model()
    return jm, from_numpy(from_jax_model(jm), "cpu", torch.float64)


@pytest.fixture(scope="module")
def port_model():
    """The port's numpy model tree, the oracle's input."""
    return from_jax_model(default_sim_model())


@pytest.fixture(scope="module")
def jax_innov(models):
    jm, _ = models
    return jax.jit(jax.vmap(lambda i, a: jpe.draw_innovations(
        jm, jax.random.key(SEED), i, a, S, BUF)))(jnp.asarray(IDS),
                                                   jnp.asarray(ANTI))


def carried(ji) -> tpe.Innovations:
    """JAX innovations [B, ...] in the port's batch-last layout."""
    def tn(a):
        return torch.as_tensor(np.array(a))

    def tb(a):
        return tn(a).t().contiguous()

    return tpe.Innovations(
        start_offset=tn(ji.start_offset), start_regime=tn(ji.start_regime),
        initial_vix=tn(ji.initial_vix), regime_full=tb(ji.regime_full),
        eps=tn(ji.eps).permute(2, 1, 0).contiguous(), u_chi=tb(ji.u_chi),
        vix_noise=tb(ji.vix_noise), irx_noise=tb(ji.irx_noise),
        stress_norms=tn(ji.stress_norms).permute(2, 1, 0).contiguous(),
        u_jump=tb(ji.u_jump), t_abs=tb(ji.t_abs), jump_sign=tb(ji.jump_sign),
        te_draws=tn(ji.te_draws).permute(2, 1, 0).contiguous(),
        mode_key=torch.as_tensor(np.asarray(
            jax.random.key_data(ji.mode_key)).astype(np.int64)))


def trial(innov: tpe.Innovations, b: int) -> dict:
    """Trial b of the port's innovations in the oracle's per-trial layout."""
    def tr(a, perm):
        return a[..., b].permute(*perm).numpy() if perm else a[..., b].numpy()

    return tpe.Innovations(
        start_offset=innov.start_offset[b].item(),
        start_regime=innov.start_regime[b].item(),
        initial_vix=innov.initial_vix[b].item(),
        regime_full=tr(innov.regime_full, None),
        eps=tr(innov.eps, (1, 0)), u_chi=tr(innov.u_chi, None),
        vix_noise=tr(innov.vix_noise, None),
        irx_noise=tr(innov.irx_noise, None),
        stress_norms=tr(innov.stress_norms, (1, 0)),
        u_jump=tr(innov.u_jump, None), t_abs=tr(innov.t_abs, None),
        jump_sign=tr(innov.jump_sign, None),
        te_draws=tr(innov.te_draws, (1, 0)), mode_key=None)


def close(got, ref, rtol, atol=0.0, name=""):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


def paths_close(tp, jp, atol_ret, atol_vix, name=""):
    """A port path [.., B] against a JAX one [B, ..]."""
    close(tp.etf_ret.numpy().transpose(2, 1, 0), jp.etf_ret, 0.0, atol_ret,
          name + " etf_ret")
    for k in ("tlt_ret", "spy_ret", "qqq_ret", "cash_ret", "risk_free"):
        close(getattr(tp, k).numpy().T, getattr(jp, k), 0.0, atol_ret,
              f"{name} {k}")
    close(tp.vix.numpy().T, jp.vix, 0.0, atol_vix, name + " vix")
    np.testing.assert_array_equal(tp.regime.numpy().T, np.asarray(jp.regime))
    for k in ("valid", "repaired", "jump_days", "start_offset"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)), err_msg=k)


# ---------------------------------------------------------------------------
# Fault 1: the reference's parameters, names, order and defaults
# ---------------------------------------------------------------------------

SIGNATURES = (
    # (port function, reference function, the port's keyword-only extras)
    (tpe.draw_innovations, jpe.draw_innovations, ("engine_mode",)),
    (tpe.path_from_innovations, jpe.path_from_innovations, ()),
    (tpe.generate_paths_batch, jpe.generate_paths_batch, ()),
    (tpe.generate_path, jpe.generate_path, ()),
    (tpb.generate_paths_batched, jpb.generate_paths_batched, ()),
    (tpb.draw_innovations_fast, jpb.draw_innovations_fast, ()),
    (tpb.draw_innovations_batched, jpb.draw_innovations_batched, ()),
)


@pytest.mark.parametrize("port,ref,extras", SIGNATURES,
                         ids=[f"{r.__module__.split('.')[-1]}.{r.__name__}"
                              f"->{p.__name__}" for p, r, _ in SIGNATURES])
def test_signature_matches_reference(port, ref, extras):
    """The reference's parameters in name, default and order (the batch
    entry's keywords are generate_path's, which the reference's forwards
    as **static_kwargs); the
    port's own extras come after them, keyword-only: draw_innovations'
    engine_mode, default the reference's institutional_v1."""
    ref_p = list(inspect.signature(ref).parameters.values())
    if ref_p[-1].kind == inspect.Parameter.VAR_KEYWORD:
        ref_p = ref_p[:-1] + list(inspect.signature(
            jpe.generate_path).parameters.values())[len(ref_p) - 1:]
    got = list(inspect.signature(port).parameters.values())
    assert [p.name for p in got[:len(ref_p)]] == [p.name for p in ref_p]
    for r, g in zip(ref_p, got):
        assert g.default == r.default, r.name
    rest = got[len(ref_p):]
    assert tuple(p.name for p in rest) == extras
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY for p in rest)
    if extras:
        assert rest[0].default == "institutional_v1"


def test_reference_shaped_call_runs_the_institutional_model(models):
    """generate_paths_batch(model, key, ids, anti, S), the call of
    letf_tpu/diagnose.py:52, runs the institutional model in both
    packages: the same paths within 1e-12 (no start buffer, so the
    window is the whole path)."""
    jm, mt = models
    jp = jpe.generate_paths_batch(jm, jax.random.key(SEED),
                                  jnp.asarray(IDS), jnp.asarray(ANTI), S)
    tp = tpe.generate_paths_batch(mt, rng.key(SEED), torch.as_tensor(IDS),
                                  torch.as_tensor(ANTI), S)
    paths_close(tp, jp, 1e-12, 1e-10, "reference-shaped")
    # An antithetic pair is two paths in this mode (negated joint normals).
    assert not torch.equal(tp.spy_ret[:, 0], tp.spy_ret[:, 1])


# ---------------------------------------------------------------------------
# The per-trial institutional engine
# ---------------------------------------------------------------------------

def test_institutional_draws_match_jax(models, jax_innov):
    _, mt = models
    got = tpe.draw_innovations(mt, rng.key(SEED), torch.as_tensor(IDS),
                               torch.as_tensor(ANTI), S, BUF)
    ref = carried(jax_innov)
    for k in ("start_offset", "start_regime", "regime_full", "u_jump",
              "jump_sign", "mode_key", "initial_vix"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(ref, k).numpy(), err_msg=k)
    for k in ("eps", "u_chi", "vix_noise", "irx_noise", "stress_norms",
              "t_abs", "te_draws"):
        close(getattr(got, k).numpy(), getattr(ref, k).numpy(), DRAW_RTOL,
              DRAW_ATOL, k)
    # Antithetic pairs negate the joint normals only.
    np.testing.assert_array_equal(got.eps[..., 0].numpy(),
                                  -got.eps[..., 1].numpy())
    np.testing.assert_array_equal(got.u_chi[:, 0].numpy(),
                                  got.u_chi[:, 1].numpy())


def test_institutional_path_matches_jax_and_oracle(models, port_model,
                                                   jax_innov):
    """On the JAX draws, the port's path equals the JAX engine's and the
    port's oracle's (every trial) within 1e-12."""
    jm, mt = models
    innov = carried(jax_innov)
    tp = tpe.path_from_innovations(mt, innov, S)
    jp = jax.jit(jax.vmap(lambda inn: jpe.path_from_innovations(
        jm, inn, S)))(jax_innov)
    paths_close(tp, jp, 1e-12, 1e-10, "jax engine")
    for b in range(B):
        orc = oracle.oracle_path(port_model, trial(innov, b), S)
        close(tp.etf_ret[:, :, b].numpy().T, orc["etf_ret"], 0.0, 1e-12,
              f"oracle etf {b}")
        close(tp.vix[:, b].numpy(), orc["vix"], 0.0, 1e-10, f"oracle vix {b}")
        close(tp.cash_ret[:, b].numpy(), orc["cash_ret"], 1e-12)
        np.testing.assert_array_equal(tp.regime[:, b].numpy(), orc["regime"])


@pytest.mark.parametrize("flags", [dict(moment_matching=False),
                                   dict(use_funding_model=False,
                                        use_stress=False)],
                         ids=["no_moment_matching", "no_funding_no_stress"])
def test_long_horizon_and_switches_match_oracle(models, port_model, flags):
    """The port's own draws over 2 years + a 1-year buffer (trial 3, as
    tests/test_path_engine.py:47 runs it) against the oracle on the same
    draws, with each switch: the JAX package's long-horizon criterion,
    atol 2e-6 on returns and 1e-3 on VIX (here float64 on both sides, so
    far tighter in fact)."""
    _, mt = models
    innov = tpe.draw_innovations(mt, rng.key(SEED), torch.tensor([3]),
                                 torch.tensor([False]), 504, 252)
    tp = tpe.path_from_innovations(mt, innov, 504, **flags)
    orc = oracle.oracle_path(port_model, trial(innov, 0), 504, **flags)
    close(tp.etf_ret[:, :, 0].numpy().T, orc["etf_ret"], 0.0, 2e-6)
    close(tp.vix[:, 0].numpy(), orc["vix"], 0.0, 1e-3)
    np.testing.assert_array_equal(tp.regime[:, 0].numpy(), orc["regime"])
    if not flags.get("use_stress", True):
        assert int(tp.jump_days[0]) == 0


def test_moment_matching_centers_long_run_mean(models):
    """With moment matching the TLT stream's mean moves 10% of the way to
    the theoretical mean (tests/test_path_engine.py:155 over 2,520 days,
    here 1,008; abs 1e-12)."""
    jm, mt = models
    innov = tpe.draw_innovations(mt, rng.key(33), torch.tensor([0]),
                                 torch.tensor([False]), 1008, 0, "none")
    with_mm = tpe.path_from_innovations(mt, innov, 1008, True)
    without = tpe.path_from_innovations(mt, innov, 1008, False)
    m_with = float(with_mm.tlt_ret.mean())
    m_without = float(without.tlt_ret.mean())
    expected = m_without + (jm.joint.theo_mean[2] - m_without) * 0.1
    assert m_with == pytest.approx(expected, abs=1e-12)


def test_generate_path_is_one_trial_of_the_batch(models):
    _, mt = models
    one = tpe.generate_path(mt, rng.key(SEED), 2, True, 63, 42)
    batch = tpe.generate_paths_batch(mt, rng.key(SEED), torch.tensor([1, 2]),
                                     torch.tensor([False, True]), 63, 42)
    assert one.etf_ret.shape == (6, 63) and one.valid.shape == ()
    # float64 torch math differs by an ulp between batch widths.
    close(one.etf_ret.numpy(), batch.etf_ret[..., 1].numpy(), 1e-14, 1e-17)
    assert tpe.draw_innovations_jit is tpe.draw_innovations
    assert tpe.path_from_innovations_jit is tpe.path_from_innovations


# ---------------------------------------------------------------------------
# The XLA-only batched routes
# ---------------------------------------------------------------------------

def test_batched_per_trial_draws_equal_the_per_trial_engine(models,
                                                            jax_innov):
    """fast_draws=False: the per-trial engine's draws and scan; on the JAX
    draws the batched path equals the JAX package's batched path
    (tests/test_path_batched.py:26, atol 1e-10 / 1e-9), and the port's
    route equals its per-trial batch bit for bit."""
    jm, mt = models
    jp = jax.jit(lambda inn: jpb.path_from_innovations_batched(
        jm, inn, S))(jax_innov)
    tp = tpb.path_from_innovations_batched(mt, carried(jax_innov), S)
    paths_close(tp, jp, 1e-10, 1e-9, "batched")
    ids, anti = torch.as_tensor(IDS), torch.as_tensor(ANTI)
    a = tpb.generate_paths_batched(mt, rng.key(0), ids, anti, S, BUF,
                                   fast_draws=False)
    b = tpe.generate_paths_batch(mt, rng.key(0), ids, anti, S, BUF)
    for f in tpe.PathOutputs._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy(), err_msg=f)


def test_fast_draws_joint_kernel_off_matches_jax(models):
    """joint_kernel="off": the fast samplers and the torch joint scan
    against the JAX package's fast route (on the CPU its
    generate_paths_batched takes it), atol 1e-10 / 1e-9; the spell
    regime paths exactly."""
    jm, mt = models
    jp = jax.jit(lambda: jpb.generate_paths_batched(
        jm, jax.random.key(1), jnp.asarray(IDS), jnp.asarray(ANTI),
        sim_days=S, buffer_days=BUF))()
    tp = tpb.generate_paths_batched(mt, rng.key(1), torch.as_tensor(IDS),
                                    torch.as_tensor(ANTI), S, BUF,
                                    joint_kernel="off")
    paths_close(tp, jp, 1e-10, 1e-9, "off")


def test_fast_samplers_match_jax():
    """chi2_from_normal on a grid and t_int_df (df 5 and 10) against the
    JAX package's, float64: the Chebyshev sum exactly as formed, the t
    draws within the sampler bounds."""
    from letf_tpu.models.params import chi2_log_quantile_cheb

    z = np.linspace(-7.0, 7.0, 2001)
    for nu in (4.5, 8.37):
        cheb = chi2_log_quantile_cheb(nu)
        ref = np.asarray(jpb.chi2_from_normal(jnp.asarray(z),
                                              jnp.asarray(cheb)))
        got = tpb.chi2_from_normal(torch.as_tensor(z),
                                   torch.as_tensor(cheb)).numpy()
        close(got, ref, 1e-14)
    ks = jax.random.split(jax.random.key(0), 16)
    tk = torch.as_tensor(np.asarray(jax.random.key_data(ks)).astype(
        np.int64))
    for df in (5, 10):
        ref = np.asarray(jax.vmap(lambda k: jpb.t_int_df(k, df, (40,)))(ks))
        got = tpb.t_int_df(tk, df, 40, torch.float64).numpy()
        close(got, ref, 1e-13, DRAW_ATOL)


def test_joint_kernel_route_without_compose_runs(models):
    """The kernel route (K1, K2') without the funding model or the stress
    channels composes on the fast samplers' draws, as the reference's
    compose kernel steps aside: finite, no jumps, the same windowed
    streams as the full route."""
    _, mt = models
    ids, anti = torch.as_tensor(IDS), torch.as_tensor(ANTI)
    full = tpb.generate_paths_batched(mt, rng.key(2), ids, anti, S, BUF)
    bare = tpb.generate_paths_batched(mt, rng.key(2), ids, anti, S, BUF,
                                      use_stress=False)
    assert bool(torch.isfinite(bare.etf_ret).all())
    assert int(bare.jump_days.sum()) == 0
    np.testing.assert_array_equal(bare.tlt_ret.numpy(), full.tlt_ret.numpy())
    np.testing.assert_array_equal(bare.regime.numpy(), full.regime.numpy())
    with pytest.raises(ValueError, match="joint_kernel"):
        tpb.generate_paths_batched(mt, rng.key(2), ids, anti, S, BUF,
                                   joint_kernel="pallas")
