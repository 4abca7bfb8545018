"""Checkpoints, resume and the chunk containment of the port's runner.

- ``utils/checkpoint``: a model saved by the port is read by the JAX
  package's ``load_sim_model`` (its ``.npz`` fallback, no orbax checkpoint
  at the path), and a file written as the JAX package's fallback writes it
  is read by the port's; both give back every leaf bit for bit. The run
  manifest is the JAX package's JSON.
- ``run_monte_carlo(checkpoint_dir=..., max_chunks=...)`` killed after one
  chunk and resumed equals an uninterrupted run bit for bit
  (tests/test_mc_runner.py:119); resuming under another configuration
  raises ``ValueError``.
- ``fault_tolerant``: a chunk that keeps failing is skipped with NaN
  wealth and flagged, the other chunks bit for bit the clean run; a
  transient failure or a timed-out attempt recovers on its retry; an
  error that leaves the CUDA context unusable is raised, not flagged
  (tests/test_mc_runner.py:277).
"""

import json
import time

import numpy as np
import pytest
import torch

from letf_tpu.models.params import default_sim_model as jax_default_model
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu.utils import checkpoint as jckpt
from letf_tpu_torch import config as tcfg
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.utils import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

KW = dict(num_simulations=96, seed=11, chunk_size=32, progress=False,
          device="cpu")


@pytest.fixture(scope="module", autouse=True)
def short_buffer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "RANDOM_START_BUFFER_YEARS", 0.5)
        yield


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.fixture(scope="module")
def clean(model):
    return mc_runner.run_monte_carlo(model, 0.25, **KW)


def perturbed(model):
    """The model with a few leaves moved off their defaults, so that a
    load that fell back to the template would show."""
    return model._replace(
        irx_base=model.irx_base + 0.25,
        joint=model.joint._replace(nu=model.joint.nu + 1.5),
        regime=model.regime._replace(p_stay=model.regime.p_stay * 0.99))


def assert_models_equal(a, b):
    fa, fb = dict(ckpt.flat_model_arrays(a)), dict(ckpt.flat_model_arrays(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        assert fa[k].dtype == fb[k].dtype, k


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_checkpoint_round_trip_with_jax(tmp_path, writer):
    port_model = perturbed(default_sim_model())
    jax_model = perturbed(jax_default_model())
    path = tmp_path / "model"
    if writer == "port":
        ckpt.save_sim_model(port_model, path)
    else:
        # The JAX package's fallback write (letf_tpu/utils/checkpoint.py:34).
        np.savez(str(path) + ".npz", **dict(jckpt.flat_model_arrays(
            jax_model)))
    assert (tmp_path / "model.npz").exists() and not path.exists()
    assert_models_equal(ckpt.load_sim_model(path), port_model)
    assert_models_equal(jckpt.load_sim_model(path), jax_model)
    assert ckpt.load_sim_model(tmp_path / "absent") is None
    assert jckpt.load_sim_model(tmp_path / "absent") is None


def test_unflatten_takes_the_template_for_absent_fields():
    model = perturbed(default_sim_model())
    flat = dict(ckpt.flat_model_arrays(model))
    del flat["joint.chi_cheb"]
    got = ckpt.unflatten_model(default_sim_model(), flat)
    np.testing.assert_array_equal(got.joint.chi_cheb,
                                  default_sim_model().joint.chi_cheb)
    np.testing.assert_array_equal(got.joint.nu, model.joint.nu)


def test_run_manifest_is_the_jax_packages(tmp_path):
    kw = dict(seed=3, num_simulations=96, time_horizon=0.25,
              completed_trials=32, engine_mode="institutional_v1",
              chunk_size=32, random_start_method="offset",
              use_antithetic=True)
    ckpt.save_run_manifest(tmp_path / "port.json", **kw)
    jckpt.save_run_manifest(tmp_path / "jax.json", **kw)
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
    assert ckpt.load_run_manifest(tmp_path / "port.json") == kw
    assert ckpt.load_run_manifest(tmp_path / "absent.json") is None


def test_kill_and_resume_is_bitwise(model, clean, tmp_path):
    d = tmp_path / "mc_ckpt"
    partial = mc_runner.run_monte_carlo(model, 0.25, checkpoint_dir=str(d),
                                        max_chunks=1, **KW)
    assert partial.final_wealth.shape[0] == 32
    np.testing.assert_array_equal(partial.trial_ids, clean.trial_ids[:32])
    np.testing.assert_array_equal(partial.final_wealth,
                                  clean.final_wealth[:32])
    assert sorted(p.name for p in d.iterdir()) == [
        "chunk_000000000000_000000000032.npz", "manifest.json"]
    man = json.loads((d / "manifest.json").read_text())
    assert man["completed_trials"] == 32 and man["chunk_size"] == 32
    assert set(man) == {"seed", "num_simulations", "time_horizon",
                        "completed_trials", "engine_mode", "chunk_size",
                        "random_start_method", "use_antithetic"}

    # A second budgeted call resumes after the restored chunk.
    second = mc_runner.run_monte_carlo(model, 0.25, checkpoint_dir=str(d),
                                       resume=True, max_chunks=1, **KW)
    assert second.final_wealth.shape[0] == 64
    resumed = mc_runner.run_monte_carlo(model, 0.25, checkpoint_dir=str(d),
                                        resume=True, **KW)
    for k, v in vars(clean).items():
        np.testing.assert_array_equal(np.asarray(vars(resumed)[k]),
                                      np.asarray(v), err_msg=k)
    assert len(list(d.glob("chunk_*.npz"))) == 3

    with pytest.raises(ValueError, match="different run configuration"):
        mc_runner.run_monte_carlo(model, 0.25, checkpoint_dir=str(d),
                                  resume=True,
                                  **dict(KW, seed=99))


def failing_chunk(monkeypatch, fail):
    """Make ``_Run.chunk`` raise where ``fail(first trial id, attempt)``
    says so; returns the per-first-id attempt counts."""
    real = mc_runner._Run.chunk
    attempts = {}

    def chunk(self, ids, anti):
        first = int(ids[0])
        attempts[first] = attempts.get(first, 0) + 1
        if fail(first, attempts[first]):
            raise RuntimeError("injected chunk failure")
        return real(self, ids, anti)

    monkeypatch.setattr(mc_runner._Run, "chunk", chunk)
    return attempts


def test_containment_skips_and_flags_a_failing_chunk(model, clean,
                                                     monkeypatch):
    """The middle chunk (trial rows 32..63, base ids from 16) fails on
    both attempts: it is skipped with the JAX package's sentinel
    summaries and flagged; the others equal the clean run."""
    attempts = failing_chunk(monkeypatch, lambda first, n: first == 16)
    got = mc_runner.run_monte_carlo(model, 0.25, fault_tolerant=True,
                                    chunk_timeout=120.0, chunk_retries=1,
                                    **KW)
    assert attempts == {0: 1, 16: 2, 32: 1}
    np.testing.assert_array_equal(got.chunk_failed,
                                  np.repeat([False, True, False], 32))
    bad = slice(32, 64)
    ref = jmc._failed_chunk_summaries(32)
    for k, v in ref.items():
        g = getattr(got, k)[bad]
        np.testing.assert_array_equal(g, v, err_msg=k)
        assert g.dtype == v.dtype or k in ("start_offset", "start_regime"), k
    keep = np.r_[0:32, 64:96]
    for k in ("final_wealth", "num_trades", "max_dd", "valid", "liq_mean",
              "start_offset", "regime_high_days"):
        np.testing.assert_array_equal(getattr(got, k)[keep],
                                      getattr(clean, k)[keep], err_msg=k)


@pytest.mark.parametrize("fault", ["raise", "timeout"])
def test_containment_retries_a_transient_failure(model, clean, monkeypatch,
                                                 fault):
    """The first attempt at the last chunk fails (an exception, or a stall
    past ``chunk_timeout``); its retry succeeds and the run equals the
    clean one with no chunk flagged."""
    if fault == "raise":
        failing_chunk(monkeypatch, lambda first, n: first == 32 and n == 1)
    else:
        real = mc_runner._Run.chunk
        seen = []

        def slow_once(self, ids, anti):
            if int(ids[0]) == 32 and not seen:
                seen.append(1)
                time.sleep(3.0)
            return real(self, ids, anti)

        monkeypatch.setattr(mc_runner._Run, "chunk", slow_once)
    got = mc_runner.run_monte_carlo(model, 0.25, fault_tolerant=True,
                                    chunk_timeout=1.0 if fault == "timeout"
                                    else 120.0, chunk_retries=1, **KW)
    assert not got.chunk_failed.any()
    np.testing.assert_array_equal(got.final_wealth, clean.final_wealth)


def test_containment_raises_when_the_context_is_poisoned(model,
                                                         monkeypatch):
    """A failure after which the device no longer answers (a sticky CUDA
    error) is raised at once: no retry, no flag."""
    poisoned = mc_runner._context_poisoned
    assert not poisoned((torch.device("cpu"),))
    attempts = failing_chunk(monkeypatch, lambda first, n: first == 16)
    monkeypatch.setattr(mc_runner, "_context_poisoned", lambda devs: True)
    with pytest.raises(RuntimeError, match="injected chunk failure"):
        mc_runner.run_monte_carlo(model, 0.25, fault_tolerant=True, **KW)
    assert attempts == {0: 1, 16: 1}
