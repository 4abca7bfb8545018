"""The port's runner entries take the reference's arguments.

``monte_carlo_report`` and ``run_monte_carlo`` have the JAX package's
parameters in name, default and order, with the port's own ``device`` and
``stage_seconds`` after them as keyword-only; a call shaped like
``letf_tpu/runner.py::run_report``'s runs, and the arguments of the
reference's multi-device runs, checkpoint/resume, chunk budget and chunk
containment run and keep the plain run's trials."""

import inspect

import numpy as np
import pytest

from letf_tpu.models.params import default_sim_model
from letf_tpu.parallel import mc_runner as jmc
from letf_tpu_torch import reporting
from letf_tpu_torch.parallel import mc_runner as tmc
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, SEED = 8, 3
PORT_EXTRAS = {"monte_carlo_report": ("device", "stage_seconds"),
               "run_monte_carlo": ("device",)}


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.mark.parametrize("name", sorted(PORT_EXTRAS))
def test_signature_matches_reference(name):
    ref = list(inspect.signature(getattr(jmc, name)).parameters.values())
    got = list(inspect.signature(getattr(tmc, name)).parameters.values())
    assert [p.name for p in got[:len(ref)]] == [p.name for p in ref]
    for r, g in zip(ref, got):
        assert g.kind == r.kind == inspect.Parameter.POSITIONAL_OR_KEYWORD
        assert g.default == r.default, (name, r.name)
    extras = got[len(ref):]
    assert tuple(p.name for p in extras) == PORT_EXTRAS[name]
    assert all(p.kind == inspect.Parameter.KEYWORD_ONLY for p in extras)
    assert next(p for p in extras if p.name == "device").default == "cuda"


def _drop_timing(rep):
    return {k: v for k, v in rep.items() if k != "post_tax_seconds"}


def test_reference_runner_call_runs(model):
    """The call of letf_tpu/runner.py:62-65, with chunks_per_dispatch=2
    over two chunks, gives the report of the same call without it."""
    kw = dict(num_simulations=N, seed=SEED, chunk_size=N // 2,
              tax_config=dict(reporting.DEFAULT_TAX_CONFIG),
              tax_mode="sampled", device="cpu")
    with_cpd = tmc.monte_carlo_report(model, 1, chunks_per_dispatch=2, **kw)
    without = tmc.monte_carlo_report(model, 1, **kw)
    assert with_cpd["n_trials"] == N and "post_tax" in \
        with_cpd["strategies"]["S7"]
    assert _drop_timing(with_cpd) == _drop_timing(without)


def test_run_monte_carlo_accepts_dispatch_and_containment_knobs(model):
    """chunks_per_dispatch, progress, chunk_timeout and chunk_retries are
    accepted and change no summary (the last two act only under
    fault_tolerant)."""
    kw = dict(num_simulations=N, seed=SEED, chunk_size=N // 2,
              device="cpu")
    base = tmc.run_monte_carlo(model, 0.25, progress=False, **kw)
    knobs = tmc.run_monte_carlo(model, 0.25, chunks_per_dispatch=4,
                                progress=True, chunk_timeout=5.0,
                                chunk_retries=3, **kw)
    for k, v in vars(base).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(vars(knobs)[k]), err_msg=k)


def _run_argument(arg, tmp_path):
    """The keywords of one of the reference's runner arguments that the
    port once refused: a two-shard CPU mesh, a checkpoint directory (also
    resumed from, and under a chunk budget) and the chunk containment."""
    from letf_tpu_torch.parallel.mesh import trial_mesh

    ck = str(tmp_path / "ckpt")
    return {"mesh": dict(mesh=trial_mesh(["cpu", "cpu"])),
            "checkpoint_dir": dict(checkpoint_dir=ck),
            "resume": dict(checkpoint_dir=ck, resume=True),
            "max_chunks": dict(checkpoint_dir=ck, max_chunks=1),
            "fault_tolerant": dict(fault_tolerant=True)}[arg]


RUN_ARGS = ("mesh", "checkpoint_dir", "resume", "max_chunks",
            "fault_tolerant")


@pytest.mark.parametrize("arg", RUN_ARGS)
def test_run_argument_runs(model, arg, tmp_path):
    """Each argument runs and keeps the plain run's trials bit for bit
    (one 64-trial chunk, 32 trials a CPU shard: see tests/test_torch_mesh.py
    on the CPU's batch widths); ``max_chunks=1`` over chunks of 32 returns
    the first 32."""
    kw = dict(num_simulations=64, seed=SEED, chunk_size=64, progress=False,
              device="cpu")
    want = tmc.run_monte_carlo(model, 0.25, **kw)
    n = 64
    if arg == "max_chunks":
        kw["chunk_size"] = n = 32
    got = tmc.run_monte_carlo(model, 0.25, **_run_argument(arg, tmp_path),
                              **kw)
    assert got.final_wealth.shape == (n, 19)
    for k in ("final_wealth", "num_trades", "max_dd", "start_offset",
              "trial_ids"):
        np.testing.assert_array_equal(getattr(got, k),
                                      getattr(want, k)[:n], err_msg=k)
    assert (got.chunk_failed is not None) == (arg == "fault_tolerant")


def test_report_mesh_runs(model):
    from letf_tpu_torch.parallel.mesh import trial_mesh

    kw = dict(num_simulations=64, seed=SEED, chunk_size=64,
              tax_mode="none", device="cpu")
    got = tmc.monte_carlo_report(model, 0.25, mesh=trial_mesh(["cpu", "cpu"]),
                                 **kw)
    assert got == tmc.monte_carlo_report(model, 0.25, **kw)
    assert got["n_trials"] == 64
