"""Multi-device runs of the port: a trial mesh of CPU shards.

``parallel.mesh.trial_mesh(["cpu", "cpu"])`` holds two shards on one
device (a mesh allows repeats), so the sharded code path runs here as it
runs over several cards: each chunk padded to a multiple of the shard
count, cut into contiguous slices, each slice through its shard's
``_Run``, the summaries gathered in order.

- ``run_monte_carlo`` and ``monte_carlo_report`` on the mesh equal the
  single-device run bit for bit (trials replay from (seed, trial id)),
  with a cashflow schedule and historical anchors too, as
  tests/test_mc_runner.py:43-78 holds the JAX package's shard_map; a
  padded last chunk (ids ``arange(lo, lo + n_pad) % N``) is cut back.
- ``exact_post_tax_all_trials`` on the mesh (full FIFO chunks through the
  shards, the partial tail on one device) equals the single-device run
  within rtol 1e-9, as tests/test_multichip_tax.py:75.

The shards' slices are 32 trials wide or a multiple of that: torch's CPU
kernels run a scalar loop on the tail of a row that is not a whole number
of vector pairs, and its scalar ``pow`` differs from the vectorised one by
an ulp, so on the CPU a trial's bits depend on its batch width unless both
widths are whole multiples of 32 (a CUDA kernel computes every element
alike).
"""

import numpy as np
import pytest
import torch

from letf_tpu_torch import config as tcfg
from letf_tpu_torch import reporting
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.parallel.mesh import (
    TrialMesh,
    pad_to_multiple,
    trial_mesh,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TWO = trial_mesh(["cpu", "cpu"])


@pytest.fixture(scope="module", autouse=True)
def short_buffer():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcfg, "RANDOM_START_BUFFER_YEARS", 0.5)
        yield


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


def assert_arrays_equal(a, b, n=None):
    for k, v in vars(a).items():
        w = vars(b)[k]
        if isinstance(v, np.ndarray) and n is not None:
            w = w[:n]
        np.testing.assert_array_equal(np.asarray(v), np.asarray(w),
                                      err_msg=k)


def test_trial_mesh():
    mesh = trial_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert isinstance(mesh, TrialMesh) and mesh.size == 3
    assert mesh.distinct() == (torch.device("cpu"),)
    assert tuple(mesh) == (torch.device("cpu"),) * 3
    assert pad_to_multiple(63, 2) == 64 and pad_to_multiple(64, 2) == 64
    with pytest.raises(ValueError, match="at least one device"):
        trial_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trial_mesh()
    with pytest.raises(TypeError, match="TrialMesh"):
        mc_runner.run_monte_carlo(None, 0.25, num_simulations=4,
                                  mesh=["cpu", "cpu"], device="cpu")


@pytest.mark.parametrize("overlays", [False, True],
                         ids=["plain", "cashflows_anchors"])
def test_sharded_run_equals_single(model, overlays):
    """Two shards over two chunks of 64, bit for bit one device; with a
    monthly $500 schedule and a historical-anchor start pool the overlays
    reach every shard."""
    kw = dict(num_simulations=128, seed=7, chunk_size=64, progress=False,
              device="cpu")
    if overlays:
        cash = np.zeros(63, np.float32)
        cash[::21] = 500.0
        kw.update(random_start_method="historical_anchor", cashflows=cash,
                  anchors=(np.array([0, 1, 0, 1, 1], np.int32),
                           np.array([14.0, 33.0, 18.0, 29.0, 41.0],
                                    np.float32)))
    single = mc_runner.run_monte_carlo(model, 0.25, **kw)
    multi = mc_runner.run_monte_carlo(model, 0.25, mesh=TWO, **kw)
    assert multi.chunk_failed is None
    assert_arrays_equal(multi, single)
    if overlays:
        plain = mc_runner.run_monte_carlo(model, 0.25, num_simulations=128,
                                          seed=7, chunk_size=64,
                                          progress=False, device="cpu")
        assert not np.array_equal(plain.final_wealth, multi.final_wealth)


def test_sharded_run_pads_the_last_chunk(model):
    """127 trials in chunks of 64 on two shards: the last chunk's 63
    trials are padded to 64 with trial row 0 (``% N``) and cut back; each
    trial equals its row of a single-device run of 128."""
    kw = dict(seed=5, chunk_size=64, progress=False, device="cpu")
    multi = mc_runner.run_monte_carlo(model, 0.25, num_simulations=127,
                                      mesh=TWO, **kw)
    single = mc_runner.run_monte_carlo(model, 0.25, num_simulations=128,
                                       **kw)
    assert multi.final_wealth.shape == (127, 19)
    assert_arrays_equal(multi, single, n=127)


def test_chunk_size_padded_to_the_shard_count(model):
    three = trial_mesh(["cpu"] * 3)
    shards = mc_runner._Shards(three, lambda d: mc_runner._Run(
        model, 0.25, 10, 0, 4, device=d))
    assert shards.chunk_size == 6 and len(shards.runs) == 1


def test_sharded_report_equals_single(model):
    kw = dict(num_simulations=64, seed=3, chunk_size=64, device="cpu")
    single = mc_runner.monte_carlo_report(model, 1, **kw)
    multi = mc_runner.monte_carlo_report(model, 1, mesh=TWO, **kw)
    for rep in (single, multi):
        rep.pop("post_tax_seconds")
    assert multi == single
    assert len([s for s in multi["strategies"].values()
                if "post_tax" in s]) == 13


def test_sharded_exact_all_equals_single(model):
    """80 trials in chunks of 64: the first chunk through the two shards,
    the 16-trial tail on one device; every table within rtol 1e-9."""
    kw = dict(chunk_size=64, seed=2, strategy_ids=["S7", "S8", "S12"],
              device="cpu")
    values = {}
    single = reporting.exact_post_tax_all_trials(model, 1, 80, **kw)
    multi = reporting.exact_post_tax_all_trials(model, 1, 80, mesh=TWO,
                                                trial_values=values, **kw)
    assert set(multi) == set(single) == {"S7", "S8", "S12"}
    for sid, e in single.items():
        assert multi[sid]["n_trials"] == e["n_trials"] == 80
        for k, v in e.items():
            assert multi[sid][k] == pytest.approx(v, rel=1e-9, abs=1e-9), \
                (sid, k)
    w, pw = values["S7"]
    assert np.isfinite(w).all() and (pw <= w).all()
    with pytest.raises(TypeError, match="TrialMesh"):
        reporting.exact_post_tax_all_trials(model, 1, 8, mesh=object(),
                                            device="cpu")
