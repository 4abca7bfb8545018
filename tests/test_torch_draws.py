"""The samplers' dispatch on the CPU: ``rng.normal``, ``gamma`` and ``t``
on CPU keys run the torch twin (``_normal_plain``, ``_gamma_plain``,
``_t_plain``), launch nothing and count their draws as ``plain_draws``
(the gamma loops' ``draw_rounds`` as before); the kernel's wrapper refuses
what the kernel cannot draw before it reaches the library. The kernel
itself runs only on a card (tests/test_torch_draws_cuda.py)."""

import pytest
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.models import params as tparams
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.ops import path_engine as pe
from letf_tpu_torch.ops import rng
from letf_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SAMPLERS = {
    "normal": (lambda k, n, dt: rng.normal(k, n, dt),
               lambda k, n, dt: rng._normal_plain(k, n, dt), False),
    "gamma": (lambda k, n, dt: rng.gamma(k, 0.7, n, dt),
              lambda k, n, dt: rng._gamma_plain(k, 0.7, n, dt), True),
    "t": (lambda k, n, dt: rng.t(k, 5.0, n, dt),
          lambda k, n, dt: rng._t_plain(k, 5.0, n, dt), True),
}


@pytest.fixture(autouse=True)
def tracer():
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_cpu_keys_take_the_twin(name, dtype):
    entry, twin, rounds = SAMPLERS[name]
    k = rng.split(rng.key(13), 24)
    n0 = rng.LAUNCHES
    with profiling.tracing(), profiling.span("draws"):
        got = entry(k, 50, dtype)
    (rec,) = profiling.records()
    assert rng.LAUNCHES == n0
    assert torch.equal(got, twin(k, 50, dtype)) and got.dtype == dtype
    assert rec.counters.pop("plain_draws") == 24 * 50
    assert "fused_draws" not in rec.counters
    assert (rec.counters.pop("draw_rounds", 0) > 0) == rounds
    assert not rec.counters


def test_normal_counts_every_key_of_any_layout():
    k = rng.split(rng.key(4), 15).reshape(3, 5, 2)
    with profiling.tracing(), profiling.span("draws"):
        got = rng.normal(k, 7, torch.float64, lo=3)
    (rec,) = profiling.records()
    assert got.shape == (3, 5, 7)
    assert torch.equal(got, rng._normal_plain(k, 7, torch.float64, lo=3))
    assert rec.counters == {"plain_draws": 15 * 7}


def test_a_parametric_batch_counts_all_its_draws_as_plain():
    """4 trials x 1 year without a buffer (T = S = 252): the VIX and IRX
    normals (2T), the stress normals (2S), the jump sizes' t (S), the
    tracking-error t (one per asset and day, 6S) and the returns' t (3T),
    all through the twin."""
    mt = tparams.from_numpy(default_sim_model(), "cpu", torch.float64)
    rows = torch.arange(4)
    with profiling.tracing():
        pe.generate_paths_batch(mt, rng.key(2), rows // 2, rows % 2 == 1,
                                252, 0, engine_mode="parametric")
    recs = profiling.records()
    plain = sum(r.counters.get("plain_draws", 0) for r in recs)
    assert plain == 4 * (5 * 252 + (3 + cfg.N_ASSETS) * 252)
    assert not any("fused_draws" in r.counters for r in recs)


@pytest.mark.parametrize("dtype,key_dtype", [(torch.float16, torch.int64),
                                             (torch.bfloat16, torch.int64),
                                             (torch.float32, torch.int32)])
def test_the_kernel_wrapper_refuses_before_the_library(dtype, key_dtype):
    k = rng.split(rng.key(1), 4).to(key_dtype)
    n0 = rng.LAUNCHES
    with pytest.raises(TypeError):
        rng._launch("letf_draw_normal", k, 8, dtype, 0)
    assert rng.LAUNCHES == n0
