"""The port's production chunk with the overlays of the slab path: no
random-start buffer (no window), historical-anchor start conditions and a
DCA cashflow schedule, against the JAX slab chain with its Pallas kernels
in interpret mode (as tests/test_path_batched.py's overlay test)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from letf_tpu.models.params import default_sim_model
from letf_tpu.ops import pallas_joint, pallas_strategies, pallas_window
from letf_tpu.ops.path_batched import plan_max_spells
from letf_tpu.ops.slab_chunk import slab_chunk_summaries as jax_chunk
from letf_tpu.strategies.engine import dca_schedule
from letf_tpu_torch.models.params import from_numpy
from letf_tpu_torch.ops import compose_strategies as k3
from letf_tpu_torch.ops import rng
from letf_tpu_torch.ops.slab_chunk import slab_chunk_summaries
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_slab_chunk_anchor_cashflow_no_buffer(monkeypatch):
    model = default_sim_model()
    B, S, seed = 1024, 126, 13
    cf = np.asarray(dca_schedule(S, 750.0), np.float32)
    anchors = ((np.arange(400) % 2).astype(np.int32),
               (15.0 + (np.arange(400) % 20)).astype(np.float32))
    for mod, name in ((pallas_joint, "pallas_joint_generate"),
                      (pallas_window, "window_offsets_slab"),
                      (pallas_strategies, "pallas_compose_strategies_run")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    jax_chunk.clear_cache()
    ref = jax_chunk(
        jax.tree.map(jnp.asarray, model), jax.random.key(seed),
        jnp.arange(B, dtype=jnp.int32) // 2, (jnp.arange(B) % 2) == 1,
        sim_days=S, buffer_days=0, random_start_method="historical_anchor",
        anchors=tuple(jnp.asarray(a) for a in anchors),
        cashflows=jnp.asarray(cf), max_spells=plan_max_spells(model, S))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    jax_chunk.clear_cache()

    rows = torch.arange(B)
    got = slab_chunk_summaries(
        from_numpy(model, "cpu", torch.float64), rng.key(seed), rows // 2,
        rows % 2 == 1, sim_days=S, buffer_days=0,
        random_start_method="historical_anchor", anchors=anchors,
        cashflows=torch.from_numpy(cf), max_spells=plan_max_spells(model, S))
    got = {k: v.numpy() for k, v in got.items()}

    k3.check_parity(got, ref,
                    exact=("start_offset", "start_regime",
                           "regime_high_days", "path_finite"),
                    at_most_one=("valid",))
    assert 0 < ref["start_regime"].mean() < 1       # both anchor regimes
    np.testing.assert_allclose(got["liq_mean"], ref["liq_mean"],
                               atol=1e-4 / S)
