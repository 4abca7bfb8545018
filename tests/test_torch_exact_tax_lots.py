"""The port's exact-tax report under each elected lot order (LIFO, HIFO,
LOFO, LTFO, STFO, MINTAX) against the JAX package's, on the same emission.

As tests/test_torch_exact_tax.py does for FIFO: the JAX package's
``exact_post_tax_all_trials`` runs on the port's general-path emission
(its chunk function replaced for the test), float64, rtol 1e-9, all 13
taxable strategies. 8 trials x 1 year: each order's day scan over
fixed-capacity lot arrays (capacity max(256, the chunk's most buy events
rounded up to 256)) is the slow part of both."""

import numpy as np
import pytest

import letf_tpu.parallel.mc_runner as jax_runner
from letf_tpu import config as cfg
from letf_tpu import reporting as jax_reporting
from letf_tpu.models.params import default_sim_model
from letf_tpu_torch import reporting
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.tax import device_bridge as bridge

from test_torch_exact_tax import (
    PCTS,
    SEED,
    as_jax_chunk,
    assert_tables_close,
    port_chunk,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N = 8


@pytest.fixture(scope="module")
def chunk():
    return port_chunk(default_sim_model(), N)


@pytest.mark.parametrize("method", bridge.ELECTION_METHODS[1:])
def test_elected_lot_orders_match_jax(chunk, method, monkeypatch):
    model = default_sim_model()
    monkeypatch.setattr(mc_runner, "general_chunk", lambda *a, **k: chunk)
    monkeypatch.setattr(jax_runner, "_mc_chunk", as_jax_chunk(*chunk))
    kw = dict(seed=SEED, chunk_size=N, percentiles=PCTS, lot_method=method)
    got = reporting.exact_post_tax_all_trials(model, 1, N, device="cpu",
                                              **kw)
    want = jax_reporting.exact_post_tax_all_trials(model, 1, N, **kw)
    assert_tables_close(got, want)
    assert all(got[s]["n_trials"] == N and got[s]["nonfinite_trials"] == 0
               for s in cfg.TAXABLE_IDS)
    assert np.isfinite(got["S7"]["median_tax"])
