"""The exact tax bridge at 50 years against the JAX package.

``exact_post_tax_all_trials(model, 50, 4, chunk_size=4, seed=11,
strategy_ids=["S7"])`` on the CPU: the general path with journal emission
over 12,600 days, the device bridge (K7's and K8's plain versions, the
year bucketing over 50 years) and the vectorized tax with the income path
and bracket inflation stretched to 50 years. The JAX package's
``exact_post_tax_all_trials`` runs on the port's own emission of the same
trials (its ``_mc_chunk`` replaced for the test, as in
tests/test_torch_exact_tax.py), and the tables agree within that file's
rtol 1e-9.
"""

import numpy as np

import letf_tpu.parallel.mc_runner as jax_runner
from letf_tpu import reporting as jax_reporting
from letf_tpu.models.params import default_sim_model as jax_default_model
from letf_tpu_torch import reporting
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.parallel import mc_runner
from test_torch_exact_tax import as_jax_chunk, assert_tables_close
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_50y_exact_tax_bridge_matches_jax(monkeypatch):
    chunks = []
    inner = mc_runner.general_chunk

    def general_chunk(*args, **kw):
        out = inner(*args, **kw)
        chunks.append(out)
        return out

    monkeypatch.setattr(mc_runner, "general_chunk", general_chunk)
    kw = dict(chunk_size=4, seed=11, strategy_ids=["S7"])
    got = reporting.exact_post_tax_all_trials(default_sim_model(), 50, 4,
                                              device="cpu", **kw)
    (summ, emission), = chunks
    assert emission[0].shape == (50 * 252, 4, 13)
    monkeypatch.setattr(jax_runner, "_mc_chunk",
                        as_jax_chunk(summ, emission))
    want = jax_reporting.exact_post_tax_all_trials(jax_default_model(), 50,
                                                   4, **kw)
    assert_tables_close(got, want, ["S7"])
    e = got["S7"]
    assert e["n_trials"] == 4 and e["nonfinite_trials"] == 0
    assert np.isfinite(e["median_tax"]) and e["median_tax"] > 0
    assert e["post_tax_p50"] <= e["pre_tax_p50"]
