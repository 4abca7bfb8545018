"""The sample the default report's post-tax tables are drawn from
(``report["post_tax_sample"]``, ``reporting.sampled_post_tax_tables``'s
``sample``): each taxable strategy's picked rows at the evenly spaced
sorted-wealth positions of the final wealth the report reduced, their
pre-tax wealth, and their exact taxes, which equal the JAX package's
bridge and tax on the port's own emission of those rows (rtol 1e-9, as
test_torch_sampled_report.py holds the tables). At 16 trials x 1 y every
trial is sampled; at 256 x 2 y fifty of them. The tables are the parent
computation of that sample, bit for bit, with or without ``sample=``;
and a traced report has the ``post_tax`` span over the five stages, its
``replay`` counting the rows it replays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu import config as jcfg
from letf_tpu.income import simulate_wired_income_path
from letf_tpu.reporting import DEFAULT_TAX_CONFIG, _income_kwargs
from letf_tpu.tax.device_bridge import yearly_activity_from_emission
from letf_tpu.tax.vectorized import total_tax_all_trials
from letf_tpu_torch import config as cfg
from letf_tpu_torch import reporting
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.parallel import mc_runner
from letf_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEED = 9
STAGES = ("pick_rows", "replay", "bridge", "tax", "interp_reduce")


@pytest.fixture(scope="module")
def model():
    return default_sim_model()


@pytest.fixture(scope="module", params=[(16, 1), (256, 2)],
                ids=["16x1y", "256x2y"])
def case(request, model):
    """A traced report, its spans, and the [N, 19] final wealth its
    reduction took (the wealth the tables sample)."""
    n, years = request.param
    held = {}
    inner = mc_runner.reduce_report

    def reduce(fw, *a):
        held["fw"] = fw.clone()
        return inner(fw, *a)

    profiling.reset()
    with pytest.MonkeyPatch.context() as mp, profiling.tracing():
        mp.setattr(mc_runner, "reduce_report", reduce)
        rep = mc_runner.monte_carlo_report(model, years, num_simulations=n,
                                           seed=SEED, device="cpu")
    spans = profiling.records()
    profiling.reset()
    return n, years, rep, spans, held["fw"]


def jax_taxes(model, n, years, rows):
    """The JAX package's bridge and tax of each taxable column of the
    port's emission of ``rows`` (float64): [len(rows), 13]."""
    run = mc_runner._Run(model, years, n, SEED, device="cpu")
    ids, anti = mc_runner._trial_layout(n, run.use_antithetic)
    _, em = mc_runner.general_chunk(run, ids[rows], anti[rows])
    em = [e.numpy() if e.dtype == torch.int8 else e.double().numpy()
          for e in em]
    income = simulate_wired_income_path(
        DEFAULT_TAX_CONFIG["ordinary_income"], years,
        **_income_kwargs(DEFAULT_TAX_CONFIG))
    out = np.zeros((len(rows), len(jcfg.TAXABLE_IDS)))
    for col in range(len(jcfg.TAXABLE_IDS)):
        act, n_tr = yearly_activity_from_emission(
            *[jnp.asarray(e[:, :, col]) for e in em], n_years=years)
        out[:, col] = np.asarray(total_tax_all_trials(
            act[..., :4], jnp.asarray(income), jcfg.INITIAL_CAPITAL,
            n_tr.astype(act.dtype) / years)["total_tax"])
    return out


def test_sample_is_the_sorted_wealth_picks_and_their_exact_taxes(model,
                                                                 case):
    n, years, rep, _, fw = case
    fw = fw.numpy()
    sample = rep["post_tax_sample"]
    assert list(sample) == list(cfg.TAXABLE_IDS)
    m = min(reporting.MAX_TAX_SIMS, n)
    pos = np.linspace(0, n - 1, m, dtype=int)
    for sid in cfg.TAXABLE_IDS:
        w = fw[:, cfg.STRATEGY_INDEX[sid]]
        s = sample[sid]
        assert rep["strategies"][sid]["post_tax"]["n_sampled"] == m
        np.testing.assert_array_equal(
            s["rows"], np.argsort(w, kind="stable")[pos], err_msg=sid)
        np.testing.assert_array_equal(s["wealth"], w[s["rows"]],
                                      err_msg=sid)
    uniq = np.unique(np.concatenate([sample[s]["rows"]
                                     for s in cfg.TAXABLE_IDS]))
    want = jax_taxes(model, n, years, uniq)
    for col, sid in enumerate(cfg.TAXABLE_IDS):
        at = np.searchsorted(uniq, sample[sid]["rows"])
        np.testing.assert_allclose(sample[sid]["tax"], want[at, col],
                                   rtol=1e-9, atol=1e-9, err_msg=sid)
    assert max(max(sample[s]["tax"]) for s in cfg.TAXABLE_IDS) > 0


def test_tables_are_the_parent_computation_of_the_sample(model, case):
    """The fans, median taxes and win rates, bit for bit, are the parent's
    computation (its interpolation and reductions, term by term) over the
    sample; and ``sampled_post_tax_tables`` without ``sample=`` returns
    the same tables."""
    n, years, rep, _, fw_dev = case
    run = mc_runner._Run(model, years, n, SEED, device="cpu")
    dt = torch.float64
    q = torch.tensor([p / 100.0 for p in rep["percentiles"]], dtype=dt)
    spy = fw_dev[:, cfg.STRATEGY_INDEX["S2"]].to(dt)
    for sid in cfg.TAXABLE_IDS:
        s = rep["post_tax_sample"][sid]
        w = fw_dev[:, cfg.STRATEGY_INDEX[sid]].to(dt)
        sw = w[torch.as_tensor(s["rows"])]
        o = torch.argsort(sw, stable=True)
        tax_all = reporting.interp(w, sw[o],
                                   torch.as_tensor(s["tax"], dtype=dt)[o])
        post = torch.clamp_min(w - tax_all, 0.0)
        pt = rep["strategies"][sid]["post_tax"]
        assert [pt["wealth"][f"p{p}"] for p in rep["percentiles"]] == \
            torch.quantile(post, q, interpolation="linear").tolist(), sid
        assert pt["win_rate_vs_spy_post_tax"] == float(
            (post > spy).to(dt).mean()), sid
        assert pt["median_tax"] == float(torch.quantile(
            tax_all, 0.5, interpolation="linear")), sid
    if n == 16:
        plain = reporting.sampled_post_tax_tables(
            model, fw_dev, years, n, SEED, None, "institutional_v1",
            run.random_start_method, run.buffer_days, run.use_antithetic,
            tuple(rep["percentiles"]), device="cpu", stage_seconds=None)
        assert plain == {sid: rep["strategies"][sid]["post_tax"]
                         for sid in cfg.TAXABLE_IDS}


def test_traced_report_has_the_post_tax_span(case):
    n, _, rep, spans, _ = case
    by_id = {s.id: s for s in spans}
    post = [s for s in spans if s.name == "post_tax"]
    assert len(post) == 1
    assert by_id[post[0].parent].name == "report"
    under = [s for s in spans if s.parent == post[0].id]
    assert [s.name for s in under] == ["pick_rows", "replay", "bridge",
                                       "tax", "bridge", "tax",
                                       "interp_reduce"]
    assert set(STAGES) == {s.name for s in under}
    uniq = np.unique(np.concatenate([rep["post_tax_sample"][s]["rows"]
                                     for s in cfg.TAXABLE_IDS]))
    replay = next(s for s in under if s.name == "replay")
    assert replay.counters["replayed_trials"] == len(uniq)
    assert post[0].host_ms >= sum(s.host_ms for s in under)
    assert post[0].host_ms / 1e3 <= rep["post_tax_seconds"] + 1e-3
