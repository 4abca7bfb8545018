"""The port's sampled post-tax tables against the benchmark's plain
post-tax reference (``benchmark/reference/post_tax``: the row's path by
the plain institutional engine, the plain emitting replay, the JAX
package's host tracker and statute, copied), at 64 trials x 2 y with
float64 on both sides (the CPU's glue dtype):

- every sampled (row, strategy)'s pre-tax wealth and exact tax against
  the reference's;
- the full tables, win rate included, recomputed in float64 from all 64
  trials' wealth and the sample;
- the sampled tax mode's checks of the tables against their own sample
  (``benchmark/reference/tax_modes/sampled.py``) read 0."""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import post_tax
from letf_tpu_torch import config as cfg
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.parallel import mc_runner
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, YEARS, SEED = 64, 2, 2**32 + 21
ROOT = Path(__file__).resolve().parents[1]

# Where the port's device bridge and the host tracker may part: the
# tracker skips a change of under 0.001 shares and drops lots below it
# (the bridge keeps them), so a tax may move by those trades' gains, a
# fraction of a share's price against the row's gross traded dollars. And
# the replays'
# float32 paths part by rounding (K1 and K5 in NumPy against torch), so a
# rebalance near its turnover threshold may happen on one side only: the
# tax then moves by that rebalance's gains, ~1e-4 of gross a flip.
DUST_RTOL = 1e-6
FLIP_RTOL = 1e-3


@pytest.fixture(scope="module")
def cell():
    c = spec.load_cell(ROOT, "inst_sampled_1m")
    c.traffic = dict(c.traffic, trials=N, years=YEARS)
    return c


@pytest.fixture(scope="module")
def case():
    held = {}
    inner = mc_runner.reduce_report

    def reduce(fw, *a):
        held["fw"] = fw.clone()
        return inner(fw, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mc_runner, "reduce_report", reduce)
        rep = mc_runner.monte_carlo_report(default_sim_model(), YEARS,
                                           num_simulations=N, seed=SEED,
                                           device="cpu")
    return rep, held["fw"].double().numpy()


def test_sampled_wealth_and_taxes_match_the_plain_reference(cell, case):
    rep, _ = case
    sample = rep["post_tax_sample"]
    pairs = [(int(r), sid) for sid in cfg.TAXABLE_IDS
             for r in sample[sid]["rows"]]
    got_w = np.concatenate([sample[s]["wealth"] for s in cfg.TAXABLE_IDS])
    got_t = np.concatenate([sample[s]["tax"] for s in cfg.TAXABLE_IDS])
    ref = post_tax.pair_taxes(pairs, SEED, YEARS, cell.config,
                              torch.float64)
    # The report's wealth is the slab chunk's (K3's plain loop in torch
    # here), the reference's its plain engine's (K3's loop in NumPy):
    # float32 both, rounding apart, which two years of leverage amplify.
    rel = np.abs(got_w - ref["wealth"]) / np.maximum(ref["wealth"], 1.0)
    assert np.median(rel) <= 1e-5 and rel.max() <= 5e-3
    # The emitting replay (its signals as cumulative-sum differences, not
    # K3's running sums a day) parts from it by the signals' rounding.
    np.testing.assert_allclose(ref["replay_wealth"], ref["wealth"],
                               rtol=1e-3)
    scale = np.maximum.reduce([ref["gross"], np.abs(ref["tax"]),
                               np.ones(len(pairs))])
    gap = np.abs(got_t - ref["tax"]) / scale
    assert np.median(gap) <= DUST_RTOL
    assert (gap > FLIP_RTOL).mean() <= 0.05
    assert gap.max() <= 10 * FLIP_RTOL
    assert (ref["tax"] > 0).mean() > 0.5


def test_full_tables_recomputed_in_float64(cell, case):
    from benchmark.reference.tax_modes import sampled

    rep, fw = case
    pct = rep["percentiles"]
    spy = fw[:, cfg.STRATEGY_INDEX["S2"]]
    for sid in cfg.TAXABLE_IDS:
        s = rep["post_tax_sample"][sid]
        w = fw[:, cfg.STRATEGY_INDEX[sid]]
        tax_all = sampled.interp(w, s["wealth"], s["tax"])
        post = np.maximum(w - tax_all, 0.0)
        pt = rep["strategies"][sid]["post_tax"]
        np.testing.assert_allclose(
            [pt["wealth"][f"p{p}"] for p in pct],
            np.quantile(post, np.asarray(pct) / 100.0, method="linear"),
            rtol=1e-12, err_msg=sid)
        np.testing.assert_allclose(pt["median_tax"],
                                   np.quantile(tax_all, 0.5), rtol=1e-12,
                                   atol=1e-9, err_msg=sid)
        assert pt["win_rate_vs_spy_post_tax"] == float(np.mean(post > spy))


def test_tables_hold_to_their_sample(cell, case):
    from benchmark.reference.tax_modes import sampled

    rep, _ = case
    nums = sampled.sample_numbers(cell, rep)
    assert nums == {"sample_mismatch": 0.0, "pick_mismatches": 0.0,
                    "post_fan_max_gap": nums["post_fan_max_gap"],
                    "median_tax_gap": nums["median_tax_gap"]}
    assert nums["post_fan_max_gap"] <= 1e-12
    assert nums["median_tax_gap"] <= 1e-12
