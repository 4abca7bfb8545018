"""Reporting: the results-list summary, and the report's post-tax tables.

Port of ``letf_tpu/reporting.py``'s results-list surface:
``get_tax_config_interactive`` (the menu, and the defaults when stdin is
not a terminal or ``LETF_NON_INTERACTIVE`` is set), ``estimate_tax_simple``,
``explain_percentile``, and ``create_summary_statistics`` (the Roth and
taxable tables of per-trial result dicts) with its ``_tax_all_trials``:
the reference's amortization (exact tax of <= ``MAX_TAX_SIMS`` trials
sampled evenly across sorted wealth through the host tax chain,
``integration.process_trades_with_wired_engine``, and ``np.interp`` for
the rest), or every trial's exact tax (``exact_all``: the host bridge
``tax/vectorized.yearly_activity_from_trades`` for attached trade lists,
or, for ``Trade_Replay`` descriptors, ``_exact_tax_via_replay``: the
general path with emission, the device bridge with kernels K7 and K8, and
the vectorized tax). ``_fill_missing_trades`` replays the sampled trials
that carry only a descriptor. A taxable result with neither is an error,
never zero tax.

And the report's post-tax tables, sampled and exact over every trial.

Port of ``letf_tpu/reporting.py::sampled_post_tax_tables``, the reference's
tax amortization (reporting.py:455-509) at report scale: per taxable
strategy, <= ``MAX_TAX_SIMS`` trial rows sampled evenly across its sorted
final wealth (a stable argsort: ruined trials tie at 0); one replay of
their union on the general path with journal emission; the FIFO device
bridge (kernels K7 and K8) and the vectorized tax for each sample, in two
bridge groups (the 12 strategies that trade TQQQ alone, then S8, the only
one that trades the SPY leg); the tax spread over all N trials by linear
interpolation on the sampled wealths; post-tax fans and win rates vs SPY
reduced on the device. And of ``exact_post_tax_all_trials`` on one device
(``tax_mode="exact_all"``): every trial taxed through the same bridge,
chunk by chunk, with the strategies folded into batches of at most
``FOLD_ROWS`` rows, any lot election, and a per-trial finiteness gate
(``bridge_activity_tax``); its percentiles reduce on the host, as the
reference's do.

The port keeps its own copies of the reference's tax configuration
(``STATE_TAX_INFO``, ``DEFAULT_TAX_CONFIG``, ``MAX_TAX_SIMS``,
``_income_kwargs``) and of the income path (``letf_tpu_torch/income.py``).

The interpolation is a plain index lookup (``torch.searchsorted`` plus
gathers) in the working precision; the reference's one-hot matmul was a
TPU workaround. The interpolation and the reductions run in the glue
dtype (float64 on the CPU, float32 on the card, as on the TPU); every
bridge and its tax (the sampled tables, ``exact_post_tax_all_trials``,
``_exact_tax_via_replay``) run in ``BRIDGE_DTYPE``, float64 on both
(``bridge_columns``): a float32 cumulative share coordinate near 10^7
shares is one share apart, which over 30 years moved a trial's tax by up
to 2.4e-3 of its gross traded dollars on the card.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.income import simulate_wired_income_path
from letf_tpu_torch.integration import process_trades_with_wired_engine
from letf_tpu_torch.tax.device_bridge import (
    ELECTION_METHODS,
    max_buy_events,
    yearly_activity_from_emission,
)
from letf_tpu_torch.tax.engine import TaxpayerElections
from letf_tpu_torch.tax.vectorized import (
    total_tax_all_trials,
    yearly_activity_from_trades,
)
from letf_tpu_torch.utils import profiling
from letf_tpu_torch.utils.device import glue_dtype

# The reference's state table, sampled-tax budget and default tax
# configuration (letf_tpu/reporting.py:30-51), and the exact path's fold:
# at most this many rows (trials x strategies) in one bridge batch
# (reporting.py:517).
STATE_TAX_INFO = {
    "CA": {"name": "California", "rate": 0.093},
    "NY": {"name": "New York", "rate": 0.065},
    "TX": {"name": "Texas", "rate": 0.0},
    "FL": {"name": "Florida", "rate": 0.0},
    "WA": {"name": "Washington", "rate": 0.07},
    "NV": {"name": "Nevada", "rate": 0.0},
    "IL": {"name": "Illinois", "rate": 0.0495},
    "MA": {"name": "Massachusetts", "rate": 0.05},
    "NJ": {"name": "New Jersey", "rate": 0.0637},
}
MAX_TAX_SIMS = 50
FOLD_ROWS = 8192
BRIDGE_DTYPE = torch.float64   # the precision of every bridge and its tax
DEFAULT_TAX_CONFIG = {
    "state": "CA", "state_name": "California",
    "ordinary_income": 150000, "filing_status": "single",
    "career_stage": "mid", "years_until_retirement": None,
    "retirement_income": None,
}


_PCTS = [("p10", 10), ("p25", 25), ("p40", 40), ("p60", 60),
         ("p75", 75), ("p90", 90)]


def _non_interactive() -> bool:
    return (not sys.stdin.isatty() or bool(os.getenv("LETF_NON_INTERACTIVE"))
            or bool(os.getenv("LETF_NONINTERACTIVE")))


def _int_or(text: str, default):
    """``int(text)`` after the reference's "," and "$" stripping, or
    ``default`` where int() would refuse it."""
    t = text.replace(",", "").replace("$", "").strip()
    return int(t) if re.fullmatch(r"[+-]?\d+(_\d+)*", t) else default


def get_tax_config_interactive() -> Dict:
    """Tax configuration menu; defaults when stdin is not a terminal."""
    if _non_interactive():
        print("\n  [Non-interactive] Tax config: CA, $150k, Single, Mid-career")
        return dict(DEFAULT_TAX_CONFIG)

    print("\nSelect state (1=CA 2=NY 3=TX 4=FL 5=WA 6=NV 7=IL 8=MA 9=NJ):")
    state_map = {"1": "CA", "2": "NY", "3": "TX", "4": "FL", "5": "WA",
                 "6": "NV", "7": "IL", "8": "MA", "9": "NJ"}
    state = state_map.get(input("Enter (1-9) [1]: ").strip() or "1", "CA")
    income = _int_or(input("Ordinary income [150000]: ").strip()
                     or "150000", 150000)
    filing = "married" if (input("Filing (1=Single 2=Married) [1]: ").strip()
                           == "2") else "single"
    career = {"1": "early", "2": "mid", "3": "late"}.get(
        input("Career stage (1=early 2=mid 3=late) [2]: ").strip() or "2",
        "mid")
    retire_str = input("Years until retirement [skip]: ").strip()
    years_until_retirement = int(retire_str) if retire_str.isdigit() else None
    retirement_income = None
    if years_until_retirement:
        ri = input("Retirement income [50% of peak]: ").strip()
        if ri:
            retirement_income = _int_or(ri, None)
    return {
        "state": state, "state_name": STATE_TAX_INFO[state]["name"],
        "ordinary_income": income, "filing_status": filing,
        "career_stage": career,
        "years_until_retirement": years_until_retirement,
        "retirement_income": retirement_income,
    }


def estimate_tax_simple(gains: float, ordinary_income: float, state: str,
                        filing_status: str) -> Dict:
    """Coarse 50/50 ST-LT split tax estimate (reporting.py:160-197)."""
    if gains <= 0:
        return {"total_tax": 0, "effective_rate": 0}
    st, lt = gains * 0.5, gains * 0.5
    total_income = ordinary_income + gains
    if filing_status == "single":
        cuts = [(100525, 0.22, 0.0), (191950, 0.24, 0.15),
                (518900, 0.32, 0.15), (float("inf"), 0.37, 0.20)]
        niit_thresh = 200000
    else:
        cuts = [(201050, 0.22, 0.0), (383900, 0.24, 0.15),
                (583750, 0.32, 0.15), (float("inf"), 0.37, 0.20)]
        niit_thresh = 250000
    for limit, st_rate, lt_rate in cuts:
        if total_income < limit:
            break
    federal = st * st_rate + lt * lt_rate
    state_tax = gains * STATE_TAX_INFO[state]["rate"]
    niit = (min(gains, max(0, total_income - niit_thresh)) * 0.038
            if total_income > niit_thresh else 0)
    total = federal + state_tax + niit
    return {"total_tax": total,
            "effective_rate": total / gains * 100 if gains > 0 else 0}


_SCENARIOS = {
    10: ("WORST 10% (beaten in 90% of cases)",
         "2-3 major crashes; VIX >30 for months; strategy whipsaws; "
         "comparable to 2000-2010."),
    25: ("BELOW AVERAGE (beaten in 75% of cases)",
         "One major crash with a slow 3-5y recovery; comparable to 2007-2013."),
    40: ("SLIGHTLY BELOW MEDIAN",
         "A few 15-20% corrections, normal volatility; an average decade."),
    60: ("SLIGHTLY ABOVE MEDIAN",
         "Minor corrections only, low volatility; a good decade."),
    75: ("ABOVE AVERAGE (needs luck)",
         "Max ~10% pullbacks, VIX 12-15, mostly bull; comparable to 2012-2017."),
    90: ("BEST 10% (DO NOT PLAN ON THIS)",
         "No corrections, VIX 10-12 throughout; the best period on record."),
}


def explain_percentile(p: int, pre_cagr: float, horizon: int,
                       spy_cagr: float = 0.0) -> str:
    if p not in _SCENARIOS:
        return ""
    title, body = _SCENARIOS[p]
    return (f"\nP{p} - {title}\n"
            f"  Strategy pre-tax CAGR {pre_cagr:+.2f}% | SPY B&H at P{p}: "
            f"{spy_cagr:+.2f}% | horizon {horizon}y\n  {body}\n")


def _wealth(results: List[Dict]) -> np.ndarray:
    return np.array([r["Final_Wealth"] for r in results])


def _income_kwargs(tax_config: Dict) -> Dict:
    return dict(
        years_until_retirement=tax_config.get("years_until_retirement"),
        retirement_income=tax_config.get("retirement_income"), seed=42)


def interp(w, xp, fp):
    """jnp.interp over a small ascending table: clamped to fp[0] / fp[-1]
    outside it, and t == 0 on exact node hits (ties take the last tied
    node), as the reference's compare-count form."""
    m = xp.shape[0]
    idx = torch.searchsorted(xp.contiguous(), w.contiguous(), right=True)
    i0 = (idx - 1).clamp(0, m - 1)
    i1 = idx.clamp(0, m - 1)
    x0, x1, f0, f1 = xp[i0], xp[i1], fp[i0], fp[i1]
    t = torch.clamp((w - x0) / torch.where(x1 > x0, x1 - x0, 1.0), 0.0, 1.0)
    return f0 + t * (f1 - f0)


def bridge_columns(cols):
    """Emission columns (alloc, value, price, asset) with the float ones
    in ``BRIDGE_DTYPE``, as every caller hands them to the bridge."""
    return [c if c.dtype == torch.int8 else c.to(BRIDGE_DTYPE)
            for c in cols]


def bridge_activity_tax(stacked, assets: tuple, n_years: int, income,
                        tax_kw: Dict, method: str = "FIFO",
                        lot_capacity: Optional[int] = None,
                        stage_seconds: Optional[Dict] = None):
    """Exact tax of each journal column of one bridge batch: ``stacked``
    the (alloc, value, price, asset) [S, R] emission columns (computed in
    their float dtype), ``assets`` the bridge assets the batch may trade,
    ``method`` / ``lot_capacity`` the lot election. Raises when a skipped
    asset sold shares. Returns (total tax [R], ok [R]: the trial's yearly
    activity and tax are all finite); ``stage_seconds`` accumulates the
    "bridge" and "tax" seconds."""
    dev = stacked[0].device
    with _stage(stage_seconds, "bridge", dev):
        activity, n_trades, viol = yearly_activity_from_emission(
            *stacked, n_years=n_years, method=method,
            lot_capacity=lot_capacity, assets=assets)
        if bool(viol):
            raise RuntimeError("a statically-skipped bridge asset sold "
                               f"shares (assets {assets})")
    with _stage(stage_seconds, "tax", dev):
        total = total_tax_all_trials(
            activity[..., :4], income, cfg.INITIAL_CAPITAL,
            n_trades.to(activity.dtype) / n_years, **tax_kw)["total_tax"]
        # The tax engine propagates non-finite inputs, so the activity and
        # the total are both checked (a -inf gain can net to a finite tax).
        ok = torch.isfinite(activity).all(dim=(1, 2)) & torch.isfinite(total)
    return total, ok


def bridge_tax(stacked, assets: tuple, n_years: int, income, tax_kw: Dict,
               stage_seconds: Optional[Dict] = None):
    """``bridge_activity_tax`` under FIFO that raises on any non-finite
    trial (the sampled tables' gate). Returns total tax [R]."""
    total, ok = bridge_activity_tax(stacked, assets, n_years, income,
                                    tax_kw, stage_seconds=stage_seconds)
    if not bool(ok.all()):
        raise FloatingPointError("non-finite bridge activity or tax: "
                                 "upstream emission/bridge defect")
    return total


def tax_setup(tax_config: Optional[Dict], n_years: int):
    """(income path [Y+1], filing-status / state keywords) of a tax
    configuration (the reference's DEFAULT_TAX_CONFIG when None)."""
    tax_config = dict(DEFAULT_TAX_CONFIG) if tax_config is None \
        else tax_config
    income = simulate_wired_income_path(
        tax_config.get("ordinary_income", 150000), n_years,
        **_income_kwargs(tax_config))
    return income, dict(filing_status=tax_config.get("filing_status",
                                                     "single").lower(),
                        state_code=tax_config.get("state", "CA"))


@contextlib.contextmanager
def _stage(stage_seconds, name, dev):
    """The block as the span ``name``; with ``stage_seconds``, its seconds
    (after the card has finished it) are added to that stage."""
    t0 = time.perf_counter()
    with profiling.span(name):
        yield
    if stage_seconds is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stage_seconds[name] = (stage_seconds.get(name, 0.0)
                               + time.perf_counter() - t0)


def sampled_post_tax_tables(model, fw_dev, time_horizon: int,
                            num_simulations: int, seed: int,
                            tax_config: Optional[Dict],
                            engine_mode: str, random_start_method: str,
                            buffer_days: int, use_antithetic: bool,
                            percentiles,
                            max_tax_sims: Optional[int] = None,
                            cashflows=None, anchors=None,
                            bootstrap_pools=None, *, device="cuda",
                            stage_seconds: Optional[Dict] = None,
                            sample: Optional[Dict] = None) -> Dict:
    """Post-tax tables of the report, with the reference's parameters:
    ``fw_dev`` is the report run's [N, 19] final wealth on ``device``; the
    run's configuration (model, seed, engine mode with its bootstrap
    pools, start method and buffer, pairing, cashflows, anchors) replays
    the sampled trials with emission. Returns {sid: {wealth: {pXX}, cagr:
    {pXX}, median_tax, win_rate_vs_spy_post_tax, n_sampled, method}} for
    the 13 taxable ids. ``stage_seconds``, when given, receives the
    seconds of each stage (pick_rows, replay, bridge, tax, interp_reduce;
    bridge and tax summed over the two bridge groups). ``sample``, when
    a dict, receives the sample each table was drawn from: {sid: {"rows":
    [m] report rows, "wealth": [m] pre-tax final wealth, "tax": [m] exact
    tax}} in sorted-wealth order, as lists; they leave the device in the
    one copy that takes the tables."""
    from letf_tpu_torch.parallel.mc_runner import (
        _Run,
        _trial_layout,
        general_chunk,
    )

    run = _Run(model, time_horizon, num_simulations, seed, None,
               use_antithetic, random_start_method, True, cashflows, anchors,
               device, engine_mode, bootstrap_pools)
    run.buffer_days = int(buffer_days)
    if time_horizon != int(time_horizon):
        raise ValueError("the sampled post-tax tables need a whole number "
                         f"of years, got {time_horizon}")
    n_years = int(time_horizon)
    n = run.num_simulations
    m = min(MAX_TAX_SIMS if max_tax_sims is None else max_tax_sims, n)
    sids = list(cfg.TAXABLE_IDS)
    wcol = {sid: cfg.STRATEGY_INDEX[sid] for sid in sids}
    jcol = {sid: cfg.TAXABLE_IDS.index(sid) for sid in sids}
    dev = fw_dev.device
    dt = glue_dtype(dev)

    with _stage(stage_seconds, "pick_rows", dev):
        # Reference sampling rule: evenly spaced sorted-wealth positions.
        pos = torch.as_tensor(np.linspace(0, n - 1, m, dtype=int),
                              device=dev)
        rows = torch.stack([
            torch.argsort(fw_dev[:n, wcol[sid]], stable=True)[pos]
            for sid in sids])                                     # [13, m]
        rows_h = rows.cpu().numpy()
        uniq = np.unique(rows_h)
        urow = np.searchsorted(uniq, rows_h)                      # [13, m]

    with _stage(stage_seconds, "replay", dev):
        profiling.count("replayed_trials", len(uniq))
        ids, anti = _trial_layout(n, run.use_antithetic)
        _, emission = general_chunk(run, ids[uniq], anti[uniq],
                                    apply_costs=True)
        emission = [e if e.dtype == torch.int8 else e.to(dt)
                    for e in emission]
    income, tax_kw = tax_setup(tax_config, n_years)

    def tax_group(gsids):
        """Exact tax of each (sid, sample) of the group: the sampled rows'
        journal columns as one bridge batch."""
        bidx = torch.as_tensor(np.concatenate(
            [urow[sids.index(s)] for s in gsids]), device=dev)
        cidx = torch.as_tensor(np.concatenate(
            [np.full(m, jcol[s]) for s in gsids]), device=dev)
        stacked = bridge_columns(e[:, bidx, cidx] for e in emission)
        return bridge_tax(stacked, (0, 1) if "S8" in gsids else (0,),
                          n_years, income, tax_kw,
                          stage_seconds).to(dt).reshape(len(gsids), m)

    others = [s for s in sids if s != "S8"]
    tax_map = dict(zip(others, tax_group(others)))
    tax_map["S8"] = tax_group(["S8"])[0]
    with _stage(stage_seconds, "interp_reduce", dev):
        sample_tax = torch.stack([tax_map[s] for s in sids])      # [13, m]
        q = torch.tensor([p / 100.0 for p in percentiles], dtype=dt,
                         device=dev)
        # SPY (S2) is a benchmark id without a journal: post-tax ==
        # pre-tax.
        spy_post = fw_dev[:n, cfg.STRATEGY_INDEX["S2"]].to(dt)
        fans, wins, meds, sws = [], [], [], []
        for i, sid in enumerate(sids):
            w = fw_dev[:n, wcol[sid]].to(dt)
            sw = w[rows[i]]
            o = torch.argsort(sw, stable=True)
            tax_all = interp(w, sw[o], sample_tax[i][o])
            post = torch.clamp_min(w - tax_all, 0.0)
            fans.append(torch.quantile(post, q, interpolation="linear"))
            wins.append((post > spy_post).to(dt).mean())
            meds.append(torch.quantile(tax_all, 0.5,
                                       interpolation="linear"))
            sws.append(sw)
        # One copy to the host: the tables, then the sample.
        parts = [torch.stack(fans), torch.stack(wins), torch.stack(meds),
                 torch.stack(sws), sample_tax]
        host = torch.cat([v.reshape(-1) for v in parts]).cpu().numpy()
        cuts = np.cumsum([v.numel() for v in parts])[:-1]
        fans, wins, meds, sample_w, sample_t = (
            h.reshape(v.shape) for h, v in zip(np.split(host, cuts), parts))

    if sample is not None:
        for i, sid in enumerate(sids):
            sample[sid] = {"rows": rows_h[i].tolist(),
                           "wealth": sample_w[i].tolist(),
                           "tax": sample_t[i].tolist()}

    cap = float(cfg.INITIAL_CAPITAL)
    out = {}
    for i, sid in enumerate(sids):
        out[sid] = {
            "wealth": {f"p{p}": float(v)
                       for p, v in zip(percentiles, fans[i])},
            "cagr": {f"p{p}": float((max(float(v), 1e-12) / cap)
                                    ** (1.0 / time_horizon) - 1.0)
                     for p, v in zip(percentiles, fans[i])},
            "median_tax": float(meds[i]),
            "win_rate_vs_spy_post_tax": float(wins[i]),
            "n_sampled": m,
            "method": "sampled-exact device bridge + on-device interp "
                      f"(<= {m} replayed trials/strategy)",
        }
    return out


def _bridge_groups(strategy_ids, n_here: int):
    """The strategies folded into bridge batches of at most FOLD_ROWS rows
    (trials x strategies), S8 alone: it is the only one that trades the
    SPY leg. Returns [(sids, bridge assets)]."""
    gsz = max(1, FOLD_ROWS // max(n_here, 1))
    others = [s for s in strategy_ids if s != "S8"]
    groups = [(others[g0:g0 + gsz], (0,))
              for g0 in range(0, len(others), gsz)]
    if "S8" in strategy_ids:
        groups.append((["S8"], (0, 1)))
    return groups


def _taxed_chunk(run, ids, anti, strategy_ids, groups, lot_method: str,
                 n_years: int, income, tax_kw: Dict,
                 stage_seconds: Optional[Dict]):
    """One exact-all chunk on ``run``'s device: the general path with
    journal emission, then each bridge batch of ``groups`` through the
    device bridge and the vectorized tax. Returns (final wealth [n, 19],
    per group its total tax [n, G] and its ok flags [n, G]) as device
    tensors."""
    from letf_tpu_torch.parallel.mc_runner import general_chunk

    dev = run.device
    dt = glue_dtype(dev)
    n_here = len(ids)
    with _stage(stage_seconds, "emission", dev):
        summ, emission = general_chunk(run, ids, anti, apply_costs=True)
        emission = [e if e.dtype == torch.int8 else e.to(dt)
                    for e in emission]
        fw = summ["final_wealth"]
        del summ
    lot_cap = None
    if lot_method != "FIFO":
        worst = max(max_buy_events(*bridge_columns(
            e[:, :, cfg.TAXABLE_IDS.index(sid)] for e in emission))
            for sid in strategy_ids)
        lot_cap = max(256, -(-worst // 256) * 256)
    totals, oks = [], []
    for gsids, assets in groups:
        cols = torch.as_tensor([cfg.TAXABLE_IDS.index(s) for s in gsids],
                               device=dev)
        G = len(gsids)
        stacked = bridge_columns(
            e[:, :, cols].reshape(e.shape[0], n_here * G) for e in emission)
        total, ok = bridge_activity_tax(
            stacked, assets, n_years, income, tax_kw, lot_method, lot_cap,
            stage_seconds)
        del stacked
        totals.append(total.reshape(n_here, G))
        oks.append(ok.reshape(n_here, G))
    return fw, totals, oks


def exact_post_tax_all_trials(model, time_horizon: int,
                              num_simulations: int,
                              tax_config: Optional[Dict] = None,
                              strategy_ids: Optional[List[str]] = None,
                              seed: int = 0, chunk_size: int = 4096,
                              percentiles=(10, 25, 50, 75, 90),
                              lot_method: str = "FIFO",
                              on_nonfinite: str = "raise", mesh=None, *,
                              device="cuda",
                              stage_seconds: Optional[Dict] = None,
                              trial_values: Optional[Dict] = None) -> Dict:
    """Exact post-tax percentiles of every trial (the reference's
    ``exact_post_tax_all_trials``): chunks of at most
    ``chunk_size`` trials re-run on the general path with journal
    emission (start method, antithetic pairing and trial layout from the
    configuration), the strategies folded into bridge batches
    (``_bridge_groups``), the device bridge (kernels K7 and K8) and the
    vectorized tax for every trial.

    ``lot_method``: FIFO or one of the six elected orders, whose lot
    capacity is max(256, the chunk's most buy events rounded up to 256).
    ``on_nonfinite``: "raise" fails on a trial with non-finite yearly
    activity or tax, naming the strategy and chunk; "record" drops such
    trials from the percentiles and counts them in ``nonfinite_trials``.
    ``mesh`` (a ``TrialMesh`` of several shards), with FIFO: each full
    chunk whose size the shard count divides runs its emission, bridge and
    tax on each shard's slice of it; partial tails and the elected lot
    orders take the single-device path on the mesh's first device, which
    takes the place of ``device`` (the reference's rule,
    letf_tpu/reporting.py:419-446).
    ``stage_seconds`` receives the seconds of "emission", "bridge", "tax"
    and "reduce"; ``trial_values``, when given, receives {sid: (pre-tax,
    post-tax)} numpy vectors of the kept trials, which the percentiles
    reduce. Returns {sid: {n_trials, nonfinite_trials, median_tax,
    exact_all_trials, pre_tax_pXX, post_tax_pXX}}."""
    from letf_tpu_torch.parallel.mc_runner import (
        _mesh_of,
        _Run,
        _Shards,
        _trial_layout,
    )

    if on_nonfinite not in ("raise", "record"):
        raise ValueError(f"on_nonfinite must be 'raise' or 'record', "
                         f"got {on_nonfinite!r}")
    if lot_method not in ELECTION_METHODS:
        raise ValueError(f"lot_method must be one of {ELECTION_METHODS}, "
                         f"got {lot_method!r}")
    mesh = _mesh_of(mesh, device)
    if strategy_ids is None:
        strategy_ids = list(cfg.TAXABLE_IDS)
    shards = _Shards(mesh, lambda d: _Run(
        model, time_horizon, num_simulations, seed, chunk_size, device=d))
    run = shards.run
    dev = run.device
    n, cs = run.num_simulations, run.chunk_size
    sharded = (mesh.size > 1 and lot_method == "FIFO"
               and cs % mesh.size == 0)
    income, tax_kw = tax_setup(tax_config, time_horizon)
    ids, anti = _trial_layout(n, run.use_antithetic)
    pre = {sid: [] for sid in strategy_ids}
    post = {sid: [] for sid in strategy_ids}
    nonfinite = {sid: 0 for sid in strategy_ids}
    for lo in range(0, n, cs):
        hi = min(n, lo + cs)
        n_here = hi - lo
        groups = _bridge_groups(strategy_ids, n_here)

        def taxed(r, i, a):
            return _taxed_chunk(r, i, a, strategy_ids, groups, lot_method,
                                time_horizon, income, tax_kw, stage_seconds)

        if sharded and n_here == cs:
            outs = shards.map(taxed, ids[lo:hi], anti[lo:hi])
        else:
            outs = [taxed(run, ids[lo:hi], anti[lo:hi])]
        with _stage(stage_seconds, "reduce", dev):
            fw = np.concatenate([o[0].cpu().numpy() for o in outs])
            for g, (gsids, _) in enumerate(groups):
                total = np.concatenate([o[1][g].cpu().numpy() for o in outs])
                ok = np.concatenate([o[2][g].cpu().numpy() for o in outs])
                for gi, sid in enumerate(gsids):
                    w = fw[:, cfg.STRATEGY_INDEX[sid]]
                    bad = ~ok[:, gi]
                    if bad.any():
                        if on_nonfinite == "raise":
                            raise FloatingPointError(
                                f"{sid}: {int(bad.sum())} trial(s) with "
                                "non-finite yearly activity or tax in chunk "
                                f"[{lo}, {hi}): upstream emission/bridge "
                                "defect (pass on_nonfinite='record' to drop "
                                "and count)")
                        nonfinite[sid] += int(bad.sum())
                    pre[sid].append(w[~bad])
                    # Drag capped at 100%, as the reference's tables.
                    post[sid].append(np.maximum(w[~bad] - total[~bad, gi],
                                                0.0))
        del outs

    with _stage(stage_seconds, "reduce", dev):
        out = {}
        for sid in strategy_ids:
            w = np.concatenate(pre[sid])
            pw = np.concatenate(post[sid])
            if trial_values is not None:
                trial_values[sid] = (w, pw)
            entry = {"n_trials": len(w), "nonfinite_trials": nonfinite[sid],
                     "median_tax": float(np.median(w - pw)),
                     "exact_all_trials": True}
            for p in percentiles:
                entry[f"pre_tax_p{p}"] = float(np.percentile(w, p))
                entry[f"post_tax_p{p}"] = float(np.percentile(pw, p))
            out[sid] = entry
    return out


# ---------------------------------------------------------------------------
# The results-list route: per-trial result dicts
# ---------------------------------------------------------------------------

def _exact_tax_via_replay(ctx: Dict, sid: str, n: int, time_horizon: int,
                          tax_config: Dict, chunk_size: int = 4096,
                          replay_cache: Optional[Dict] = None) -> np.ndarray:
    """Exact per-trial tax for trials [0, n) of one strategy by
    deterministic replay: chunks re-run on the general path with journal
    emission, through the device bridge (kernels K7 and K8) and the
    vectorized tax, as ``exact_post_tax_all_trials`` taxes them. Used when
    a results list carries Trade_Replay descriptors instead of trade lists
    (num_simulations > trade_list_limit). ``replay_cache``, when given,
    keeps each chunk's emission for the other strategies of the same
    results (the replay of a chunk is deterministic, so every strategy's
    columns come from one run of it)."""
    from letf_tpu_torch.parallel.mc_runner import (
        _Run,
        _trial_layout,
        general_chunk,
    )

    col = cfg.TAXABLE_IDS.index(sid)
    run = _Run(ctx["model"], time_horizon, ctx["num_simulations"],
               ctx["seed"], chunk_size, ctx["use_antithetic"],
               ctx["random_start_method"], anchors=ctx["anchors"],
               device=ctx["device"], engine_mode=ctx["engine_mode"],
               bootstrap_pools=ctx["bootstrap_pools"])
    dt = glue_dtype(run.device)
    ids, anti = _trial_layout(ctx["num_simulations"], ctx["use_antithetic"])
    income, tax_kw = tax_setup(tax_config, time_horizon)
    cache = {} if replay_cache is None else replay_cache
    taxes = []
    for start in range(0, n, chunk_size):
        stop = min(start + chunk_size, n)
        key = (start, stop)
        if key not in cache:
            _, emission = general_chunk(run, ids[start:stop],
                                        anti[start:stop], apply_costs=True)
            cache[key] = [e if e.dtype == torch.int8 else e.to(dt)
                          for e in emission]
        cols4 = bridge_columns(e[:, :, col] for e in cache[key])
        tax = bridge_tax(cols4, (0, 1) if sid == "S8" else (0,),
                         time_horizon, income, tax_kw)
        taxes.append(tax.cpu().numpy())
    return np.concatenate(taxes)


def _fill_missing_trades(results: List[Dict], sample, sid: str,
                         time_horizon: int) -> None:
    """Materialize Trade_Lists for sampled trials that carry only a
    Trade_Replay descriptor, via one batched deterministic replay.
    Raises if a sampled trial has neither: taxing an absent trade list as
    zero trades would silently report post-tax == pre-tax."""
    missing = [idx for idx in sample
               if results[idx].get("Trade_List") is None]
    if not missing:
        return
    replays = [results[idx].get("Trade_Replay") for idx in missing]
    if any(r is None for r in replays):
        raise ValueError(
            f"{sid}: {len(missing)} sampled trial(s) carry neither "
            "Trade_List nor Trade_Replay: cannot compute post-tax wealth. "
            "Attach trades (trade_list_limit) or use run_monte_carlo + "
            "reporting.exact_post_tax_all_trials for the tensor path.")
    from letf_tpu_torch.parallel.mc_runner import _trade_lists

    # emit_trade_lists' replay, building the trade lists of this strategy
    # alone.
    ctx = replays[0]["ctx"]
    got = _trade_lists(
        ctx["model"], time_horizon, [r["trial"] for r in replays],
        ctx["seed"], ctx["use_antithetic"], ctx["random_start_method"],
        ctx["num_simulations"], True, ctx["engine_mode"],
        ctx["bootstrap_pools"], None, ctx["anchors"], ctx["device"], [sid])
    for idx, rep in zip(missing, replays):
        results[idx]["Trade_List"] = got[rep["trial"]][sid]


def _tax_all_trials(results: List[Dict], time_horizon: int, tax_config: Dict,
                    sid: str, exact_all: bool = False,
                    replay_cache: Optional[Dict] = None,
                    stage_seconds: Optional[Dict] = None) -> np.ndarray:
    """Per-trial tax for a strategy's result list.

    Default: the reference's amortization: exact tax for <= MAX_TAX_SIMS
    trials sampled evenly across sorted wealth (the host tax chain),
    interpolated for the rest. With ``exact_all=True`` every trial is
    taxed exactly: attached trade lists through the host bridge and the
    vectorized tax (float64, on the host), Trade_Replay descriptors through
    ``_exact_tax_via_replay`` (``replay_cache``: its chunk emissions).

    Results whose Trade_List was not materialized must carry a
    Trade_Replay descriptor; the needed trials are replayed. A result with
    neither is a hard error: it is never priced as zero tax.
    ``stage_seconds``, when given, accumulates the host-clock seconds of
    "replay" (trade lists replayed for the sample, or the exact route's
    emission, bridge and tax) and "host_chain" (the host tax chain)."""
    wealth = _wealth(results)
    n = len(results)
    t0 = time.perf_counter()

    def mark(name):
        nonlocal t0
        if stage_seconds is not None:
            stage_seconds[name] = (stage_seconds.get(name, 0.0)
                                   + time.perf_counter() - t0)
        t0 = time.perf_counter()

    if exact_all:
        if all(r.get("Trade_List") is not None for r in results):
            elections = TaxpayerElections()
            yearly = np.stack([
                yearly_activity_from_trades(r["Trade_List"], time_horizon,
                                            elections) for r in results])
            trades_per_year = np.array(
                [len(r["Trade_List"]) / time_horizon for r in results])
            income_path = simulate_wired_income_path(
                tax_config.get("ordinary_income", 150000), time_horizon,
                **_income_kwargs(tax_config))
            out = total_tax_all_trials(
                torch.as_tensor(yearly), torch.as_tensor(income_path),
                cfg.INITIAL_CAPITAL, torch.as_tensor(trades_per_year),
                filing_status=tax_config.get("filing_status",
                                             "single").lower(),
                state_code=tax_config.get("state", "CA"))
            mark("host_chain")
            return out["total_tax"].numpy()
        replay = next((r.get("Trade_Replay") for r in results
                       if r.get("Trade_Replay") is not None), None)
        if replay is None:
            raise ValueError(
                f"{sid}: exact_all tax requested but results carry neither "
                "Trade_List nor Trade_Replay: cannot compute post-tax "
                "wealth (refusing to price missing trades as zero tax).")
        taxes = _exact_tax_via_replay(replay["ctx"], sid, n, time_horizon,
                                      tax_config, replay_cache=replay_cache)
        mark("replay")
        return taxes
    order = np.argsort(wealth)
    if n <= MAX_TAX_SIMS:
        sample = list(range(n))
    else:
        positions = np.linspace(0, n - 1, MAX_TAX_SIMS, dtype=int)
        sample = [int(order[p]) for p in positions]
    _fill_missing_trades(results, sample, sid, time_horizon)
    mark("replay")

    sw, stx = [], []
    for idx in sample:
        trades = results[idx]["Trade_List"]
        if trades:
            tax = process_trades_with_wired_engine(
                trades=trades, time_horizon_years=time_horizon,
                elections=TaxpayerElections(),
                initial_capital=cfg.INITIAL_CAPITAL,
                strategy_id=f"{sid}_bulk", tax_config=tax_config)["total_tax"]
        else:
            tax = 0.0
        sw.append(wealth[idx])
        stx.append(tax)

    sw, stx = np.array(sw), np.array(stx)
    o = np.argsort(sw)
    if n <= MAX_TAX_SIMS:
        all_tax = np.zeros(n)
        for i, idx in enumerate(sample):
            all_tax[idx] = stx[i]
    else:
        all_tax = np.interp(wealth, sw[o], stx[o])
    mark("host_chain")
    return all_tax


def create_summary_statistics(mc_results: Dict[str, List[Dict]],
                              time_horizon: int,
                              tax_config: Optional[Dict] = None,
                              exact_tax_all_trials: bool = False, *,
                              stage_seconds: Optional[Dict] = None) -> Dict:
    """Percentile-fan report of a results list: the Roth (pre-tax) and
    taxable (post-tax) tables, printed as the reference prints them and
    returned {"roth": {sid: row}, "taxable": {sid: row}}.
    ``stage_seconds``, when given, accumulates ``_tax_all_trials``'s
    "replay" and "host_chain" seconds."""
    if tax_config is None:
        tax_config = dict(DEFAULT_TAX_CONFIG)

    horizon = time_horizon
    cap = cfg.INITIAL_CAPITAL
    out: Dict[str, Dict] = {"roth": {}, "taxable": {}}
    replay_cache: Dict = {}

    spy_results = mc_results.get("S2", [])
    spy_wealth = _wealth(spy_results) if spy_results else np.array([])

    # Market scenario banner keyed to SPY percentiles.
    if len(spy_wealth):
        print(f"\n{'=' * 100}")
        print(f"MARKET SCENARIOS FOR THE {horizon}-YEAR HORIZON (SPY reference)")
        print(f"{'=' * 100}")
        for _, pv in _PCTS:
            if pv == 50:
                continue
            w = np.percentile(spy_wealth, pv)
            cagr = (w / cap) ** (1 / horizon) - 1
            print(explain_percentile(pv, cagr * 100, horizon, cagr * 100),
                  end="")

    # ---------------- Roth table ----------------
    print(f"\n{'=' * 110}")
    print(f"ROTH IRA COMPATIBLE - {horizon}-YEAR HORIZON (pre-tax)")
    print(f"{'=' * 110}")
    header = (f"{'Rank':<5}{'ID':<5}{'Strategy':<20}{'Win%':>7}"
              + "".join(f"{p:>9}" for p, _ in _PCTS[:3])
              + f"{'Median$':>10}{'CAGR':>8}"
              + "".join(f"{p:>9}" for p, _ in _PCTS[3:])
              + f"{'MaxDD':>8}{'Trd/Y':>7}")
    print(header)
    print("-" * 110)

    roth_rows = []
    for sid in cfg.ROTH_IDS:
        if not mc_results.get(sid):
            continue
        results = mc_results[sid]
        wealth = _wealth(results)
        row = {
            "id": sid, "name": cfg.STRATEGIES[sid]["name"],
            "median": float(np.median(wealth)),
            "cagr": (np.median(wealth) / cap) ** (1 / horizon) - 1,
            "max_dd": float(np.median([r.get("Max_DD", 0) for r in results])),
            "trades": float(np.mean([r.get("Trades_Per_Year", 0)
                                     for r in results])),
            "win": (float(np.mean(wealth > spy_wealth) * 100)
                    if len(spy_wealth) == len(wealth) else 0.0),
        }
        for pn, pv in _PCTS:
            row[pn] = float(np.percentile(wealth, pv))
        roth_rows.append(row)
        out["roth"][sid] = row

    roth_rows.sort(key=lambda x: x["median"], reverse=True)
    for i, d in enumerate(roth_rows, 1):
        print(f"{i:<5}{d['id']:<5}{d['name']:<20}{d['win']:>6.1f}%"
              + "".join(f"{d[p]:>9,.0f}" for p, _ in _PCTS[:3])
              + f"{d['median']:>10,.0f}{d['cagr'] * 100:>7.2f}%"
              + "".join(f"{d[p]:>9,.0f}" for p, _ in _PCTS[3:])
              + f"{d['max_dd'] * 100:>7.1f}%{d['trades']:>7.1f}")

    # ---------------- Taxable table ----------------
    print(f"\n{'=' * 110}")
    print(f"TAXABLE BROKERAGE - {horizon}-YEAR HORIZON "
          f"({tax_config.get('state_name', tax_config.get('state'))}, "
          f"${tax_config.get('ordinary_income', 0):,}, "
          f"{tax_config.get('filing_status', 'single')})")
    print(f"{'=' * 110}")
    print(f"{'Rank':<5}{'ID':<5}{'Strategy':<24}{'PreTax$':>12}{'PostTax$':>12}"
          f"{'PostCAGR':>10}{'Win%':>7}{'MaxDD':>8}{'Trd/Y':>8}")
    print("-" * 110)

    # SPY post-tax cache reused for every taxable win-rate comparison.
    spy_post_tax = None
    if spy_results:
        if any(r.get("Trade_List") or r.get("Trade_Replay")
               for r in spy_results):
            spy_taxes = _tax_all_trials(spy_results, horizon, tax_config,
                                        "SPY",
                                        exact_all=exact_tax_all_trials,
                                        replay_cache=replay_cache,
                                        stage_seconds=stage_seconds)
            spy_post_tax = spy_wealth - spy_taxes
        else:
            # Reference behavior (reporting.py:426-437): SPY results carrying
            # no trade list compare post-tax == pre-tax by design (S2 is a
            # benchmark id with no journal). The hard missing-trades error in
            # _tax_all_trials applies to TAXABLE strategies only.
            spy_post_tax = spy_wealth.copy()

    tax_rows = []
    for sid in cfg.TAXABLE_IDS:
        if not mc_results.get(sid):
            continue
        results = mc_results[sid]
        wealth = _wealth(results)
        if not len(wealth):
            continue
        taxes = _tax_all_trials(results, horizon, tax_config, sid,
                                exact_all=exact_tax_all_trials,
                                replay_cache=replay_cache,
                                stage_seconds=stage_seconds)
        post = wealth - taxes

        pcts = {}
        for pn, pv in _PCTS:
            pre_w = float(np.percentile(wealth, pv))
            post_w = float(np.percentile(post, pv))
            pre_cagr = (pre_w / cap) ** (1 / horizon) - 1
            post_cagr = ((post_w / cap) ** (1 / horizon) - 1
                         if post_w > 0 else float("nan"))
            if pre_cagr > 0.001 and not np.isnan(post_cagr):
                drag = min((pre_cagr - post_cagr) / pre_cagr * 100, 100.0)
            elif pre_cagr > 0.001:
                drag = 100.0
            else:
                drag = 0.0
            pcts[pn] = {"pre_wealth": pre_w, "post_wealth": post_w,
                        "pre_cagr": pre_cagr, "post_cagr": post_cagr,
                        "drag": drag, "tax_paid": pre_w - post_w}

        if spy_post_tax is not None and len(spy_post_tax) == len(post):
            win = float(np.mean(post > spy_post_tax) * 100)
        elif len(spy_wealth) == len(wealth):
            win = float(np.mean(wealth > spy_wealth) * 100)
        else:
            win = 0.0

        row = {
            "id": sid, "name": cfg.STRATEGIES[sid]["name"], "pcts": pcts,
            "max_dd": float(np.median([r.get("Max_DD", 0) for r in results])),
            "trades": float(np.mean([r.get("Trades_Per_Year", 0)
                                     for r in results])),
            "win": win,
        }
        tax_rows.append(row)
        out["taxable"][sid] = row
    del replay_cache

    # Ranked by P60 post-tax wealth (reference reporting.py:563).
    tax_rows.sort(key=lambda x: x["pcts"]["p60"]["post_wealth"], reverse=True)
    for i, d in enumerate(tax_rows, 1):
        p60 = d["pcts"]["p60"]
        post_cagr = (p60["post_cagr"] * 100 if not np.isnan(p60["post_cagr"])
                     else float("nan"))
        print(f"{i:<5}{d['id']:<5}{d['name']:<24}{p60['pre_wealth']:>12,.0f}"
              f"{p60['post_wealth']:>12,.0f}{post_cagr:>9.2f}%"
              f"{d['win']:>6.1f}%{d['max_dd'] * 100:>7.1f}%{d['trades']:>8.1f}")
    print("-" * 110)
    print("Ranked by P60 post-tax wealth. Drag capped at 100% (IRC §1211 "
          "asymmetry: gains taxed fully, losses deductible $3k/yr).")

    # ---------------- top-5 percentile detail ----------------
    print("\nPERCENTILE DETAIL - top 5 post-tax strategies")
    print("-" * 110)
    for d in tax_rows[:5]:
        print(f"\n{d['name']} ({d['id']})")
        hdr = f"{'':>8}" + "".join(f"{pn.upper():>14}" for pn, _ in _PCTS)
        print(hdr)
        for label, key, fmt in (("Pre:", "pre_wealth", ",.0f"),
                                ("Post:", "post_wealth", ",.0f"),
                                ("Drag:", "drag", ".1f")):
            line = f"{label:>8}"
            for pn, _ in _PCTS:
                line += f"{d['pcts'][pn][key]:>14{fmt}}"
            print(line)
    print("=" * 110)

    return out
