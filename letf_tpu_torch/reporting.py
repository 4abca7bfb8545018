"""The report's post-tax tables: sampled, and exact over every trial.

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
TPU workaround. The bridge and tax run in the glue dtype (float64 on the
CPU, float32 on the card, as on the TPU).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.income import simulate_wired_income_path
from letf_tpu_torch.tax.device_bridge import (
    ELECTION_METHODS,
    max_buy_events,
    yearly_activity_from_emission,
)
from letf_tpu_torch.tax.vectorized import total_tax_all_trials
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
DEFAULT_TAX_CONFIG = {
    "state": "CA", "state_name": "California",
    "ordinary_income": 150000, "filing_status": "single",
    "career_stage": "mid", "years_until_retirement": None,
    "retirement_income": None,
}


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


def bridge_activity_tax(stacked, assets: tuple, n_years: int, income,
                        tax_kw: Dict, method: str = "FIFO",
                        lot_capacity: Optional[int] = None,
                        stage_seconds: Optional[Dict] = None):
    """Exact tax of each journal column of one bridge batch: ``stacked``
    the (alloc, value, price, asset) [S, R] emission columns, ``assets``
    the bridge assets the batch may trade, ``method`` / ``lot_capacity``
    the lot election. Raises when a skipped asset sold shares. Returns
    (total tax [R], ok [R]: the trial's yearly activity and tax are all
    finite); ``stage_seconds`` accumulates the "bridge" and "tax"
    seconds."""
    dev = stacked[0].device
    t0 = time.perf_counter()
    activity, n_trades, viol = yearly_activity_from_emission(
        *stacked, n_years=n_years, method=method, lot_capacity=lot_capacity,
        assets=assets)
    if bool(viol):
        raise RuntimeError("a statically-skipped bridge asset sold shares "
                           f"(assets {assets})")
    t0 = _mark(stage_seconds, "bridge", t0, dev)
    total = total_tax_all_trials(
        activity[..., :4], income, cfg.INITIAL_CAPITAL,
        n_trades.to(activity.dtype) / n_years, **tax_kw)["total_tax"]
    # The tax engine propagates non-finite inputs, so the activity and
    # the total are both checked (a -inf gain can net to a finite tax).
    ok = torch.isfinite(activity).all(dim=(1, 2)) & torch.isfinite(total)
    _mark(stage_seconds, "tax", t0, dev)
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


def _mark(stage_seconds, name, t0, dev):
    """Add the seconds since t0 to a stage (after the card has finished
    it); returns the new start."""
    if stage_seconds is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stage_seconds[name] = (stage_seconds.get(name, 0.0)
                               + time.perf_counter() - t0)
    return time.perf_counter()


def sampled_post_tax_tables(run, fw, time_horizon: int, percentiles,
                            tax_config: Optional[Dict] = None,
                            max_tax_sims: Optional[int] = None,
                            stage_seconds: Optional[Dict] = None) -> Dict:
    """Post-tax tables of the report. ``run``: the report's resolved
    configuration (parallel.mc_runner._Run: model, key, trial layout,
    horizon, buffer, cashflows); ``fw``: its [N, 19] final wealth on the
    device. Returns {sid: {wealth: {pXX}, cagr: {pXX}, median_tax,
    win_rate_vs_spy_post_tax, n_sampled, method}} for the 13 taxable ids.
    ``stage_seconds``, when given, receives the seconds of each stage
    (pick_rows, replay, bridge, tax, interp_reduce; bridge and tax summed
    over the two bridge groups)."""
    from letf_tpu_torch.parallel.mc_runner import _trial_layout, general_chunk

    if time_horizon != int(time_horizon):
        raise ValueError("the sampled post-tax tables need a whole number "
                         f"of years, got {time_horizon}")
    n_years = int(time_horizon)
    n = run.num_simulations
    m = min(MAX_TAX_SIMS if max_tax_sims is None else max_tax_sims, n)
    sids = list(cfg.TAXABLE_IDS)
    wcol = {sid: cfg.STRATEGY_INDEX[sid] for sid in sids}
    jcol = {sid: cfg.TAXABLE_IDS.index(sid) for sid in sids}
    dev = fw.device
    dt = glue_dtype(dev)
    t0 = time.perf_counter()

    # Reference sampling rule: evenly spaced sorted-wealth positions.
    pos = torch.as_tensor(np.linspace(0, n - 1, m, dtype=int), device=dev)
    rows = torch.stack([torch.argsort(fw[:n, wcol[sid]], stable=True)[pos]
                        for sid in sids])                         # [13, m]
    rows_h = rows.cpu().numpy()
    uniq = np.unique(rows_h)
    urow = np.searchsorted(uniq, rows_h)                          # [13, m]
    t0 = _mark(stage_seconds, "pick_rows", t0, dev)

    ids, anti = _trial_layout(n, run.use_antithetic)
    _, emission = general_chunk(run, ids[uniq], anti[uniq], apply_costs=True)
    emission = [e if e.dtype == torch.int8 else e.to(dt) for e in emission]
    t0 = _mark(stage_seconds, "replay", t0, dev)
    income, tax_kw = tax_setup(tax_config, n_years)

    def tax_group(gsids):
        """Exact tax of each (sid, sample) of the group: the sampled rows'
        journal columns as one bridge batch."""
        bidx = torch.as_tensor(np.concatenate(
            [urow[sids.index(s)] for s in gsids]), device=dev)
        cidx = torch.as_tensor(np.concatenate(
            [np.full(m, jcol[s]) for s in gsids]), device=dev)
        stacked = [e[:, bidx, cidx] for e in emission]            # [S, R]
        return bridge_tax(stacked, (0, 1) if "S8" in gsids else (0,),
                          n_years, income, tax_kw,
                          stage_seconds).reshape(len(gsids), m)

    others = [s for s in sids if s != "S8"]
    tax_map = dict(zip(others, tax_group(others)))
    tax_map["S8"] = tax_group(["S8"])[0]
    t0 = time.perf_counter()
    sample_tax = torch.stack([tax_map[s] for s in sids])          # [13, m]

    q = torch.tensor([p / 100.0 for p in percentiles], dtype=dt, device=dev)
    # SPY (S2) is a benchmark id without a journal: post-tax == pre-tax.
    spy_post = fw[:n, cfg.STRATEGY_INDEX["S2"]].to(dt)
    fans, wins, meds = [], [], []
    for i, sid in enumerate(sids):
        w = fw[:n, wcol[sid]].to(dt)
        sw = w[rows[i]]
        o = torch.argsort(sw, stable=True)
        tax_all = interp(w, sw[o], sample_tax[i][o])
        post = torch.clamp_min(w - tax_all, 0.0)
        fans.append(torch.quantile(post, q, interpolation="linear"))
        wins.append((post > spy_post).to(dt).mean())
        meds.append(torch.quantile(tax_all, 0.5, interpolation="linear"))
    fans, wins, meds = (torch.stack(v).cpu().numpy()
                        for v in (fans, wins, meds))
    _mark(stage_seconds, "interp_reduce", t0, dev)

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
    ``exact_post_tax_all_trials``, single device): chunks of at most
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
    A ``mesh`` raises: multi-device runs are ROADMAP section 1 item 17.
    ``stage_seconds`` receives the seconds of "emission", "bridge", "tax"
    and "reduce"; ``trial_values``, when given, receives {sid: (pre-tax,
    post-tax)} numpy vectors of the kept trials, which the percentiles
    reduce. Returns {sid: {n_trials, nonfinite_trials, median_tax,
    exact_all_trials, pre_tax_pXX, post_tax_pXX}}."""
    from letf_tpu_torch.parallel.mc_runner import (
        _check_single_device,
        _Run,
        _trial_layout,
        general_chunk,
    )

    if on_nonfinite not in ("raise", "record"):
        raise ValueError(f"on_nonfinite must be 'raise' or 'record', "
                         f"got {on_nonfinite!r}")
    if lot_method not in ELECTION_METHODS:
        raise ValueError(f"lot_method must be one of {ELECTION_METHODS}, "
                         f"got {lot_method!r}")
    _check_single_device(mesh)
    if strategy_ids is None:
        strategy_ids = list(cfg.TAXABLE_IDS)
    run = _Run(model, time_horizon, num_simulations, seed, chunk_size,
               device=device)
    dev = run.device
    dt = glue_dtype(dev)
    n = run.num_simulations
    income, tax_kw = tax_setup(tax_config, time_horizon)
    ids, anti = _trial_layout(n, run.use_antithetic)
    pre = {sid: [] for sid in strategy_ids}
    post = {sid: [] for sid in strategy_ids}
    nonfinite = {sid: 0 for sid in strategy_ids}
    for lo in range(0, n, run.chunk_size):
        hi = min(n, lo + run.chunk_size)
        n_here = hi - lo
        t0 = time.perf_counter()
        summ, emission = general_chunk(run, ids[lo:hi], anti[lo:hi],
                                       apply_costs=True)
        emission = [e if e.dtype == torch.int8 else e.to(dt)
                    for e in emission]
        fw = summ["final_wealth"]
        del summ
        _mark(stage_seconds, "emission", t0, dev)
        lot_cap = None
        if lot_method != "FIFO":
            worst = max(max_buy_events(
                *(e[:, :, cfg.TAXABLE_IDS.index(sid)] for e in emission))
                for sid in strategy_ids)
            lot_cap = max(256, -(-worst // 256) * 256)
        for gsids, assets in _bridge_groups(strategy_ids, n_here):
            cols = torch.as_tensor([cfg.TAXABLE_IDS.index(s) for s in gsids],
                                   device=dev)
            G = len(gsids)
            stacked = [e[:, :, cols].reshape(e.shape[0], n_here * G)
                       for e in emission]
            total, ok = bridge_activity_tax(
                stacked, assets, time_horizon, income, tax_kw, lot_method,
                lot_cap, stage_seconds)
            del stacked
            t0 = time.perf_counter()
            total = total.reshape(n_here, G).cpu().numpy()
            ok = ok.reshape(n_here, G).cpu().numpy()
            for gi, sid in enumerate(gsids):
                w = fw[:, cfg.STRATEGY_INDEX[sid]].cpu().numpy()
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
                post[sid].append(np.maximum(w[~bad] - total[~bad, gi], 0.0))
            _mark(stage_seconds, "reduce", t0, dev)
        del emission, fw

    t0 = time.perf_counter()
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
    _mark(stage_seconds, "reduce", t0, dev)
    return out
