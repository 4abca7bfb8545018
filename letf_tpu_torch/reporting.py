"""The report's sampled post-tax tables.

Port of ``letf_tpu/reporting.py::sampled_post_tax_tables``, the reference's
tax amortization (reporting.py:455-509) at report scale: per taxable
strategy, <= ``MAX_TAX_SIMS`` trial rows sampled evenly across its sorted
final wealth (a stable argsort: ruined trials tie at 0); one replay of
their union on the general path with journal emission; the FIFO device
bridge (kernels K7 and K8) and the vectorized tax for each sample, in two
bridge groups (the 12 strategies that trade TQQQ alone, then S8, the only
one that trades the SPY leg); the tax spread over all N trials by linear
interpolation on the sampled wealths; post-tax fans and win rates vs SPY
reduced on the device.

The port keeps its own copies of the reference's tax configuration
(``DEFAULT_TAX_CONFIG``, ``MAX_TAX_SIMS``, ``_income_kwargs``) and of the
income path (``letf_tpu_torch/income.py``).

The interpolation is a plain index lookup (``torch.searchsorted`` plus
gathers) in the working precision; the reference's one-hot matmul was a
TPU workaround. The bridge and tax run in the glue dtype (float64 on the
CPU, float32 on the card, as on the TPU).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from letf_tpu_torch import config as cfg
from letf_tpu_torch.income import simulate_wired_income_path
from letf_tpu_torch.tax.device_bridge import yearly_activity_from_emission
from letf_tpu_torch.tax.vectorized import total_tax_all_trials
from letf_tpu_torch.utils.device import glue_dtype

# The reference's sampled-tax budget and default tax configuration
# (letf_tpu/reporting.py:42-51).
MAX_TAX_SIMS = 50
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


def bridge_tax(stacked, assets: tuple, n_years: int, income, tax_kw: Dict,
               stage_seconds: Optional[Dict] = None):
    """Exact tax of each journal column of one bridge batch: ``stacked``
    the (alloc, value, price, asset) [S, R] emission columns, ``assets``
    the bridge assets the batch may trade. Raises when a skipped asset
    sold shares or a tax is not finite. Returns total tax [R];
    ``stage_seconds`` accumulates the "bridge" and "tax" seconds."""
    dev = stacked[0].device
    t0 = time.perf_counter()
    activity, n_trades, viol = yearly_activity_from_emission(
        *stacked, n_years=n_years, assets=assets)
    if bool(viol):
        raise RuntimeError("a statically-skipped bridge asset sold shares "
                           f"(assets {assets})")
    t0 = _mark(stage_seconds, "bridge", t0, dev)
    total = total_tax_all_trials(
        activity[..., :4], income, cfg.INITIAL_CAPITAL,
        n_trades.to(activity.dtype) / n_years, **tax_kw)["total_tax"]
    if not (bool(torch.isfinite(activity).all())
            and bool(torch.isfinite(total).all())):
        raise FloatingPointError("non-finite bridge activity or tax: "
                                 "upstream emission/bridge defect")
    _mark(stage_seconds, "tax", t0, dev)
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
