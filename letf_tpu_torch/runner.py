"""Orchestrator: the production report from the data to the fans.

The port's copy of ``letf_tpu/runner.py::run_report`` (:21-98): the golden
tax gate, then (without a model) the offline history and the calibration
of every model, then one ``monte_carlo_report`` per horizon, printing the
reference's tables. The fits and the reports run on ``device``.

``run`` (the reference's full analysis: date and tax menus, validation
battery, results lists, summary statistics, historical comparison) is
ROADMAP item 16 and raises.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from letf_tpu_torch.utils.device import resolve_device


def _fmt_elapsed(seconds: float) -> str:
    if seconds < 60:
        return f"{seconds:.1f}s"
    m, s = divmod(seconds, 60)
    return f"{int(m)}m {s:.1f}s"


def run_report(horizons: Optional[List[int]] = None,
               num_simulations: Optional[int] = None, seed: int = 0,
               force_synthetic: bool = False, model=None,
               chunk_size: Optional[int] = None,
               chunks_per_dispatch: Optional[int] = None,
               tax_overrides: Optional[Dict] = None,
               tax_mode: str = "sampled", *, device="cuda",
               stage_seconds: Optional[Dict] = None) -> Dict:
    """Production at-scale report pipeline: calibrate, then run each
    horizon through ``monte_carlo_report`` (the chunk loop with the
    percentile report reduced on the device). Returns {horizon: report
    dict} with both pre- and post-tax fans (tax_mode: sampled / exact_all
    / none).

    ``model``: an optional pre-built SimModel or calibration dict; it skips
    the data and the calibration. ``stage_seconds``, if given, receives
    the host-clock seconds of ``data``, ``calibration`` and each
    ``horizon_<n>`` (the device synchronised at each end)."""
    import torch

    from letf_tpu_torch import config as cfg
    from letf_tpu_torch.parallel.mc_runner import monte_carlo_report
    from letf_tpu_torch.reporting import DEFAULT_TAX_CONFIG, STATE_TAX_INFO
    from letf_tpu_torch.tax.engine import run_golden_tests

    dev = resolve_device(device)
    stages = {} if stage_seconds is None else stage_seconds

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run_golden_tests(trace_failures=True)
    if model is None:
        from letf_tpu_torch.calibration import calibrate_all
        from letf_tpu_torch.data import fetch_historical_data

        t0 = time.perf_counter()
        df = fetch_historical_data(force_synthetic=force_synthetic)
        t1 = time.perf_counter()
        model, _ = calibrate_all(df, device=dev)
        sync()
        stages["data"] = t1 - t0
        stages["calibration"] = time.perf_counter() - t1

    tax_config = dict(DEFAULT_TAX_CONFIG)
    if tax_overrides:
        tax_config.update(tax_overrides)
        if "state" in tax_overrides:
            tax_config["state_name"] = STATE_TAX_INFO[
                tax_overrides["state"]]["name"]

    reports: Dict[int, Dict] = {}
    for horizon in (horizons or [10, 20, 30]):
        t0 = time.perf_counter()
        rep = monte_carlo_report(
            model, horizon, num_simulations=num_simulations, seed=seed,
            chunk_size=chunk_size, chunks_per_dispatch=chunks_per_dispatch,
            tax_config=tax_config, tax_mode=tax_mode, device=dev)
        sync()
        dt = time.perf_counter() - t0
        stages[f"horizon_{horizon}"] = dt
        reports[horizon] = rep
        print(f"\n{'=' * 72}")
        print(f"AT-SCALE REPORT: {rep['n_trials']:,} trials x {horizon}y "
              f"({_fmt_elapsed(dt)}; valid {rep['valid_frac']:.4f})")
        print(f"{'=' * 72}")
        hdr = "  ".join(f"p{p:<4d}" for p in rep["percentiles"])
        print(f"  {'sid':<4s} {'name':<28s} {hdr}  win%  mdd")
        for sid, s in rep["strategies"].items():
            fan = "  ".join(f"{s['wealth'][f'p{p}']:>5.0f}"
                            for p in rep["percentiles"])
            name = cfg.STRATEGIES.get(sid, {}).get("name", "")[:28]
            print(f"  {sid:<4s} {name:<28s} {fan}  "
                  f"{100 * s['win_rate_vs_spy']:4.0f}  "
                  f"{s['median_max_dd']:.2f}")
        if tax_mode != "none":
            print(f"\n  TAXABLE (post-tax, {tax_config['state']} "
                  f"${tax_config['ordinary_income']:,} "
                  f"{tax_config['filing_status']}; "
                  f"{tax_mode}; +{rep.get('post_tax_seconds', 0):.1f}s)")
            print(f"  {'sid':<4s} {'name':<28s} {hdr}  win%  medTax")
            for sid, s in rep["strategies"].items():
                pt = s.get("post_tax")
                if pt is None:
                    continue
                fan = "  ".join(f"{pt['wealth'][f'p{p}']:>5.0f}"
                                for p in rep["percentiles"])
                name = cfg.STRATEGIES.get(sid, {}).get("name", "")[:28]
                win = pt.get("win_rate_vs_spy_post_tax")
                win_s = f"{100 * win:4.0f}" if win is not None else "   -"
                print(f"  {sid:<4s} {name:<28s} {fan}  {win_s}  "
                      f"{pt['median_tax']:>7.0f}")
    return reports


def run(horizons: Optional[List[int]] = None, seed: int = 0,
        tax_overrides: Optional[Dict] = None,
        force_synthetic: bool = False) -> Dict:
    """The reference's complete analysis (``letf_tpu/runner.py:101``)."""
    raise NotImplementedError(
        "runner.run (menus, validation battery, results lists, summary "
        "statistics, historical comparison) is not ported yet: ROADMAP "
        "item 16; runner.run_report is")
