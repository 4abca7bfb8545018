"""Orchestrator: the full analysis, and the production report.

The port's copy of ``letf_tpu/runner.py`` (reference letf/__init__.py:
19-202):

- ``run`` (``:101``): golden tax gate -> date selection -> data -> tax
  configuration -> calibration (6 models) -> validation battery -> per
  horizon the results-list Monte Carlo (``parallel_monte_carlo_fixed``),
  the summary statistics (``create_summary_statistics``) and the
  historical comparison -> timing summary. Returns {horizon: summary}.
- ``run_report`` (``:21-98``): the golden tax gate, then (without a model)
  the offline history and the calibration of every model, then one
  ``monte_carlo_report`` per horizon, printing the reference's tables.

The fits, the Monte Carlo and the kernels run on ``device``.
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
        force_synthetic: bool = False, *, device="cuda",
        stage_seconds: Optional[Dict] = None) -> Dict:
    """Run the complete analysis on ``device``. Returns {horizon: summary
    dict} (the reference only prints). ``stage_seconds``, when given,
    receives each step's host-clock seconds (the device synchronised at
    each step's end) under the timing summary's labels, and each
    horizon's replay and host tax chain seconds inside its summary
    statistics ("Summary stats <h>Y: replay" / ": host tax chain")."""
    import torch

    from letf_tpu_torch import config as cfg
    from letf_tpu_torch.tax.engine import run_golden_tests

    dev = resolve_device(device)
    run_start = time.perf_counter()
    step_times = []
    stages = {} if stage_seconds is None else stage_seconds

    def _step(label: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if step_times:
            prev_label, prev_start = step_times[-1]
            stages[prev_label] = now - prev_start
            print(f"  [{_fmt_elapsed(now - prev_start)}] {prev_label}")
        step_times.append((label, now))

    cfg.init_cache()
    cfg.print_banner(dev)

    # Mandatory gate: abort on any golden-test failure.
    _step("Tax engine validation")
    run_golden_tests(trace_failures=True)

    from letf_tpu_torch.calibration import calibrate_all
    from letf_tpu_torch.data import fetch_historical_data
    from letf_tpu_torch.historical import (
        compare_simulated_vs_historical,
        compare_simulated_vs_synthetic_historical,
    )
    from letf_tpu_torch.parallel.mc_runner import parallel_monte_carlo_fixed
    from letf_tpu_torch.reporting import (
        STATE_TAX_INFO,
        create_summary_statistics,
        get_tax_config_interactive,
    )
    from letf_tpu_torch.ui import (
        get_start_date_interactive,
        validate_time_horizons_for_start_date,
    )
    from letf_tpu_torch.validation import run_validation_tests

    _step("Date selection")
    selected_start, selected_end = get_start_date_interactive()
    print(f"  Using date range: {selected_start} to {selected_end}")

    _step("Fetch historical data")
    df = fetch_historical_data(force_synthetic=force_synthetic)

    _step("Tax configuration")
    tax_config = get_tax_config_interactive()
    if tax_overrides:
        tax_config.update(tax_overrides)
        if "state" in tax_overrides:
            tax_config["state_name"] = STATE_TAX_INFO[
                tax_overrides["state"]]["name"]

    _step("Calibration (all models)")
    regime_model, correlation_matrices = calibrate_all(df, device=dev)

    _step("Validation tests")
    run_validation_tests(df=df, regime_model=regime_model, device=dev)

    requested = horizons if horizons else [10, 20, 30]
    time_horizons = validate_time_horizons_for_start_date(
        cfg.ANALYSIS_START_DATE, requested)
    if not time_horizons:
        print("\nERROR: Not enough data for any requested time horizon!")
        return {}

    summaries: Dict[int, Dict] = {}
    subs: Dict[str, float] = {}
    for horizon in time_horizons:
        print(f"\n{'=' * 80}")
        print(f"MONTE CARLO SIMULATION: {horizon}-YEAR HORIZON")
        print(f"{'=' * 80}")

        _step(f"MC simulation {horizon}Y")
        mc_results = parallel_monte_carlo_fixed(
            strategy_ids=list(cfg.STRATEGIES.keys()),
            time_horizon=horizon,
            regime_model=regime_model,
            correlation_matrices=correlation_matrices,
            historical_df=df,
            seed=seed, device=dev,
        )

        _step(f"Summary stats {horizon}Y")
        tax_stages: Dict[str, float] = {}
        summaries[horizon] = create_summary_statistics(
            mc_results, horizon, tax_config=tax_config,
            stage_seconds=tax_stages)
        subs[f"Summary stats {horizon}Y: replay"] = tax_stages.get(
            "replay", 0.0)
        subs[f"Summary stats {horizon}Y: host tax chain"] = tax_stages.get(
            "host_chain", 0.0)

        _step(f"Historical comparison {horizon}Y")
        compare_simulated_vs_historical(df, mc_results, horizon, device=dev)
        compare_simulated_vs_synthetic_historical(df, mc_results, horizon)

    _step("done")
    stages.update(subs)
    total = time.perf_counter() - run_start
    print("\n" + "=" * 80)
    print("TIMING SUMMARY")
    print("=" * 80)
    for i in range(len(step_times) - 1):
        label, start = step_times[i]
        _, end = step_times[i + 1]
        pct = (end - start) / total * 100 if total > 0 else 0
        print(f"  {label:<40s} {_fmt_elapsed(end - start):>8s}  ({pct:5.1f}%)")
        for part in ("replay", "host tax chain"):
            sub = subs.get(f"{label}: {part}")
            if sub is not None:
                print(f"    {part:<38s} {_fmt_elapsed(sub):>8s}")
    print(f"  {'TOTAL':<40s} {_fmt_elapsed(total):>8s}")
    print("\nANALYSIS COMPLETE")
    return summaries
