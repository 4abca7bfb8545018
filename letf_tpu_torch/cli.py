"""Command-line interface: ``python -m letf_tpu_torch.cli [options]``.

The reference's flags and defaults (``letf_tpu/cli.py``) plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions), which stands
in for the JAX package's platform choice. The default branch runs the full
analysis (``runner.run``), ``--report`` the production report
(``runner.run_report``), ``--quick`` the smoke test (``quick.main``: 10
sims x 10y over S1-S3). Without ``--interactive`` the date and tax menus
take their defaults (``LETF_NON_INTERACTIVE=1``), as in the reference.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="letf_tpu_torch",
        description="Leveraged-ETF Monte Carlo framework, PyTorch/CUDA port")
    p.add_argument("--interactive", action="store_true",
                   help="enable interactive date/tax menus")
    p.add_argument("--sims", type=int, default=None,
                   help="simulations per horizon (default config)")
    p.add_argument("--horizons", type=int, nargs="+", default=None,
                   help="time horizons in years (default 10 20 30)")
    p.add_argument("--start-date", type=str, default=None,
                   help="analysis start date YYYY-MM-DD")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--state", type=str, default="CA",
                   choices=["CA", "NY", "TX", "FL", "WA", "NV", "IL", "MA", "NJ"])
    p.add_argument("--income", type=int, default=150000)
    p.add_argument("--filing", type=str, default="single",
                   choices=["single", "married"])
    p.add_argument("--synthetic-data", action="store_true",
                   help="force the offline synthetic market history")
    p.add_argument("--quick", action="store_true",
                   help="10 sims x 10y, strategies S1-S3")
    p.add_argument("--report", action="store_true",
                   help="at-scale production report: full percentile fans "
                        "reduced on device, pre- AND post-tax (honors "
                        "--state/--income/--filing; scales to 1M+ trials; "
                        "pair with --sims)")
    p.add_argument("--tax-mode", type=str, default="sampled",
                   choices=["sampled", "exact_all", "none"],
                   help="--report taxable tables: sampled (reference "
                        "amortization, <=50 exact trials/strategy + "
                        "device interp), exact_all (every trial taxed "
                        "exactly; minutes at 1M), none (pre-tax only)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="where the fits, the Monte Carlo and the reports "
                        "run (cuda: the hand-written kernels; cpu: their "
                        "plain versions)")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not args.interactive:
        os.environ["LETF_NON_INTERACTIVE"] = "1"

    from letf_tpu_torch import config as cfg

    if args.sims is not None:
        cfg.NUM_SIMULATIONS = args.sims
    if args.start_date:
        cfg.ANALYSIS_START_DATE = args.start_date

    if args.quick:
        cfg.NUM_SIMULATIONS = args.sims or 10
        from letf_tpu_torch import quick
        quick.main(device=args.device, force_synthetic=args.synthetic_data)
        return

    if args.report:
        from letf_tpu_torch.runner import run_report
        run_report(horizons=args.horizons, num_simulations=args.sims,
                   seed=args.seed, force_synthetic=args.synthetic_data,
                   tax_overrides={"state": args.state,
                                  "ordinary_income": args.income,
                                  "filing_status": args.filing},
                   tax_mode=args.tax_mode, device=args.device)
        return

    from letf_tpu_torch.runner import run
    run(horizons=args.horizons, seed=args.seed,
        tax_overrides={"state": args.state, "ordinary_income": args.income,
                       "filing_status": args.filing},
        force_synthetic=args.synthetic_data, device=args.device)


if __name__ == "__main__":
    main()
