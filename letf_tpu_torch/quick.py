"""Smoke test of the port: the reference's primary validation tool
(``quick_test.py:main``, reference quick_test.py:31-108) on the port:
golden tax tests, data, calibration, a 10-sim x 10y results list over
S1-S3, and summary statistics, on ``device``.

    python -m letf_tpu_torch.cli --quick [--synthetic-data] [--device cpu]
"""

from __future__ import annotations

import time


def main(*, device="cuda", force_synthetic: bool = False) -> None:
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch.calibration import calibrate_all
    from letf_tpu_torch.data import fetch_historical_data
    from letf_tpu_torch.parallel.mc_runner import parallel_monte_carlo_fixed
    from letf_tpu_torch.reporting import create_summary_statistics
    from letf_tpu_torch.tax.engine import run_golden_tests
    from letf_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    t0 = time.time()
    print("=" * 80)
    print("QUICK TEST - LETF Monte Carlo, PyTorch/CUDA port")
    print("=" * 80)

    run_golden_tests()

    cfg.init_cache()
    df = fetch_historical_data(force_synthetic=force_synthetic)
    regime_model, correlations = calibrate_all(df, device=dev)

    mc = parallel_monte_carlo_fixed(
        strategy_ids=["S1", "S2", "S3"], time_horizon=10,
        regime_model=regime_model, correlation_matrices=correlations,
        historical_df=df, num_simulations=10, device=dev)

    create_summary_statistics(mc, 10)

    print(f"\nQUICK TEST COMPLETE in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
