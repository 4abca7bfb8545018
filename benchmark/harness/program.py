"""The system under test: the port's percentile report
(``letf_tpu_torch.parallel.mc_runner.monte_carlo_report``) with a cell's
configuration and traffic. The port is imported here, lazily, and nothing
else of the harness touches it."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from benchmark.harness.hooks import Swaps

# Modules of the port that count their kernel launches (``LAUNCHES``).
LAUNCH_COUNTERS = ("joint", "window", "compose_strategies", "strategies",
                   "compose", "sort_bridge", "wash", "gbm")

# The port's configuration constants a configuration file states, by the
# file's key: a run on a port whose defaults differ is no sound run.
STATED = {"random_start_buffer_years": "RANDOM_START_BUFFER_YEARS",
          "random_start_method": "RANDOM_START_METHOD",
          "antithetic": "USE_ANTITHETIC_VARIATES",
          "moment_matching": "USE_MOMENT_MATCHING"}


def trial_years(traffic: dict) -> float:
    return float(traffic["trials"]) * float(traffic["years"])


class Program:
    """One cell's reports on ``device``; ``capture()`` keeps the device
    summaries that the last report reduced, for the comparison."""

    def __init__(self, config: dict, traffic: dict, device: str):
        from letf_tpu_torch import config as pcfg
        from letf_tpu_torch.parallel import mc_runner

        from benchmark.harness import spec

        for key, const in STATED.items():
            if getattr(pcfg, const) != config[key]:
                raise RuntimeError(
                    f"the port's {const} is {getattr(pcfg, const)!r}; the "
                    f"configuration states {key}={config[key]!r}")
        if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
            raise ValueError("the generator drives one client in a closed "
                             f"loop, not {traffic.get('loop')!r} x "
                             f"{traffic.get('clients')!r}")
        self.mc = mc_runner
        self.config, self.traffic = config, traffic
        self.model = spec.model(config["model"]).program()
        self.kw = dict(
            chunk_size=int(config["chunk_trials"]),
            use_antithetic=config["antithetic"],
            random_start_method=config["random_start_method"],
            apply_costs=config["apply_costs"],
            engine_mode=config["engine_mode"],
            percentiles=tuple(traffic["percentiles"]),
            tax_config=config.get("tax_config"),
            tax_mode=traffic["tax_mode"], device=device)
        self.swaps = Swaps()
        self.seed: Optional[int] = None
        self.held: Optional[Dict] = None
        self.held_seed: Optional[int] = None

    def report(self, seed: int, trials: Optional[int] = None,
               stage_seconds: Optional[dict] = None) -> dict:
        """One percentile report; its result is on the host on return."""
        self.seed = seed
        return self.mc.monte_carlo_report(
            self.model, self.traffic["years"],
            num_simulations=int(trials or self.traffic["trials"]),
            seed=seed, stage_seconds=stage_seconds, **self.kw)

    def warm(self, seed: int) -> None:
        """Build and load the kernels and warm the allocator and the launch
        path: one report of the traffic's horizon and tax mode over one
        chunk of trials (the cell's chunk shape)."""
        self.report(seed, trials=min(int(self.traffic["trials"]),
                                     int(self.config["chunk_trials"])))

    def capture(self) -> None:
        """Hold the device summaries each report reduces, and its seed (the
        last one's stay held): references only, no copy inside the
        window."""
        def wrap(inner):
            def held(fw, mdd, nt, valid, repaired, path_finite, vix_ok,
                     *args, **kw):
                self.held = dict(final_wealth=fw, max_dd=mdd, num_trades=nt,
                                 valid=valid, repaired=repaired,
                                 path_finite=path_finite, vix_ok=vix_ok)
                self.held_seed = self.seed
                return inner(fw, mdd, nt, valid, repaired, path_finite,
                             vix_ok, *args, **kw)
            return held

        self.swaps.swap(self.mc.__name__, "reduce_report", wrap)

    def release(self) -> Dict[str, np.ndarray]:
        """The held summaries on the host; the program's device state is
        dropped."""
        self.swaps.restore()
        held = {k: v.cpu().numpy() for k, v in (self.held or {}).items()}
        self.held = None
        self.model = None
        return held

    @staticmethod
    def launches() -> Dict[str, int]:
        import importlib

        return {m: importlib.import_module(f"letf_tpu_torch.ops.{m}").LAUNCHES
                for m in LAUNCH_COUNTERS}
