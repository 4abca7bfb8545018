"""The readings a cell's limits are set from, taken on the chip.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3 \
        [--sound] [--control] [--reduction]

- ``--sound``: for each seed, one report of the cell on the card (its own
  size, the timed path), and the comparison a run makes of it
  (``harness/main.compare``): the lower readings.
- ``--control``: for each seed, the rows a run of that seed samples,
  through the plain reference in float32 and in bfloat16 (the nearest
  precision below the configuration's float32), the second in the
  program's place (one process a seed and precision, beside the reports):
  the upper readings of the row numbers.
- ``--reduction``: for each seed, one report on the card gives the
  summaries a report reduces, and the report's reductions computed from
  them in bfloat16 are held against the float64 ones, as a run holds the
  program's: the upper readings of the reduction numbers.

One JSON line a seed and part; PERF.md keeps the readings and the limits
set from them."""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _rows(args):
    seed, low, config, traffic = args
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import checks, spec
    from benchmark.reference import precision

    torch.set_num_threads(1)
    rows = checks.sample_rows(seed, int(traffic["trials"]),
                              int(traffic["check_rows"]),
                              int(config["chunk_trials"]))
    t = time.perf_counter()
    eng = spec.engine(config["engine_mode"])
    if low:
        with precision.lowered():
            out = eng.summaries(rows, seed, traffic["years"], config)
    else:
        out = eng.summaries(rows, seed, traffic["years"], config)
    return out, time.perf_counter() - t


def _bf16(a):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def reduction_control(cell, arrays) -> dict:
    """A report's reductions in bfloat16 against float64 ones."""
    from benchmark.harness import checks

    low = {k: (_bf16(v) if v.dtype.kind == "f" else v)
           for k, v in arrays.items()}
    red = checks.reduced(low, cell.traffic["percentiles"],
                         cell.traffic["years"])
    sids = [f"S{i + 1}" for i in range(low["final_wealth"].shape[1])]
    pct = cell.traffic["percentiles"]
    rep = {"n_trials": int(cell.traffic["trials"]), "percentiles": pct,
           "strategies": {s: {
               "wealth": {f"p{p}": float(_bf16(red["wealth_fan"][j, i]))
                          for j, p in enumerate(pct)},
               "median_max_dd": float(_bf16(red["mdd_median"][i])),
               "trades_per_year": float(_bf16(red["trades_per_year"][i])),
               "win_rate_vs_spy": float(_bf16(red["win_rate_vs_spy"][i])),
               "ruin_frac": float(_bf16(red["ruin_frac"][i]))}
               for i, s in enumerate(sids)}}
    for k in ("valid_frac", "repaired_frac", "finite_frac", "vix_ok_frac"):
        rep[k] = float(_bf16(red[k]))
    return checks.reduction_numbers(rep, arrays, int(cell.traffic["trials"]),
                                    cell.traffic["years"])


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import checks, spec

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sound", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--reduction", action="store_true")
    a = p.parse_args(argv)
    cell = spec.load_cell(ROOT, a.workload)
    pool = pending = None
    if a.control:
        jobs = [(s, low, cell.config, cell.traffic) for s in a.seeds
                for low in (False, True)]
        pool = mp.get_context("spawn").Pool(min(len(jobs), 6))
        pending = pool.map_async(_rows, jobs)
    if a.sound or a.reduction:
        import torch

        from benchmark.harness.main import compare
        from benchmark.harness.program import Program

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        prog = Program(cell.config, cell.traffic, dev)
        prog.warm(a.seeds[0])
        prog.capture()
        for s in a.seeds:
            t = time.perf_counter()
            rep = prog.report(s)
            held = {k: v.cpu().numpy() for k, v in prog.held.items()}
            t_rep = time.perf_counter() - t
            if a.sound:
                t = time.perf_counter()
                nums = compare(cell, held, s, rep,
                               torch.float32 if dev == "cuda"
                               else torch.float64)
                print("sound " + json.dumps(dict(
                    workload=a.workload, seed=s, numbers=nums,
                    report_seconds=t_rep,
                    reference_seconds=time.perf_counter() - t)), flush=True)
            if a.reduction:
                print("control reduction " + json.dumps(dict(
                    workload=a.workload, seed=s,
                    numbers=reduction_control(cell, held))), flush=True)
        prog.release()
    if pool is not None:
        outs = pending.get()
        pool.close()
        pool.join()
        for i, s in enumerate(a.seeds):
            (f32, t32), (b16, t16) = outs[2 * i], outs[2 * i + 1]
            print("control rows " + json.dumps(dict(
                workload=a.workload, seed=s,
                numbers=checks.row_numbers(b16, f32), seconds_f32=t32,
                seconds_bf16=t16)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
