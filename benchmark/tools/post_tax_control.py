"""The readings the sampled tax mode's limits are set from, taken on the
chip.

    python3 benchmark/tools/post_tax_control.py --workload inst_sampled_1m \
        --seeds 1 2 3 [--parallel 6]

For each seed, one report of the cell on the card (its own size, the
timed path), and:

- ``sound``: the tax mode's numbers of that report (the lower readings);
- ``control bf16``: the reference in bfloat16 in the program's place
  (``precision.lowered``): its checked pairs' wealth and tax against the
  float32 reference's, and the report's sample and tables rounded to
  bfloat16 against their own sample;
- ``control bridge_f32``: the checked pairs' taxes through the program's
  tax bridge in float32 (``reporting.BRIDGE_DTYPE``) instead of float64:
  their rows replayed with emission on the card as the tables replay
  them, the bridge and tax then run by their plain versions on the host
  (the kernels K7 and K8 take only 64-bit words), against the float32
  reference; the tables' numbers are the sound report's.

``--detail`` prints each checked pair (strategy, sampled position, row,
the report's and the reference's wealth and tax, gross traded, trades,
days priced below the bridge's floor).

The references run on the host in ``--parallel`` processes, beside the
reports. One JSON line a seed and part; PERF.md keeps the readings and
the limits set from them."""

from __future__ import annotations

import argparse
import copy
import json
import multiprocessing as mp
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _reference(args):
    pairs, seed, years, config, low = args
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.reference import post_tax, precision

    torch.set_num_threads(1)
    t = time.perf_counter()
    if low:
        with precision.lowered():
            out = post_tax.pair_taxes(pairs, seed, years, config,
                                      torch.float32)
    else:
        out = post_tax.pair_taxes(pairs, seed, years, config, torch.float32)
    return out, time.perf_counter() - t


def _bf16(x):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def bridge_f32_taxes(prog, cell, report: dict, seed: int, pairs, dev):
    """The pairs' taxes with the program's bridge in float32: the rows'
    emission from the general path on ``dev``, the bridge's plain
    versions on the host."""
    import numpy as np
    import torch

    from benchmark.reference import config as rcfg
    from letf_tpu_torch import reporting
    from letf_tpu_torch.parallel.mc_runner import (
        _Run,
        _trial_layout,
        general_chunk,
    )

    c = cell.config
    years = int(cell.traffic["years"])
    n = int(report["n_trials"])
    run = _Run(prog.model, years, n, seed, None, c["antithetic"],
               c["random_start_method"], True, None, None, dev,
               c["engine_mode"])
    rows = np.unique([r for r, _ in pairs])
    ids, anti = _trial_layout(n, run.use_antithetic)
    _, em = general_chunk(run, ids[rows], anti[rows], apply_costs=True)
    em = [e.cpu() for e in em]
    income, kw = reporting.tax_setup(c.get("tax_config"), years)
    saved = reporting.BRIDGE_DTYPE
    reporting.BRIDGE_DTYPE = torch.float32
    out = np.zeros(len(pairs))
    for sid in rcfg.TAXABLE_IDS:
        at = [i for i, (_, s) in enumerate(pairs) if s == sid]
        b = torch.as_tensor(np.searchsorted(rows, [pairs[i][0] for i in at]))
        col = rcfg.TAXABLE_IDS.index(sid)
        cols = reporting.bridge_columns(e[:, b, col] for e in em)
        total, _ = reporting.bridge_activity_tax(
            cols, (0, 1) if sid == "S8" else (0,), years, income, kw)
        out[at] = total.double().numpy()
    reporting.BRIDGE_DTYPE = saved
    return out


def lowered_report(report: dict) -> dict:
    """The report with its sample and post-tax tables rounded to
    bfloat16, as a program storing them in bfloat16 would hand them."""
    rep = copy.deepcopy(report)
    for sid, entry in rep["post_tax_sample"].items():
        entry["wealth"] = _bf16(entry["wealth"])
        entry["tax"] = _bf16(entry["tax"])
        pt = rep["strategies"][sid]["post_tax"]
        pt["wealth"] = {k: float(_bf16(v)) for k, v in pt["wealth"].items()}
        pt["median_tax"] = float(_bf16(pt["median_tax"]))
    return rep


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import spec
    from benchmark.harness.program import Program

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--parallel", type=int, default=6)
    p.add_argument("--detail", action="store_true")
    a = p.parse_args(argv)
    cell = spec.load_cell(ROOT, a.workload)
    mode = spec.tax_mode(cell.traffic["tax_mode"])
    years = int(cell.traffic["years"])
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    prog = Program(cell.config, cell.traffic, dev)
    prog.warm(a.seeds[0])
    sound, f32 = {}, {}
    jobs = []
    for s in a.seeds:
        t = time.perf_counter()
        sound[s] = prog.report(s)
        t_rep = time.perf_counter() - t
        pairs = mode.checked_pairs(cell, sound[s], s)[0]
        f32[s] = bridge_f32_taxes(prog, cell, sound[s], s, pairs, dev)
        jobs += [(pairs, s, years, cell.config, low) for low in (False,
                                                                True)]
        print(f"reports of seed {s}: {t_rep} s, post_tax_seconds "
              f"{sound[s]['post_tax_seconds']}", flush=True)
    prog.release()
    with mp.get_context("spawn").Pool(min(len(jobs), a.parallel)) as pool:
        refs = pool.map(_reference, jobs)
    for i, s in enumerate(a.seeds):
        (r32, t32), (r16, t16) = refs[2 * i], refs[2 * i + 1]
        pairs, w, tax = mode.checked_pairs(cell, sound[s], s)
        nums = mode.sample_numbers(cell, sound[s])
        nums.update(mode.pair_numbers(pairs, w, tax, r32))
        print("sound " + json.dumps(dict(workload=a.workload, seed=s,
                                         numbers=nums, seconds_f32=t32)),
              flush=True)
        low = mode.sample_numbers(cell, lowered_report(sound[s]))
        low.update(mode.pair_numbers(pairs, r16["wealth"], r16["tax"], r32))
        print("control bf16 " + json.dumps(dict(
            workload=a.workload, seed=s, numbers=low, seconds_bf16=t16)),
            flush=True)
        bnums = mode.sample_numbers(cell, sound[s])
        bnums.update(mode.pair_numbers(pairs, w, f32[s], r32))
        print("control bridge_f32 " + json.dumps(dict(
            workload=a.workload, seed=s, numbers=bnums)), flush=True)
        if a.detail:
            m = min(mode.max_tax_sims(cell), int(sound[s]["n_trials"]))
            at = mode.check_positions(
                s, m, int(cell.traffic["check_taxes_per_strategy"]))
            pos = [int(j) for row in at for j in row]
            for i, (r, sid) in enumerate(pairs):
                print("pair " + json.dumps(dict(
                    seed=s, sid=sid, position=pos[i], row=r,
                    wealth=w[i], ref_wealth=r32["wealth"][i],
                    replay_wealth=r32["replay_wealth"][i], tax=tax[i],
                    ref_tax=r32["tax"][i], f32_tax=f32[s][i],
                    bf16_tax=r16["tax"][i], gross=r32["gross"][i],
                    trades=r32["trades"][i],
                    floored=r32["floored"][i])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
