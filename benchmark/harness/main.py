"""One run of one cell: set-up, the measured window, the traced report's
reductions, the comparison with the plain reference, and the result line.

The port is imported only through ``harness/program.py``; the reference
(``benchmark/reference``) imports nothing of it. After the window the run
refuses to print a result while ``sys.modules`` holds the JAX stack or the
JAX package (top-level names compared whole)."""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from benchmark.harness import checks, spec
from benchmark.harness import trace as tr
from benchmark.harness.hooks import DeviceClock, Swaps, span
from benchmark.harness.peaks import bound_s
from benchmark.harness.program import Program, trial_years
from benchmark.harness.window import closed_loop

BANNED = ("jax", "jaxlib", "flax", "letf_tpu")

# The traced run's profiled reports: the first under torch.profiler with
# the host's operations and the spans below (its idle gaps, labelled, make
# the breakdown), the second under a device-only trace with no spans (its
# device operations give the idle share, the kernels' times and the
# breakdown's device operations). The profiler slows both.
LABELLED, DEVICE_ONLY = 0, 1
PROFILED = (LABELLED, DEVICE_ONLY)

# Calls labelled in the traced report, so that its idle gaps name them.
SPANS = (("letf_tpu_torch.parallel.mc_runner", "slab_chunk_summaries"),
         ("letf_tpu_torch.parallel.mc_runner", "general_chunk"),
         ("letf_tpu_torch.parallel.mc_runner", "reduce_report"),
         ("letf_tpu_torch.ops.path_engine", "draw_innovations"),
         ("letf_tpu_torch.ops.path_engine", "path_from_innovations"),
         ("letf_tpu_torch.reporting", "sampled_post_tax_tables"))


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own library cache is ``build/letf_tpu_torch``), and no JAX
    behind a library that would load it."""
    cache = Path(root) / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Run:
    """What a per-layer reader sees of the traced run."""

    def __init__(self, cell: spec.Cell, bench: Path):
        self.cell, self.bench = cell, bench
        self.config, self.traffic = cell.config, cell.traffic
        self.swaps = Swaps()
        self.k = 0                                  # current report index
        self.reports: List[dict] = []
        self.stage_seconds: List[dict] = []
        self.trace: Optional[tr.TraceSummary] = None
        self._clocks: Dict[tuple, DeviceClock] = {}

    def clock(self, module: str, attr: str) -> DeviceClock:
        key = (module, attr)
        if key not in self._clocks:
            self._clocks[key] = DeviceClock(self.swaps, module, attr,
                                            lambda: self.k)
        return self._clocks[key]

    def calls_ms(self, module: str, attr: str) -> List[tuple]:
        """[(report, device ms)] of every call of ``module.attr`` in the
        traced window's reports other than the profiled ones (the first
        two), which the profiler slows (all of them if there are no
        others)."""
        calls = self.clock(module, attr).calls_ms()
        rest = [c for c in calls if c[0] not in PROFILED]
        return rest or calls

    def per_report_ms(self, module: str, attr: str) -> Dict[int, float]:
        out: Dict[int, float] = {}
        for k, ms in self.calls_ms(module, attr):
            out[k] = out.get(k, 0.0) + ms
        return out

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """A kernel's share of its roofline in the traced report, its
        launches at the configuration's chunk shape."""
        if self.trace is None:
            return None
        rf = spec.roofline(kernel, self.bench)
        sec, n = self.trace.kernel(rf.KERNEL)
        if n == 0 or sec <= 0:
            return None
        sim = int(self.traffic["years"] * 252)
        buf = (int(self.config["random_start_buffer_years"] * 252)
               if self.config["random_start_method"] == "offset" else 0)
        ops, nbytes = rf.count(dict(
            trials=min(int(self.config["chunk_trials"]),
                       int(self.traffic["trials"])),
            sim_days=sim, buffer_days=buf))
        return 100.0 * n * bound_s(ops, nbytes) / sec


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out


def compare(cell: spec.Cell, held: Dict, seed: int, report: dict,
            glue, bench: Path = spec.HERE) -> Dict[str, float]:
    """The numbers of the comparison: a sample of the report's rows drawn
    from its seed (evenly over its chunks) against the plain reference,
    its reductions against float64 ones over the rows it reduced, and what
    its tax mode adds."""
    traffic = cell.traffic
    rows = checks.sample_rows(seed, int(traffic["trials"]),
                              int(traffic["check_rows"]),
                              int(cell.config["chunk_trials"]))
    ref = spec.engine(cell.config["engine_mode"], bench).summaries(
        rows, seed, traffic["years"], cell.config, glue=glue, device="cpu")
    numbers = checks.row_numbers({k: v[rows] for k, v in held.items()}, ref)
    numbers.update(checks.reduction_numbers(
        report, held, int(traffic["trials"]), traffic["years"]))
    numbers.update(spec.tax_mode(traffic["tax_mode"], bench).numbers(
        cell, report, seed))
    return numbers


def main(argv, root: Path, t0: float, *, bench: Path = spec.HERE,
         device: Optional[str] = None) -> int:
    """Run one cell; returns the exit code. ``device`` set (tests) skips
    the look for a card and runs the port there."""
    args = parse(argv)
    cell = spec.load_cell(root, args.workload, bench)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: torch.cuda.is_available() is false",
                  file=sys.stderr)
            return 3
        if torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 3
        device = "cuda"
    cuda = device.startswith("cuda")
    traffic = cell.traffic
    run = Run(cell, bench)
    cuda_act = torch.profiler.ProfilerActivity.CUDA
    acts = [torch.profiler.ProfilerActivity.CPU] + ([cuda_act] if cuda
                                                     else [])
    spans = Swaps()

    # ---- set-up: import, build and load, model tables, warm shapes ----
    prog = Program(cell.config, traffic, device)
    prog.warm(args.seed)
    readers = {}
    if args.trace:
        readers = {m["name"]: spec.metric_reader(m["name"], bench)
                   for m in cell.per_layer}
        for r in readers.values():
            if hasattr(r, "install"):
                r.install(run)
    prog.capture()
    if args.trace:
        # Outermost, so that taking them off after the labelled report
        # leaves the readers' clocks and the capture in place.
        for module, attr in SPANS:
            span(spans, module, attr)
        with torch.profiler.profile(activities=acts):     # load CUPTI
            torch.ones(1, device=device).add_(1)
            if cuda:
                torch.cuda.synchronize()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    launches0 = Program.launches()

    # ---- the window ----
    profiled: Dict[int, tuple] = {}

    def issue(k: int) -> float:
        run.k = k
        stages = {} if args.trace else None
        which = ({LABELLED: acts, DEVICE_ONLY: [cuda_act] if cuda else []}
                 .get(k) if args.trace else None)
        if which:
            with torch.profiler.profile(activities=which) as prof:
                t0 = time.perf_counter()
                rep = prog.report(args.seed + k, stage_seconds=stages)
                if cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            profiled[k] = (prof, wall)
            if k == LABELLED:
                spans.restore()
        else:
            rep = prog.report(args.seed + k, stage_seconds=stages)
        if rep.get("n_trials") != int(traffic["trials"]):
            raise ValueError(f"report {k}: n_trials {rep.get('n_trials')}")
        run.reports.append(rep)
        run.stage_seconds.append(stages or {})
        return trial_years(traffic)

    win = closed_loop(issue, args.seconds)
    spans.restore()
    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
    launches1 = Program.launches()
    print("window: " + json.dumps(dict(
        reports=win.attempted, failed=win.failed, seconds=win.seconds,
        report_seconds=win.report_seconds)))
    print("launches per report: " + json.dumps(
        {k: (launches1[k] - launches0[k]) / win.attempted
         for k in launches0}))
    post = [r.get("post_tax_seconds") for r in run.reports]
    if any(p is not None for p in post):
        print(f"post_tax_seconds: {post}")
    print(f"memory_peak_bytes: {peak} (torch.cuda.max_memory_allocated)")

    metrics: Dict[str, dict] = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    breakdown = None
    if args.trace:
        summaries = {k: tr.from_profiler(prof, wall)
                     for k, (prof, wall) in sorted(profiled.items())}
        profiled.clear()
        for k, t in summaries.items():
            kind = "device only" if k == DEVICE_ONLY else "labelled"
            print(f"trace of report {k} ({kind}): {t.events} device "
                  f"operations, busy {t.busy_s} s of {t.window_s} s, idle "
                  f"{t.idle_pct} %")
        rest = [sec for k, sec in enumerate(win.report_seconds)
                if k not in PROFILED]
        if DEVICE_ONLY in summaries and rest:
            busy = summaries[DEVICE_ONLY].busy_s
            print(f"idle at the untraced reports' pace: "
                  f"{100.0 * (1.0 - busy * len(rest) / sum(rest))} % "
                  f"(report {DEVICE_ONLY}'s busy seconds over the mean of "
                  f"{len(rest)} untraced reports' seconds)")
        if summaries:
            labelled = summaries[LABELLED]
            run.trace = summaries.get(DEVICE_ONLY, labelled)
            dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            breakdown = {"device_ops": run.trace.breakdown()["device_ops"],
                         "idle_gaps": labelled.breakdown()["idle_gaps"]}
        for m in cell.per_layer:
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif win.work > 0:
                metrics[m["name"]] = {"value": win.rate, "unit": m["unit"]}
    run.swaps.restore()

    # ---- the comparison, once the program's state is freed ----
    seed = prog.held_seed
    held = prog.release()
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers: Dict[str, float] = {}
    t_ref = time.perf_counter()
    if win.failed == 0 and held:        # a report that never came fails
        numbers = compare(cell, held, seed, run.reports[-1],
                          torch.float32 if cuda else torch.float64, bench)
    correct, lines, table = checks.judge(numbers, cell.limits)
    correct = correct and bool(numbers)
    print(f"reference: {time.perf_counter() - t_ref} s")
    if cuda:
        print(f"card: {card_line()}")

    found = banned_modules()
    if found:
        print(f"refused: the process holds {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = table
    print(json.dumps(out), flush=True)
    return 0
