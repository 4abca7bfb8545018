#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (letf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check (one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain at short shapes

Phases, each raising on failure:
1. The card: torch.cuda must be available; prints nvidia-smi's name and
   power limit.
2. Build: one nvcc per letf_tpu_torch/csrc/*.cu, started together, linked
   into build/letf_tpu_torch/; then the kernel_info line: each kernel's
   registers, shared memory, spills and resident blocks/warps an SM at its
   launch shape (_build.kernel_info).
3. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   on the same inputs, at the main paths' shapes (B=16,384 trials, 30
   years + 5-year buffer; with --quick a 252-day window and a 126-day
   buffer): K1 (joint) within rtol 1e-4 / VIX atol 1e-3 over the buffer
   and the first 1,260 days (PLAIN_DAYS) and bit for bit the first port's
   one-thread-a-trial kernel at the full shape (its output digests, stored
   below), K2 (window) bitwise (independent, antithetic-paired and equal
   offsets, a ragged B of 650, a span past one 32-trial ring), K3
   (compose + strategies) within compose_strategies.check_parity's
   bounds over the first 1,260 days (PLAIN_DAYS), K5 (compose) within
   rtol 1e-5 / atol 1e-6 over the first 1,260 days and bit for bit the
   first port's kernel at 16,384 and at the report's 650 trials (its
   output digests, stored below), K7 (bridge merge of float64 keys and
   payloads, merge and valley kinds, [2S, 600] and [2S, 2,048] with 0/2/4
   payloads, and the exact-all bridge's [15,120, 8,192] and [15,120,
   4,096] and the 50-year [25,200, 256], each beside torch.sort) and K8
   (float64 wash matching, [S, 650], edge cases at 1, 33 and 650 trials,
   and the exact-all bridge's [S, 8,192]) bitwise; K6 (buy-and-hold) within
   rtol 1e-5 at 1,048,576 x 30 years (K4 follows in phase 8, on the main
   path's channels; with --quick here, at 16,384 x 252 days). Each
   kernel's time beside the plain version's, its bound and, where one
   PyTorch call computes the same function, that call's time; K1, K2 and K3 as min/median/max over 5, 5 and 3 runs,
   K1 and K3 also on the chunk's first 4,096 trials (3 runs). Then the
   samplers (csrc/draws.cu, phase_draws): the parametric 10-year
   report's seven normal and t calls over 16,384 keys (1,024 with
   --quick), each bitwise its torch twin, timed beside it, with their
   integer floor. Then the emitting day kernel (csrc/emit_days.cu,
   phase_emit_days) on the emitting engine's own inputs at [7,560, 650]
   (the sampled replay) and [7,560, 16,384] (an exact-all chunk; 252
   days with --quick), bitwise its torch twin, timed beside it and its
   byte bound.
4. Reports through kernels vs plain versions on the card: 1,024 trials x
   0.5 year pre-tax, and the default sampled report at 1,024 x 1 year.
5. The general path against the slab path (K1, K2, K3): with the emitting
   engine (16,384 trials, 2 years + 2-year buffer) and without emission
   (K1, K2', K5, signals, K4 in both modes; 16,384 trials x 30 years),
   K4's fused-signals mode bitwise the slab path's K3.
6. The pre-tax report, 65,536 x 30 years (the first slice's main path).
7. The default report, monte_carlo_report(default_sim_model(), 30,
   1,048,576 trials, seed 2, chunks of 16,384, tax_mode="sampled") (the
   second slice's main path), its pre-tax statistics against the JAX
   reference's, its post-tax tables against the reference's exact-all
   taxes and its sampled estimator's spread (phase_tax_reference); then
   the exact-tax report, monte_carlo_report(default_sim_model(), 30,
   8,192 trials, seed 2, tax_mode="exact_all"), every trial taxed in
   float64, held to the reference's exact-all statistics and to the tax
   reference's shared trials, its chunks broken down by stage; after it,
   counted apart, its first chunk's first bridge fold run again through
   K7's and K8's plain versions in float64, bitwise (phase_exact_all).
8. This slice's main path, monte_carlo_report(default_sim_model(), 30,
   16,384 trials, seed 2, engine_mode="parametric") with its default
   sampled taxes, the seconds of each stage of its chunk (timed inside
   the report), K4 (strategies) on that chunk's own channels bit for bit
   the first port's kernel (its output digests, stored below) and within
   check_parity's bounds of its plain version (channel mode over 16,384
   trials and the first 1,260 of its 7,560 days, fused-signals mode over
   its first 504),
   then the parametric report
   through kernels and through plain versions (1,024 x 0.5 year), and the
   first 1,024 trials of the parametric run held to the JAX package's
   (constants below).
9. The production entry from data to fans (phase_calibrated), in a
   temporary cache of the port's: (a) fetch_historical_data(
   force_synthetic=True) against the committed history's per-column
   digests and sums (HISTORY_*); (b) calibrate_all on the card against the
   committed fits (the historical regimes exactly, GARCH within 2e-5,
   the rest within rtol 1e-6), its seconds; (c) runner.run_report([10,
   30], 1,048,576 trials, seed 2) from a cold fit cache, each
   horizon's wall, post-tax seconds and trial-days/s, every fan finite,
   the kernels' launches; (d) the first 1,024 trials x 30 years on the
   committed fits against the JAX package's (JAX_CAL_*); (e) cli --report
   --synthetic-data --sims 16384 --horizons 1 on the warm cache.
10. The reference's complete analysis (phase_analysis), in a temporary
   cache of the port's: (1) runner.run(horizons=[10], seed 0,
   force_synthetic=True) at its 200 trials, its timing summary logged and
   its output in build/analysis/analysis_run.txt: every summary number
   finite, the launches of each kernel, the results lists equal to
   run_monte_carlo's arrays, the battery's JSON (the zero-drift invariant
   passes, the structural checks equal the JAX package's, the rolling
   OOS ran 3 splits), K4 on the historical backtest's windows against its
   plain version and K1, K3 at the run's 200 trials against theirs; (2)
   the results list's first 200 trials x 10 y on the committed fits and
   the backtests against the JAX package's numbers (ANALYSIS_*, printed by
   tools/analysis_reference.py); (3) the Trade_Replay route,
   parallel_monte_carlo_fixed at 4,096 x 30 y, create_summary_statistics
   sampled and with exact_tax_all_trials (K7, K8), the exact taxes held
   to the host tax chain's at the sampled trials; (4) the CLI's default
   branch (--synthetic-data --sims 64 --horizons 10) and --quick as
   subprocesses.
11. The reference's other engine modes (phase_engine_modes), in a
   temporary cache of the port's: (1) run_monte_carlo(default_sim_model(),
   30, 4,096 trials, seed 2, engine_mode="legacy_hybrid",
   bootstrap_pools=the block bootstrap pools of the offline history) (K4
   at its channel shape) and the reference-shaped sampled_post_tax_tables
   on its wealth with the pools (K7, K8); its first 1,024 trials against
   the JAX package's (ENGINE_*, printed by
   tools/engine_modes_reference.py): offset and regime-day sums exact,
   S1-S3 medians within ENGINE_P50_RTOL, each day's chosen block row of
   128 trials (float32 near-ties counted); the run's Gumbel draws timed
   inside it; (2) parallel_monte_carlo_fixed at 200 x 2 y under
   SIM_ENGINE_MODE="legacy_hybrid"; (3) the reference-shaped per-trial
   institutional call generate_paths_batch(model, key, ids, anti, 7,560)
   at 1,024 trials (its draws and joint day loop timed inside it) and
   generate_paths_batched's joint_kernel="off" route
   (1,024 x 10 y), the first 8 trials' first 150 days against the JAX
   package's, and its fast_draws=False route bitwise the per-trial call
   (1,024 x 1 y); (4) the three diagnose_* functions at the sizes of
   tests/test_aux.py:58 against the JAX package's. Then the oracles
   (phase_oracles): the history backtest through K4 against the host
   strategy oracle per window, the per-trial engine's first 4 paths of
   (3) against the float64 path oracle on their innovations, the TQQQ
   flow and the income paths on the card.
12. The 50-year envelope (phase_envelope): the TPU record's 50-year
   chunk through run_monte_carlo (4,096 trials, seed 9) against its 384
   spells and S2 median and, on its first 128 trials, the JAX package's
   slab route (ENVELOPE_*, printed by tools/long_horizon_reference.py:
   the integer sums exact, S1 and S2 per trial within their bounds);
   the default report at 65,536 x 50 years; exact-all at 1,024 x 50
   years with its first bridge fold bitwise through the plain K7 and K8.
13. The runner (phase_runner), on every visible card or two shards of
   one: mesh runs and reports bitwise one device's, exact-all on the
   mesh within rtol 1e-9, a run killed after 2 of 4 chunks and resumed
   bitwise the whole one, the chunk containment's flag, a device-side
   assert under it raised (in a subprocess); and a trial's bits
   independent of its batch width: at 20 years one chunk of 16 trials
   against two shards of 8 in the parametric, legacy_hybrid and
   institutional modes, bitwise, and the tax of 1-1,024 trials alone
   bitwise that of 4,096.
14. The buy-and-hold headline: K6 against the port of the XLA twin by
   bench.py's distribution gate (262,144 x 10 years), then
   gbm_percentile_report(1, 1,048,576, 30) after a seed-0 warm-up, held
   to the first port's K6 (its values, stored below).
15. The validation invariants: zero-drift drag through K3, flat-market
   decay through K6.
16. A torch.profiler breakdown of one pre-tax chunk; the post-tax part of
   a one-chunk sampled report by stage (host clock, nvidia-smi's busy
   samples).
Every path runs with the launch counters set to 0 just before it and read
just after. The last lines are the kernel_info JSON, nvidia-smi's name
and power limit, the kernels JSON and {"ok": true, ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

B_CHUNK = 16384
QUICK = dict(sim=252, buf=126)
FULL = dict(sim=30 * 252, buf=5 * 252)
# K1, K3, K4 and K5 against their plain versions over the first 5 years
# of the 30-year chunk (K1 with its buffer): the plain versions are
# host-bound day loops (~30-110 s over all the days), and the smoke must
# end well inside its limit; the kernels are timed at the full shape, and
# K1's, K4's and K5's full-shape outputs are held to the first port's.
PLAIN_DAYS = 5 * 252

# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and
# float32 and float64 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_F64 = 34e12
# float32 operations per trial-day of each kernel's day body, counted from
# its source (a transcendental counts as one): the operation side of the
# bound. The integer counter hashing is not counted. K1's 419, at the
# model's 14 Chebyshev coefficients: 115 in the draws (the six uniforms'
# scale and offset, Box-Muller, the 13-step Clenshaw pass at 4 each, expf,
# the scale, the signs, IRX) and 304 in the carry chain (GARCH, DCC, the
# correlation and Cholesky, x, z, VIX), each NaN-propagating max or min
# counted as 3 (two NaN compares and the max), a clip as 6. The regime
# blends of the parameters (pa + pd * r) are not counted: with the regime 0
# or 1, as the model's is, per-regime rows would make them loads.
OPS_PER_TRIAL_DAY = {"joint": 419, "compose_strategies": 2000,
                     "strategies": 1200, "strategies_fused": 1500,
                     "compose": 640, "gbm": 16, "emit_days": 390}


# bit_digest of K1's five outputs (x0, x1, x2, VIX, IRX) from the first
# port's kernel (one thread per trial, csrc/joint.cu before the draw warps
# in the git history), on chain_inputs at seed 2 over the chunk's 16,384
# trials: the --quick shape (252 + 126 days) and the full one (7,560 +
# 1,260), as this script's K1 phase computes them. Every later K1 must
# reproduce them.
JOINT_DIGESTS_FIRST_PORT = {
    "quick": [8022251606426999569, -6531180406265040227, 862387567883774011,
              -5197426976195207276, 4348479962836073629],
    "full": [4406066641351886039, -6543449953699000622, 7058428530418077991,
             -253267574117871014, -7552742787963051914]}


# bit_digest of K4's three outputs (final wealth, trade counts, max
# drawdown) from the first port's kernel (one thread per trial: csrc/
# strategies.cu, strategies_day.cuh and common.cuh of commit df4b86e,
# before the group warps of 627985b), on the parametric chunk's 23 channels
# (parametric_breakdown: 16,384 trials x 7,560 days, seed 2; the day means
# in the fixed order of ops/reductions.day_mean) as k4_digests computes
# them: channel mode, fused-signals mode, and channel mode with
# k4_cashflows and no costs. Retaken by `tools/k4_first_port.py` (the
# first port's build, on an H100 80GB HBM3 at 700 W): the same values as
# before the day means' repair, which moves no channel. Every later K4
# must reproduce them.
K4_DIGESTS_FIRST_PORT = {
    "channel": [94221039556548971, 195363920246722, -3826228012210327674],
    "fused": [94211092148682884, 195363068299635, -3826228185658061218],
    "cashflows_no_costs": [2273546247011725738, 195363920246722,
                           -3887716469964402089]}


# bit_digest of K5's seven outputs (etf, spy_a, qqq_a, cash, jump count,
# liquidity sum, credit sum) from the first port's kernel (one thread per
# trial, csrc/compose.cu before the stress and asset warps in the git
# history), on phase_k5's inputs (the chunk's windowed K1 channels at seed
# 2, 7,560 days): all 16,384 trials, and the first K5_REPORT_B, the
# default report's shape (13 taxable strategies x MAX_TAX_SIMS picks at
# most). Every later K5 must reproduce them.
K5_REPORT_B = 650
K5_DIGESTS_FIRST_PORT = {
    "chunk": [-8226637578731920693, -899343144844771927,
              -7206864643762964599, 6294501185735322578, 147910592265191424,
              154906975708069908, 154390408346035487],
    "report": [1606196546298109373, -1928557560609437481,
               1774073264177089851, -4834089686883258278, 233117355606016,
               244182593901583, 243360926587612]}


# The headline gbm_percentile_report(1, 1,048,576, 30) through the first
# port's K6 (the log-domain kernel, csrc/gbm.cu before the linear-domain
# blocks in the git history) on an H100: the redesigned K6 must give its
# wealth percentiles and CVaR(5%) within 1e-4 relative and its median max
# drawdown within 1e-5 (HEADLINE_BOUNDS).
HEADLINE_FIRST_PORT = {
    "percentiles": {"p10": 0.016368340700864792, "p25": 0.17986826598644257,
                    "p40": 0.9567040205001831, "p50": 2.604794979095459,
                    "p60": 7.064236164093018, "p75": 37.30531311035156,
                    "p90": 411.80035400390625},
    "cvar_5pct_wealth": 0.0013922149082645774,
    "median_max_drawdown": 0.9838876128196716}
HEADLINE_BOUNDS = (1e-4, 1e-5)


def bound(nbytes: float, ops: float, peak: float = PEAK_F32):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and operations over the peak rate of their type (float32
    unless ``peak`` says otherwise)."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def with_bound(rec, nbytes, ops, library_ms=None, peak=PEAK_F32):
    b, by = bound(nbytes, ops, peak)
    rec.update(bound_ms=b, bound_by=by, library_ms=library_ms)
    return rec


def log(msg):
    print(msg, flush=True)


def timed(fn, reps: int, warm: bool = True):
    """(mean milliseconds of fn() over reps runs by CUDA events, the last
    run's result), after one warm-up run unless ``warm`` is false (the
    kernels are built and loaded already; the plain versions compile
    nothing)."""
    if warm:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def spread(fn, reps: int):
    """([min, median, max] milliseconds of fn() over reps runs, each timed
    alone by CUDA events after one warm-up run, the last run's result):
    times spread 15-50% between calls, so one reading is not a time."""
    fn()
    ms = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return [min(ms), float(np.median(ms)), max(ms)], out


def fmt_spread(v):
    return f"{v[1]:.3f} ms (min {v[0]:.3f}, max {v[2]:.3f})"


GENERAL_WINDOWS = 0     # window_offsets launches inside the general path
GENERAL_TRIALS = []     # the trial count of each general-path call
# The engine-modes phase's per-trial 30-year call (default model, 1,024
# trials): its innovations and path, which the oracles phase reads.
PER_TRIAL_SAMPLE = {}


def observe_general_windows():
    """K2 (the slab chunk's window) and K2' (the general path's) are one
    kernel behind one wrapper, ``window.window_offsets``, with one launch
    counter. To report them apart, the general path's entry in mc_runner
    is wrapped: the window launches made inside it go to GENERAL_WINDOWS
    (K2'), and ``read`` gives K2 the rest. Each call's trial count (K5's
    B) goes to GENERAL_TRIALS."""
    from letf_tpu_torch.ops import window
    from letf_tpu_torch.parallel import mc_runner

    inner = mc_runner.generate_paths_batched

    def generate_paths_batched(*args, **kw):
        global GENERAL_WINDOWS
        before = window.LAUNCHES
        GENERAL_TRIALS.append(len(args[2]))
        out = inner(*args, **kw)
        GENERAL_WINDOWS += window.LAUNCHES - before
        return out

    mc_runner.generate_paths_batched = generate_paths_batched


def counters():
    """Each kernel's launch counter: name -> (module, attribute)."""
    from letf_tpu_torch.ops import compose, emit_days, gbm, joint, sort_bridge
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops import rng, wash, window

    return {"joint": (joint, "LAUNCHES"), "window": (window, "LAUNCHES"),
            "draws": (rng, "LAUNCHES"), "emit_days": (emit_days, "LAUNCHES"),
            "window_tiles": (sys.modules[__name__], "GENERAL_WINDOWS"),
            "compose_strategies": (k3, "LAUNCHES"),
            "strategies": (k4, "LAUNCHES"), "compose": (compose, "LAUNCHES"),
            "gbm": (gbm, "LAUNCHES"), "sort_bridge": (sort_bridge, "LAUNCHES"),
            "wash": (wash, "LAUNCHES")}


def reset(ctrs):
    for mod, attr in ctrs.values():
        setattr(mod, attr, 0)


def read(ctrs):
    out = {k: getattr(mod, attr) for k, (mod, attr) in ctrs.items()}
    out["window"] -= out["window_tiles"]
    return out


def chain_inputs(model_t, B, sim, buf, seed=2):
    """Glue of the production chunk for trial rows 0..B-1: regime [T, B]
    f32, int32 ids, antithetic signs, seed words, start offsets."""
    from letf_tpu_torch.ops import path_batched as pb
    from letf_tpu_torch.ops import rng

    dev = model_t.regime.p_stay.device
    rows = torch.arange(B, device=dev)
    ids, anti = rows // 2, rows % 2 == 1
    key = rng.key(seed, dev)
    sc = pb.start_conditions(model_t, key, ids, buf, "offset", None,
                             torch.float32)
    regime = pb.simulate_regime_paths_spell(
        model_t, rng.stream(rng.trial_key(key, ids), rng.REGIME),
        sc.start_regime, sim + buf,
        max_spells=pb.plan_max_spells(model_t, sim + buf),
        out_dtype=torch.float32)
    signs = torch.where(anti, -1.0, 1.0).to(torch.float32)
    return (regime, ids.to(torch.int32), signs,
            [int(v) for v in key.tolist()], sc.start_offset.to(torch.int32))


def bit_digest(x: torch.Tensor) -> int:
    """Position-weighted sum of a float32 tensor's int32 view in int64
    (wrapping, so the same in any summation order): equal digests mean,
    short of a collision, bitwise equal tensors."""
    v = x.reshape(-1).view(torch.int32)
    acc = torch.zeros((), dtype=torch.int64, device=x.device)
    step = 1 << 26
    for s in range(0, v.numel(), step):
        c = v[s:s + step].to(torch.int64)
        w = torch.arange(s, s + c.numel(), device=x.device,
                         dtype=torch.int64) % 1_000_003 + 1
        acc += (c * w).sum()
    return int(acc)


def joint_args(model_t, regime, ids, signs, seed_words):
    from letf_tpu_torch.models import params as tparams

    return (tparams.pack_joint_params(model_t),
            model_t.joint.chi_cheb.to(torch.float32), regime, ids, signs,
            seed_words)


def windowed(model_t, x, offs, sim):
    """The six windowed K3 input channels (moment-matching bias on x0..x2)
    from K1's outputs and the regime, through the K2 kernel."""
    from letf_tpu_torch.ops import window

    theo = model_t.joint.theo_mean.to(torch.float32)
    biases = [(theo[c] - x[c].mean(dim=0)) * 0.1 for c in range(3)]
    return window.window_offsets(list(x), offs, sim,
                                 biases=biases + [None, None, None])


def k3_args(model_t, ids, seed_words, chans):
    from letf_tpu_torch.models import params as tparams

    return (tparams.pack_stress_params(model_t),
            tparams.pack_asset_params(model_t), ids, seed_words, *chans)


def phase_kernels(model_t, quick: bool):
    """Each kernel against its plain version on the card at the main
    path's shapes (B=16,384, 30 years + 5-year buffer; with ``quick`` a
    252-day window and a 126-day buffer), and each one's time beside the
    plain version's on the same inputs. Returns the per-kernel records of
    the kernels JSON line."""
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import joint, window

    rec = {}
    shape = QUICK if quick else FULL
    sim, buf = shape["sim"], shape["buf"]
    T = sim + buf
    regime, ids, signs, sw, offs = chain_inputs(model_t, B_CHUNK, sim, buf)
    ja = joint_args(model_t, regime, ids, signs, sw)
    k1_ms, xk = spread(lambda: joint.joint_generate(*ja), 5)
    digests = [bit_digest(x) for x in xk]
    want = JOINT_DIGESTS_FIRST_PORT["quick" if quick else "full"]
    assert digests == want, ("K1 is not the first port's kernel bit for bit",
                             digests, want)
    # The same kernel on the chunk's first 4,096 trials: one block an SM
    # instead of four.
    q = B_CHUNK // 4
    jq = (*ja[:2], regime[:, :q].contiguous(), ids[:q].contiguous(),
          signs[:q].contiguous(), sw)
    k1q_ms, _ = spread(lambda: joint.joint_generate(*jq), 3)
    # The plain version over the buffer and the first PLAIN_DAYS days; the
    # kernel's full-shape output is held to the first port's digests.
    plain_T = min(T, buf + PLAIN_DAYS)
    jp = (*ja[:2], regime[:plain_T].contiguous(), *ja[3:])
    xs = joint.joint_generate(*jp)
    plain_ms, xp = timed(lambda: joint.joint_plain(*jp), 1, warm=False)
    errs = [float((a - b).abs().max()) for a, b in zip(xs, xp)]
    for c in (0, 1, 2, 4):
        torch.testing.assert_close(xs[c], xp[c], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(xs[3], xp[3], rtol=0, atol=1e-3)
    log(f"K1 joint vs plain at B={B_CHUNK} over the first {plain_T} days: "
        f"max abs err x0..x2 {max(errs[:3]):.3e}, vix {errs[3]:.3e}, irx "
        f"{errs[4]:.3e}; output digests at T={T} equal the first port's; "
        f"kernel {fmt_spread(k1_ms)} over 5 runs at T={T} (at B={q}: "
        f"{fmt_spread(k1q_ms)}), plain {plain_ms:.3f} ms at T={plain_T}")
    rec["joint"] = with_bound(
        dict(max_abs_err=max(errs), ms=k1_ms[1], plain_ms=plain_ms,
             days=T, plain_days=plain_T,
             ms_spread=k1_ms, quarter_ms_spread=k1q_ms, digest_match=True),
        (T + 5 * T) * B_CHUNK * 4 + 8 * B_CHUNK,
        OPS_PER_TRIAL_DAY["joint"] * T * B_CHUNK)
    del xs, xp, jp

    chans = windowed(model_t, list(xk) + [regime], offs, sim)
    del xk
    ka = k3_args(model_t, ids, sw, chans)
    k3_ms, got = spread(lambda: k3.compose_strategies(*ka), 3)
    ms = k3_ms[1]
    plain_days = min(sim, PLAIN_DAYS)
    kc = (*ka[:4], *(c[:plain_days].contiguous() for c in ka[4:]))
    got = k3.compose_strategies(*kc)
    plain_ms, ref = timed(lambda: k3.compose_strategies_plain(*kc), 1,
                          warm=False)
    del kc
    st = k3.check_parity(dict(zip(k3.OUTPUTS, got)),
                         dict(zip(k3.OUTPUTS, ref)),
                         exact=("path_finite", "vix_min", "vix_max",
                                "regime_high_days"))
    # The same kernel on the chunk's first 4,096 trials: one block an SM
    # instead of four.
    q = B_CHUNK // 4
    kq = (*ka[:2], ka[2][:q], ka[3], *(c[:, :q].contiguous() for c in ka[4:]))
    k3q_ms, _ = spread(lambda: k3.compose_strategies(*kq), 3)
    log(f"K3 compose_strategies vs plain at B={B_CHUNK} over the first "
        f"{plain_days} days: {st}; kernel {fmt_spread(k3_ms)} over 3 runs at "
        f"S={sim} (at B={B_CHUNK // 4}: {fmt_spread(k3q_ms)}), plain "
        f"{plain_ms:.3f} ms at S={plain_days}")
    rec["compose_strategies"] = with_bound(
        dict(max_abs_err=st["max_abs_err"], ms=ms, plain_ms=plain_ms,
             days=sim, plain_days=plain_days,
             ms_spread=k3_ms, quarter_ms_spread=k3q_ms),
        6 * sim * B_CHUNK * 4 + 65 * B_CHUNK * 4,
        OPS_PER_TRIAL_DAY["compose_strategies"] * sim * B_CHUNK)
    del got, ref
    rec["compose"] = phase_k5(ka)
    del chans, ka

    rec["window"] = phase_k2(T, sim)
    rec["window_tiles"] = dict(rec["window"])     # the same kernel and call
    torch.cuda.empty_cache()
    rec["sort_bridge"] = phase_k7(sim)
    torch.cuda.empty_cache()
    rec["wash"] = phase_k8(sim)
    torch.cuda.empty_cache()
    return rec


def window_case(g, T, B, sim, offs, n_ch=2):
    """K2 against its plain version, bitwise, on n_ch random [T, B]
    channels (a bias on the first) at the offsets ``offs``."""
    from letf_tpu_torch.ops import window

    xs = [torch.randn((T, B), generator=g, device="cuda") for _ in range(n_ch)]
    xs[0][1, 0] = float("nan")
    xs[-1][2, B - 1] = -0.0
    bias = [torch.randn(B, generator=g, device="cuda")] + [None] * (n_ch - 1)
    got = window.window_offsets(xs, offs, sim, biases=bias)
    for a, b in zip(got, window.window_plain(xs, offs, sim, biases=bias)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def phase_k2(T, sim):
    """K2 against its plain version, bitwise (NaN payloads and -0.0
    included): the six channels at the main path's shape with independent
    offsets and with antithetic-paired ones (the chain's: trials 2k and
    2k + 1 share an offset), each timed over 5 runs; then a ragged B of 650
    (the replay's K2'), all offsets equal, and a span wider than a 32-trial
    ring holds (T - S = 3,000 at S = 2,520: the narrower-strip branch).
    Returns the record of the kernels line."""
    from letf_tpu_torch.ops import window

    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn((T, B_CHUNK), generator=g, device="cuda")
          for _ in range(5)]
    xs.append((torch.rand((T, B_CHUNK), generator=g, device="cuda")
               < 0.3).to(torch.float32))
    xs[0][7, 3] = float("nan")
    xs[1][11, 5] = -0.0
    bias = [torch.randn(B_CHUNK, generator=g, device="cuda")
            for _ in range(3)] + [None] * 3
    indep = torch.randint(0, T - sim + 1, (B_CHUNK,), generator=g,
                          device="cuda", dtype=torch.int32)
    paired = torch.randint(0, T - sim + 1, (B_CHUNK // 2,), generator=g,
                           device="cuda",
                           dtype=torch.int32).repeat_interleave(2)
    equal = torch.full((B_CHUNK,), (T - sim) // 2, device="cuda",
                       dtype=torch.int32)
    ms = {}
    for name, offs in (("independent", indep), ("antithetic-paired", paired),
                       ("all equal", equal)):
        ms[name], wk = spread(lambda: window.window_offsets(
            xs, offs, sim, biases=bias), 5)
        wp = window.window_plain(xs, offs, sim, biases=bias)
        for a, b in zip(wk, wp):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
        del wk, wp
        log(f"K2 window vs plain at B={B_CHUNK} T={T} S={sim}, 6 channels, "
            f"{name} offsets: bitwise equal; kernel {fmt_spread(ms[name])} "
            f"over 5 runs")
    plain_ms, _ = timed(lambda: window.window_plain(xs, indep, sim,
                                                    biases=bias), 3)
    # The one PyTorch call that computes the window: a gather over the six
    # channels side by side (the bias add left out).
    stacked = torch.cat(xs, dim=1)
    gidx = (torch.arange(sim, device="cuda")[:, None]
            + indep.long()[None, :]).repeat(1, 6)
    lib_ms, _ = timed(lambda: torch.gather(stacked, 0, gidx), 5)
    del stacked, gidx, xs
    torch.cuda.empty_cache()
    log(f"K2 plain at independent offsets {plain_ms:.3f} ms, torch.gather "
        f"{lib_ms:.3f} ms")
    window_case(g, T, 650, sim, torch.randint(
        0, T - sim + 1, (650,), generator=g, device="cuda", dtype=torch.int32))
    S2, T2 = 2520, 2520 + 3000
    window_case(g, T2, B_CHUNK, S2, torch.randint(
        0, T2 - S2 + 1, (B_CHUNK,), generator=g, device="cuda",
        dtype=torch.int32))
    log(f"K2 window vs plain: bitwise at B=650 (ragged strip), T={T}, "
        f"S={sim}; and at B={B_CHUNK}, T={T2}, S={S2} (spans past one "
        f"32-trial ring)")
    torch.cuda.empty_cache()
    return with_bound(dict(max_abs_err=0.0, ms=ms["independent"][1],
                           plain_ms=plain_ms,
                           ms_spread=ms["independent"],
                           paired_ms_spread=ms["antithetic-paired"],
                           equal_ms_spread=ms["all equal"]),
                      (2 * 6 * sim + 4) * B_CHUNK * 4, 3 * sim * B_CHUNK,
                      lib_ms)


# K5 against its plain version: every ETF plane, the adjusted SPY/QQQ and
# cash within rtol 1e-5 / atol 1e-6 (torch divides by a Python scalar as a
# multiply by its reciprocal on the card, the kernel divides, so the two
# differ by ulps that the tracking-error carry keeps), jump counts on at
# most one trial (a uniform within ulps of the jump probability), the
# liquidity and credit sums within rtol 1e-5. At the full shape also bit
# for bit the first port's kernel (K5_DIGESTS_FIRST_PORT), on all the
# chunk's trials and on the first K5_REPORT_B (the default report's
# shape), both timed over 5 runs.
def phase_k5(ka):
    from letf_tpu_torch.ops import compose

    S, B = ka[4].shape
    ms_spread, got = spread(lambda: compose.compose_generate(*ka), 5)
    ms = ms_spread[1]
    rb = K5_REPORT_B
    kr = (*ka[:2], ka[2][:rb].contiguous(), ka[3],
          *(c[:, :rb].contiguous() for c in ka[4:]))
    report_ms, got_r = spread(lambda: compose.compose_generate(*kr), 5)
    digests = None
    if S == FULL["sim"]:
        digests = {"chunk": [bit_digest(x) for x in got],
                   "report": [bit_digest(x) for x in got_r]}
        assert digests == K5_DIGESTS_FIRST_PORT, (
            "K5 is not the first port's kernel bit for bit", digests)
    del got_r
    # The plain version over the first PLAIN_DAYS days; the kernel's
    # full-shape output is held to the first port's digests.
    plain_days = min(S, PLAIN_DAYS)
    kp = (*ka[:4], *(c[:plain_days].contiguous() for c in ka[4:]))
    got = compose.compose_generate(*kp)
    plain_ms, ref = timed(lambda: compose.compose_plain(*kp), 1, warm=False)
    del kp
    errs = [float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4])]
    for a, b in zip(got[:4], ref[:4]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    jump_mismatch = int((got[4] != ref[4]).sum())
    assert jump_mismatch <= 1, jump_mismatch
    for a, b in zip(got[5:], ref[5:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
    held = ("output digests equal the first port's" if digests
            else "digests not held at this shape")
    log(f"K5 compose vs plain at B={B} over the first {plain_days} days: "
        f"max abs err etf {errs[0]:.3e}, spy/qqq adj {max(errs[1:3]):.3e}, "
        f"cash {errs[3]:.3e}; jump-count mismatches {jump_mismatch}; "
        f"bitwise {bitwise}; {held} at S={S}; kernel "
        f"{fmt_spread(ms_spread)} over 5 runs at S={S} (at B={rb}: "
        f"{fmt_spread(report_ms)}), plain {plain_ms:.3f} ms at "
        f"S={plain_days}")
    return with_bound(dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           days=S, plain_days=plain_days,
                           ms_spread=ms_spread, report_ms_spread=report_ms,
                           digest_match=bool(digests) or None),
                      (6 + 9) * S * B * 4 + 4 * B * 4,
                      OPS_PER_TRIAL_DAY["compose"] * S * B)


def bridge_sort_inputs(g, R, S, kind, n_pay, head_zero=False,
                       dtype=torch.float64):
    """Bridge-like K7 operands [2S, R]: non-negative keys of ``dtype`` with
    ties, ascending halves (the first half unsorted for "valley"), the
    unique packed secondary (tag << 24) | position, random payloads of
    ``dtype`` (zero in the first half with ``head_zero``, as the bridge's
    valley has them)."""
    N = 2 * S
    key = torch.round(torch.randn((N, R), generator=g, device="cuda",
                                  dtype=dtype).abs() * 4) / 4
    key[S:] = torch.sort(key[S:], dim=0).values
    if kind == "merge":
        key[:S] = torch.sort(key[:S], dim=0).values
    pos = torch.arange(N, device="cuda", dtype=torch.int32)
    sec = torch.where(pos >= S, pos | (1 << 24), pos)[:, None].expand(
        N, R).contiguous()
    pays = [torch.randn((N, R), generator=g, device="cuda", dtype=dtype)
            for _ in range(n_pay)]
    if head_zero:
        for p in pays:
            p[:S] = 0.0
    return key, sec, pays


# The K7 shapes of the exact-all bridge at 30 years (a 4,096-trial
# chunk's folds of two strategies, 8,192 columns, and S8's 4,096) and at
# the reference's 50-year horizon, where the sec row leaves shared memory:
# (kind, payloads, days a half, columns).
K7_EXACT_SHAPES = (("merge", 2, 7560, 8192), ("valley", 4, 7560, 8192),
                  ("merge", 2, 7560, 4096), ("valley", 4, 7560, 4096),
                  ("merge", 2, 12600, 256), ("valley", 4, 12600, 256))


def phase_k7(sim):
    """K7 (float64 keys and payloads, int32 sec) against its plain version
    (one full stable sort, float64 keys in IEEE total order), bitwise:
    merge and valley at R = 600 (the sampled report's bridge batch) and
    2,048 rows of 2 x sim days with 0, 2 and 4 payloads; then (not with
    --quick) at the exact-all bridge's shapes and the 50-year ones
    (K7_EXACT_SHAPES, the valley with zero head payloads as the bridge
    calls it), each timed over 5 runs beside one stable torch.sort of the
    float64 keys' total-order int64 (the library call for the same
    ordering)."""
    from letf_tpu_torch.ops import sort_bridge as k7

    g = torch.Generator(device="cuda").manual_seed(71)
    out = dict(max_abs_err=0.0)
    for R in (600, 2048):
        for kind in ("merge", "valley"):
            for n_pay in (0, 2, 4):
                key, sec, pays = bridge_sort_inputs(g, R, sim, kind, n_pay)
                args = (key, sec, tuple(pays), kind)
                ms, got = timed(lambda: k7.sort_bridge(*args), 3)
                plain_ms, ref = timed(lambda: k7.sort_bridge_plain(*args), 3)
                for a, b in zip(got, ref):
                    assert torch.equal(a, b), (R, kind, n_pay)
                log(f"K7 sort_bridge {kind} vs plain at [{2 * sim}, {R}], "
                    f"{n_pay} payloads: bitwise equal; kernel {ms:.3f} ms, "
                    f"plain {plain_ms:.3f} ms")
                if (R, kind, n_pay) == (600, "merge", 2):
                    ok = k7._order_key(key, None)
                    lib_ms, _ = timed(lambda: torch.sort(ok, dim=0,
                                                         stable=True), 3)
                    N = 2 * sim
                    with_bound(out, N * R * (2 * 12 + 2 * 8 * n_pay),
                               N * R * math.log2(sim), lib_ms)
                    out.update(ms=ms, plain_ms=plain_ms)
    if sim != FULL["sim"]:
        return out
    shapes = []
    for kind, n_pay, S, R in K7_EXACT_SHAPES:
        hz = kind == "valley"
        key, sec, pays = bridge_sort_inputs(g, R, S, kind, n_pay, hz)
        args = (key, sec, tuple(pays), kind, hz)
        ms, got = spread(lambda: k7.sort_bridge(*args), 5)
        ref = k7.sort_bridge_plain(*args)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), (kind, n_pay, S, R)
        del got, ref
        ok = k7._order_key(key, None)
        lib_ms, _ = spread(lambda: torch.sort(ok, dim=0, stable=True), 3)
        del ok
        # Bytes: key (8) and sec (4) both halves, the payloads' tails (and
        # heads unless zero), every output.
        nbytes = R * (12 * 2 * S + 8 * n_pay * (S if hz else 2 * S)
                      + (12 + 8 * n_pay) * 2 * S)
        b_ms, _ = bound(nbytes, 0.0)
        shapes.append(dict(kind=kind, payloads=n_pay, shape=[2 * S, R],
                           ms_spread=ms, torch_sort_ms=lib_ms[1],
                           bound_ms=b_ms))
        log(f"K7 sort_bridge {kind} at [{2 * S}, {R}], {n_pay} payloads"
            f"{' (zero head)' if hz else ''}: bitwise its plain version; "
            f"kernel {fmt_spread(ms)}, torch.sort {fmt_spread(lib_ms)}, "
            f"bound {b_ms:.3f} ms")
        del key, sec, pays
        torch.cuda.empty_cache()
    out["shapes"] = shapes
    return out


def wash_inputs(g, S, B):
    """Bridge-like K8 inputs [S, B] in float64: sparse buys, sells, losses
    on half the sells."""
    def sparse(p, scale):
        u = torch.rand((S, B), generator=g, device="cuda",
                       dtype=torch.float64)
        v = torch.rand((S, B), generator=g, device="cuda",
                       dtype=torch.float64) * scale
        return torch.where(u < p, v, 0.0)

    buy, sell = sparse(0.25, 6.0), sparse(0.15, 8.0)
    return torch.where(sell > 0, sparse(0.5, 100.0), 0.0), sell, buy


def wash_edge_inputs(g, case, B):
    """K8 edge cases at B trials: [S, B] float64 loss, sell, buy."""
    at = torch.tensor(0.001, dtype=torch.float64, device="cuda")
    above = torch.nextafter(at, torch.ones_like(at))
    loss, sell, buy = wash_inputs(g, 97 if case != "one_day" else 1, B)
    S = loss.shape[0]
    f64 = dict(generator=g, device="cuda", dtype=torch.float64)
    if case == "every_day_a_loss":
        loss = torch.rand((S, B), **f64) * 50 + 1
    elif case == "buys_every_day":
        buy = torch.rand((S, B), **f64) * 5 + 0.5
    elif case == "buys_at_the_threshold":
        pick = torch.randint(0, 3, (S, B), generator=g, device="cuda")
        buy = torch.where(pick == 0, at, torch.where(pick == 1, above, 0.0))
    elif case == "first_and_last_day_losses":
        loss = torch.zeros_like(loss)
        loss[[0, S - 1]] = 50.0
        buy = torch.zeros_like(buy)
        buy[[1, 30, 31, S - 2, S - 31, S - 32]] = 2.0
    return loss, sell, buy


WASH_EDGE_CASES = ("one_day", "ragged_days", "every_day_a_loss",
                   "buys_every_day", "buys_at_the_threshold",
                   "first_and_last_day_losses")


def phase_k8(sim, B=650, B_exact=8192):
    """K8 (float64) against its plain version, bitwise, at [sim, 650] (the
    sampled report's batch) on bridge-like inputs (sparse buys, sells,
    losses on half the sells), and on edge cases (one day, 97 days, a loss
    every day, a buy every day, buys of exactly 0.001 shares and the next
    float, losses on the first and last days) at 1, 33 and 650 trials;
    then (not with --quick) at [sim, 8,192], the exact-all bridge's fold
    of two strategies. Its time by CUDA events around the wrapper (three
    launches, their outputs and scratch allocated there; the median of 5
    runs) and, at 650 trials, the three kernels' device time by the
    profiler."""
    from letf_tpu_torch.ops import wash

    g = torch.Generator(device="cuda").manual_seed(8)
    loss, sell, buy = wash_inputs(g, sim, B)
    ms_spread, got = spread(lambda: wash.wash_matching(loss, sell, buy), 5)
    ms = ms_spread[1]
    plain_ms, ref = timed(lambda: wash.wash_plain(loss, sell, buy), 1,
                          warm=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    _, dev_ms, top = device_profile(lambda: wash.wash_matching(loss, sell,
                                                               buy))
    n_edge = 0
    for case in WASH_EDGE_CASES:
        for nb in (1, 33, 650):
            args = wash_edge_inputs(g, case, nb)
            for a, b in zip(wash.wash_matching(*args), wash.wash_plain(*args)):
                assert torch.equal(a, b), (case, nb)
            n_edge += 1
    n_match = int(got[2].sum())
    log(f"K8 wash vs plain at [{sim}, {B}]: bitwise equal ({n_match} "
        f"matched loss days, {int((loss > 0).sum())} loss days); bitwise on "
        f"{n_edge} edge cases; kernel {fmt_spread(ms_spread)} over 5 runs, "
        f"its three launches' device time {dev_ms:.4f} ms "
        f"({'; '.join(f'{k[:40]} {v:.4f}' for k, v in top)}), plain "
        f"{plain_ms:.3f} ms")
    # Bytes: the three float64 inputs read once, dis (8 bytes), off (4)
    # and has (1) written once. Operations: the two float64 compares of
    # every trial-day (loss > 0, buy > 0.001) and, on a matched loss day,
    # the compare, max, division and product of the epilogue; the bitset
    # matching is integer work.
    out = with_bound(dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                          ms_spread=ms_spread, device_ms=dev_ms),
                     37 * sim * B, 2 * sim * B + 4 * n_match, peak=PEAK_F64)
    del loss, sell, buy, got, ref
    if sim != FULL["sim"]:
        return out
    loss, sell, buy = wash_inputs(g, sim, B_exact)
    x_spread, got = spread(lambda: wash.wash_matching(loss, sell, buy), 5)
    x_plain_ms, ref = timed(lambda: wash.wash_plain(loss, sell, buy), 1,
                            warm=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b), "K8 at the exact-all fold"
    n_match = int(got[2].sum())
    b_ms, by = bound(37 * sim * B_exact, 2 * sim * B_exact + 4 * n_match,
                     PEAK_F64)
    out["shapes"] = [dict(shape=[sim, B_exact], ms_spread=x_spread,
                          plain_ms=x_plain_ms, bound_ms=b_ms, bound_by=by)]
    log(f"K8 wash vs plain at [{sim}, {B_exact}]: bitwise equal "
        f"({n_match} matched loss days); kernel {fmt_spread(x_spread)} over "
        f"5 runs, plain {x_plain_ms:.3f} ms, bound {b_ms:.3f} ms")
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel of the reports -- the production chunk's K1, K2,
    K3, the general path's K2', K4 and K5 and the bridge's K7 and K8 --
    through its plain PyTorch version (on the card), for the
    kernels-vs-plain comparison of whole reports."""
    from letf_tpu_torch.ops import compose, joint, path_batched, slab_chunk
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import sort_bridge, strategies, wash, window
    from letf_tpu_torch.tax import device_bridge

    swaps = [(path_batched, "joint_generate", joint.joint_plain),
             (path_batched, "window_offsets", window.window_plain),
             (strategies, "strategies_run", strategies.strategies_plain),
             (path_batched, "compose_generate", compose.compose_plain),
             (slab_chunk, "compose_strategies", k3.compose_strategies_plain),
             (device_bridge, "sort_bridge", sort_bridge.sort_bridge_plain),
             (device_bridge, "wash_matching", wash.wash_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


def phase_small_report(model):
    """Kernels vs plain versions on the card: 1,024 trials x 0.5 year
    (a 1-year start buffer: the plain K1 loops over every buffer day) per
    trial (K3 bounds) and as a pre-tax report; and the default sampled
    report at 1,024 trials x 1 year, whose post-tax fans and median taxes
    must agree within 1% (of at least $100): the replayed rows, K1 and the
    bridge agree bitwise, K5 and K3 to ulps that flip a few trades."""
    from letf_tpu_torch import config as tcfg
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.parallel import mc_runner

    kw = dict(num_simulations=1024, seed=2, chunk_size=1024, device="cuda")
    saved, tcfg.RANDOM_START_BUFFER_YEARS = tcfg.RANDOM_START_BUFFER_YEARS, 1
    try:
        arr_k = mc_runner.run_monte_carlo(model, 0.5, **kw)
        rep_k = mc_runner.monte_carlo_report(model, 0.5, tax_mode="none",
                                             **kw)
        tax_k = mc_runner.monte_carlo_report(model, 1, **kw)
        with plain_kernels():
            arr_p = mc_runner.run_monte_carlo(model, 0.5, **kw)
            rep_p = mc_runner.monte_carlo_report(model, 0.5,
                                                 tax_mode="none", **kw)
            tax_p = mc_runner.monte_carlo_report(model, 1, **kw)
    finally:
        tcfg.RANDOM_START_BUFFER_YEARS = saved
    st = k3.check_parity(vars(arr_k), vars(arr_p),
                         exact=("path_finite", "regime_high_days",
                                "start_offset", "start_regime"),
                         at_most_one=("valid", "repaired"))
    for sid, s in rep_k["strategies"].items():
        for p, w in s["wealth"].items():
            wp = rep_p["strategies"][sid]["wealth"][p]
            assert abs(w - wp) <= 5e-3 * max(abs(wp), 1.0), (sid, p, w, wp)
    assert rep_k["finite_frac"] == 1.0 and rep_k["valid_frac"] > 0.5, rep_k
    log(f"report 1024 x 0.5y, kernels vs plain on the card: {st}; "
        f"valid_frac {rep_k['valid_frac']} (plain {rep_p['valid_frac']})")
    worst = 0.0
    for sid, s in tax_k["strategies"].items():
        if "post_tax" not in s:
            continue
        pk, pp = s["post_tax"], tax_p["strategies"][sid]["post_tax"]
        pairs = [(pk["wealth"][q], pp["wealth"][q]) for q in pk["wealth"]]
        pairs.append((pk["median_tax"], pp["median_tax"]))
        for a, b in pairs:
            assert np.isfinite(a) and abs(a - b) <= 0.01 * max(abs(b), 100.0), \
                (sid, a, b)
            worst = max(worst, abs(a - b) / max(abs(b), 100.0))
    s7 = tax_k["strategies"]["S7"]["post_tax"]
    log(f"sampled report 1024 x 1y, kernels vs plain on the card: 13 "
        f"post-tax tables, worst relative difference {worst:.3e}; S7 "
        f"post-tax p50 {s7['wealth']['p50']:.4f} (plain "
        f"{tax_p['strategies']['S7']['post_tax']['wealth']['p50']:.4f})")


# Bounds of the general path against the slab path: those of
# tests/test_path_batched.py:373-392 (median relative wealth error, share
# of cells above 1e-3, share of trade counts that differ, the p10/p50/p90
# fans' rtol), and looser ones for K4's channel mode at 30 years, whose
# signals come from the signal pass's float32 cumsum-difference windows
# (letf_tpu/ops/rolling.py's algorithm; the slab path sums its windows
# exactly in the ring), which drift over 8,820 days and flip borderline
# trades. The JAX package drifts as far between its own two signal
# sources: tools/channel_signal_drift.py (30 years, on the CPU) reads
# 2.5e-5, 0.108, 0.506, 0.022 at 1,024 trials (seed 11) and 2.4e-5, 0.105,
# 0.510, 0.017 at 2,048 (seed 12); the port's channel mode on the card
# read 5.1e-5, 0.159, 0.488, 0.011 at 16,384 (H100, 700 W).
SLAB_BOUNDS = (1e-5, 0.01, 0.05, 5e-3)
CHANNEL_BOUNDS = (1e-4, 0.2, 0.6, 2e-2)


def general_vs_slab_stats(fw, nt, sm, bounds=SLAB_BOUNDS):
    """The general path's summaries against the slab path's on the same
    trials, within ``bounds``."""
    sfw = sm["final_wealth"].cpu().numpy()
    snt = sm["num_trades"].cpu().numpy()
    fw, nt = fw.cpu().numpy(), nt.cpu().numpy()
    rel = np.abs(sfw - fw) / np.maximum(np.abs(fw), 1.0)
    fan = [np.abs(np.percentile(sfw, q, axis=0) - np.percentile(fw, q, axis=0))
           / np.maximum(np.abs(np.percentile(fw, q, axis=0)), 1.0)
           for q in (10, 50, 90)]
    stats = dict(median_rel=float(np.median(rel)),
                 frac_rel_gt_1e3=float((rel > 1e-3).mean()),
                 trades_mismatch=float((snt != nt).mean()),
                 fan_max_rel=float(np.max(fan)))
    for (k, v), b in zip(stats.items(), bounds):
        assert v < b, (k, stats, bounds)
    return stats


def phase_general_vs_slab(model_t):
    """The general path against the slab path (K1, K2, K3) on the same
    trials, B = 16,384:
    - with the emitting engine at 2 years + a 2-year buffer;
    - without emission at 30 years + the 5-year buffer (K1, K2', K5, then
      K4), which holds K4 at its full shape against K3. K4's fused-signals
      mode computes the signals as K3 does and is held to SLAB_BOUNDS; its
      channel mode, the main path's, reads the signal pass's windows and is
      held to CHANNEL_BOUNDS, to its plain version (phase_k4) and to the
      JAX package (phase_jax_reference)."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.ops.slab_chunk import slab_chunk_summaries
    from letf_tpu_torch.strategies.engine import run_strategies_batch
    from letf_tpu_torch.strategies.signals import compute_signals

    rows = torch.arange(B_CHUNK, device="cuda")
    ids, anti, key = rows // 2, rows % 2 == 1, rng.key(11, "cuda")
    for S, buf, emit in ((2 * 252, 504, True),
                         (FULL["sim"], FULL["buf"], False)):
        t0 = time.perf_counter()
        p = generate_paths_batched(model_t, key, ids, anti, sim_days=S,
                                   buffer_days=buf)
        sig = compute_signals(p)
        runs = {}
        if emit:
            r = run_strategies_batch(p, sig, emit_trades=True)
            runs["emitting engine"] = (r.final_wealth, r.num_trades, None)
        else:
            chans = k4.channels_from(p, sig)
            del sig
            runs["K4 channel mode"] = k4.strategies_run(chans)
            runs["K4 fused-signals mode"] = k4.strategies_run(
                chans[:k4.N_FUSED], fused_signals=True)
            del chans
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        sm = slab_chunk_summaries(model_t, key, ids, anti, sim_days=S,
                                  buffer_days=buf)
        assert torch.equal(sm["valid"], p.valid)
        assert torch.equal(sm["jump_days"], p.jump_days)
        torch.testing.assert_close(sm["liq_mean"], p.liq_mean, rtol=0,
                                   atol=1e-6)
        for what, (fw, nt, mdd) in runs.items():
            bounds = (CHANNEL_BOUNDS if what == "K4 channel mode"
                      else SLAB_BOUNDS)
            stats = general_vs_slab_stats(fw, nt, sm, bounds)
            if what == "K4 fused-signals mode":
                # K3 (the slab path's) runs K4's day math split over warps:
                # the same operations, so the same bits.
                for a, b in ((fw, sm["final_wealth"]),
                             (nt, sm["num_trades"]), (mdd, sm["max_dd"])):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32)), what
                stats["bitwise"] = True
            log(f"general path + {what} vs slab path at B={B_CHUNK}, "
                f"{S} days + {buf}-day buffer: {stats} (bounds {bounds}); "
                f"valid and jump days equal; general path + strategies "
                f"{t_gen:.3f} s")
        del p, sm, runs
        torch.cuda.empty_cache()


def phase_pretax(model, counters):
    """The pre-tax report alone, 65,536 trials x 30 years."""
    from letf_tpu_torch.parallel import mc_runner

    n, years = 65536, 30
    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = mc_runner.monte_carlo_report(
        model, years, num_simulations=n, seed=2, chunk_size=B_CHUNK,
        tax_mode="none", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    chunks = n // B_CHUNK
    log(f"pre-tax path: monte_carlo_report {n} x {years}y, chunks of "
        f"{B_CHUNK}: wall {wall:.3f} s, "
        f"{n * years * 252 / wall:.6e} trial-days/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    check_pretax(rep, 0.0015, 0.02, 0.006)
    assert launches["joint"] == chunks, launches
    assert launches["compose_strategies"] == chunks, launches
    assert launches["window"] == chunks, launches
    for k in ("window_tiles", "compose", "strategies", "gbm", "draws"):
        assert launches[k] == 0, launches
    return launches


def check_pretax(rep, tol_valid, tol_cagr, tol_ruin):
    """Pre-tax checks against the JAX reference's 1,048,576 x 30y report
    of the same model and seed (BENCH_FULL_r05.json): the VIX-range
    validity check saturates at 30 years (valid_frac 0.002787), p90 S1
    (TQQQ) CAGR -0.4946, S1 ruin_frac 0.0682; S2 never ruins."""
    s1, s2 = rep["strategies"]["S1"], rep["strategies"]["S2"]
    log("report: " + json.dumps({
        "valid_frac": rep["valid_frac"], "finite_frac": rep["finite_frac"],
        "S1": {"p50": s1["wealth"]["p50"], "p90_cagr": s1["cagr"]["p90"],
               "ruin_frac": s1["ruin_frac"]},
        "S2": {"p10": s2["wealth"]["p10"], "p50": s2["wealth"]["p50"],
               "p90": s2["wealth"]["p90"], "ruin_frac": s2["ruin_frac"]}}))
    for sid, s in rep["strategies"].items():
        assert all(np.isfinite(v) for v in s["wealth"].values()), sid
    assert rep["finite_frac"] == 1.0, rep["finite_frac"]
    assert s2["ruin_frac"] == 0.0, s2
    assert abs(rep["valid_frac"] - 0.002787) < tol_valid, rep["valid_frac"]
    assert abs(s1["cagr"]["p90"] - (-0.4946)) < tol_cagr, s1
    assert abs(s1["ruin_frac"] - 0.0682) < tol_ruin, s1


# The JAX reference at 1,048,576 x 30y, seed 2, default tax configuration:
# its default (sampled) report (bench.py:437-452, BENCH_FULL_r05.json) and
# its exact-all run, every trial taxed (EXACT_TAX_SCALE_r05.json).
REF_SAMPLED = {"S7": {"post_tax_p50": 8946.5, "median_tax": 1437.2},
               "S8": {"median_tax": 15258.9}}
REF_EXACT = {"S7": {"post_tax_p50": 5347.93, "median_tax": 2068.57},
             "S8": {"post_tax_p50": 0.0, "median_tax": 1061.08}}


def phase_main_path(model, counters):
    """The default report at full size: monte_carlo_report(
    default_sim_model(), 30, 1,048,576 trials, seed 2, chunks of 16,384)
    with its default tax_mode="sampled", the launch counters set to 0
    just before and read just after."""
    from letf_tpu_torch.parallel import mc_runner

    n, years = 1_048_576, 30
    reset(counters)
    GENERAL_TRIALS.clear()
    stages = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = mc_runner.monte_carlo_report(
        model, years, num_simulations=n, seed=2, chunk_size=B_CHUNK,
        device="cuda", stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    chunks = n // B_CHUNK
    log(f"default report: monte_carlo_report {n} x {years}y (tax_mode "
        f"{rep['tax_mode']!r}), chunks of {B_CHUNK}: wall {wall:.3f} s, "
        f"post_tax_seconds {rep['post_tax_seconds']}, pre-tax "
        f"{wall - rep['post_tax_seconds']:.3f} s, "
        f"{n * years * 252 / wall:.6e} trial-days/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, post-tax "
        f"stages (s) {json.dumps(stages)}, launches {launches}, "
        f"general path (K5) at {GENERAL_TRIALS} trials")
    check_pretax(rep, 0.0005, 0.005, 0.003)
    post = {sid: rep["strategies"][sid]["post_tax"] for sid in ("S7", "S8")}
    log("post-tax: " + json.dumps(
        {sid: {"pre_tax_p50": rep["strategies"][sid]["wealth"]["p50"],
               "wealth": e["wealth"], "median_tax": e["median_tax"],
               "win_rate_vs_spy_post_tax": e["win_rate_vs_spy_post_tax"],
               "n_sampled": e["n_sampled"]} for sid, e in post.items()})
        + "; reference (sampled) " + json.dumps(REF_SAMPLED))
    for sid in rep["strategies"]:
        e = rep["strategies"][sid].get("post_tax")
        if e is not None:
            assert all(np.isfinite(v) for v in e["wealth"].values()), sid
            assert np.isfinite(e["median_tax"]) and e["median_tax"] >= 0
    assert len([s for s in rep["strategies"].values()
                if "post_tax" in s]) == 13
    assert launches["joint"] == chunks + 1, launches
    assert launches["compose_strategies"] == chunks, launches
    assert launches["window"] == chunks, launches
    assert launches["window_tiles"] == 1, launches
    assert launches["compose"] == 1, launches
    assert launches["sort_bridge"] == 6, launches
    assert launches["wash"] == 3, launches
    assert launches["emit_days"] == 1, launches
    assert launches["strategies"] == 0 and launches["gbm"] == 0, launches
    return launches, rep


def phase_tax_reference(model, rep, n=1_048_576, years=30, stride=128,
                        chunk=4096, draws=10_000, seed=0):
    """Holds the default report's post-tax tables to the JAX reference.

    The sampled estimator taxes one trial per sorted-wealth node (50
    nodes) and interpolates between them, so its median tax and post-tax
    p50 hinge on which trials sit at the nodes: the port's K3 differs from
    the TPU's by ulps that reorder neighbouring trials, and any faithful
    port samples other, equally valid, trials. Two checks therefore:
    1. Exact taxes of a systematic subsample (every 128th of the same
       1,048,576 trials, 8,192 of them) through the same replay, bridge
       and tax as the exact-all report (float64): their S7/S8 post-tax p50 and median tax drag (the
       reference's exact-all statistic, median of wealth minus post-tax
       wealth, i.e. of the tax capped at the wealth) must lie within 4
       bootstrap standard errors of the reference's exact-all values.
    2. The sampled estimator emulated on that subsample's exact taxes (50
       nodes at the evenly spaced sorted positions, each node's trial
       drawn among its 9 nearest in wealth, 10,000 draws): the port's
       sampled S7 p50, S7 median tax and S8 median tax must rank inside
       the emulated estimator's central 99.8%, and the reference's sampled
       values inside its central 99.98%.
    Returns the subsample's rows and {sid: (wealth, tax)} of S7 and S8."""
    from letf_tpu_torch import reporting
    from letf_tpu_torch.parallel import mc_runner

    t0 = time.perf_counter()
    run = mc_runner._Run(model, years, n, 2)
    ids, anti = mc_runner._trial_layout(n, run.use_antithetic)
    rows = np.arange(0, n, stride)
    income, tax_kw = reporting.tax_setup(None, years)
    cols = {"S7": (0,), "S8": (0, 1)}
    tax = {sid: [] for sid in cols}
    wealth = {sid: [] for sid in cols}
    for lo in range(0, len(rows), chunk):
        r = rows[lo:lo + chunk]
        summ, em = mc_runner.general_chunk(run, ids[r], anti[r])
        for sid, assets in cols.items():
            c = mc_runner.cfg.TAXABLE_IDS.index(sid)
            stacked = reporting.bridge_columns(e[:, :, c].contiguous()
                                               for e in em)
            tax[sid].append(reporting.bridge_tax(
                stacked, assets, years, income, tax_kw).cpu())
            wealth[sid].append(summ["final_wealth"][
                :, mc_runner.cfg.STRATEGY_INDEX[sid]].cpu())
        del summ, em
    rng_np = np.random.default_rng(seed)
    out, failed = {}, []
    for sid in cols:
        t = torch.cat(tax[sid]).double().numpy()
        w = torch.cat(wealth[sid]).double().numpy()
        post = np.maximum(w - t, 0.0)
        boot = rng_np.integers(0, len(t), (200, len(t)))
        drag = w - post
        stats = {"median_tax": (np.median(drag),
                                np.median(drag[boot], axis=1)),
                 "post_tax_p50": (np.median(post),
                                  np.median(post[boot], axis=1))}
        for k, (v, bs) in stats.items():
            se = float(bs.std())
            ref = REF_EXACT[sid][k]
            out[f"{sid}_exact_{k}"] = dict(value=float(v), se=se, ref=ref)
            if abs(v - ref) > 4.0 * se + 1.0:
                failed.append((sid, "exact", k))
        # The sampled estimator on the subsample's exact taxes.
        order = np.argsort(w, kind="stable")
        ws, ts = w[order], t[order]
        m = len(ws)
        base = np.round(np.linspace(0, m - 1, 50)).astype(int)
        est = {"post_tax_p50": [], "median_tax": []}
        for _ in range(draws):
            nodes = np.clip(base + rng_np.integers(-4, 5, 50), 0, m - 1)
            ti = np.interp(ws, ws[nodes], ts[nodes])
            est["post_tax_p50"].append(np.median(np.maximum(ws - ti, 0.0)))
            est["median_tax"].append(np.median(ti))
        pt = rep["strategies"][sid]["post_tax"]
        for k, e in est.items():
            e = np.asarray(e)
            got = pt["wealth"]["p50"] if k == "post_tax_p50" \
                else pt["median_tax"]
            ref = REF_SAMPLED[sid].get(k)

            def rank(v, e=e):
                return float((e < v).mean() + 0.5 * (e == v).mean())

            out[f"{sid}_sampled_{k}"] = dict(
                port=got, port_rank=rank(got), ref=ref,
                ref_rank=None if ref is None else rank(ref),
                q001_q999=[float(x) for x in np.quantile(e, [0.001, 0.999])])
            if not 0.001 <= rank(got) <= 0.999 and e.min() != e.max():
                failed.append((sid, "sampled", k, "port"))
            if ref is not None and not 1e-4 <= rank(ref) <= 1 - 1e-4:
                failed.append((sid, "sampled", k, "reference"))
    log(f"tax reference check ({len(rows)} trials exactly taxed, "
        f"{time.perf_counter() - t0:.1f} s): " + json.dumps(out))
    assert not failed, failed
    return rows, {sid: (torch.cat(wealth[sid]).double().numpy(),
                        torch.cat(tax[sid]).double().numpy())
                  for sid in cols}


@contextlib.contextmanager
def replay_clock(stages):
    """Times the bridge's replay_trades (its day loop) on the host clock
    after a sync, into stages["replay_trades"], while the block runs."""
    from letf_tpu_torch.tax import device_bridge

    inner = device_bridge.replay_trades

    def replay_trades(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        stages["replay_trades"] = (stages.get("replay_trades", 0.0)
                                   + time.perf_counter() - t0)
        return out

    device_bridge.replay_trades = replay_trades
    try:
        yield
    finally:
        device_bridge.replay_trades = inner


# The JAX reference's exact-all run: 1,048,576 x 30y, seed 2, default tax
# configuration, every trial taxed (TPU; only its statistics are used).
EXACT_TAX_REFERENCE = "EXACT_TAX_SCALE_r05.json"


def first_fold_plain(first):
    """The first bridge fold kept in ``first`` again through K7's and K8's
    plain versions: (bitwise the kernels' taxes, seconds)."""
    from letf_tpu_torch import reporting
    from letf_tpu_torch.ops import sort_bridge, wash
    from letf_tpu_torch.tax import device_bridge

    saved = (device_bridge.sort_bridge, device_bridge.wash_matching)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_bridge.sort_bridge = sort_bridge.sort_bridge_plain
    device_bridge.wash_matching = wash.wash_plain
    try:
        plain = reporting.bridge_activity_tax(first["cols"],
                                              *first["args"])[0].cpu()
    finally:
        device_bridge.sort_bridge, device_bridge.wash_matching = saved
    torch.cuda.synchronize()
    return (bool(np.array_equal(plain.numpy(), first["total"])),
            time.perf_counter() - t0)


@contextlib.contextmanager
def keep_first_fold(first):
    """Keeps the first bridge fold of the block's reports (its columns,
    its other arguments and its taxes) in ``first``, and the seconds the
    keeping took."""
    from letf_tpu_torch import reporting

    inner = reporting.bridge_activity_tax
    first["keep_seconds"] = 0.0

    def bridge_activity_tax(stacked, *args, **kw):
        total, ok = inner(stacked, *args, **kw)
        if "cols" not in first:
            t0 = time.perf_counter()
            first["cols"] = [c.clone() for c in stacked]
            first["args"] = args[:6]      # no stage seconds
            first["total"] = total.cpu().numpy()
            first["keep_seconds"] = time.perf_counter() - t0
        return total, ok

    reporting.bridge_activity_tax = bridge_activity_tax
    try:
        yield
    finally:
        reporting.bridge_activity_tax = inner


def phase_exact_all(model, counters, shared, n=8_192, years=30, seed=0):
    """This slice's main path: monte_carlo_report(default_sim_model(), 30,
    n trials, seed 2, tax_mode="exact_all"), every trial taxed exactly in
    4,096-trial chunks, the launch counters set to 0 just before and read
    just after, its post-tax stages timed (replay_trades apart). Holds: no
    trial dropped as non-finite (the default on_nonfinite="raise" would
    have raised); each taxable strategy's post-tax p50 and median tax
    drag, from the per-trial vectors the report reduces, within 4
    bootstrap standard errors (+$1) of the reference's exact-all values
    (EXACT_TAX_REFERENCE); the trials shared with phase_tax_reference's
    stride-128 subsample (``shared``) have the same S7 and S8 wealth and
    drag to float32 rounding; K7 launched 16 times a chunk (12 valley and
    merge sorts on the folds of two strategies, 4 on S8's two assets) and
    K8 8 times.

    The report's chunks are also broken down by stage: the host seconds of
    the emission, the bridge with its replay_trades apart, the tax and the
    reduction; the device milliseconds (CUDA events) of K7
    (sort_bridge._merge_halves), of the merge and valley sorts around it,
    of the restore torch.sort and of K8; the device's busy share as
    nvidia-smi samples it.

    After the counted run and counted apart, the first chunk's first
    bridge fold (kept as the report built it, the keeping's seconds taken
    off the run's wall) runs again through K7's and K8's plain versions:
    its float64 taxes must equal the kernels' bit for bit. Returns the
    launches."""
    from pathlib import Path

    from letf_tpu_torch import config as tcfg
    from letf_tpu_torch import reporting
    from letf_tpu_torch.ops import sort_bridge
    from letf_tpu_torch.parallel import mc_runner
    from letf_tpu_torch.tax import device_bridge

    ref = json.loads((Path(__file__).resolve().parent
                      / EXACT_TAX_REFERENCE).read_text())["per_strategy"]
    values, stages, dev_ms, samples = {}, {}, {}, []

    # The report's exact-tax helper, asked for the per-trial vectors it
    # reduces.
    inner = reporting.exact_post_tax_all_trials

    def exact_post_tax_all_trials(*args, **kw):
        return inner(*args, trial_values=values, **kw)

    first = {}
    reporting.exact_post_tax_all_trials = exact_post_tax_all_trials
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(keep_first_fold(first))
            stack.enter_context(replay_clock(stages))
            stack.enter_context(device_clock(
                dev_ms, "K7", sort_bridge, "_merge_halves"))
            stack.enter_context(device_clock(
                dev_ms, None, device_bridge, "sort_bridge",
                key=lambda a, kw: f"sort_bridge {kw.get('kind', 'merge')}"))
            stack.enter_context(device_clock(
                dev_ms, "K8", device_bridge, "wash_matching"))
            stack.enter_context(busy_samples(samples))
            reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = mc_runner.monte_carlo_report(
                model, years, num_simulations=n, seed=2,
                tax_mode="exact_all", device="cuda", stage_seconds=stages)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0 - first["keep_seconds"]
            launches = read(counters)
    finally:
        reporting.exact_post_tax_all_trials = inner
    chunks = -(-n // 4096)
    per_chunk = {k: v / chunks for k, v in dev_ms.items()}
    per_chunk["valley and merge sorts besides K7"] = (
        per_chunk.get("sort_bridge valley", 0.0)
        + per_chunk.get("sort_bridge merge", 0.0) - per_chunk["K7"])
    log(f"exact_all breakdown, a {4096} x {years}y chunk on average: "
        f"device ms (CUDA events) {json.dumps(per_chunk)}; device busy "
        f"over the report (nvidia-smi utilization.gpu, {len(samples)} "
        f"samples of 100 ms) mean "
        f"{float(np.mean(samples)) if samples else float('nan'):.1f}%")
    assert samples and per_chunk["K7"] > 0 and per_chunk["K8"] > 0
    log(f"exact_all report: monte_carlo_report {n} x {years}y "
        f"(tax_mode {rep['tax_mode']!r}): wall {wall:.3f} s (without the "
        f"{first['keep_seconds']:.3f} s of keeping the first chunk's "
        f"bridge batches), post_tax_seconds {rep['post_tax_seconds']}, "
        f"post-tax stages (s) {json.dumps(stages)}, "
        f"{n * years * 252 / rep['post_tax_seconds']:.6e} taxed "
        f"trial-days/s, launches {launches}")

    reset(counters)
    plain_equal, m_seconds = first_fold_plain(first)
    m_launches = read(counters)
    del first["cols"]
    log("exact_all: the first chunk's first bridge fold again through K7's "
        f"and K8's plain versions ({m_seconds:.1f} s, launches "
        f"{m_launches}): float64 taxes bitwise the kernels': {plain_equal}")
    assert plain_equal, "K7/K8 differ from their plain versions"
    assert not any(m_launches.values()), m_launches
    rng_np = np.random.default_rng(seed)
    out, failed = {}, []
    for sid in tcfg.TAXABLE_IDS:
        pt = rep["strategies"][sid]["post_tax"]
        w, pw = values[sid]
        assert pt["n_sampled"] == len(w) == n, (sid, pt["n_sampled"])
        assert np.isfinite(w).all() and np.isfinite(pw).all(), sid
        assert pt["wealth"]["p50"] == float(np.percentile(pw, 50)), sid
        drag = w - pw
        boot = rng_np.integers(0, n, (200, n))
        for k, (v, bs) in {"post_tax_p50": (np.median(pw),
                                            np.median(pw[boot], axis=1)),
                           "median_tax": (np.median(drag),
                                          np.median(drag[boot], axis=1))
                           }.items():
            se = float(bs.std())
            r = ref[sid][k]
            z = (v - r) / se if se > 0 else 0.0
            out[f"{sid}_{k}"] = dict(value=float(v), se=se, ref=r,
                                     z=float(z))
            if abs(v - r) > 4.0 * se + 1.0:
                failed.append((sid, k))
    rows, ref_tax = shared
    take = rows < n
    diffs = {}
    for sid, (w_ref, t_ref) in ref_tax.items():
        w, pw = values[sid]
        w_ref, t_ref = w_ref[take], t_ref[take]
        d = (w - pw)[rows[take]]
        d_ref = np.minimum(t_ref, np.maximum(w_ref, 0.0))
        ulp = np.spacing(np.maximum(np.abs(w_ref), np.abs(t_ref))
                         .astype(np.float32)).astype(np.float64)
        diffs[sid] = dict(trials=int(take.sum()),
                          max_wealth_diff=float(np.abs(w[rows[take]]
                                                       - w_ref).max()),
                          max_drag_diff=float(np.abs(d - d_ref).max()),
                          max_drag_diff_ulps=float((np.abs(d - d_ref)
                                                    / ulp).max()))
        if not (np.array_equal(w[rows[take]], w_ref)
                and (np.abs(d - d_ref) <= 4 * ulp).all()):
            failed.append((sid, "shared trials"))
    log("exact_all against the reference's exact-all run (4 bootstrap SE "
        "+ $1): " + json.dumps(out) + "; trials shared with the tax "
        "reference subsample: " + json.dumps(diffs))
    assert not failed, failed
    assert launches["sort_bridge"] == 16 * chunks, launches
    assert launches["wash"] == 8 * chunks, launches
    assert launches["compose"] == chunks, launches
    assert launches["window_tiles"] == chunks, launches
    assert launches["joint"] == chunks + 1, launches
    assert launches["compose_strategies"] == 1, launches
    return launches


@contextlib.contextmanager
def device_clock(ms, name, mod, attr, key=None):
    """Times each call of mod.attr on the card (CUDA events around it,
    read after the block) into ms[name], or ms[key(args, kw)] when ``key``
    is given."""
    inner = getattr(mod, attr)
    marks = []

    def timed_call(*args, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = inner(*args, **kw)
        b.record()
        marks.append((name if key is None else key(args, kw), a, b))
        return out

    setattr(mod, attr, timed_call)
    try:
        yield
    finally:
        setattr(mod, attr, inner)
        torch.cuda.synchronize()
        for k, a, b in marks:
            ms[k] = ms.get(k, 0.0) + a.elapsed_time(b)


@contextlib.contextmanager
def busy_samples(samples, period_ms=100):
    """nvidia-smi's utilization.gpu (the share of its last sample period
    in which a kernel ran) every period_ms while the block runs."""
    p = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-lms", str(period_ms)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield
    finally:
        p.terminate()
        out, _ = p.communicate(timeout=60)
        samples.extend(int(v) for v in out.split() if v.isdigit())


def general_channels(model_t, days: int):
    """K4's 23 channels from the general path and its signals at
    B = 16,384 x ``days`` (the short shape of --quick)."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.strategies.signals import compute_signals

    rows = torch.arange(B_CHUNK, device="cuda")
    p = generate_paths_batched(model_t, rng.key(21, "cuda"), rows // 2,
                               rows % 2 == 1, sim_days=days,
                               buffer_days=days)
    return k4.channels_from(p, compute_signals(p))


def k4_cashflows(S: int) -> torch.Tensor:
    """The cashflow schedule of K4's digest run with cashflows: $500 in
    every 21 days, $3,000 out at each year's last day."""
    t = torch.arange(S, device="cuda")
    return ((t % 21 == 0) * 500.0 - (t % 252 == 251) * 3000.0).to(
        torch.float32)


def k4_digests(chans) -> dict:
    """bit_digest of K4's three outputs (final wealth, trade counts, max
    drawdown) on the 23 channels ``chans``: channel mode, fused-signals
    mode (the first 7), and channel mode with k4_cashflows and
    apply_costs=False."""
    from letf_tpu_torch.ops import strategies as k4

    S = chans[0].shape[0]
    runs = {"channel": lambda: k4.strategies_run(chans),
            "fused": lambda: k4.strategies_run(chans[:k4.N_FUSED],
                                               fused_signals=True),
            "cashflows_no_costs": lambda: k4.strategies_run(
                chans, cashflows=k4_cashflows(S), apply_costs=False)}
    return {k: [bit_digest(x) for x in fn()] for k, fn in runs.items()}


def phase_k4(chans, fused_plain_days=504, digests=False,
             plain_days=PLAIN_DAYS):
    """K4 against its plain version on the card on the 23 channels
    ``chans`` [S, B] within compose_strategies.check_parity's bounds (the
    plain loop and the kernel differ by float32 ulps of division and powf
    that flip borderline trades). The full run gives it the main path's own
    channels, one parametric chunk of 16,384 trials x 7,560 days, compares
    channel mode, the main path's, over their first ``plain_days`` days
    (the plain loop is host-bound, ~13 ms a day), and with ``digests``
    holds both modes (and a run with cashflows and no costs) bit for bit to
    the first port's kernel (K4_DIGESTS_FIRST_PORT). Fused-signals mode
    (the first 7 channels) runs on no main path and is held bitwise to K3
    at 7,560 days by phase_general_vs_slab; against its plain version it is
    compared over the first ``fused_plain_days`` days, since the plain
    loops are host-bound (~8-13 ms a day). Both modes are timed at the full
    shape, channel mode over 5 runs and on the first 4,096 trials (3).
    Returns the record of the kernels line."""
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import strategies as k4

    S, B = chans[0].shape
    rec = {}
    if digests:
        got = k4_digests(chans)
        assert got == K4_DIGESTS_FIRST_PORT, (
            "K4 is not the first port's kernel bit for bit", got)
        log("K4 output digests (channel, fused-signals, cashflows without "
            "costs) equal the first port's")
    for fused in (False, True):
        cs = chans[:k4.N_FUSED] if fused else chans
        ms_spread, got = spread(
            lambda: k4.strategies_run(cs, fused_signals=fused), 5)
        ms = ms_spread[1]
        extra = {}
        if not fused:
            q = B // 4
            cq = [c[:, :q].contiguous() for c in cs]
            extra["quarter_ms_spread"], _ = spread(
                lambda: k4.strategies_run(cq), 3)
            del cq
        cut = fused_plain_days if fused else plain_days
        if cut < S:
            cs = [c[:cut] for c in cs]
            got = k4.strategies_run(cs, fused_signals=fused)
        plain_ms, ref = timed(
            lambda: k4.strategies_plain(cs, fused_signals=fused), 1,
            warm=False)
        names = ("final_wealth", "num_trades", "max_dd")
        st = k3.check_parity(dict(zip(names, got)), dict(zip(names, ref)),
                             exact=())
        mdd_err = float((got[2] - ref[2]).abs().max())
        mode = "fused-signals" if fused else "channel"
        quarter = (f" (at B={B // 4}: {fmt_spread(extra['quarter_ms_spread'])})"
                   if extra else "")
        log(f"K4 strategies ({mode} mode) vs plain at B={B} "
            f"S={cs[0].shape[0]}: {st}, max drawdown max abs err "
            f"{mdd_err:.3e}; kernel {fmt_spread(ms_spread)} over 5 runs at "
            f"S={S}{quarter}, plain {plain_ms:.3f} ms at S={cs[0].shape[0]}")
        rec[mode] = dict(max_abs_err=st["max_abs_err"], ms=ms,
                         plain_ms=plain_ms, plain_days=cs[0].shape[0],
                         ms_spread=ms_spread, **extra)
        del got, ref
    # Each channel read once, the 57 summaries written once.
    fused = with_bound(rec["fused-signals"], (k4.N_FUSED * S + 57) * B * 4,
                       OPS_PER_TRIAL_DAY["strategies_fused"] * S * B)
    return with_bound(dict(rec["channel"], days=S, fused=fused,
                           digest_match=digests or None),
                      (len(chans) * S + 57) * B * 4,
                      OPS_PER_TRIAL_DAY["strategies"] * S * B)


# The parametric 16,384-trial 10-year report's sampler calls
# (path_engine.draw_innovations and generate_returns_parametric), float32:
# (name, sampler, parameter, draws a trial) at T days (10 years and the
# 5-year buffer) and S simulated days.
DRAW_T, DRAW_S = 15 * 252, 10 * 252
DRAW_CALLS = (("vix_normal", "normal", None, DRAW_T),
              ("irx_normal", "normal", None, DRAW_T),
              ("stress_normal", "normal", None, 2 * DRAW_S),
              ("jump_t5", "t", 5.0, DRAW_S),
              ("te_t5", "t", 5.0, 4 * DRAW_S),
              ("te_t10", "t", 10.0, 2 * DRAW_S),
              ("returns_t5", "t", 5.0, 3 * DRAW_T))
# threefry2x32 hashes of a draw (csrc/draws.cu): a normal 1; a t 8 (its
# normal, and its gamma's element key, that key's split, the x key, the
# normal key, the normal, the U key, U) when the gamma accepts its first
# x; redraws and rejections add more, so the count is a floor. The rows'
# split keys (2 a row) are left out.
DRAW_HASHES = {"normal": 1, "t": 8}
# SASS instructions of one hash in the sm_90a build, counted in cuobjdump
# -sass of draws.cu's normal_kernel<float> (its one hash, unrolled: 68
# instructions from the counter's key add to the last key injection):
# 56 on the integer ALU pipe (15 IADD3, 21 LOP3: 20 xors and the key's
# parity word, 20 SHF.L.W rotates; 64 lanes an SM a clock on sm_90) and 12
# IMAD.IADD adds the compiler put on the FMA pipe; every instruction takes
# an issue slot (4 schedulers x 32 lanes an SM a clock). The float work
# (the mantissa fill, erf_inv, the Marsaglia-Tsang test, the logs) is not
# counted.
HASH_SASS = {"alu": 56, "all": 68}


def draws_bound_ms(hashes: float, sms: int, clock_hz: float):
    """The integer floor of ``hashes`` threefry hashes on the card: the
    ALU pipe's instructions at 64 lanes an SM a clock, or all at 128,
    whichever takes longer."""
    per_sm_clock = max(HASH_SASS["alu"] / 64, HASH_SASS["all"] / 128)
    return hashes * per_sm_clock / (sms * clock_hz) * 1e3


def phase_draws(quick: bool):
    """The samplers' kernel (csrc/draws.cu through rng.normal and rng.t on
    CUDA keys) on the parametric report's seven calls (DRAW_CALLS) over
    16,384 keys (1,024 with ``quick``), each bitwise the torch twin
    (rng._normal_plain, rng._t_plain) on the same keys, timed beside it
    (the kernel min/median/max over 5 runs, 2 with ``quick``; the twin
    once), with its integer floor (draws_bound_ms)."""
    from letf_tpu_torch.ops import rng

    B, reps = (1024, 2) if quick else (B_CHUNK, 5)
    props = torch.cuda.get_device_properties(0)
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]
    clock = float(mhz) * 1e6
    kernel = {"normal": rng.normal, "t": rng.t}
    twin = {"normal": rng._normal_plain, "t": rng._t_plain}
    shapes, tot = {}, dict(ms=[0.0, 0.0, 0.0], plain_ms=0.0, bound_ms=0.0)
    for i, (name, kind, param, n) in enumerate(DRAW_CALLS):
        keys = rng.split(rng.key(100 + i, "cuda"), B)
        args = (keys, n) if param is None else (keys, param, n)
        before = rng.LAUNCHES
        ms, got = spread(lambda: kernel[kind](*args), reps)
        assert rng.LAUNCHES == before + reps + 1, (name, rng.LAUNCHES)
        plain_ms, ref = timed(lambda: twin[kind](*args), 1, warm=False)
        same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        assert same and bool(torch.isfinite(got).all()), name
        b_ms = draws_bound_ms(B * n * DRAW_HASHES[kind],
                              props.multi_processor_count, clock)
        shapes[name] = dict(draws=B * n, ms_spread=ms, plain_ms=plain_ms,
                            bound_ms=b_ms)
        tot["ms"] = [a + b for a, b in zip(tot["ms"], ms)]
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += b_ms
        del got, ref
    log(f"draws: the parametric report's {len(DRAW_CALLS)} sampler calls at "
        f"{B} keys, float32, each bitwise the twin; kernel "
        f"{fmt_spread(tot['ms'])} summed over the calls, twin "
        f"{tot['plain_ms']:.3f} ms, integer floor {tot['bound_ms']:.3f} ms "
        f"({props.multi_processor_count} SMs at {mhz} MHz): "
        + json.dumps(shapes))
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=tot["ms"][1], ms_spread=tot["ms"],
                plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                bound_by="operations", library_ms=None, shapes=shapes)


def emit_days_inputs(model_t, B, sim, buf, seed=6):
    """The positional arguments the emitting engine hands emit_days on a
    general path of B trials (K1, K2', K5, signals), kept from its
    call."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.strategies import engine
    from letf_tpu_torch.strategies.signals import compute_signals

    rows = torch.arange(B, device="cuda")
    p = generate_paths_batched(model_t, rng.key(seed, "cuda"), rows // 2,
                               rows % 2 == 1, sim_days=sim, buffer_days=buf)
    sig = compute_signals(p)
    kept = []

    def keep(inner):
        def emit_days(*args):
            kept.append(args)
            return inner(*args)
        return emit_days

    with wrapped(engine, "emit_days", keep):
        engine.run_strategies_batch(p, sig, emit_trades=True)
    return kept[0]


def emit_days_bytes(S: int, B: int) -> int:
    """What the emitting day kernel reads and writes once: 17 columns of
    ret_all and 4 channels a day (S19's candidate, TQQQ, TMF, cash), S6's
    two embedded leverages on its rebalance days, the cashflows; the
    journal's 13 equities and S19's flag byte a day, 2 x 19 summaries."""
    return (4 * S * B * (17 + 4 + 13) + 4 * 2 * ((S - 1) // 21) * B
            + S * B + 4 * 2 * 19 * B + 4 * S)


def phase_emit_days(model_t, quick: bool):
    """The emitting day kernel (csrc/emit_days.cu) on the emitting
    engine's own inputs (emit_days_inputs, 30 y + 5 y buffer; 252 + 126
    days with ``quick``) at the sampled replay's 650 trials and at 16,384
    (the inputs of 4,096 trials four times over: the whole emitting engine
    at 16,384 x 30 y does not fit on the card beside its path): each
    output bitwise the torch twin's (emit_days_plain, on the card), the
    kernel timed (min/median/max over 5 runs, 2 with ``quick``) beside the
    twin (once) and its byte bound."""
    from letf_tpu_torch.ops import emit_days as ed

    shape = QUICK if quick else FULL
    sim, reps = shape["sim"], 2 if quick else 5
    shapes = {}
    for B, tiles in ((K5_REPORT_B, 1), (B_CHUNK, 4)):
        args = emit_days_inputs(model_t, B // tiles, sim, shape["buf"])
        args = (*(torch.cat([x] * tiles, dim=-1) for x in args[:7]),
                *args[7:])
        before = ed.LAUNCHES
        ms, got = spread(lambda: ed.emit_days(*args), reps)
        assert ed.LAUNCHES == before + reps + 1, ed.LAUNCHES
        plain_ms, ref = timed(lambda: ed.emit_days_plain(*args), 1,
                              warm=False)
        for name, a, b in zip(("equity", "max_dd", "value", "traded19"),
                              got, ref):
            va, vb = ((a.view(torch.int32), b.view(torch.int32))
                      if a.is_floating_point() else (a, b))
            assert torch.equal(va, vb), (name, B)
        b_ms, by = bound(emit_days_bytes(sim, B),
                         OPS_PER_TRIAL_DAY["emit_days"] * sim * B)
        shapes[f"{sim}x{B}"] = dict(ms_spread=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=by)
        log(f"emit_days at [{sim}, {B}]: bitwise the twin; kernel "
            f"{fmt_spread(ms)}, twin {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({by})")
        del args, got, ref
        torch.cuda.empty_cache()
    main = shapes[f"{sim}x{K5_REPORT_B}"]
    return dict(max_abs_err=0.0, ms=main["ms_spread"][1],
                ms_spread=main["ms_spread"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, days=sim, shapes=shapes)


def phase_k6(n=1_048_576, years=30, reps=5, gate=True):
    """K6 against its plain version on the card at n trials x years. Both
    draw the same counter bits and compound the same float32 growth
    factors g = 1 + max(net, -0.999) in the same order: products over
    blocks of gbm.block_pairs day pairs, the log of each block summed,
    drawdown 1 - min(W_t / max W_s); so wealth within rtol 1e-5 and
    drawdown within 1e-5 (the CUDA math library serves both; the kernel's
    loop and torch's per-op kernels may round a log differently by an
    ulp). Then bench.py:132-165's distribution gate against the port of
    the XLA twin (different streams, 262,144 x 10 years)."""
    from letf_tpu_torch.ops import gbm, rng

    days = years * 252
    mu, sigma = 0.10 / 252.0, 0.24 / math.sqrt(252.0)
    args = (0, n, days, mu, sigma, 3.0, 0.0086 / 252)
    ms_spread, (wk, mk) = spread(lambda: gbm.gbm_buyhold(*args), reps)
    ms = ms_spread[1]
    plain_ms, (wp, mp) = timed(lambda: gbm.gbm_plain(*args, device="cuda"),
                               1, warm=False)
    torch.testing.assert_close(wk, wp, rtol=1e-5, atol=0)
    torch.testing.assert_close(mk, mp, rtol=0, atol=1e-5)
    err = float((wk - wp).abs().max())
    bitwise = torch.equal(wk, wp) and torch.equal(mk, mp)
    log(f"K6 gbm vs plain at N={n} days={days}: max abs err wealth "
        f"{err:.3e} (max rel {float(((wk - wp).abs() / wp).max()):.3e}), "
        f"drawdown {float((mk - mp).abs().max()):.3e}; bitwise {bitwise}; "
        f"kernel {fmt_spread(ms_spread)} over {reps} runs, plain "
        f"{plain_ms:.3f} ms")
    rec = with_bound(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          ms_spread=ms_spread),
                     2 * n * 4, OPS_PER_TRIAL_DAY["gbm"] * n * days)
    del wk, mk, wp, mp
    if not gate:
        return rec

    ng, yg = 262_144, 10
    wp, mp = gbm.gbm_buyhold(7, ng, yg * 252, mu, sigma, 3.0, 1e-4)
    t0 = time.perf_counter()
    wx, mx = gbm.gbm_buyhold_xla(rng.key(7, "cuda"), ng, yg * 252, mu,
                                 sigma, 3.0, 1e-4)
    torch.cuda.synchronize()
    t_xla = time.perf_counter() - t0
    wp, mp, wx, mx = (a.double().cpu().numpy() for a in (wp, mp, wx, mx))
    lp, lx = np.log(wp), np.log(wx)
    checks = {
        "mean_logw": (lp.mean(), lx.mean(),
                      6 * lx.std() / np.sqrt(ng) + 1e-3),
        "std_logw": (lp.std(), lx.std(), 0.01 * lx.std()),
        "p10_logw": (np.percentile(lp, 10), np.percentile(lx, 10), 0.03),
        "p50_logw": (np.percentile(lp, 50), np.percentile(lx, 50), 0.03),
        "p90_logw": (np.percentile(lp, 90), np.percentile(lx, 90), 0.03),
        "median_mdd": (np.median(mp), np.median(mx), 0.005),
    }
    out = {k: dict(kernel=float(a), xla_twin=float(b), tol=float(t),
                   passed=bool(abs(a - b) <= t))
           for k, (a, b, t) in checks.items()}
    log(f"K6 distribution gate vs the XLA twin's port at {ng} x {yg}y "
        f"(twin {t_xla:.3f} s): " + json.dumps(out))
    assert all(v["passed"] for v in out.values()), out
    return rec


def phase_headline(counters):
    """The buy-and-hold headline, gbm_percentile_report(1, 1,048,576, 30)
    after a seed-0 warm-up (bench.py:110-129), with the launch counters
    set to 0 just before it and read just after; its wealth percentiles,
    CVaR(5%) and median max drawdown held to the first port's K6
    (HEADLINE_FIRST_PORT, HEADLINE_BOUNDS)."""
    from letf_tpu_torch.ops.gbm import gbm_percentile_report

    n, years = 1_048_576, 30
    gbm_percentile_report(0, n, years)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = gbm_percentile_report(1, n, years)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    log(f"headline: gbm_percentile_report(1, {n}, {years}) in {wall:.4f} s, "
        f"{n * years * 252 / wall:.6e} path-days/s, p50 CAGR "
        f"{rep['cagr_percentiles']['p50']:.4f}, median max drawdown "
        f"{rep['median_max_drawdown']:.4f}, CVaR(5%) "
        f"{rep['cvar_5pct_wealth']:.6f}, launches {launches}")
    vals = list(rep["percentiles"].values())
    assert all(np.isfinite(v) for v in vals) and vals == sorted(vals), rep
    assert 0.0 <= rep["median_max_drawdown"] <= 1.0, rep
    assert launches["gbm"] == 1, launches
    rtol, atol = HEADLINE_BOUNDS
    ref = HEADLINE_FIRST_PORT
    rel = {p: abs(rep["percentiles"][p] / v - 1)
           for p, v in ref["percentiles"].items()}
    rel["cvar_5pct_wealth"] = abs(rep["cvar_5pct_wealth"]
                                  / ref["cvar_5pct_wealth"] - 1)
    mdd_err = abs(rep["median_max_drawdown"] - ref["median_max_drawdown"])
    log(f"headline against the first port's K6: max relative difference "
        f"{max(rel.values()):.3e} (bound {rtol}), median max drawdown "
        f"{mdd_err:.3e} (bound {atol})")
    assert max(rel.values()) <= rtol and mdd_err <= atol, (rel, mdd_err)
    return launches


def parametric_breakdown(model_t, B=B_CHUNK, years=30):
    """Seconds of each stage of one parametric chunk (B trials, synchronised
    between stages): the draws (draw_innovations), the mode's t returns,
    the day scans and composition of path_from_innovations, the signals,
    K4. Returns (the seconds, the chunk's 23 K4 channels): the main path's
    first chunk, the same trials and seed."""
    from letf_tpu_torch.ops import path_engine as pe
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.strategies.signals import compute_signals

    rows = torch.arange(B, device="cuda")
    key = rng.key(2, "cuda")
    sim, buf = years * 252, FULL["buf"]
    out = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        return r

    innov = stage("draws", lambda: pe.draw_innovations(
        model_t, key, rows // 2, rows % 2 == 1, sim, buf,
        engine_mode="parametric"))
    stage("returns_t_draws", lambda: pe.generate_returns_parametric(
        model_t, innov.regime_full, innov.mode_key))
    path = stage("path_scans_and_t_draws",
                 lambda: pe.path_from_innovations(
                     model_t, innov, sim, engine_mode="parametric"))
    del innov
    sig = stage("signals", lambda: compute_signals(path))
    chans = k4.channels_from(path, sig)
    del sig, path
    stage("k4", lambda: k4.strategies_run(chans))
    return out, chans


@contextlib.contextmanager
def keep_k4_channels(kept, S, B):
    """The channels of K4's first channel-mode call at [S, B] (the chunk's
    pre-tax strategies) appended to ``kept``."""
    from letf_tpu_torch.ops import strategies as k4

    inner = k4.strategies_run

    def run(channels, *args, **kw):
        if (not kept and len(channels) == k4.NCH
                and tuple(channels[0].shape) == (S, B)):
            kept.append(list(channels))
        return inner(channels, *args, **kw)

    k4.strategies_run = run
    try:
        yield
    finally:
        k4.strategies_run = inner


def parametric_stages(stack, ms):
    """CUDA-event clocks (device_clock) on the stages of the parametric
    chunk inside the run, keyed by stage and trial count: the draws, the
    mode's Student-t returns, the path (its day scans and composition,
    the returns included), the signals and K4."""
    from letf_tpu_torch.ops import path_engine as pe
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.parallel import mc_runner

    for name, mod, attr, width in (
            ("draws", pe, "draw_innovations", lambda a: a[2].shape[0]),
            ("returns_t_draws", pe, "generate_returns_parametric",
             lambda a: a[1].shape[1]),
            ("path_scans_and_t_draws", pe, "path_from_innovations",
             lambda a: a[1].start_offset.shape[0]),
            ("signals", mc_runner, "compute_signals",
             lambda a: a[0].vix.shape[1]),
            ("k4", k4, "strategies_run", lambda a: a[0][0].shape[1])):
        stack.enter_context(device_clock(
            ms, name, mod, attr,
            key=lambda a, kw, n=name, w=width: f"{n} ({w(a)} trials)"))


def phase_parametric(model, counters):
    """This slice's main path: monte_carlo_report(default_sim_model(), 30,
    num_simulations=16,384, seed=2, engine_mode="parametric") with its
    default sampled taxes and chunks of 16,384 (K4 at the production chunk
    shape), the counters set to 0 just before and read just after, its
    stages timed inside it (parametric_stages), and K4 against its plain
    version on that chunk's own channels, kept from its K4 call
    (phase_k4). Returns (the launches, K4's record)."""
    from letf_tpu_torch.parallel import mc_runner

    # One chunk: its time is ~90% torch draw glue, and the smoke's budget
    # goes to holding the kernels at their shapes (K4 at 16,384 x 7,560);
    # the gates read the first 1,024 trials and that chunk.
    n, years = 16_384, 30
    reset(counters)
    stages, chunk_ms, kept = {}, {}, []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(keep_k4_channels(kept, years * 252, B_CHUNK))
        parametric_stages(stack, chunk_ms)
        rep = mc_runner.monte_carlo_report(
            model, years, num_simulations=n, seed=2, chunk_size=B_CHUNK,
            engine_mode="parametric", device="cuda", stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read(counters)
    peak = torch.cuda.max_memory_allocated() / 2**30
    chunks = n // B_CHUNK
    s1, s7 = rep["strategies"]["S1"], rep["strategies"]["S7"]
    log(f"parametric main path: monte_carlo_report {n} x {years}y "
        f"(engine_mode 'parametric', tax_mode {rep['tax_mode']!r}), chunks "
        f"of {B_CHUNK}: wall {wall:.3f} s, post_tax_seconds "
        f"{rep['post_tax_seconds']}, pre-tax "
        f"{wall - rep['post_tax_seconds']:.3f} s, "
        f"{n * years * 252 / wall:.6e} trial-days/s, peak device memory "
        f"{peak:.2f} GiB, post-tax stages (s) {json.dumps(stages)}, "
        f"launches {launches}")
    log("parametric report: " + json.dumps({
        "valid_frac": rep["valid_frac"], "finite_frac": rep["finite_frac"],
        "S1": {"p50": s1["wealth"]["p50"], "ruin_frac": s1["ruin_frac"]},
        "S7": {"p50": s7["wealth"]["p50"],
               "post_tax_p50": s7["post_tax"]["wealth"]["p50"],
               "median_tax": s7["post_tax"]["median_tax"]}}))
    assert rep["finite_frac"] == 1.0, rep["finite_frac"]
    for sid, st in rep["strategies"].items():
        assert all(np.isfinite(v) for v in st["wealth"].values()), sid
        e = st.get("post_tax")
        if e is not None:
            assert all(np.isfinite(v) for v in e["wealth"].values()), sid
            assert np.isfinite(e["median_tax"]) and e["median_tax"] >= 0
    assert len([s for s in rep["strategies"].values()
                if "post_tax" in s]) == 13
    assert launches["strategies"] == chunks, launches
    assert launches["draws"] >= 7 * chunks, launches
    for k in ("joint", "window", "window_tiles", "compose_strategies",
              "compose", "gbm"):
        assert launches[k] == 0, launches
    assert launches["sort_bridge"] >= 1 and launches["wash"] >= 1, launches
    log(f"parametric report's stages, device ms inside the run (CUDA "
        f"events; the {B_CHUNK}-trial pre-tax chunk and the post-tax "
        f"replays): " + json.dumps(chunk_ms))
    chans = kept.pop()
    rec = phase_k4(chans, digests=True)
    del chans
    torch.cuda.empty_cache()
    return launches, rec


def phase_parametric_small(model):
    """The parametric mode through kernels vs plain versions on the card:
    run_monte_carlo's summaries at 1,024 trials x 0.5 year within
    check_parity's bounds and the pre-tax report's fans within 5e-3."""
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.parallel import mc_runner

    kw = dict(num_simulations=1024, seed=2, chunk_size=1024, device="cuda",
              engine_mode="parametric")
    arr_k = mc_runner.run_monte_carlo(model, 0.5, **kw)
    rep_k = mc_runner.monte_carlo_report(model, 0.5, tax_mode="none", **kw)
    with plain_kernels():
        arr_p = mc_runner.run_monte_carlo(model, 0.5, **kw)
        rep_p = mc_runner.monte_carlo_report(model, 0.5, tax_mode="none",
                                             **kw)
    st = k3.check_parity(vars(arr_k), vars(arr_p),
                         exact=("path_finite", "regime_high_days",
                                "start_offset", "start_regime", "valid",
                                "jump_days"))
    for sid, s in rep_k["strategies"].items():
        for p, w in s["wealth"].items():
            wp = rep_p["strategies"][sid]["wealth"][p]
            assert abs(w - wp) <= 5e-3 * max(abs(wp), 1.0), (sid, p, w, wp)
    log(f"parametric report 1024 x 0.5y, kernels vs plain on the card: "
        f"{st}; valid_frac {rep_k['valid_frac']}")


# The JAX package's parametric run_monte_carlo: f32 (no x64), seed 2, the
# first 1,024 trials x 30 years, chunk of 1,024, on the CPU, made with
#   JAX_PLATFORMS=cpu python -c "from letf_tpu.models.params import
#   default_sim_model; from letf_tpu.parallel import mc_runner;
#   a = mc_runner.run_monte_carlo(default_sim_model(), 30,
#   num_simulations=1024, seed=2, chunk_size=1024,
#   engine_mode='parametric', progress=False)"
# and summarised as: S1 (buy-and-hold TQQQ) final wealth of the even
# trials (the parametric mode draws no joint normals, so the two trials of
# an antithetic pair are equal), the trade counts summed over the trials
# per strategy, the median final wealth per strategy, and integer sums of
# the start offsets, regime-1 days, jump days and valid flags.
JAX_PARAM_S1_WEALTH = (
    1.17809429e-06, 0.303354859, 1.70489116e-07, 0.169302493, 0.181942001,
    9.9937497e-06, 2.15045702e-07, 5.98441696e-12, 0.0169269629, 0.407225728,
    0.294270247, 14.6481266, 4.48084506e-07, 2.12537074, 8.80949287e-08,
    0.0565720163, 5.93935729e-05, 6.86477069e-05, 4.5986515e-05, 0.0389168747,
    1.98423411e-08, 6.82920813e-08, 0.160017818, 0.203568578, 0.000581159489,
    3.95184026e-15, 4.12109985e-05, 5.28945275e-05, 3.16048094e-08, 34.0409698,
    13.2002592, 8.61156707e-07, 3.66081906e-07, 9.32292323e-07, 1300.78589,
    1.18133321e-05, 0.00164358539, 0.0342282169, 0.0366876498, 1.56310961e-07,
    0.00251122098, 0.0059348275, 0.511605978, 0.000797862536, 0.000815010397,
    3.9648653e-06, 0.000272541627, 0.000380793615, 3.96455574, 0.425015062,
    0.0144766746, 2.95780028e-05, 0.0404851176, 0.00217915722, 3.2096048e-11,
    0.00850990787, 0.145245701, 3.90701672e-11, 4.77539761e-05, 0.00734907994,
    0.000270451914, 0.152058125, 5.64851507e-06, 1.39746116e-05,
    6.44871591e-07, 0.00159591448, 5.90230902e-12, 3.23058174e-07,
    5.71987016e-07, 0.00415327819, 0.00428211456, 0.00417696778,
    6.32150332e-08, 1.46081049e-06, 0.000483638432, 0.0227377247,
    1.56818047e-07, 0.00178548717, 0.000383164064, 2.31206298, 2.7651005e-08,
    0.00872861035, 0.790225327, 4.8848381, 0.00304000755, 8.34018299e-10,
    6.47652632e-05, 0.000401410827, 4.77249733e-11, 2.77910512e-08,
    0.873548508, 4.88418341, 5.90040725e-11, 7.33013152e-08, 0.000248494587,
    1.38721826e-10, 1.81629621e-05, 6.75795548e-07, 4.76422088e-07,
    0.00977897644, 7.64295748e-07, 2.24212121e-10, 0.00056257454,
    1.57045754e-09, 6759.48193, 0.000455524481, 2.64116073, 1.38663336e-06,
    2.79148344e-06, 9.22621609e-07, 1.76048037e-10, 1.49400353e-06,
    3.79632354e-07, 3.28887033e-08, 1.45082231e-05, 0.000185456462,
    1.79410363e-05, 6.92852459e-12, 1.94170596e-10, 0.0251252726,
    1.7550039e-05, 0.000934172189, 0.0181493014, 3.49307857e-06, 0.00849923119,
    3.9174215e-09, 0.000159885385, 5.08330668e-05, 8.92413807, 3.97593292e-09,
    0.00161744701, 0.0240423474, 1.87324947e-11, 0.0649224296, 2.1832393e-05,
    0.00336316647, 7.57081651e-08, 4.12077572e-09, 6.49651702e-05, 0.160293326,
    0.000184038101, 0.208313823, 6184.75781, 0.00326973759, 0.00419153925,
    3.05318531e-06, 0.000151846398, 1.46050445e-06, 0.107145041,
    0.000362606632, 4.1216211e-10, 2.92260884e-05, 0.0318562835, 0.00163367752,
    0.920823276, 1.78229718e-12, 0.00175620604, 0.000178064583, 0.00129481358,
    0.00637641922, 3.37089758e-13, 1.94530561e-08, 1.30055378e-06, 0.103695035,
    0.00381559739, 0.000816409069, 0.00029287074, 5.62833424e-09,
    2.99723365e-06, 2.68031604e-12, 1.71867356e-08, 0.000183130163,
    4.67943628e-10, 1.05035891e-08, 0.00933025125, 2.74844879e-05,
    7.57475007e-08, 6.48934328e-09, 5.6516633, 5.00056245e-08, 1.22904758e-05,
    0.00248012249, 2.16173157e-05, 5.56419945e-06, 0.000464515266,
    0.00318255811, 0.000614930468, 2.17071683e-05, 0.000126030121, 0.762881279,
    20.6935234, 4.89003449e-10, 1.4839469e-07, 3.01773671e-05, 10310.6348,
    0.00155163114, 0.0006175983, 1.5083015, 4.69659017e-16, 9.2837281e-06,
    5.0906241e-08, 4.32301204e-06, 0.000845273782, 4.16551702e-05,
    4.11373003e-06, 1.77900529e-05, 0.00891209766, 9.41971414e-12,
    0.000273307669, 3.03433421e-06, 0.00964473747, 2.79311996e-09,
    6.83072903e-06, 3.97119665, 0.00034677409, 7.46802442e-08, 3.84313587e-14,
    2.57449784e-07, 3.95146089e-05, 0.195693165, 4.52777203e-05,
    5.20120484e-05, 7.24737816e-08, 1.47400581e-08, 0.0802942067,
    1.3283473e-05, 7.03220806e-08, 0.365393192, 0.552434862, 9.85526327e-09,
    1.80861404e-09, 0.622277498, 3.61695491e-08, 0.000464509998, 0.176714003,
    37.0831566, 1.01770002e-10, 0.000210933489, 7.17883495e-08, 3.83215166e-08,
    0.210293561, 5.29925899e-07, 0.846123099, 2.7044772e-10, 8.92540338e-05,
    2.26772227e-06, 1.98636418e-09, 3.39602252e-07, 3.90590671e-09,
    6.24602981e-05, 5.89418705e-13, 0.000175619774, 7.65005898e-05,
    0.200449198, 3.39444705e-05, 3.53695686e-05, 0.00409096899, 0.000175466324,
    4.72412694e-06, 5.01191211e-13, 0.00107861124, 0.00958192814,
    0.00397872133, 0.000273483718, 0.000856761646, 0.000346788234,
    5.85520876e-09, 2.38489093e-07, 1.2387857e-08, 0.00200181338,
    7.57940552e-06, 0.00203671074, 4.88242113e-09, 1.00307558e-08,
    1.40421366e-06, 1.02873288e-09, 6.61511887e-11, 9.93297111e-10,
    0.142184898, 9.75830062e-07, 2.51736583e-05, 1.43929437e-08, 56.4020462,
    6.23566157e-05, 4.97474957e-06, 5.35306313e-11, 0.00017210262,
    3.13989858e-06, 2.04893702e-09, 1.97269955e-07, 0.00109196338,
    2.32794872e-09, 6.35207334e-06, 1.4713376e-05, 1.11899442e-06,
    1.54934187e-05, 5.21248928e-08, 4.34069443e-05, 0.490133405,
    1.05792305e-05, 2.38395135e-08, 4.67096555e-07, 0.452511013,
    1.49092938e-09, 1.20787408e-11, 4.02344546e-15, 0.00273601152,
    9.43235356e-09, 2.61982175e-14, 0.000469961844, 0.000145350452, 48.7987518,
    2.15942153e-09, 0.224049062, 0.0136808613, 1.18205878e-09, 2.86838531e-09,
    6.58255539e-09, 0.000245591684, 0.000273015321, 4.05041959e-07,
    7.98072719e-09, 30713.043, 1.68136182e-07, 5.28042904e-07, 3.04860328e-06,
    5.39001732e-10, 0.0685225725, 2.17075026e-07, 3.73909984e-06, 44.3340874,
    1.79998502e-10, 0.000576331397, 0.0112674264, 0.000161360585,
    6.80243275e-08, 251.74585, 9.42753715e-08, 3.51115981e-09, 9.41236576e-05,
    0.00012086772, 9.91915567e-06, 6.07951479e-05, 0.0502046868,
    0.000101442136, 1.05005569e-07, 0.005470125, 0.000255784107,
    2.03984041e-06, 1.69709301e-06, 0.00027781722, 1.15542991e-06,
    8.90453375e-05, 1.45333473e-07, 1.28244901e-05, 0.0300545599,
    3.58174452e-06, 9.70868719e-10, 21.3787727, 31.3335609, 0.00597738754,
    0.237730324, 0.000137810493, 9.75241554e-11, 1.34547954e-05,
    0.000891606498, 6.99037337e-05, 5.44433369e-08, 4.21314805e-09,
    5.48111359e-07, 1.35799655e-05, 0.00160416029, 0.0269072782, 6.3968313e-05,
    0.00154944451, 1.21575304e-05, 0.00548206875, 3.25889869e-06, 0.0779428035,
    8.32619699e-14, 8.13466482e-13, 7.76964049e-10, 6.61613228e-07,
    3.14399548e-12, 0.000296593207, 0.00968884304, 1.15138491e-05,
    8.36583422e-06, 4.13862745e-06, 0.957248926, 0.00453393534, 7.46108416e-13,
    0.00511990208, 8.82166059e-05, 7.7886364e-11, 0.0830258578, 2.0385728e-06,
    8.45018405e-07, 0.0525601991, 0.00321619934, 6.21366638e-08,
    5.20234266e-07, 1.14093872e-07, 1.12362238e-06, 6.56027533e-13,
    4.20928119e-11, 4.66797519e-06, 2.46019793, 0.00269208592, 4.3681105e-08,
    0.000120454431, 8.18955414e-06, 0.00174142874, 0.0110476045,
    0.000571155746, 8.5051289e-07, 7.58302379e-11, 1.09854118e-05, 28.3367672,
    9.49981484e-07, 7.54061917e-12, 0.00286900112, 7.0442884e-06,
    3.70760134e-08, 2.09885734e-10, 4.95447461e-10, 3.17007041, 2.74115473e-06,
    0.36948669, 13.5379124, 3.9780366e-06, 5.95445382e-09, 0.338074952,
    2.5073993e-07, 2.42265332e-06, 5.96776744e-08, 2.39660608e-07,
    6.8446725e-06, 1.03188352e-11, 0.0211892333, 9.58896362e-06,
    0.000159139323, 8.3423214, 26.5289383, 6.96234892e-08, 1.17009386e-05,
    0.000198462658, 9.09473243e-08, 3.83155857e-05, 1.97682967e-10,
    0.00220527337, 0.0121139949, 9.81628327e-05, 2.64552042e-08, 36.762619,
    0.0498209931, 1.38471616e-08, 1.06381314e-07, 8.25654567e-09,
    1.58324804e-06, 0.000734812231, 0.0350078866, 0.000848727184, 21.0741081,
    1.6547036e-10, 0.222947061, 0.169178784, 0.0603309162, 0.0200772919,
    3.93648079e-05, 0.0103356512, 0.0205549374, 0.504310429, 1.32514169e-05,
    0.000150197156, 1.45425743e-08, 1.18353569e-06, 0.0101239588,
    4.42026554e-11, 1.14479867e-07, 1.92795833e-05, 2.81876318e-08,
    0.00104243646, 0.00188255403, 0.158121273, 3.60791719e-13, 8.38441636e-08,
    0.0861226097, 0.398215175, 0.0298467632, 4.65811945e-06, 0.460993826,
    3.3550196e-10, 0.000288519572, 2.37338609e-05, 0.000323758723, 1.2809602,
    0.00186739594, 0.327151597, 0.040911518, 1.36281506e-06, 2.34313156e-05,
    1.37712419e-07, 5.83031445e-09, 0.0879072919, 0.0829968527, 2.96548275e-09,
    2.84381741e-07, 7.48855114, 0.00410058955, 5.81267996e-05, 1.3073703e-08,)
JAX_PARAM_TRADE_SUMS = (0, 0, 0, 259854, 244042, 735232, 4149714, 1141028, 7152368, 5574496, 7400038, 7484428, 7441386, 7333118, 5658782, 7596764, 6355624, 7297408, 2635558)
JAX_PARAM_WEALTH_P50 = (3.943971e-05, 23846.01, 1653.457, 0.5234566, 0.1812698, 42.40187, 12548.94, 3236.632, 13084.02, 12005.22, 19766.68, 20066.78, 17746.56, 18773.1, 2756.774, 1097476.0, 8316.772, 10107.15, 187.1099)
JAX_PARAM_INT_SUMS = {'start_offset': 663260, 'regime_high_days': 1937774, 'jump_days': 14676, 'valid': 922}


def phase_jax_reference(model):
    """The first 1,024 trials of the parametric run on the card against the
    JAX package's (constants above). The start offsets and regime paths
    are exact; the two trials of each antithetic pair are equal; S1 takes
    no decisions, so its wealth agrees trial by trial to the float32 ulps
    of the two libm's compounded over 7,560 days (median relative error
    < 1e-5, every trial within rtol 1e-3); the other strategies' trades
    flip where a signal sits within ulps of a threshold (the two packages
    compute the rolling signals differently in float32): each strategy's
    summed trade count within 0.5% of the JAX package's, its median wealth
    within 2%."""
    from letf_tpu_torch.parallel import mc_runner

    a = mc_runner.run_monte_carlo(model, 30, num_simulations=1024, seed=2,
                                  chunk_size=1024, engine_mode="parametric",
                                  device="cuda")
    s1 = a.final_wealth[:, 0].astype(np.float64)
    assert np.array_equal(s1[0::2], s1[1::2]), "antithetic pairs differ"
    s1 = s1[0::2]
    ref = np.asarray(JAX_PARAM_S1_WEALTH)
    rel = np.abs(s1 - ref) / np.maximum(np.abs(ref), 1e-30)
    sums = a.num_trades.sum(0)
    tr = np.abs(sums - np.asarray(JAX_PARAM_TRADE_SUMS)) / np.maximum(
        np.asarray(JAX_PARAM_TRADE_SUMS), 1)
    p50 = np.median(a.final_wealth.astype(np.float64), 0)
    prel = np.abs(p50 - np.asarray(JAX_PARAM_WEALTH_P50)) / np.maximum(
        np.abs(np.asarray(JAX_PARAM_WEALTH_P50)), 1e-30)
    ints = {"start_offset": int(a.start_offset.sum()),
            "regime_high_days": int(a.regime_high_days.sum()),
            "jump_days": int(a.jump_days.sum()), "valid": int(a.valid.sum())}
    log(f"parametric run vs the JAX package (1,024 x 30y): S1 per-trial "
        f"rel err median {np.median(rel):.3e} max {rel.max():.3e}; trade "
        f"sums max rel diff {tr.max():.3e}; median wealth max rel diff "
        f"{prel.max():.3e}; integer sums {ints} (JAX {JAX_PARAM_INT_SUMS})")
    assert ints["start_offset"] == JAX_PARAM_INT_SUMS["start_offset"], ints
    assert ints["regime_high_days"] == JAX_PARAM_INT_SUMS[
        "regime_high_days"], ints
    assert abs(ints["jump_days"] - JAX_PARAM_INT_SUMS["jump_days"]) <= 2
    assert abs(ints["valid"] - JAX_PARAM_INT_SUMS["valid"]) <= 2
    assert np.median(rel) < 1e-5 and rel.max() < 1e-3, rel.max()
    assert tr.max() < 5e-3, tr
    assert prel.max() < 2e-2, prel


# The calibrated path's references, printed by
#   JAX_PLATFORMS=cpu python3 -m tools.calibrated_reference
# HISTORY_*: per column of the committed letf_tpu_cache_v1/
# historical_data.pkl (read with pandas there; the card's machine has
# none): the first 16 hex digits of the SHA-256 of its bytes, its NaN count
# and its sum over the other days. JAX_CAL_*: the JAX package's
# run_monte_carlo on the model of the committed fits, float32, seed 2, the
# first 1,024 trials x 30 years in one chunk, through its production slab
# route (the Pallas kernels in interpret mode on the CPU), summarised as
# the JAX_PARAM_* constants are.
HISTORY_SHAPE = (25960, 38)
HISTORY_SPAN = ('1926-07-01', '2025-12-31')
HISTORY_COLUMNS = {
    'SPY_Ret': ('35a220c8b1fe6c10', 0, 7.243454429538584),
    'QQQ_Ret': ('0e327261fa9836a5', 0, 10.26631293415533),
    'NASDAQ_Ret': ('e678fad3bea32be9', 0, 10.472764254293947),
    'TLT_Ret': ('0a0360ccae594667', 0, 4.629317904375315),
    'VIX': ('912edb7e6ec50fd9', 0, 533552.4516234193),
    'IRX': ('d53fdbd7e16985d6', 0, 92786.87245767843),
    'TNX': ('cc89596b3f89ad72', 0, 117954.44212552936),
    'RF': ('222c62a29fec17e4', 0, 3.682018748320573),
    'Cash_Ret': ('222c62a29fec17e4', 0, 3.682018748320573),
    'SPY_Price': ('f1ecb19eea5b9c17', 0, 52950560.77342598),
    'QQQ_Price': ('923e0dee4f6c0c73', 0, 108374133.20422256),
    'NASDAQ_Price': ('7e2a20a5435d1fb2', 0, 129003589.56498167),
    'TLT_Price': ('e863b935275c1c0c', 0, 20828587.560552925),
    'TQQQ_Real_Ret': ('dd49e551643fc51b', 21815, 9.059258547981548),
    'TQQQ_Real_Price': ('e6f7ab59afc7c36b', 21815, 24015381.359711755),
    'UPRO_Real_Ret': ('c421004388b59ff4', 21650, 5.611727971020497),
    'UPRO_Real_Price': ('dd41adb61a64a8f4', 21650, 5148824.638445302),
    'SSO_Real_Ret': ('0465bd46d88d280e', 20878, 5.656427773409004),
    'SSO_Real_Price': ('497dd46aaccd3e11', 20878, 14124191.660353798),
    'Data_Source': ('str', ['synthetic-offline']),
    'TQQQ_Ret': ('ea5b2dc9561edcd1', 0, 21.47621747846562),
    'TQQQ_Price': ('3afb55aad9221a30', 0, 98253761103123.02),
    'TQQQ_IsSynthetic': ('bc47565aa47ac160', 0, 21815.0),
    'UPRO_Ret': ('c88148e4858a9ac7', 0, 12.419588151046689),
    'UPRO_Price': ('8e6ebc87213e0bfa', 0, 42496388760.792854),
    'UPRO_IsSynthetic': ('6e6099ebc2a475f2', 0, 21650.0),
    'SSO_Ret': ('273b583d04e0a51f', 0, 9.524781164346972),
    'SSO_Price': ('8f5d425242d0d910', 0, 249568661.35497957),
    'SSO_IsSynthetic': ('446ed7521c25c3f4', 0, 20878.0),
    'TMF_Ret': ('450fb3dc35ef6bc0', 0, 4.361907353567079),
    'TMF_Price': ('0ba83b912743f4ed', 0, 269785.5650169955),
    'TMF_IsSynthetic': ('cfef4e029f9dbbd1', 0, 21600.0),
    'SPY_IsSynthetic': ('03240921c9591b55', 0, 17371.0),
    'QQQ_IsSynthetic': ('48a7642b14b340e2', 0, 18964.0),
    'SMA200': ('21753bb942cec501', 0, 51770700.408924796),
    'Market_Vol_EWMA': ('cb4f210d3d8afe64', 1, 5234.737411512198),
    'Market_Vol_20d': ('cd04ad04e9ff36de', 19, 5179.612715279802),
    'Market_Vol': ('cb4f210d3d8afe64', 1, 5234.737411512198),
}
JAX_CAL_S1_WEALTH = (
    1.34507155418396, 5.592013835906982, 1216.8416748046875, 0.001909411745145917, 2.5724294185638428,
    2.2686777114868164, 0.124141626060009, 88.56299591064453, 3.585774538805708e-05, 397255.3125,
    0.3064655065536499, 163.0492401123047, 413.4117431640625, 0.040432970970869064, 428.7625427246094,
    0.008131266571581364, 0.026872169226408005, 257.99102783203125, 614.2467651367188, 0.013052214868366718,
    0.044762663543224335, 10.816006660461426, 2.013261318206787, 0.7547817230224609, 0.00012311385944485664,
    64783.671875, 20.78925323486328, 0.1258600950241089, 0.15336459875106812, 12.832879066467285,
    30.910470962524414, 1.349390983581543, 0.012899274006485939, 8249.69921875, 145.30413818359375,
    0.030688170343637466, 1.4299615621566772, 3.3654544353485107, 9482.0, 0.0018881902797147632,
    1092.4031982421875, 0.015415134839713573, 141.63084411621094, 0.08514934778213501, 4.909639358520508,
    2.75707745552063, 2578.318115234375, 0.23031385242938995, 26893.14453125, 0.000290961645077914,
    0.19448785483837128, 0.8520624041557312, 0.14731146395206451, 26.192909240722656, 0.7480908036231995,
    20.23885726928711, 0.0013392397668212652, 85785.5546875, 12.536791801452637, 1.0183534622192383,
    19.741300582885742, 1.1332823038101196, 0.0014962153509259224, 0.306828111410141, 33961.54296875,
    0.001525386585853994, 99.63497161865234, 0.031166724860668182, 0.00022674787032883614, 37122.42578125,
    0.9154635071754456, 0.5954964756965637, 3.820707082748413, 2.9793436527252197, 0.04489243030548096,
    5.527516841888428, 0.9244744777679443, 6.741024017333984, 2086.0048828125, 0.028504157438874245,
    67.81185150146484, 0.030445648357272148, 30193.544921875, 0.0003190739080309868, 4.619347095489502,
    52.301170349121094, 1057.3245849609375, 0.002906559966504574, 0.26288875937461853, 88.42448425292969,
    34718.63671875, 6.358580867527053e-05, 5.984193801879883, 0.04161611571907997, 1.2045092582702637,
    0.270664244890213, 0.00010455510346218944, 95220.296875, 0.5416318774223328, 1.996480107307434,
    1.687786340713501, 0.7827906012535095, 0.012998168356716633, 0.005669415928423405, 648.212890625,
    0.028648613020777702, 63.04585647583008, 0.02494649589061737, 47.04644012451172, 1.067720651626587,
    0.5694826245307922, 32.813873291015625, 0.02730570361018181, 1.1844490766525269, 1614.2647705078125,
    0.01208340935409069, 9.175987361231819e-05, 159314.515625, 0.04337153211236, 306.77520751953125,
    0.0038482986856251955, 50.22645950317383, 232.93247985839844, 0.013038345612585545, 6.373170852661133,
    0.3694387376308441, 1141.1082763671875, 0.10556801408529282, 0.7245007157325745, 30.945154190063477,
    0.0005321502103470266, 6184.75390625, 0.12659253180027008, 244.48936462402344, 2.021850824356079,
    0.13796094059944153, 0.06590170413255692, 60.21147537231445, 0.49293550848960876, 2.2272212505340576,
    0.4533208906650543, 64.73171997070312, 0.016280198469758034, 6715.4091796875, 0.034396328032016754,
    17.07740592956543, 0.00022865700884722173, 4664.53125, 0.8426898121833801, 9.161076545715332,
    0.004384842235594988, 11.194672584533691, 8.387054549530149e-05, 3.3629751205444336, 4666.45751953125,
    0.00018644567171577364, 33.65837097167969, 0.7237582802772522, 0.029024627059698105, 861.3146362304688,
    0.49427738785743713, 17.980867385864258, 21.872392654418945, 1.4308215379714966, 3367.045654296875,
    0.0014748626854270697, 105.14830017089844, 0.038610126823186874, 587.2337036132812, 0.1288519650697708,
    24.43004035949707, 0.0420459620654583, 0.006190324202179909, 109.66028594970703, 0.30722278356552124,
    9.519499778747559, 1.653385993449774e-06, 0.00031906465301290154, 57.06486129760742, 2.0019750595092773,
    18.795028686523438, 0.20836572349071503, 0.00042263095383532345, 0.15876471996307373, 0.025576895102858543,
    50.89520263671875, 0.004067701753228903, 2841.34912109375, 14.989151954650879, 0.27952972054481506,
    0.31770965456962585, 0.23266954720020294, 4.667786598205566, 34.249176025390625, 36.75273132324219,
    0.7870647311210632, 36.18708419799805, 0.5129332542419434, 1.057859182357788, 3.2837631702423096,
    10.23906135559082, 10.167553901672363, 0.5368775725364685, 0.09119099378585815, 316.95904541015625,
    0.0631658285856247, 0.0002673667040653527, 4391.5244140625, 4332.82421875, 0.008034157566726208,
    0.006056283134967089, 491.2409362792969, 1.9327090978622437, 6.541721820831299, 0.00020084787684027106,
    194.4699249267578, 9.547137260437012, 1.8133440017700195, 4.8046393394470215, 1.7232747077941895,
    638.0247192382812, 0.0046058036386966705, 0.0272805355489254, 27.673376083374023, 437.75555419921875,
    0.0821954682469368, 19.18253517150879, 0.7868719696998596, 260.2483825683594, 0.01756291463971138,
    2908.097412109375, 0.003246977459639311, 2.2048983573913574, 2.2860052585601807, 54.73116683959961,
    1.1793125867843628, 35.18867874145508, 0.27413931488990784, 0.00044443129445426166, 2.6068124771118164,
    149035.875, 2.295865215273807e-06, 327.2711181640625, 0.026847749948501587, 0.12841540575027466,
    229.8186798095703, 6.989522933959961, 24.255619049072266, 2638.046630859375, 0.0028373105451464653,
    4.233529090881348, 0.6104264259338379, 386.48760986328125, 0.041829485446214676, 1602915.375,
    5.1303904911037534e-06, 920.4266357421875, 0.034900397062301636, 70.96472930908203, 0.04155214503407478,
    3384.3896484375, 0.006447393447160721, 0.07297548651695251, 85.9933090209961, 1.7240023612976074,
    4.683084487915039, 1.5833805377951649e-07, 1547.768798828125, 66368.1171875, 0.00028536751051433384,
    54.15236282348633, 0.07306765764951706, 9.664084434509277, 0.8192050457000732, 3.0862624645233154,
    3.318100690841675, 3695.402587890625, 0.02963452972471714, 0.07907901704311371, 55.6201057434082,
    10.400957107543945, 0.0003354425716679543, 0.0018965012859553099, 11215.3701171875, 651.7164916992188,
    0.1325092762708664, 12.326499938964844, 0.7727430462837219, 0.0071667879819869995, 386.9255065917969,
    0.016358843073248863, 249.84884643554688, 2.9039182662963867, 0.23042988777160645, 0.12305793166160583,
    72.9807357788086, 21.164785385131836, 0.7113112211227417, 19.80194091796875, 0.31196698546409607,
    0.17703719437122345, 64.51464080810547, 17499.166015625, 0.002290839096531272, 37.159332275390625,
    0.3225248157978058, 19041.138671875, 0.0008178590796887875, 2.8695995807647705, 0.004851925652474165,
    0.001626473036594689, 570.2703857421875, 0.0936376079916954, 42.17698669433594, 88.5489501953125,
    0.13357703387737274, 0.027610257267951965, 15.998730659484863, 2.7933170795440674, 0.06272859871387482,
    0.23743514716625214, 6.383221626281738, 12.339203834533691, 0.0853317379951477, 1.4822072982788086,
    0.0007736222469247878, 0.010073027573525906, 468.616943359375, 24.02574348449707, 5.526508630282478e-06,
    0.8935554623603821, 5.970462322235107, 0.0010173545451834798, 1361.9254150390625, 25.717025756835938,
    0.22468644380569458, 1693.24365234375, 0.03340592235326767, 0.9533334374427795, 2.9957003593444824,
    0.13115853071212769, 8.299527168273926, 3.469517230987549, 3.1598806381225586, 0.4297260046005249,
    0.2675964832305908, 36.31520080566406, 0.011092028580605984, 0.010169725865125656, 68.72704315185547,
    0.020602818578481674, 2.2104577890313948e-10, 0.6245737671852112, 22.15891456604004, 21.85192108154297,
    0.05873826518654823, 0.04938780516386032, 69.19955444335938, 1.7970799207687378, 22.876605987548828,
    289.8008728027344, 0.04240031912922859, 1.0751091241836548, 11.421236991882324, 0.004887673072516918,
    2330.382080078125, 726.50390625, 0.01529531367123127, 0.04991764947772026, 276.2864990234375,
    0.1643117070198059, 0.8555842041969299, 60899.03515625, 0.00014697678852826357, 0.1288464516401291,
    1.9891173839569092, 91613.515625, 0.00037490014801733196, 3456.705078125, 0.026153670623898506,
    0.35658735036849976, 3.5140695571899414, 282.8518371582031, 0.053140074014663696, 1.2107175588607788,
    0.2368922084569931, 10.768892288208008, 0.6329458951950073, 0.022109247744083405, 1768.46484375,
    0.3110720217227936, 8.863691329956055, 0.018458636477589607, 6875.9462890625, 0.06029419228434563,
    0.0410483255982399, 0.416422575712204, 0.19798149168491364, 523135.3125, 1.1785356946347747e-05,
    53.20417022705078, 0.29541248083114624, 1.8053728342056274, 4.462436199188232, 41.27290344238281,
    0.6870893836021423, 0.11138872057199478, 149.4231414794922, 52.19865417480469, 0.09870793670415878,
    126.51338958740234, 0.017747916281223297, 3.3511552810668945, 3.367218494415283, 0.009941110387444496,
    60.29018783569336, 0.09284155815839767, 263.469970703125, 0.18963541090488434, 20.961084365844727,
    0.421056866645813, 50.655216217041016, 11.542924880981445, 0.039640020579099655, 12.643059730529785,
    0.1804824024438858, 0.005231262184679508, 826.4631958007812, 69.740966796875, 0.12750224769115448,
    0.2560892701148987, 2.8099024295806885, 0.017669154331088066, 38.80467987060547, 39.46820831298828,
    9.931264912665938e-07, 0.1196129247546196, 27.153940200805664, 2.031263589859009, 1.4328792095184326,
    0.1947636902332306, 5.611675262451172, 0.0025333359371870756, 7967.21533203125, 626.6738891601562,
    0.04205746203660965, 226.2307586669922, 0.02014155313372612, 0.1164092943072319, 41.125362396240234,
    0.01122622936964035, 4368.3232421875, 22.364709854125977, 0.08146156370639801, 2.450014591217041,
    2.216149091720581, 0.01849716156721115, 930.593017578125, 420210.65625, 0.00011206272029085085,
    7.148087024688721, 0.5675760507583618, 0.007140928413718939, 232.00430297851562, 1.625908510050067e-07,
    434381.96875, 0.08572520315647125, 25.35472297668457, 1.8087270259857178, 57.46760940551758,
    1.0425251722335815, 70.12077331542969, 235.71542358398438, 0.02270311489701271, 0.7601396441459656,
    1.161811113357544, 15.857638359069824, 0.010869982652366161, 0.23395812511444092, 24.0810489654541,
    201526.203125, 9.689041746696603e-08, 352378.28125, 3.7797269669681555e-06, 15284.0712890625,
    2.1080424630781636e-05, 0.02412416785955429, 5.035185813903809, 0.3185456395149231, 23.47044563293457,
    1.6396336555480957, 0.6257457733154297, 559.533447265625, 0.043567005544900894, 1.1886756420135498,
    0.18173719942569733, 11.294892311096191, 0.2327592372894287, 0.11622562259435654, 643.3803100585938,
    29034.505859375, 0.0012948414077982306, 0.28011777997016907, 0.40474802255630493, 0.2942981421947479,
    4.414846420288086, 0.015336711890995502, 0.05297601595520973, 0.0018760364037007093, 591.0001831054688,
    3.729200601577759, 0.07555641233921051, 0.4421238303184509, 55.33637619018555, 168.56455993652344,
    0.09154120087623596, 609.6041870117188, 0.19248852133750916, 0.40613847970962524, 21.299694061279297,
    0.09224873036146164, 1876.94677734375, 10.125426292419434, 1.8802108764648438, 0.07229985296726227,
    0.75978684425354, 3362.3271484375, 0.006309209391474724, 4.970596378939263e-09, 1.1033174729391249e-07,
    0.1670667976140976, 8.092409133911133, 198.8149871826172, 4.175452090748877e-07, 18.834800720214844,
    0.08700767904520035, 1.245516300201416, 13.113670349121094, 628.2035522460938, 0.005675758700817823,
    10.194612503051758, 25.333234786987305, 2468.879638671875, 0.01046067290008068, 0.27470698952674866,
    89.75133514404297, 0.18399523198604584, 54.73244094848633, 5.375291347503662, 0.06757564842700958,
    27.144420623779297, 0.5554785132408142, 169.6527862548828, 0.2839427888393402, 0.08429629355669022,
    428.4690856933594, 1634.090087890625, 0.025728857144713402, 10.380599975585938, 0.41950932145118713,
    1.9051845073699951, 2.052549123764038, 52.44464874267578, 0.1625230759382248, 76249.421875,
    2.1350169845391065e-05, 2.4788386821746826, 0.06281743198633194, 146739.609375, 0.0007016558665782213,
    17.300378799438477, 0.23124118149280548, 0.0023765501100569963, 80.4485855102539, 20731.91015625,
    0.0006184940575622022, 4.066812992095947, 1.1870962381362915, 0.014029035344719887, 138.71871948242188,
    8.748518943786621, 0.2863689661026001, 675.9525756835938, 0.04530814662575722, 1.6431039571762085,
    4.611596694792386e-12, 6.231802463531494, 0.009264915250241756, 0.020482387393712997, 124.62034606933594,
    0.16120466589927673, 71.86605834960938, 0.20134712755680084, 217.14064025878906, 81.83356475830078,
    0.2194736748933792, 0.0012267177226021886, 8372.625, 0.3570273816585541, 23.712352752685547,
    18.01897621154785, 1.5735751390457153, 0.7488094568252563, 0.3845306932926178, 412.42236328125,
    0.023309901356697083, 0.6098368763923645, 0.798427939414978, 1036.501220703125, 0.0002643618790898472,
    0.5198612213134766, 4.941497802734375, 20178.484375, 0.00022373402316588908, 3.713170289993286,
    1.447678565979004, 33450.69140625, 0.012130418792366982, 0.17149506509304047, 0.5361475944519043,
    281.8710021972656, 0.01575453206896782, 230.27207946777344, 0.04833827167749405, 6.70201116008684e-05,
    690535.75, 0.031278450042009354, 4.712028385256417e-05, 2448.64404296875, 0.017850100994110107,
    0.24603238701820374, 6.998460292816162, 3.132286310195923, 0.2995550334453583, 1.1652195453643799,
    3.3610610961914062, 0.0506427027285099, 1532.3372802734375, 0.4398377239704132, 0.7059944868087769,
    0.35057130455970764, 4.985022068023682, 10.540797233581543, 0.00023535554646514356, 23.940515518188477,
    1.7185332775115967, 0.6953414082527161, 2.285290241241455, 0.056328799575567245, 48.81822967529297,
    3.478055000305176, 39.046627044677734, 43.32110595703125, 0.0010839413153007627, 0.0006030664080753922,
    123.81108856201172, 0.00014255844871513546, 367259.25, 9.82174301147461, 6.411388874053955,
    0.7490965723991394, 0.8864989876747131, 0.45774567127227783, 0.03136184811592102, 0.18273884057998657,
    192.15184020996094, 0.3481970727443695, 31.12995147705078, 0.0027553439140319824, 594.7989501953125,
    0.008885926567018032, 551.0682983398438, 0.0029767840169370174, 6117.7646484375, 0.026303991675376892,
    33.088233947753906, 0.04755664989352226, 968.5833740234375, 9.795066833496094, 0.3600287139415741,
    873.9556884765625, 0.014025216922163963, 15.817340850830078, 0.08804634213447571, 29.664220809936523,
    0.02796272002160549, 3429.104248046875, 0.00016581045929342508, 0.00028005699277855456, 407.2777099609375,
    0.003438725834712386, 1827.57470703125, 24.249576568603516, 1.5249444246292114, 1284.5557861328125,
    0.0004409987304825336, 15.452099800109863, 0.2596072256565094, 0.4830760359764099, 70.36758422851562,
    18.335786819458008, 0.23742125928401947, 179.2915496826172, 0.1421300321817398, 0.0066767106764018536,
    518.5213012695312, 4.423447608947754, 5.052726745605469, 4.668293476104736, 0.6673030853271484,
    1112.7137451171875, 0.0018114764243364334, 0.7286360859870911, 41.990692138671875, 0.008048632182180882,
    544.6156616210938, 1966.635498046875, 0.04450530931353569, 0.46726885437965393, 4.250865459442139,
    0.0005474082427099347, 40184.0234375, 0.0030563075561076403, 0.18960431218147278, 21812.142578125,
    0.0010615583742037416, 0.3078588843345642, 31.068763732910156, 150.46258544921875, 0.034672580659389496,
    0.006247429177165031, 1.9134204387664795, 9.242995474778581e-06, 99614.1328125, 30.771080017089844,
    0.08894974738359451, 0.004719543270766735, 11792.3525390625, 0.8992394804954529, 3.1834168434143066,
    7.472159385681152, 0.027557866647839546, 0.3164902627468109, 11.480128288269043, 3.4418492317199707,
    0.9084047675132751, 0.007039801683276892, 985.7785034179688, 5.394389518187381e-06, 1660.758056640625,
    0.0003761555708479136, 24784.091796875, 1152.5347900390625, 0.00693088211119175, 26.295724868774414,
    3.412583351135254, 591.7507934570312, 0.10811644792556763, 0.7322266697883606, 0.36011970043182373,
    0.0784720852971077, 40.47528076171875, 0.0076692188158631325, 343.73870849609375, 773.7472534179688,
    0.11218889057636261, 0.12229064106941223, 0.9125125408172607, 0.007194993551820517, 1.2221672534942627,
    0.0002393306203885004, 83299.3515625, 0.0009722328395582736, 8351.0478515625, 1.4422732591629028,
    0.008305932395160198, 8.992172241210938, 0.7318795919418335, 15872.18359375, 0.0001420725166099146,
    0.4657859206199646, 0.2191714346408844, 0.0006981497863307595, 433.1473693847656, 0.10276015102863312,
    71.31425476074219, 129.61862182617188, 0.017841476947069168, 0.10436604171991348, 11.161389350891113,
    6351.68701171875, 0.0008987606852315366, 0.010069770738482475, 457.63153076171875, 4.0625715255737305,
    4.51104736328125, 883.7689819335938, 0.0018869234481826425, 0.06528820842504501, 49.88893508911133,
    98.93490600585938, 0.09094803035259247, 0.014292917214334011, 0.002208869671449065, 0.038843732327222824,
    668.83154296875, 225.67010498046875, 0.2004372924566269, 7.853241920471191, 0.2739830017089844,
    0.02919222228229046, 36.770660400390625, 0.022639993578195572, 11.57631778717041, 1.918949842453003,
    29.079761505126953, 141.11720275878906, 0.36450016498565674, 5.966498374938965, 1.063120722770691,
    0.0010525587713345885, 5036.10546875, 828.5922241210938, 0.0053988113068044186, 581.6741943359375,
    0.07788682729005814, 0.07354586571455002, 17.067134857177734, 4.906740665435791, 5.945775569671241e-07,
    0.00011501597327878699, 50564.9140625, 0.00015379158139694482, 1823.60986328125, 298.7773132324219,
    8.8332859604634e-07, 2.2164900302886963, 56.18107223510742, 0.03182274103164673, 2373.277099609375,
    1.2159048318862915, 5.173098087310791, 1.1258937120437622, 1.1659679412841797, 14.070399284362793,
    0.94921875, 9.098395347595215, 2.483088970184326, 0.21631069481372833, 63.78976058959961,
    0.4475978910923004, 27.855873107910156, 299.6235046386719, 8.83966890796728e-08, 71.54121398925781,
    0.9370326995849609, 446.4524841308594, 0.39039936661720276, 0.8326091170310974, 92.28895568847656,
    119.66722106933594, 0.08461079001426697, 0.44599851965904236, 23.425189971923828, 15273.6474609375,
    0.0012452591909095645, 3.544037103652954, 1.3116800801071804e-05, 113.67757415771484, 0.19602562487125397,
    1.110124111175537, 5.239927768707275, 1.7104849815368652, 11.638324737548828, 0.028720887377858162,
    1820.5504150390625, 9.316115379333496, 6.227487087249756, 719.1676635742188, 0.056232254952192307,
    76.28841400146484, 0.11668083071708679, 0.005071676801890135, 557.9922485351562, 3.936861753463745,
    0.0013348483480513096, 0.9340320825576782, 8.309455871582031, 0.010842554271221161, 249.69105529785156,
    3.2893771276576445e-05, 4701.7041015625, 19.560810089111328, 0.00040327967144548893, 359.7439880371094,
    0.024144506081938744, 0.1738409847021103, 9.814696311950684, 0.17132960259914398, 53.398345947265625,
    69.6253662109375, 0.4366004168987274, 0.7862537503242493, 75.10515594482422, 0.44682687520980835,
    8.589377403259277, 0.6333822011947632, 18.155797958374023, 4.604228973388672, 1.6545883417129517,
    19.661693572998047, 3.981398820877075, 2.0541772842407227, 0.9676043391227722, 917.1283569335938,
    0.0230735931545496, 15.767369270324707, 0.1558654010295868, 12.376315116882324, 0.24753141403198242,
    0.6995282173156738, 0.333655446767807, 0.5860119462013245, 4.022807598114014, 13.268289566040039,
    0.9694925546646118, 4139.63330078125, 0.01859608106315136, 0.014118635095655918, 242.05108642578125,
    0.7617335319519043, 274.60693359375, 0.030852191150188446, 0.004716580267995596, 1.0789514703901659e-07,
    3.208256721496582, 0.23526838421821594, 69.03058624267578, 43.429508209228516, 0.20570306479930878,
    1.4194271564483643, 57.89963912963867, 150262.078125, 9.275157935917377e-05, 0.21647199988365173,
    67.14395904541016, 2.080240488052368, 3.4241182804107666, 0.49325767159461975, 29.18658447265625,
    1.6834306716918945, 0.0424027182161808, 1609.1209716796875, 0.15425296127796173, 25.101394653320312,
    0.3817960023880005, 0.616443395614624, 5.753119468688965, 1.6232561392826028e-05, 133662.515625,
    4.208634376525879, 0.6917757987976074, 4.227925777435303, 0.03843245655298233, 4.329646587371826,
    0.03344187140464783, 12.126703262329102, 0.04953357204794884, 0.2537935674190521, 163.38218688964844,
    0.023855553939938545, 706.0702514648438, 588103.1875, 6.660984581685625e-07, 3.256129503250122,
    1.4582208395004272, 104.50513458251953, 0.1124163493514061, 8.014849662780762, 0.9855263829231262,
    373.6821594238281, 0.10206184536218643, 16.280906677246094, 0.03721163421869278, 4.083781719207764,
    0.5744791030883789, 2.183145761489868, 5.032205104827881, 0.014263537712395191, 3.3021810054779053,
    0.025668691843748093, 25.15879249572754, 0.3064015209674835, 7.962116241455078, 378.19451904296875,
    0.045407045632600784, 6074.265625, 0.01898372359573841, 0.7395488619804382, 10.717429161071777,
    1106.0068359375, 0.021972982212901115, 896.2477416992188, 0.023668531328439713, 0.3245164453983307,
    107.74512481689453, 4.871960639953613, 1.3720241785049438, 0.11989466100931168, 31.339685440063477,
    0.3754245936870575, 348.18731689453125, 0.0252856258302927, 581.7334594726562, 0.0007364388438872993,
    2567.977783203125, 8.334233283996582, 3.2134222984313965, 0.0001795229036360979, 0.004858255386352539,
    19.669641494750977, 0.3347267210483551, 7001952.5, 1.771454776644532e-06,
)
JAX_CAL_TRADE_SUMS = (0, 0, 0, 284232, 269769, 735232, 5441543, 1453410, 7223458, 5608660, 7468519, 7524371, 7495335, 7423104, 5528441, 7602499, 6522051, 7379367, 2861449)
JAX_CAL_WEALTH_P50 = (1.5035758018493652, 30364.3515625, 3720.964599609375, 114.1778564453125, 71.2265625, 3753.82861328125, 22098.666015625, 2037.5546875, 16211.7470703125, 18247.69921875, 23401.7890625, 25065.5, 22761.60546875, 22779.412109375, 4166.603515625, 56683.51953125, 9740.07421875, 10649.162109375, 541.6241455078125)
JAX_CAL_INT_SUMS = {'start_offset': 663260, 'regime_high_days': 202260, 'jump_days': 10598, 'valid': 1022}

REPO = Path(__file__).resolve().parent
COMMITTED_FITS = ("regime_model", "joint_return_model",
                  "funding_spread_model", "stress_state_model",
                  "tracking_residual_model")
# The committed GARCH fits are float32 (the JAX package's default mode);
# the port fits in float64, 4.1e-6 from them on the CPU.
FIT_BOUNDS = {"garch": 2e-5, "rtol": 1e-6}
CACHE_NAMES = ("DATA_CACHE", "REGIME_MODEL_CACHE", "CORRELATION_CACHE",
               "VALIDATION_RESULTS", "JOINT_RETURN_MODEL_CACHE",
               "FUNDING_MODEL_CACHE", "TRACKING_RESIDUAL_CACHE",
               "STRESS_STATE_CACHE", "BOOTSTRAP_CACHE")


def digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


@contextlib.contextmanager
def port_cache():
    """The port's cache directory, for the block, in a new temporary
    directory (removed after)."""
    from letf_tpu_torch import config as cfg

    tmp = Path(tempfile.mkdtemp(prefix="letf_tpu_torch_cache_"))
    saved = {n: getattr(cfg, n) for n in ("CACHE_DIR",) + CACHE_NAMES}
    cfg.CACHE_DIR = tmp
    for n in CACHE_NAMES:
        setattr(cfg, n, tmp / saved[n].name)
    try:
        yield tmp
    finally:
        for n, v in saved.items():
            setattr(cfg, n, v)
        shutil.rmtree(tmp, ignore_errors=True)


def committed_fits():
    """calibrate_all's output rebuilt from the JAX package's committed
    fitted-model pickles (numpy leaves only): (regime_model,
    correlations)."""
    load = {n: pickle.loads((REPO / "letf_tpu_cache_v1" / f"{n}.pkl")
                            .read_bytes()) for n in COMMITTED_FITS}
    model = dict(load["regime_model"])
    model["joint_return_model"] = load["joint_return_model"]
    model["funding_model"] = load["funding_spread_model"]
    model["stress_state_model"] = load["stress_state_model"]
    model["tracking_residual_model"] = load["tracking_residual_model"]
    corr = pickle.loads((REPO / "letf_tpu_cache_v1" / "correlations.pkl")
                        .read_bytes())
    return model, corr


def phase_history():
    """(a) fetch_historical_data(force_synthetic=True) into the port's
    cache against the committed history's per-column digests and sums:
    every column's NaN count equal and its sum within rtol 1e-12 (a numpy
    whose float64 pow differs in the last bit moves the LETF columns by
    ulps), the number of bitwise columns logged."""
    from letf_tpu_torch.data import fetch_historical_data

    t0 = time.perf_counter()
    df = fetch_historical_data(force_synthetic=True)
    secs = time.perf_counter() - t0
    assert (len(df), len(df.columns)) == HISTORY_SHAPE, (len(df),
                                                         df.columns)
    assert df.columns == list(HISTORY_COLUMNS), df.columns
    assert (str(df.index[0]), str(df.index[-1])) == HISTORY_SPAN
    bitwise, worst = 0, 0.0
    for c, ref in HISTORY_COLUMNS.items():
        if ref[0] == "str":
            assert sorted(set(df[c].tolist())) == ref[1], c
            bitwise += 1
            continue
        a = df[c]
        bitwise += digest(a) == ref[0]
        f = a.astype(np.float64)
        assert int(np.isnan(f).sum()) == ref[1], c
        rel = abs(float(np.nansum(f)) - ref[2]) / max(abs(ref[2]), 1e-300)
        worst = max(worst, rel)
        assert rel <= 1e-12, (c, rel)
    log(f"calibrated path (a): fetch_historical_data(force_synthetic=True) "
        f"{len(df)} days x {len(df.columns)} columns in {secs:.3f} s "
        f"(host); {bitwise}/{len(HISTORY_COLUMNS)} columns bitwise the "
        f"committed history, largest relative sum difference {worst:.3e}")
    return df


def fit_errors(got, ref, path="", out=None):
    """{"garch": largest |abs error| of the GARCH fits, "rel": largest
    relative error of the other numbers}; raises past FIT_BOUNDS or where
    a key, a length or the historical regimes differ."""
    out = {"garch": 0.0, "rel": 0.0} if out is None else out
    if isinstance(ref, dict):
        assert sorted(got, key=str) == sorted(ref, key=str), path
        for k in ref:
            fit_errors(got[k], ref[k], f"{path}/{k}", out)
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(got, ref)):
            fit_errors(a, b, f"{path}[{i}]", out)
    elif isinstance(ref, str):
        assert got == ref, path
    elif path.endswith("regimes_historical"):
        assert np.array_equal(got, ref), path
    elif path.endswith(("garch_alpha", "garch_beta")):
        out["garch"] = max(out["garch"], abs(got - ref))
        assert abs(got - ref) <= FIT_BOUNDS["garch"], (path, got, ref)
    else:
        a, b = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        assert a.shape == b.shape, path
        err = np.abs(a - b)
        fin = np.isfinite(b)
        assert np.array_equal(a[~fin], b[~fin]), path
        scale = np.abs(b[fin])
        rel = np.where(scale > 0, err[fin] / np.where(scale > 0, scale, 1.0),
                       np.where(err[fin] == 0, 0.0, np.inf))
        worst = float(rel.max()) if rel.size else 0.0
        out["rel"] = max(out["rel"], worst)
        assert worst <= FIT_BOUNDS["rtol"], (path, worst)
    return out


def phase_calibration(df, smi):
    """(b) calibrate_all(frame, device="cuda"): the fits on the card in
    float64 against the committed fits (FIT_BOUNDS; the historical
    regimes exactly); returns the seconds."""
    from letf_tpu_torch.calibration import calibrate_all

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, corr = calibrate_all(df, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ref_model, ref_corr = committed_fits()
    err = fit_errors(model, ref_model)
    err_c = fit_errors(corr, ref_corr)
    jm = model["joint_return_model"]["regimes"]
    log(f"calibrated path (b): calibrate_all on the card in {secs:.3f} s "
        f"({smi}); against the committed fits: GARCH largest |error| "
        f"{err['garch']:.3e} (bound {FIT_BOUNDS['garch']}), other numbers "
        f"largest relative error {max(err['rel'], err_c['rel']):.3e} "
        f"(bound {FIT_BOUNDS['rtol']}), historical regimes equal; GARCH "
        f"(alpha, beta) {[(jm[r]['garch_alpha'], jm[r]['garch_beta']) for r in sorted(jm)]}, "
        f"nu {[jm[r]['nu'] for r in sorted(jm)]}")
    return secs


def phase_calibrated_report(counters, smi, n=1_048_576, horizons=(10, 30)):
    """(c) runner.run_report(horizons=[10, 30], 1,048,576 trials, seed
    2, force_synthetic=True) from the cached history and a cold fit cache
    (so it calibrates, as a user's first report does), the launch counters
    set to 0 just before and read just after: every fan finite, finite_frac
    1.0, and every kernel of the sampled report launched."""
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch import runner

    for name in CACHE_NAMES[1:]:
        Path(getattr(cfg, name)).unlink(missing_ok=True)
    stages = {}
    reset(counters)
    GENERAL_TRIALS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = runner.run_report(horizons=list(horizons), num_simulations=n,
                             seed=2, force_synthetic=True, device="cuda",
                             stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read(counters)
    per = {}
    for h in horizons:
        rep = reps[h]
        secs = stages[f"horizon_{h}"]
        per[h] = {"wall_s": secs, "post_tax_s": rep["post_tax_seconds"],
                  "pre_tax_s": secs - rep["post_tax_seconds"],
                  "trial_days_per_s": n * h * 252 / secs,
                  "valid_frac": rep["valid_frac"],
                  "finite_frac": rep["finite_frac"],
                  "S1_p50": rep["strategies"]["S1"]["wealth"]["p50"],
                  "S7_post_tax_p50":
                      rep["strategies"]["S7"]["post_tax"]["wealth"]["p50"]}
        assert rep["n_trials"] == n and rep["finite_frac"] == 1.0, rep
        for sid, s in rep["strategies"].items():
            assert all(np.isfinite(v) for v in s["wealth"].values()), sid
            if "post_tax" in s:
                pt = s["post_tax"]
                assert all(np.isfinite(v) for v in pt["wealth"].values())
                assert np.isfinite(pt["median_tax"]), sid
        assert len([s for s in rep["strategies"].values()
                    if "post_tax" in s]) == 13
    log(f"calibrated path (c): run_report({list(horizons)}, {n} trials, "
        f"seed 2, force_synthetic) wall {wall:.3f} s ({smi}): data "
        f"{stages['data']:.3f} s, calibration {stages['calibration']:.3f} "
        f"s, per horizon {json.dumps(per)}; launches {launches}, general "
        f"path (K5) at {GENERAL_TRIALS} trials")
    chunks = -(-n // B_CHUNK) * len(horizons)
    assert launches["joint"] == chunks + len(horizons), launches
    assert launches["compose_strategies"] == chunks, launches
    assert launches["window"] == chunks, launches
    assert launches["window_tiles"] == len(horizons), launches
    assert launches["compose"] == len(horizons), launches
    assert launches["sort_bridge"] >= len(horizons), launches
    assert launches["wash"] >= len(horizons), launches
    assert launches["strategies"] == 0 and launches["gbm"] == 0, launches
    return launches


def phase_calibrated_jax_reference():
    """(d) The first 1,024 trials x 30 y of run_monte_carlo on the model of
    the committed fits, on the card, against the JAX package's run
    (JAX_CAL_*), with phase_jax_reference's bounds: start offsets and
    regime-1 days exact; S1 (no decisions) per trial within a median
    relative error of 1e-5, every trial within 1e-3; each strategy's
    summed trade count within 0.5% and its median wealth within 2%."""
    from letf_tpu_torch.parallel import mc_runner

    model, _ = committed_fits()
    a = mc_runner.run_monte_carlo(model, 30, num_simulations=1024, seed=2,
                                  chunk_size=1024, device="cuda")
    s1 = a.final_wealth[:, 0].astype(np.float64)
    ref = np.asarray(JAX_CAL_S1_WEALTH)
    rel = np.abs(s1 - ref) / np.maximum(np.abs(ref), 1e-30)
    sums = a.num_trades.sum(0)
    tr = np.abs(sums - np.asarray(JAX_CAL_TRADE_SUMS)) / np.maximum(
        np.asarray(JAX_CAL_TRADE_SUMS), 1)
    p50 = np.median(a.final_wealth.astype(np.float64), 0)
    prel = np.abs(p50 - np.asarray(JAX_CAL_WEALTH_P50)) / np.maximum(
        np.abs(np.asarray(JAX_CAL_WEALTH_P50)), 1e-30)
    ints = {"start_offset": int(a.start_offset.sum()),
            "regime_high_days": int(a.regime_high_days.sum()),
            "jump_days": int(a.jump_days.sum()), "valid": int(a.valid.sum())}
    log(f"calibrated path (d): run_monte_carlo on the committed fits vs the "
        f"JAX package (1,024 x 30y): S1 per-trial rel err median "
        f"{np.median(rel):.3e} max {rel.max():.3e}; trade sums max rel diff "
        f"{tr.max():.3e}; median wealth max rel diff {prel.max():.3e}; "
        f"integer sums {ints} (JAX {JAX_CAL_INT_SUMS}); valid_frac "
        f"{a.valid.mean():.6f}")
    assert ints["start_offset"] == JAX_CAL_INT_SUMS["start_offset"], ints
    assert ints["regime_high_days"] == JAX_CAL_INT_SUMS[
        "regime_high_days"], ints
    assert abs(ints["jump_days"] - JAX_CAL_INT_SUMS["jump_days"]) <= 2
    assert abs(ints["valid"] - JAX_CAL_INT_SUMS["valid"]) <= 2
    assert np.median(rel) < 1e-5 and rel.max() < 1e-3, rel.max()
    assert tr.max() < 5e-3, tr
    assert prel.max() < 2e-2, prel


def phase_cli(smi):
    """(e) python -m letf_tpu_torch.cli --report --synthetic-data --sims
    16384 --horizons 1, through cli.main on the warm cache (default device:
    the card)."""
    from letf_tpu_torch import cli
    from letf_tpu_torch import config as cfg

    sims = cfg.NUM_SIMULATIONS
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(["--report", "--synthetic-data", "--sims", "16384",
                  "--horizons", "1"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cfg.NUM_SIMULATIONS = sims
    text = out.getvalue()
    print(text, flush=True)
    assert "AT-SCALE REPORT: 16,384 trials x 1y" in text, text[-2000:]
    assert "Using cached historical data" in text
    assert "TAXABLE (post-tax, CA $150,000 single; sampled" in text
    log(f"calibrated path (e): cli --report --synthetic-data --sims 16384 "
        f"--horizons 1 on the warm cache in {secs:.3f} s ({smi})")


def phase_calibrated(counters, smi):
    """The production entry from data to fans (phases a-e) in a temporary
    cache of the port's."""
    with port_cache():
        df = phase_history()
        phase_calibration(df, smi)
        launches = phase_calibrated_report(counters, smi)
        phase_calibrated_jax_reference()
        phase_cli(smi)
    return launches


# Constants of the analysis phase: the JAX package's numbers on the CPU
# (float32) over the committed fits and history, printed by
# tools/analysis_reference.py.
ANALYSIS_START_OFFSETS = (123, 123, 1142, 1142, 169, 169, 333, 333, 823, 823, 1169, 1169, 659, 659, 613, 613, 1108, 1108, 435, 435, 377, 377, 145, 145, 386, 386, 461, 461, 77, 77, 1103, 1103, 631, 631, 1231, 1231, 417, 417, 408, 408, 1212, 1212, 426, 426, 1252, 1252, 1171, 1171, 1234, 1234, 465, 465, 943, 943, 1174, 1174, 1237, 1237, 139, 139, 585, 585, 1065, 1065, 859, 859, 189, 189, 303, 303, 402, 402, 426, 426, 1162, 1162, 137, 137, 65, 65, 1084, 1084, 1180, 1180, 924, 924, 352, 352, 63, 63, 520, 520, 949, 949, 595, 595, 923, 923, 273, 273, 447, 447, 930, 930, 488, 488, 650, 650, 467, 467, 406, 406, 943, 943, 1087, 1087, 60, 60, 893, 893, 1196, 1196, 169, 169, 703, 703, 604, 604, 102, 102, 1075, 1075, 508, 508, 909, 909, 71, 71, 1135, 1135, 1241, 1241, 526, 526, 396, 396, 292, 292, 606, 606, 897, 897, 51, 51, 305, 305, 814, 814, 431, 431, 465, 465, 1254, 1254, 303, 303, 1030, 1030, 1003, 1003, 946, 946, 612, 612, 263, 263, 837, 837, 1074, 1074, 71, 71, 67, 67, 742, 742, 1193, 1193, 615, 615, 1175, 1175, 859, 859, 556, 556, 449, 449, 1198, 1198)
ANALYSIS_REGIME_HIGH_DAYS = (0, 0, 0, 0, 72, 72, 0, 0, 16, 16, 78, 78, 71, 71, 49, 49, 124, 124, 82, 82, 106, 106, 25, 25, 69, 69, 98, 98, 54, 54, 77, 77, 156, 156, 35, 35, 59, 59, 92, 92, 56, 56, 31, 31, 0, 0, 0, 0, 0, 0, 48, 48, 123, 123, 0, 0, 84, 84, 116, 116, 0, 0, 88, 88, 122, 122, 120, 120, 81, 81, 113, 113, 56, 56, 0, 0, 141, 141, 44, 44, 73, 73, 20, 20, 53, 53, 81, 81, 40, 40, 95, 95, 102, 102, 18, 18, 0, 0, 32, 32, 100, 100, 49, 49, 70, 70, 70, 70, 126, 126, 8, 8, 55, 55, 38, 38, 97, 97, 98, 98, 87, 87, 110, 110, 46, 46, 32, 32, 80, 80, 72, 72, 101, 101, 121, 121, 82, 82, 134, 134, 62, 62, 115, 115, 24, 24, 114, 114, 43, 43, 0, 0, 51, 51, 125, 125, 0, 0, 36, 36, 33, 33, 62, 62, 32, 32, 43, 43, 96, 96, 81, 81, 46, 46, 70, 70, 32, 32, 87, 87, 48, 48, 25, 25, 121, 121, 80, 80, 34, 34, 71, 71, 0, 0, 83, 83, 116, 116, 52, 52)
ANALYSIS_S123_P50 = (620.4219970703125, 14399.01708984375, 7183.2861328125)
ANALYSIS_BACKTEST = {
    10: (78, 4510, {'S1': -0.05067276954650879, 'S2': 0.109363853931427, 'S3': 0.11840426921844482, 'S4': 0.18149268627166748, 'S5': 0.24754029512405396, 'S6': 0.19513338804244995, 'S7': 0.07006371021270752, 'S8': 0.08112126588821411, 'S9': 0.07325571775436401, 'S10': 0.11459755897521973, 'S11': 0.07289773225784302, 'S12': 0.06478720903396606, 'S13': 0.07702207565307617, 'S14': 0.07329553365707397, 'S15': 0.03660005331039429, 'S16': 0.11301803588867188, 'S17': 0.18700963258743286, 'S18': 0.027371764183044434, 'S19': 0.042099714279174805}),
    20: (0, 0, {}),
    30: (0, 0, {}),
}
ANALYSIS_SANITY = {'transition_matrix_finite': True, 'transition_matrix_row_stochastic': True, 'transition_matrix_nonnegative': True, 'te_seed_collision_free': True, 'tracking_model_params_valid': True, 'funding_vix_activates': False, 'funding_inv_curve_activates': True, 'funding_liquidity_activates': True, 'funding_credit_activates': True, 'all_passed': False}
ANALYSIS_ROLLING_OOS = {'splits_run': 3, 'funding_mae_mean': 5.2727287988647176e-05, 'tracking_residual_std_mean': 0.0002773111224511903, 'funding_beta_vix_drift': 0.0, 'sufficient_data': True}


# ---------------------------------------------------------------------------
# The full analysis (runner.run), the results-list API and the CLI
# ---------------------------------------------------------------------------

ANALYSIS_N = 200                   # cfg.NUM_SIMULATIONS, run's default
ANALYSIS_HORIZONS = (10,)
# The historical backtest's median window CAGR of each strategy, the port
# on the card (float32 glue, K4) against the JAX package on the CPU
# (float32, its XLA scan): the same windows and inputs, the strategies'
# arithmetic in another order.
BACKTEST_CAGR_ATOL = 1e-4
# The rolling out-of-sample numbers: the port's fits in float64 on the
# card against the JAX package's float32 mode.
OOS_RTOL = 1e-5
# The Trade_Replay route's exact taxes against the host chain's at the
# sampled trials, relative to the larger of the tax and the trial's gross
# traded dollars (the scale at which the bridge's cumulative share
# coordinates round). Its median over the 650 trials is held to
# tests/test_mc_runner.py:356's rtol 1e-6 (with atol $1). Each trial's
# bound lies near the geometric middle of the float64 bridge's reading
# (1.943e-4, S12, on an H100 80GB HBM3 at 700 W) and the float32 bridge's
# (2.4e-3: a float32 coordinate of ~10^7 shares is one share apart;
# ROADMAP section 3, fault 3). What remains in float64 is the
# reference's own: its device bridge and its host chain disagree on some
# 30-year trade lists, on the CPU too (tools/bridge_host_reference.py).
# On the CPU at short horizons tests/test_torch_results_list.py holds
# every trial to rtol 1e-6 of its tax.
REPLAY_TAX_BOUNDS = dict(median_rtol=1e-6, max_rtol=7e-4, atol=1.0)
# The strategies whose sampled replay emission analysis_replay also taxes
# through the float64 bridge (its largest differences to the host chain):
# within REPLAY_TAX_BOUNDS' atol of the exact-all chunk's taxes, so the
# emission of a trial does not depend on the batch's trial set.
REPLAY_PROBE = ("S7", "S12")
K4_ANALYSIS_PLAIN_DAYS = 504


@contextlib.contextmanager
def wrapped(mod, name, wrapper):
    """``mod.name`` replaced by ``wrapper(original)`` for the block."""
    inner = getattr(mod, name)
    setattr(mod, name, wrapper(inner))
    try:
        yield
    finally:
        setattr(mod, name, inner)


def out_file(name: str) -> Path:
    """A file for the analysis phase's long output, under build/analysis/
    in the checkout (listed in .gitignore)."""
    d = REPO / "build" / "analysis"
    d.mkdir(parents=True, exist_ok=True)
    return d / name


def summary_finite(summ) -> int:
    """Raises where a number of the Roth or taxable tables is not finite;
    a post-tax CAGR is NaN where the post-tax wealth is not positive, as
    the JAX package reports it. Returns the count of numbers checked."""
    n = 0
    for sid, row in summ["roth"].items():
        for k, v in row.items():
            if k not in ("id", "name"):
                assert np.isfinite(v), (sid, k, v)
                n += 1
    for sid, row in summ["taxable"].items():
        for k in ("max_dd", "trades", "win"):
            assert np.isfinite(row[k]), (sid, k)
            n += 1
        for pn, p in row["pcts"].items():
            for k, v in p.items():
                if k == "post_cagr" and p["post_wealth"] <= 0:
                    assert np.isnan(v), (sid, pn, v)
                    continue
                assert np.isfinite(v), (sid, pn, k, v)
                n += 1
    return n


def analysis_run(counters, smi):
    """(1) runner.run(horizons=[10], seed=0, force_synthetic=True)
    at 200 trials on the card, the launch counters set to 0 just before
    and read just after; its output goes to build/analysis/analysis_run.txt,
    its timing summary to the log. Returns (launches, the results lists
    and calibrated model by horizon, the backtests by horizon)."""
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch import historical, runner
    from letf_tpu_torch.parallel import mc_runner

    assert cfg.NUM_SIMULATIONS == ANALYSIS_N, cfg.NUM_SIMULATIONS
    results, backtests = {}, {}

    def keep_results(inner):
        def call(*a, **kw):
            out = inner(*a, **kw)
            results[kw["time_horizon"]] = (kw["regime_model"], out)
            return out
        return call

    def keep_backtest(inner):
        def call(df, horizon, *a, **kw):
            path = {}
            out = inner(df, horizon, *a, out_path=path, **kw)
            backtests[horizon] = (out, path)
            return out
        return call

    stages = {}
    path = out_file("analysis_run.txt")
    # The date and tax menus take their defaults whatever stdin is, as the
    # CLI sets it without --interactive.
    saved_env = os.environ.get("LETF_NON_INTERACTIVE")
    os.environ["LETF_NON_INTERACTIVE"] = "1"
    with wrapped(mc_runner, "parallel_monte_carlo_fixed", keep_results), \
            wrapped(historical, "backtest_strategies_on_history",
                    keep_backtest), open(path, "w", buffering=1) as f:
        reset(counters)
        GENERAL_TRIALS.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(f):
            summaries = runner.run(horizons=list(ANALYSIS_HORIZONS), seed=0,
                                   force_synthetic=True, device="cuda",
                                   stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read(counters)
    if saved_env is None:
        del os.environ["LETF_NON_INTERACTIVE"]
    else:
        os.environ["LETF_NON_INTERACTIVE"] = saved_env
    out = path.read_text()
    print(out[out.index("TIMING SUMMARY") - 81:], flush=True)
    log(f"analysis (1): runner.run({list(ANALYSIS_HORIZONS)}, seed 0, "
        f"{ANALYSIS_N} trials, force_synthetic) wall {wall:.3f} s ({smi}); "
        f"step seconds {json.dumps(stages)}; launches {launches}, general "
        f"path (K5) at {GENERAL_TRIALS} trials")
    assert sorted(summaries) == list(ANALYSIS_HORIZONS), summaries.keys()
    checked = 0
    for h in ANALYSIS_HORIZONS:
        assert len(summaries[h]["roth"]) == 6, summaries[h]["roth"].keys()
        assert len(summaries[h]["taxable"]) == 13
        checked += summary_finite(summaries[h])
    n_h = len(ANALYSIS_HORIZONS)
    # Each horizon: one slab chunk (K1, K2, K3) and one trade-list replay
    # of all 200 trials (K1, K2', K5); the validation battery: K3 (zero
    # drift) and K6 (flat decay, 2x and 3x); the backtest: K4 where the
    # history holds a window.
    n_bt = sum(1 for h in ANALYSIS_HORIZONS if backtests[h][0])
    assert launches["joint"] == 2 * n_h, launches
    assert launches["window"] == n_h, launches
    assert launches["window_tiles"] == n_h, launches
    assert launches["compose_strategies"] == n_h + 1, launches
    assert launches["compose"] == n_h, launches
    assert launches["gbm"] == 2, launches
    assert launches["strategies"] == n_bt >= 1, launches
    assert GENERAL_TRIALS == [ANALYSIS_N] * n_h, GENERAL_TRIALS
    log(f"analysis (1): {checked} summary numbers finite over "
        f"{n_h} horizons")
    return launches, results, backtests


def analysis_results_lists(results):
    """(1) Each horizon's results list against run_monte_carlo's arrays on
    the same model and seed: Final_Wealth, Num_Trades and Max_DD equal,
    every taxable trial with a trade list (200 <= trade_list_limit)."""
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch.parallel import mc_runner

    for h, (model, mc) in sorted(results.items()):
        a = mc_runner.run_monte_carlo(model, h, num_simulations=ANALYSIS_N,
                                      seed=0, device="cuda", progress=False)
        for sid, rows in mc.items():
            k = cfg.STRATEGY_INDEX[sid]
            assert len(rows) == ANALYSIS_N, (h, sid)
            for key, arr in (("Final_Wealth", a.final_wealth),
                             ("Num_Trades", a.num_trades),
                             ("Max_DD", a.max_dd)):
                got = np.array([r[key] for r in rows], np.float64)
                assert np.array_equal(got, arr[:, k].astype(np.float64)), (
                    h, sid, key)
            if sid in cfg.TAXABLE_IDS:
                assert all(isinstance(r.get("Trade_List"), list)
                           for r in rows), (h, sid)
    log(f"analysis (1): results lists at {sorted(results)} y equal "
        f"run_monte_carlo's arrays (Final_Wealth, Num_Trades, Max_DD) "
        f"bitwise")


def analysis_validation():
    """(1) The battery's JSON in the port's cache: the zero-drift
    invariant passes; the structural checks equal the JAX package's on the
    committed fits (ANALYSIS_SANITY: funding_vix_activates is false there
    too, the funding fit's beta_vix being 0 on this history, so all_passed
    is false in both); the rolling OOS ran its 3 splits, within OOS_RTOL
    of the JAX package's numbers."""
    from letf_tpu_torch import config as cfg

    res = json.loads(Path(cfg.VALIDATION_RESULTS).read_text())
    assert res["zero_drift_test"]["test_passed"], res["zero_drift_test"]
    assert res["flat_market_test"]["all_passed"], res["flat_market_test"]
    sanity = res["institutional_sanity"]
    assert sanity == ANALYSIS_SANITY, (sanity, ANALYSIS_SANITY)
    assert all(v for k, v in sanity.items()
               if k not in ("all_passed", "funding_vix_activates")), sanity
    oos = res["rolling_oos"]
    assert oos["sufficient_data"] and oos["splits_run"] == 3, oos
    rel = {}
    for k, ref in ANALYSIS_ROLLING_OOS.items():
        if isinstance(ref, float):
            rel[k] = abs(oos[k] - ref) / max(abs(ref), 1e-300)
            assert rel[k] <= OOS_RTOL, (k, oos[k], ref)
        else:
            assert oos[k] == ref, (k, oos[k], ref)
    log(f"analysis (1): zero-drift {res['zero_drift_test']['actual_drag']:.6f} "
        f"(expected {res['zero_drift_test']['expected_drag']:.6f}); "
        f"institutional sanity equals the JAX package's check for check "
        f"(all_passed {sanity['all_passed']}: funding_vix_activates "
        f"{sanity['funding_vix_activates']} in both); rolling OOS "
        f"{json.dumps(oos)}, relative difference to the JAX package's "
        f"{json.dumps(rel)} (bound {OOS_RTOL})")


def analysis_backtests(backtests):
    """(1) K4 on each horizon's backtest windows against its plain version
    on the card, within check_parity's bounds, at the windows' count and
    their first K4_ANALYSIS_PLAIN_DAYS days (the plain loop is host-bound,
    ~10 ms a day); the kernel bitwise the backtest's own run over all the
    days. (2) Window counts equal the JAX package's, each strategy's
    median window CAGR within BACKTEST_CAGR_ATOL of it; the regime-1
    window days beside its. Returns K4's record at the widest horizon."""
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import strategies as k4
    from letf_tpu_torch.strategies.signals import compute_signals

    rec = None
    worst = (0.0, None)
    for h in ANALYSIS_HORIZONS:
        bt, path = backtests[h]
        n_ref, regime_ref, med_ref = ANALYSIS_BACKTEST[h]
        wins = len(bt["S1"]) if bt else 0
        assert wins == n_ref, (h, wins, n_ref)
        if not wins:
            log(f"analysis (2): backtest {h}y: no window (as the JAX "
                "package)")
            continue
        p = path["path"]
        regime_days = int(p.regime.sum())
        for sid, ref in med_ref.items():
            d = abs(float(np.median(bt[sid])) - ref)
            if d > worst[0]:
                worst = (d, f"{h}y {sid}")
            assert d <= BACKTEST_CAGR_ATOL, (h, sid, d)
        chans = k4.channels_from(p, compute_signals(p))
        S, W = chans[0].shape
        ms, got = spread(lambda: k4.strategies_run(chans), 3)
        assert np.array_equal(got[0].cpu().numpy().astype(np.float64),
                              path["final_wealth"]), h
        cs = [c[:K4_ANALYSIS_PLAIN_DAYS] for c in chans]
        got = k4.strategies_run(cs)
        plain_ms, ref = timed(lambda: k4.strategies_plain(cs), 1, warm=False)
        names = ("final_wealth", "num_trades", "max_dd")
        st = k3.check_parity(dict(zip(names, got)), dict(zip(names, ref)),
                             exact=())
        log(f"analysis (1-2): backtest {h}y: {W} windows x {S} days equal "
            f"the JAX package's count; regime-1 window days {regime_days} "
            f"(JAX {regime_ref}, difference {regime_days - regime_ref}); K4 "
            f"vs plain at W={W} over the first {cs[0].shape[0]} days: {st}; "
            f"kernel {fmt_spread(ms)} over 3 runs at S={S}, plain "
            f"{plain_ms:.3f} ms at S={cs[0].shape[0]}")
        rec = dict(windows=W, days=S, max_abs_err=st["max_abs_err"],
                   ms_spread=ms, plain_ms=plain_ms,
                   plain_days=cs[0].shape[0])
    log(f"analysis (2): backtest median window CAGR largest difference to "
        f"the JAX package's {worst[0]:.3e} ({worst[1]}; bound "
        f"{BACKTEST_CAGR_ATOL})")
    return rec


def analysis_ragged(model):
    """K1 and K3 against their plain versions on the card at the run's 200
    trials (6 x 32 + 8: a partial last block) on the run's calibrated
    model, over a 252-day window and a 126-day buffer (the plain versions
    are host-bound day loops). Returns {"joint": rec, "compose_strategies":
    rec}."""
    from letf_tpu_torch.models.params import as_sim_model, from_numpy
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import joint

    model_t = from_numpy(as_sim_model(model), "cuda", torch.float32)
    sim, buf = QUICK["sim"], QUICK["buf"]
    B = ANALYSIS_N
    regime, ids, signs, sw, offs = chain_inputs(model_t, B, sim, buf)
    ja = joint_args(model_t, regime, ids, signs, sw)
    k1_ms, xk = spread(lambda: joint.joint_generate(*ja), 3)
    plain_ms, xp = timed(lambda: joint.joint_plain(*ja), 1, warm=False)
    errs = [float((a - b).abs().max()) for a, b in zip(xk, xp)]
    for c in (0, 1, 2, 4):
        torch.testing.assert_close(xk[c], xp[c], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(xk[3], xp[3], rtol=0, atol=1e-3)
    out = {"joint": dict(B=B, T=sim + buf, max_abs_err=max(errs),
                         ms_spread=k1_ms, plain_ms=plain_ms)}
    chans = windowed(model_t, list(xk) + [regime], offs, sim)
    ka = k3_args(model_t, ids, sw, chans)
    k3_ms, got = spread(lambda: k3.compose_strategies(*ka), 3)
    plain3_ms, ref = timed(lambda: k3.compose_strategies_plain(*ka), 1,
                           warm=False)
    st = k3.check_parity(dict(zip(k3.OUTPUTS, got)),
                         dict(zip(k3.OUTPUTS, ref)),
                         exact=("path_finite", "vix_min", "vix_max",
                                "regime_high_days"))
    out["compose_strategies"] = dict(B=B, S=sim, max_abs_err=st["max_abs_err"],
                                     ms_spread=k3_ms, plain_ms=plain3_ms)
    log(f"analysis (1): at B={B} (a partial last 32-trial block) on the "
        f"calibrated model: K1 vs plain T={sim + buf} max abs err x0..x2 "
        f"{max(errs[:3]):.3e}, vix {errs[3]:.3e}, irx {errs[4]:.3e}, kernel "
        f"{fmt_spread(k1_ms)}, plain {plain_ms:.3f} ms; K3 vs plain S={sim}: "
        f"{st}, kernel {fmt_spread(k3_ms)}, plain {plain3_ms:.3f} ms")
    return out


def analysis_jax_reference():
    """(2) The results list's first 200 trials x 10 y on the committed fits
    against the JAX package's (ANALYSIS_*): start offsets and regime-1
    days exact, S1-S3 median final wealth within rtol 1e-5."""
    from letf_tpu_torch.parallel import mc_runner

    model, _ = committed_fits()
    with contextlib.redirect_stdout(io.StringIO()):
        mc = mc_runner.parallel_monte_carlo_fixed(
            ["S1", "S2", "S3"], 10, model, num_simulations=ANALYSIS_N,
            seed=0, device="cuda")
    meta = [r["Metadata"] for r in mc["S1"]]
    offs = tuple(m["start_offset"] for m in meta)
    high = tuple(m["regime_counts"][1] for m in meta)
    assert offs == ANALYSIS_START_OFFSETS, "start offsets differ"
    assert high == ANALYSIS_REGIME_HIGH_DAYS, "regime days differ"
    p50 = [float(np.median([r["Final_Wealth"] for r in mc[s]]))
           for s in ("S1", "S2", "S3")]
    rel = [abs(a - b) / abs(b) for a, b in zip(p50, ANALYSIS_S123_P50)]
    log(f"analysis (2): the results list's {ANALYSIS_N} trials x 10y on the "
        f"committed fits vs the JAX package: start offsets and regime-1 "
        f"days equal; S1-S3 median wealth {p50}, relative differences "
        f"{[f'{r:.3e}' for r in rel]} (bound 1e-5)")
    assert max(rel) < 1e-5, rel


def analysis_replay(counters, smi, n=4096, years=30):
    """(3) The Trade_Replay route at scale: parallel_monte_carlo_fixed on
    the committed fits at 4,096 trials x 30 y (above trade_list_limit, so
    every taxable result carries a Trade_Replay descriptor), then
    create_summary_statistics sampled (50 replayed trials a strategy,
    through the host tax chain) and with exact_tax_all_trials=True (one
    emission of the 4,096 trials, the bridge with K7 and K8 for each
    strategy), the launch counters set to 0 just before and read just
    after. At the sampled trials the exact taxes agree with the host
    chain's within REPLAY_TAX_BOUNDS, and for REPLAY_PROBE the float64
    bridge on the sampled replay's own emission agrees with the exact-all
    chunk's within its atol; every sampled trial got its trade list, and
    no trial that traded is priced at zero tax by the host chain for lack
    of trades."""
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch import reporting
    from letf_tpu_torch.parallel import mc_runner

    model, _ = committed_fits()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mc = mc_runner.parallel_monte_carlo_fixed(
            list(cfg.STRATEGIES), years, model, num_simulations=n, seed=0,
            device="cuda")
    t_mc = time.perf_counter() - t0
    for sid in cfg.TAXABLE_IDS:
        assert all("Trade_Replay" in r and "Trade_List" not in r
                   for r in mc[sid]), sid
    host, taxes = {}, {}

    def keep_host(inner):
        def call(**kw):
            out = inner(**kw)
            host[id(kw["trades"])] = out["total_tax"]
            return out
        return call

    def keep_taxes(inner):
        def call(results, time_horizon, tax_config, sid, exact_all=False,
                 **kw):
            out = inner(results, time_horizon, tax_config, sid, exact_all,
                        **kw)
            taxes[sid, exact_all] = out
            return out
        return call

    # The sampled replay's own emission of REPLAY_PROBE (the one its trade
    # lists come from), kept for the float64 bridge.
    own, current = {}, [None]

    def keep_sid(inner):
        def call(results, sample, sid, time_horizon):
            current[0] = sid
            out = inner(results, sample, sid, time_horizon)
            current[0] = None
            return out
        return call

    def keep_emission(inner):
        def call(*args, **kw):
            out = inner(*args, **kw)
            if current[0] in REPLAY_PROBE:
                own[current[0]] = out[1]
            return out
        return call

    text = io.StringIO()
    st_s, st_x = {}, {}
    with wrapped(reporting, "process_trades_with_wired_engine", keep_host), \
            wrapped(reporting, "_tax_all_trials", keep_taxes):
        reset(counters)
        GENERAL_TRIALS.clear()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text), \
                wrapped(reporting, "_fill_missing_trades", keep_sid), \
                wrapped(mc_runner, "general_chunk", keep_emission):
            reporting.create_summary_statistics(mc, years,
                                                stage_seconds=st_s)
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            summ_x = reporting.create_summary_statistics(
                mc, years, exact_tax_all_trials=True, stage_seconds=st_x)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = read(counters)
    out_file("analysis_replay.txt").write_text(text.getvalue())
    summary_finite(summ_x)
    zero, traded, stats, bad, rel, probe = 0, 0, {}, {}, [], {}
    income_kw = reporting.tax_setup(None, years)
    for sid in cfg.TAXABLE_IDS:
        rows = mc[sid]
        w = reporting._wealth(rows)
        sample = np.argsort(w)[np.linspace(0, n - 1, reporting.MAX_TAX_SIMS,
                                           dtype=int)]
        h_tax, gross = [], []
        for i in sample:
            trades = rows[i]["Trade_List"]
            assert isinstance(trades, list), (sid, i)
            h_tax.append(host[id(trades)] if trades else 0.0)
            gross.append(sum(t["dollar_amount"] for t in trades))
            traded += bool(trades)
        h_tax, gross = (np.asarray(v, np.float64) for v in (h_tax, gross))
        x_tax = taxes[sid, True][sample]
        diff = np.abs(x_tax - h_tax)
        scale = np.maximum(np.abs(h_tax), gross)
        rel.append(np.maximum(diff - REPLAY_TAX_BOUNDS["atol"], 0.0)
                   / np.maximum(scale, 1.0))
        bad[sid] = int((rel[-1] > REPLAY_TAX_BOUNDS["max_rtol"]).sum())
        stats[sid] = dict(
            max_abs=float(diff.max()),
            max_rel_tax=float((diff / np.maximum(np.abs(h_tax), 1.0)).max()),
            max_rel_scale=float(rel[-1].max()),
            median_rel_scale=float(np.median(rel[-1])),
            worst_row=int(sample[int(rel[-1].argmax())]),
            median_tax=float(np.median(h_tax)),
            median_gross=float(np.median(gross)))
        zero += int(((x_tax == 0) & (h_tax != 0)).sum())
        if sid in own:
            em = [e[:, :, cfg.TAXABLE_IDS.index(sid)].contiguous()
                  for e in own.pop(sid)]
            o_tax = reporting.bridge_tax(
                reporting.bridge_columns(em), (0, 1) if sid == "S8" else (0,),
                years, *income_kw).cpu().numpy()
            o_diff = np.abs(o_tax - h_tax)
            probe[sid] = dict(
                max_abs=float(o_diff.max()),
                max_rel_scale=float((np.maximum(o_diff - REPLAY_TAX_BOUNDS[
                    "atol"], 0.0) / np.maximum(scale, 1.0)).max()),
                max_rel_tax=float((o_diff / np.maximum(np.abs(h_tax), 1.0))
                                  .max()),
                exact_all_vs_own_max_abs=float(np.abs(x_tax - o_tax).max()))
    log(f"analysis (3): the float64 bridge on the sampled trials' own "
        f"replay emission (the one their trade lists come from), against "
        f"the host chain and the exact-all chunk's taxes (bound "
        f"${REPLAY_TAX_BOUNDS['atol']}): {json.dumps(probe)}")
    log(f"analysis (3): parallel_monte_carlo_fixed {n} x {years}y in "
        f"{t_mc:.3f} s; create_summary_statistics sampled {t1 - t0:.3f} s "
        f"({json.dumps(st_s)}), exact_all {t2 - t1:.3f} s "
        f"({json.dumps(st_x)}) ({smi}); launches {launches}, general path "
        f"(K5) at {GENERAL_TRIALS} trials; at the {13 * reporting.MAX_TAX_SIMS}"
        f" sampled trials ({traded} with trades) exact-all (card, float64 "
        f"bridge) vs the host chain (float64), relative to max(tax, gross "
        f"traded): median {float(np.median(np.concatenate(rel))):.3e}, "
        f"{json.dumps(stats)}; past {REPLAY_TAX_BOUNDS['max_rtol']}: {bad};"
        f" priced zero by one and not the other {zero}")
    assert zero == 0, zero
    assert all(v["exact_all_vs_own_max_abs"] <= REPLAY_TAX_BOUNDS["atol"]
               for v in probe.values()) and len(probe) == len(REPLAY_PROBE)
    assert np.median(np.concatenate(rel)) <= REPLAY_TAX_BOUNDS["median_rtol"]
    assert not any(bad.values()), bad
    assert launches["sort_bridge"] >= 13, launches
    assert launches["wash"] >= 13, launches
    assert launches["compose"] == 14, launches
    return launches


def analysis_cli(smi):
    """(4) python -m letf_tpu_torch.cli --synthetic-data --sims 64
    --horizons 10, and --quick, as two subprocesses started together, each
    in a temporary directory of its own (its cache there): both exit 0 and
    print their tables. Their output goes to build/analysis/cli_*.txt."""
    runs = {"default": (["--synthetic-data", "--sims", "64", "--horizons",
                         "10"], ("TIMING SUMMARY", "TAXABLE BROKERAGE",
                                 "ROTH IRA COMPATIBLE - 10-YEAR",
                                 "ANALYSIS COMPLETE")),
            "quick": (["--quick"], ("ROTH IRA COMPATIBLE - 10-YEAR",
                                    "QUICK TEST COMPLETE"))}
    env = dict(os.environ, PYTHONPATH=str(REPO))
    dirs, procs = {}, {}
    t0 = time.perf_counter()
    for name, (argv, _) in runs.items():
        dirs[name] = Path(tempfile.mkdtemp(prefix=f"letf_cli_{name}_"))
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "letf_tpu_torch.cli", *argv],
            cwd=dirs[name], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    secs = {}
    for name, (argv, want) in runs.items():
        out, err = procs[name].communicate(timeout=600)
        secs[name] = time.perf_counter() - t0
        shutil.rmtree(dirs[name], ignore_errors=True)
        out_file(f"cli_{name}.txt").write_text(out + "\n" + err)
        assert procs[name].returncode == 0, (name, err[-3000:])
        for w in want:
            assert w in out, (name, w)
    log(f"analysis (4): cli {runs['default'][0]} and {runs['quick'][0]} "
        f"exit 0 with their tables, in {json.dumps(secs)} s from the start "
        f"of both ({smi})")


def phase_analysis(counters, smi):
    """The reference's complete analysis on the card, in a temporary cache
    of the port's: (1) runner.run at 200 trials x 10 y and its gates,
    (2) against the JAX package's numbers (ANALYSIS_*), (3) the
    Trade_Replay route at 4,096 x 30 y, (4) the CLI's default and --quick
    branches. Returns (the run's launches, the replay's launches, the
    kernel records at the run's shapes)."""
    t0 = time.perf_counter()
    with port_cache():
        launches, results, backtests = analysis_run(counters, smi)
        analysis_results_lists(results)
        analysis_validation()
        k4_rec = analysis_backtests(backtests)
        ragged = analysis_ragged(results[ANALYSIS_HORIZONS[0]][0])
        del results, backtests
        analysis_jax_reference()
        replay = analysis_replay(counters, smi)
        torch.cuda.empty_cache()
        analysis_cli(smi)
    log(f"analysis phase: {time.perf_counter() - t0:.1f} s")
    return launches, replay, dict(ragged, strategies=k4_rec)


# The engine-modes phase's references, printed by
#   JAX_PLATFORMS=cpu python3 -m tools.engine_modes_reference
# (the JAX package on the CPU in float32, default_sim_model(), seed 2, the
# block bootstrap pools of the committed history; see the tool).
ENGINE_POOL_DIGESTS = {'a_data': 'f56e62435cbe2840', 'a_ret': 'd2cbb3d0c4453042', 'a_count': 'df0b58fa5549e2f1', 'b_data': '5dedcd8921b35c45', 'b_ret': '959adacc62e629c3', 'b_count': 'd1a92d366d06d103'}
ENGINE_LEGACY_INT_SUMS = {'start_offset': 663260, 'regime_high_days': 1937774}
ENGINE_LEGACY_S123_P50 = (151045.578125, 33028.9140625, 8464.103515625)
ENGINE_PLAN_A = (1380610858, 1441621329, 313893960, 1757744849, 680719950, 43679734, 188309469, 1306327973, 1759325119, 814870069, 123586270, 1708824473, 1801529931, 1176682523, 203391740, 1787206128, 751003286, 556915537, 1570696823, 553690404, 1665420921, 301247165, 699566847, 1863938017, 993883129, 1352722655, 1952819557, 1229531509, 870979067, 1981457620, 187380078, 1664420289, 569534518, 593514303, 175852252, 1178908609, 49267582, 1803849905, 855852644, 13387508, 1244883968, 194964568, 996803483, 459073595, 722525970, 1641135953, 2118027457, 358370778, 1565628318, 299191971, 1699919934, 1114687403, 59734621, 459312082, 871827994, 880110412, 315823975, 172723857, 394579089, 1661841203, 1383199722, 1163398, 1458797881, 888525276, 759183950, 839216129, 1352078756, 2138634231, 1302159596, 2033958475, 1447302162, 1744941541, 727192888, 1712115272, 1773446033, 280874636, 1927531646, 923130024, 2136099300, 2127939764, 122996222, 4162105, 914514539, 1791347083, 264771967, 1417808637, 12291550, 645326150, 1239644657, 1779684637, 1050288407, 2029296659, 1025561986, 2085022169, 913641299, 836733551, 171651643, 53254643, 1729125196, 934271006, 1503572580, 966356381, 685014144, 1789061571, 1330082946, 1151873086, 109558767, 1463963227, 946021112, 144160151, 1585960426, 1578737599, 1791580957, 43068683, 1285498314, 181093845, 789893181, 1428230895, 671221239, 1956751656, 1591377366, 1627452249, 1389593324, 1207749262, 1741236286, 2117716848, 2126276941, 877061954)
ENGINE_PLAN_B = (907194840, 1104897236, 280566443, 1585863220, 939412533, 590347566, 888251579, 1999107073, 229444915, 528295699, 1881424764, 745178878, 650371423, 97794391, 2076052082, 1680062117, 963653, 1559866236, 1668857970, 129658975, 11074397, 2146777105, 783426807, 409442492, 1662226344, 45040969, 1580166751, 235232624, 2016401828, 26101166, 40689353, 540657705, 33124377, 1893514025, 1440477435, 1766978267, 1552361465, 571332337, 1966613777, 1669463703, 299111112, 480997834, 545233635, 668615332, 423389803, 1189900531, 308479482, 1408640174, 329696405, 1879625232, 1523049690, 312333693, 2090464002, 1528809241, 1517328837, 884994428, 1227607844, 869536832, 1676582603, 1971255274, 1286091725, 681344156, 244188438, 1088968153, 701366513, 185688742, 1284429003, 679895491, 171457114, 419150768, 783582951, 211896660, 1598977017, 1211350466, 630196485, 690222688, 1780845500, 1768058736, 139979799, 1636237853, 1657410588, 913626894, 1003355292, 1423508188, 978125479, 332750321, 189103327, 1556531563, 89093547, 543218070, 22561457, 766091153, 440058870, 1628746782, 639479884, 1120722130, 45032657, 1458849431, 67819449, 1787206478, 36169626, 1091262344, 1774313337, 305270509, 304690207, 1795032124, 1821142571, 119275393, 1377990910, 1421897596, 1413691470, 1350393687, 1409027933, 949368128, 1268292544, 1690683132, 1963071083, 1805742230, 1798937999, 1154929175, 1325402625, 1964902962, 2030236323, 118123742, 1416039675, 976844940, 500145070, 2099168194)
ENGINE_PER_TRIAL_LOG_GROWTH = [[0.5382500289052992, 0.4312567272361873, 0.33613679713540234, -0.016573559078991745, 0.20322225328083843, 0.2775354343035522], [-1.297496554788271, -0.6897197904731504, -0.39092395616435627, -0.18845216027795803, -0.15555766050478068, -0.2611204726967289], [-0.13850941115176427, -0.32293516285596763, -0.18866398121677477, -0.4524042857092526, -0.0699081691112394, 0.021360135793021765], [-0.08944798869324502, 0.30605647168385514, 0.23174210241489973, 0.3020476219558782, 0.14076557484293092, 0.042779302856163964], [-1.566069239273429, -0.9800530274585649, -0.5686922799136096, -0.1866633659834998, -0.23356175733412976, -0.33219757708078057], [0.3037361833998268, 0.4934078184490525, 0.4059085010351448, 0.05521183592714028, 0.2514584689657837, 0.28859330838841973], [-1.5344118897028844, -0.519911410276762, -0.3103676251637124, 0.6850750503142875, -0.12564961066985958, -0.36597763582478526], [0.6585859537076669, 0.4265179039087246, 0.319954790814972, -0.881120178066538, 0.18924040959779667, 0.35974840911873823]]
ENGINE_PER_TRIAL_VIX_SUM = [3430.602620124817, 3421.437114715576, 2452.000428199768, 2916.2790536880493, 4736.219401359558, 4259.579332351685, 3100.9764471054077, 3019.3781185150146]
ENGINE_OFF_LOG_GROWTH = [[0.3227198346943263, 0.2897458773751507, 0.236835648106617, -0.35662973170597273, 0.15062715700820883, 0.16823649814824254], [-0.4768006725887699, -0.4461540474037618, -0.25109010862755643, 0.07687465759397902, -0.09248356750001803, -0.09741800018704416], [-0.0410135365920956, -0.32851030805255205, -0.19314695020741635, -0.47775324096927146, -0.0720546128582202, 0.042649236395287594], [-0.07093195269326803, 0.32325630511012293, 0.24142171162502873, 0.3167970269818653, 0.14525593508371212, 0.03441142682296348], [0.018022255769512073, 0.029564125377061067, 0.04557285806040454, -0.08662729863063115, 0.04688525458763471, 0.05736975437495988], [-0.0886822797048365, -0.03669871201679545, 0.002092505001166787, 0.00635641634319805, 0.025404561873123333, 0.022997549357743542], [-1.0137832554572372, -0.5438946046606327, -0.3335169763150874, 0.44340799998923647, -0.14196637281096103, -0.26995522632030555], [0.8084902066328238, 0.5182231753508085, 0.3742911451428704, -0.565164410162671, 0.2118957239753935, 0.3364116044974604]]
ENGINE_OFF_VIX_SUM = [3501.2681226730347, 4073.7359476089478, 2388.1316480636597, 2441.6101541519165, 2592.093758583069, 2988.8145780563354, 3032.4081830978394, 2989.0889682769775]
ENGINE_DIAGNOSE = {'pipeline': {'spy_ann_mean': 0.08460447192192078, 'spy_ann_vol': 0.22576346283189114, 'high_vol_frac': 0.21924603174603174, 'vix_mean': 25.101322174072266, 'TQQQ_median_cagr': 0.17903542518615723, 'UPRO_median_cagr': -0.21258914470672607, 'SSO_median_cagr': -0.08043992519378662, 'TMF_median_cagr': -0.13659441471099854, 'SPY_median_cagr': 0.014857649803161621, 'QQQ_median_cagr': 0.18759536743164062, 'valid_frac': 1.0}, 'letf_drag': {'qqq_cagr': 0.1308882236480713, 'perfect_3x_cagr': 0.046331167221069336, 'with_costs_cagr': -0.040912508964538574, 'full_etf_cagr': -0.04269063472747803, 'vol_drag': -0.34633350372314453, 'cost_drag': -0.08724367618560791, 'te_drag': -0.0017781257629394531}, 'tqqq_detailed': {'daily_underlying_bps': 2.3673031330108643, 'daily_leveraged_bps': 7.101909160614014, 'daily_expense_bps': 0.3412698412698413, 'daily_borrow_bps': 3.1358449459075928, 'daily_te_bps': 0.010260564275085926, 'te_std_bps': 3.152386426925659, 'vix_mean': 24.918964385986328, 'annualized_cost_drag': 0.08762329071760178}}

ENGINE_N = 4_096                   # the legacy run: one chunk x 30 y
ENGINE_PLAN_TRIALS = 128           # trial ids whose block rows are checked
ENGINE_PATH_TRIALS, ENGINE_PATH_DAYS = 8, 150
ENGINE_OFF_YEARS = 10              # the joint_kernel="off" route's horizon
# The diagnostics at tests/test_aux.py:58's sizes.
ENGINE_DIAG_KW = {"pipeline": dict(years=1, n_trials=8),
                  "letf_drag": dict(years=2), "tqqq_detailed": dict(years=1)}
# Each bound lies near the geometric middle between the sound reading (the
# port on an H100 80GB HBM3 at 700 W against the JAX package, float32 on
# both sides) and the nearest control reading of
# `python3 -m tools.engine_modes_reference --controls` (the JAX package on
# the CPU, float32):
# S1-S3 medians of the first 1,024 legacy trials (relative): sound
# 1.397e-6; one trial next to the median changing rank moves them 1.362e-2
# (seed 3: 9.06e-2).
ENGINE_P50_RTOL = 1e-4
# The per-trial paths' first 150 days: each asset's log-growth (absolute;
# sound 1.73e-6, without moment matching 1.98e-2) and the VIX sum
# (relative; sound 2.84e-7, the window a day later 2.74e-3).
ENGINE_PATH_BOUNDS = (2e-4, 3e-5)
# The diagnostics' numbers: relative, and absolute near zero.
ENGINE_DIAG_BOUNDS = (1e-3, 1e-5)


def plan_checksum(codes: np.ndarray) -> int:
    """tools/engine_modes_reference.plan_checksum: sum(code * (t % 1009 +
    1)) mod 2**31 - 1 over a trial's [T] day codes, in int64."""
    c = np.asarray(codes).astype(np.int64)
    w = np.arange(c.shape[-1]) % 1009 + 1
    return [int(v) for v in (c * w).sum(-1) % (2 ** 31 - 1)]


def coded_pools(pools):
    """The pools with A's IRX and B's TLT columns (which steer no choice)
    replaced by regime * 1e6 + block * 1000 + row: the stitched IRX and
    TLT series name each day's block row."""
    a, b = pools.a_data.copy(), pools.b_data.copy()
    for data, c in ((a, 3), (b, 2)):
        R, N, L = data.shape[:3]
        data[..., c] = (np.arange(R)[:, None, None] * 1e6
                        + np.arange(N)[None, :, None] * 1000
                        + np.arange(L)[None, None, :])
    return pools._replace(a_data=a, b_data=b)


def engine_plans(model_t, pools, n, sim, buf):
    """Each day's chosen block row of trial ids 0..n-1 on the card (the
    regime paths and mode keys of draw_innovations, the sampler without
    its noise on coded pools) against ENGINE_PLAN_A/B: the count of trials
    whose rows differ (a float32 near-tie of the Gumbel argmax or a
    segment length) in each pool."""
    from letf_tpu_torch.models import bootstrap
    from letf_tpu_torch.ops import path_engine as pe
    from letf_tpu_torch.ops import rng

    ids = torch.arange(n, device="cuda")
    innov = pe.draw_innovations(model_t, rng.key(2, "cuda"), ids,
                                torch.zeros(n, dtype=torch.bool,
                                            device="cuda"), sim, buf,
                                engine_mode="legacy_hybrid")
    k_boot = rng.split(innov.mode_key, 2)[:, 0]
    s = bootstrap.sample_bootstrap_returns(
        bootstrap.pools_on(coded_pools(pools), "cuda", torch.float32),
        innov.regime_full, k_boot, sim + buf, add_noise=False)
    a = plan_checksum(s["IRX"].t().cpu().numpy())
    b = plan_checksum(s["TLT_Ret"].t().cpu().numpy())
    flips = (sum(x != y for x, y in zip(a, ENGINE_PLAN_A)),
             sum(x != y for x, y in zip(b, ENGINE_PLAN_B)))
    return flips


def phase_engine_modes(counters, smi):
    """The reference's other engine modes on the card, in a temporary
    cache of the port's: (1) run_monte_carlo(default_sim_model(), 30,
    4,096 trials, seed 2, engine_mode="legacy_hybrid", bootstrap_pools=
    the pools of the port's offline history) (K4 at its channel shape)
    and the reference-shaped sampled_post_tax_tables on its wealth with the
    pools (K7, K8), the counters set to 0 just before and read just after;
    the pools' digests, and its first 1,024 trials, against the JAX
    package's (offset and regime-day sums exact, S1-S3 medians within
    ENGINE_P50_RTOL), each day's block row of 128 trials (ENGINE_PLAN_*:
    flips counted); the run's Gumbel draws timed inside it (CUDA events);
    (2) parallel_monte_carlo_fixed at 200 x 2 y under
    SIM_ENGINE_MODE="legacy_hybrid"; (3) the reference-shaped per-trial
    institutional call generate_paths_batch(model, key, ids, anti, 7,560)
    at 1,024 trials (its draws and joint day loop timed inside it) and
    generate_paths_batched's joint_kernel="off" route (1,024 x 10 y),
    their first 8 trials' first 150 days against the JAX package's
    (ENGINE_PATH_BOUNDS), and its fast_draws=False route bitwise the
    per-trial call (1,024 x 1 y); (4) the three diagnostics at
    tests/test_aux.py:58's sizes against the JAX package's
    (ENGINE_DIAG_BOUNDS). Returns the launches of (1)."""
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch import diagnose, reporting
    from letf_tpu_torch.data import fetch_historical_data
    from letf_tpu_torch.models import bootstrap
    from letf_tpu_torch.models.params import default_sim_model, from_numpy
    from letf_tpu_torch.ops import path_batched as pb
    from letf_tpu_torch.ops import path_engine as pe
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.parallel import mc_runner

    t_phase = time.perf_counter()
    model = default_sim_model()
    model_t = from_numpy(model, "cuda", torch.float32)
    years, sim, buf = 30, 30 * 252, FULL["buf"]
    with port_cache():
        t0 = time.perf_counter()
        df = fetch_historical_data(force_synthetic=True)
        pools = bootstrap.create_bootstrap_sampler(df)
        digests = {f: digest(a) for f, a in zip(pools._fields, pools)}
        log(f"engine modes: pools {[tuple(a.shape) for a in pools]}, "
            f"counts {pools.a_count.tolist()} / {pools.b_count.tolist()}, "
            f"{time.perf_counter() - t0:.3f} s; digests equal the JAX "
            f"package's: {digests == ENGINE_POOL_DIGESTS}")
        assert digests == ENGINE_POOL_DIGESTS, digests

        # (1) The legacy run and its sampled post-tax tables.
        reset(counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev_ms = {}
        t0 = time.perf_counter()
        with device_clock(dev_ms, "gumbel", rng, "gumbel"):
            arrays = mc_runner.run_monte_carlo(
                model, years, num_simulations=ENGINE_N, seed=2,
                chunk_size=ENGINE_N, engine_mode="legacy_hybrid",
                bootstrap_pools=pools, progress=False, device="cuda")
        wall = time.perf_counter() - t0
        # One [B, N] draw a pool for each of the (sim + buf) // 21 + 2
        # segments.
        words = (((sim + buf) // cfg.BOOTSTRAP_BLOCK_MIN + 2) * ENGINE_N
                 * (pools.a_ret.shape[1] + pools.b_ret.shape[1]))
        run_launches = read(counters)
        peak = torch.cuda.max_memory_allocated() / 2**30
        stages = {}
        t0 = time.perf_counter()
        post = reporting.sampled_post_tax_tables(
            model, torch.as_tensor(arrays.final_wealth, device="cuda"),
            years, ENGINE_N, 2, None, "legacy_hybrid", "offset", buf, True,
            (10, 50, 90), bootstrap_pools=pools, device="cuda",
            stage_seconds=stages)
        torch.cuda.synchronize()
        post_wall = time.perf_counter() - t0
        launches = read(counters)
        log(f"engine modes (1): legacy_hybrid run_monte_carlo {ENGINE_N} x "
            f"{years}y: wall {wall:.3f} s, "
            f"{ENGINE_N * years * 252 / wall:.6e} trial-days/s, peak device "
            f"memory {peak:.2f} GiB, launches {run_launches}; its Gumbel "
            f"draws {dev_ms['gumbel'] / 1e3:.3f} s on the card (CUDA events; "
            f"{words:.6e} words, {words / dev_ms['gumbel'] * 1e3:.6e} "
            f"words/s); sampled "
            f"post-tax tables (pools carried): {post_wall:.3f} s, stages "
            f"{json.dumps(stages)}; launches of the path {launches}")
        fw = arrays.final_wealth.astype(np.float64)
        assert np.isfinite(fw).all() and arrays.valid.mean() > 0
        assert run_launches["strategies"] == 1, run_launches
        assert launches["sort_bridge"] >= 1 and launches["wash"] >= 1
        for k in ("joint", "window", "window_tiles", "compose_strategies",
                  "compose", "gbm"):
            assert launches[k] == 0, launches
        assert len(post) == 13
        for sid, e in post.items():
            assert all(np.isfinite(v) for v in e["wealth"].values()), sid
            assert np.isfinite(e["median_tax"]) and e["median_tax"] >= 0
        head = slice(0, 1024)
        ints = {"start_offset": int(arrays.start_offset[head].sum()),
                "regime_high_days": int(arrays.regime_high_days[head].sum())}
        p50 = np.median(fw[head, :3], 0)
        prel = np.abs(p50 / np.asarray(ENGINE_LEGACY_S123_P50) - 1)
        flips = engine_plans(model_t, pools, ENGINE_PLAN_TRIALS, sim, buf)
        log(f"engine modes (1) vs the JAX package: first 1,024 trials' "
            f"integer sums {ints} (JAX {ENGINE_LEGACY_INT_SUMS}); S1-S3 "
            f"median rel diff {prel.tolist()} (bound {ENGINE_P50_RTOL}); "
            f"block-row flips (float32 ties) in {ENGINE_PLAN_TRIALS} "
            f"trials: pool A {flips[0]}, pool B {flips[1]}; post-tax S7 "
            f"p50 {post['S7']['wealth']['p50']:.2f}, median tax "
            f"{post['S7']['median_tax']:.2f}")
        assert ints == ENGINE_LEGACY_INT_SUMS, ints
        assert prel.max() < ENGINE_P50_RTOL, prel
        assert max(flips) <= 2, flips
        del arrays, post
        torch.cuda.empty_cache()

        # (2) The results list under SIM_ENGINE_MODE="legacy_hybrid".
        saved = cfg.SIM_ENGINE_MODE
        cfg.SIM_ENGINE_MODE = "legacy_hybrid"
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                res = mc_runner.parallel_monte_carlo_fixed(
                    list(cfg.STRATEGY_INDEX), 2, model, historical_df=df,
                    num_simulations=200, seed=0, device="cuda")
            secs = time.perf_counter() - t0
        finally:
            cfg.SIM_ENGINE_MODE = saved
        fw2 = np.array([[r["Final_Wealth"] for r in res[s]]
                         for s in cfg.STRATEGY_INDEX])
        assert np.isfinite(fw2).all() and fw2.shape == (19, 200)
        assert all("Trade_List" in r for r in res["S7"])
        assert res["S1"][0]["Metadata"]["model_version"] == "legacy_hybrid"
        log(f"engine modes (2): parallel_monte_carlo_fixed 200 x 2y "
            f"(legacy_hybrid, trade lists attached): {secs:.3f} s; S1-S3 "
            f"medians {np.median(fw2[:3], 1).tolist()}")

    # (3) The per-trial institutional engine and the XLA-only routes.
    rows = torch.arange(1024, device="cuda")
    ids, anti = rows // 2, rows % 2 == 1
    key = rng.key(2, "cuda")
    timings = {}

    def timed_path(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = fn()
        torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        assert bool(torch.isfinite(p.etf_ret).all()), name
        return p

    def stats(p):
        n, d = ENGINE_PATH_TRIALS, ENGINE_PATH_DAYS
        etf = p.etf_ret[:, :d, :n].double()
        return (torch.log1p(etf).sum(1).t().cpu().numpy(),
                p.vix[:d, :n].double().sum(0).cpu().numpy())

    dev_ms = {}

    def keep_draws(inner):
        def call(*args, **kw):
            innov = inner(*args, **kw)
            PER_TRIAL_SAMPLE["innov"] = innov
            return innov
        return call

    with device_clock(dev_ms, "per_trial_draws", pe, "draw_innovations"), \
            device_clock(dev_ms, "per_trial_joint_day_loop", pe,
                         "simulate_joint_and_vix"), \
            wrapped(pe, "draw_innovations", keep_draws):
        per_trial = timed_path("per_trial_generate_paths_batch", lambda:
                               pe.generate_paths_batch(model_t, key, ids,
                                                       anti, sim))
    # The oracles phase runs the float64 path oracle on its first trials.
    PER_TRIAL_SAMPLE["path"] = per_trial
    timings.update({k: v / 1e3 for k, v in dev_ms.items()})
    off = timed_path("joint_kernel_off_10y", lambda:
                     pb.generate_paths_batched(
                         model_t, key, ids, anti, ENGINE_OFF_YEARS * 252,
                         joint_kernel="off"))
    # fast_draws=False is the per-trial engine batched: held bit for bit to
    # the per-trial call over 1 year (its day loops set its time), the one
    # rerun of the per-trial call.
    same = timed_path("fast_draws_false_1y", lambda: pb.generate_paths_batched(
        model_t, key, ids, anti, 252, fast_draws=False))
    ref1 = timed_path("per_trial_1y", lambda: pe.generate_paths_batch(
        model_t, key, ids, anti, 252))
    bitwise = all(torch.equal(getattr(ref1, f), getattr(same, f))
                  for f in ("etf_ret", "vix", "spy_ret", "regime"))
    del same, ref1
    errs = {}
    for name, p, lg_ref, vix_ref in (
            ("per_trial", per_trial, ENGINE_PER_TRIAL_LOG_GROWTH,
             ENGINE_PER_TRIAL_VIX_SUM),
            ("off", off, ENGINE_OFF_LOG_GROWTH, ENGINE_OFF_VIX_SUM)):
        lg, vs = stats(p)
        errs[name] = (float(np.abs(lg - np.asarray(lg_ref)).max()),
                      float(np.abs(vs / np.asarray(vix_ref) - 1).max()))
    log(f"engine modes (3): 1,024-trial paths (30 y unless named), seconds "
        f"(the per-trial call's draws and joint day loop: CUDA events) "
        f"{json.dumps(timings)}; fast_draws=False bitwise the per-trial "
        f"call (1 y): {bitwise}; first {ENGINE_PATH_TRIALS} trials' first "
        f"{ENGINE_PATH_DAYS} days vs the JAX package (max |log-growth "
        f"diff|, max VIX-sum rel diff): {errs} (bounds "
        f"{ENGINE_PATH_BOUNDS})")
    assert bitwise
    assert not torch.equal(per_trial.spy_ret[:, 0], per_trial.spy_ret[:, 1])
    for name, (e_lg, e_vix) in errs.items():
        assert e_lg < ENGINE_PATH_BOUNDS[0], (name, errs)
        assert e_vix < ENGINE_PATH_BOUNDS[1], (name, errs)
    del per_trial, off

    # (4) The diagnostics.
    t0 = time.perf_counter()
    worst = {}
    rtol, atol = ENGINE_DIAG_BOUNDS
    for name, fn in (("pipeline", diagnose.diagnose_pipeline),
                     ("letf_drag", diagnose.diagnose_letf_drag),
                     ("tqqq_detailed", diagnose.diagnose_tqqq_detailed)):
        got = fn(**ENGINE_DIAG_KW[name], device="cuda")
        ref = ENGINE_DIAGNOSE[name]
        assert sorted(got) == sorted(ref), name
        for k, v in ref.items():
            err = abs(got[k] - v)
            worst[f"{name}.{k}"] = err
            assert np.isfinite(got[k]) and err <= atol + rtol * abs(v), (
                name, k, got[k], v)
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    log(f"engine modes (4): the three diagnostics on the card "
        f"{time.perf_counter() - t0:.3f} s; largest differences from the "
        f"JAX package's: {top}")
    log(f"engine modes phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


# The oracles phase: the history backtest's windows checked against the
# host strategy oracle (an evenly spaced subset, oldest and newest
# included) and the JAX test's CAGR tolerance there
# (tests/test_data_calibration.py:201-226); the path oracle's trials and
# days (its bounds: ENGINE_PATH_BOUNDS); the income paths' size and
# tolerance (tests/test_fitting_device.py:131-150).
ORACLE_HORIZON, ORACLE_WINDOWS, ORACLE_CAGR_ATOL = 10, 12, 5e-3
ORACLE_PATH_TRIALS = 4
INCOME_PATHS, INCOME_YEARS, INCOME_RTOL = 4000, 20, 0.05


def phase_oracles(model, model_t, counters, smi):
    """The reference's oracles against the card's engine and kernels, in a
    temporary cache of the port's:
    (1) backtest_strategies_on_history on the offline history at 10 years
        (K4 on the card, the counters set to 0 just before and read just
        after) against historical.run_strategy_on_history (the host
        strategy oracle, float64 numpy) on ORACLE_WINDOWS evenly spaced
        windows, every strategy: CAGRs within ORACLE_CAGR_ATOL;
    (2) the per-trial institutional engine on the card: phase
        engine_modes' reference-shaped generate_paths_batch (default
        model, 1,024 trials x 30 y, float32; PER_TRIAL_SAMPLE), the
        innovations of its first ORACLE_PATH_TRIALS trials read back and
        run through oracle.oracle_path on the host in float64; each
        trial's first ENGINE_PATH_DAYS days within ENGINE_PATH_BOUNDS
        (each asset's log-growth, absolute; the VIX sum, relative), its
        regimes equal;
    (3) the TQQQ flow (tqqq.main, 100 x 10 y of S1-S3 through
        run_monte_carlo: K1, K2, K3) with its table and the spread
        ordering's verdict, and simulate_income_paths at 4,000 x 20 y on
        the card against the NumPy career model's final-year p10, p50 and
        p90 within 5%."""
    from letf_tpu_torch import config as cfg
    from letf_tpu_torch import historical, oracle, tqqq
    from letf_tpu_torch.data import fetch_historical_data
    from letf_tpu_torch.income import (
        simulate_income_paths,
        simulate_income_trajectory,
    )
    from letf_tpu_torch.ops import rng

    secs = {}
    t0 = time.perf_counter()
    with port_cache(), contextlib.redirect_stdout(io.StringIO()):
        df = fetch_historical_data(force_synthetic=True)
        got = {}
        reset(counters)
        historical.backtest_strategies_on_history(
            df, ORACLE_HORIZON, device="cuda", out_path=got)
        torch.cuda.synchronize()
        launches = read(counters)
    secs["backtest"] = time.perf_counter() - t0
    fw = got["final_wealth"]
    data = df.take(~np.asarray(df["TQQQ_IsSynthetic"], bool))
    window = ORACLE_HORIZON * 252
    starts = np.arange(0, len(data) - window + 1, 21)
    assert fw.shape == (len(starts), cfg.N_STRATEGIES), fw.shape
    pick = np.unique(np.linspace(0, len(starts) - 1, ORACLE_WINDOWS)
                     .round().astype(int))

    def cagr(w):
        return (max(w, 1e-12) / cfg.INITIAL_CAPITAL) ** (1 / ORACLE_HORIZON) \
            - 1.0

    t0 = time.perf_counter()
    worst = {}
    for w in pick:
        part = data.take(slice(starts[w], starts[w] + window))
        for sid, k in cfg.STRATEGY_INDEX.items():
            ec, _ = historical.run_strategy_on_history(part, sid)
            d = abs(cagr(float(fw[w, k])) - cagr(float(ec[-1])))
            worst[sid] = max(worst.get(sid, 0.0), d)
    secs["host_oracle"] = time.perf_counter() - t0
    log(f"oracles (1): backtest_strategies_on_history {ORACLE_HORIZON} y on "
        f"{len(starts)} windows (card, K4; launches {launches}) against the "
        f"host strategy oracle on {len(pick)} windows x "
        f"{cfg.N_STRATEGIES} strategies: largest |CAGR difference| "
        f"{max(worst.values()):.3e} (bound {ORACLE_CAGR_ATOL}), by strategy "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}")
    assert launches["strategies"] == 1, launches
    assert max(worst.values()) <= ORACLE_CAGR_ATOL, worst

    t0 = time.perf_counter()
    n, d = ORACLE_PATH_TRIALS, ENGINE_PATH_DAYS
    innov, path = PER_TRIAL_SAMPLE.pop("innov"), PER_TRIAL_SAMPLE.pop("path")
    sim = path.vix.shape[0]
    e_lg = e_vix = 0.0
    for b in range(n):
        orc = oracle.oracle_path(model, host_trial(innov, b), sim)
        lg = torch.log1p(path.etf_ret[:, :d, b].double()).sum(1).cpu().numpy()
        e_lg = max(e_lg, float(np.abs(lg - np.log1p(orc["etf_ret"][:d])
                                      .sum(0)).max()))
        vs = float(path.vix[:d, b].double().sum())
        e_vix = max(e_vix, abs(vs / float(orc["vix"][:d].sum()) - 1.0))
        assert np.array_equal(path.regime[:, b].cpu().numpy(),
                              orc["regime"]), b
    del innov, path
    secs["path_oracle"] = time.perf_counter() - t0
    log(f"oracles (2): the per-trial engine on the card (the first {n} of "
        f"phase engine_modes' 1,024 trials x {sim} days, float32) against "
        f"oracle.oracle_path on its "
        f"innovations (host, float64), first {d} days: max |log-growth "
        f"diff| {e_lg:.3e}, max VIX-sum rel diff {e_vix:.3e} (bounds "
        f"{ENGINE_PATH_BOUNDS}); regimes equal")
    assert e_lg < ENGINE_PATH_BOUNDS[0] and e_vix < ENGINE_PATH_BOUNDS[1]

    t0 = time.perf_counter()
    text = io.StringIO()
    reset(counters)
    with contextlib.redirect_stdout(text):
        flow = tqqq.main(device="cuda")
    torch.cuda.synchronize()
    tq_launches = read(counters)
    secs["tqqq"] = time.perf_counter() - t0
    table = text.getvalue()
    log("oracles (3): the TQQQ flow on the card (100 x 10 y), launches "
        f"{tq_launches}:\n" + table[table.index("Historical context"):]
        .rstrip())
    for c in flow["cagrs"].values():
        assert c.shape == (100,) and np.isfinite(c).all()
    assert flow["ordered"], flow["spread"]
    assert tq_launches["joint"] >= 1 and tq_launches["compose_strategies"] >= 1
    t0 = time.perf_counter()
    paths = simulate_income_paths(rng.key(0, "cuda"), 150_000.0,
                                  INCOME_YEARS, INCOME_PATHS)
    torch.cuda.synchronize()
    secs["income_paths"] = time.perf_counter() - t0
    card = paths.double().cpu().numpy()
    ref = simulate_income_trajectory(150_000.0, INCOME_YEARS,
                                     num_simulations=INCOME_PATHS,
                                     career_stage="mid", seed=3)["all_paths"]
    q = {p: (float(np.percentile(card[:, -1], p)),
             float(np.percentile(ref[:, -1], p))) for p in (10, 50, 90)}
    rel = max(abs(a / b - 1.0) for a, b in q.values())
    log(f"oracles (3): simulate_income_paths {INCOME_PATHS} x {INCOME_YEARS}"
        f" y on the card ({paths.dtype}) against the NumPy career model's "
        f"final year, (card, numpy) p10/p50/p90 {json.dumps(q)}: largest "
        f"relative difference {rel:.4f} (bound {INCOME_RTOL}); seconds "
        f"{json.dumps({k: round(v, 3) for k, v in secs.items()})} ({smi})")
    assert card.shape == ref.shape and np.isfinite(card).all()
    assert card.min() >= 75_000 - 1e-6 and card.max() <= 750_000 + 1e-6
    assert rel <= INCOME_RTOL, q
    return secs


def host_trial(innov, b):
    """Trial b of the card's batch-last innovations on the host in float64,
    in the oracle's per-trial layout (days first, components last)."""
    from letf_tpu_torch.ops import path_engine as pe

    def tr(a, perm=None):
        a = a[..., b]
        a = a.permute(*perm) if perm else a
        return a.cpu().numpy() if a.dtype in (torch.int32, torch.int64,
                                              torch.bool) \
            else a.double().cpu().numpy()

    return pe.Innovations(
        start_offset=int(innov.start_offset[b]),
        start_regime=int(innov.start_regime[b]),
        initial_vix=float(innov.initial_vix[b]),
        regime_full=tr(innov.regime_full), eps=tr(innov.eps, (1, 0)),
        u_chi=tr(innov.u_chi), vix_noise=tr(innov.vix_noise),
        irx_noise=tr(innov.irx_noise),
        stress_norms=tr(innov.stress_norms, (1, 0)),
        u_jump=tr(innov.u_jump), t_abs=tr(innov.t_abs),
        jump_sign=tr(innov.jump_sign), te_draws=tr(innov.te_draws, (1, 0)),
        mode_key=None)


def phase_validation(counters):
    """The two invariants of the validation battery on the card: the
    zero-drift drag through K3 (10,000 paths, within 1.5%), the flat-market
    decay through K6 (65,536 paths, 2x and 3x, within 2%)."""
    from letf_tpu_torch import validation

    reset(counters)
    zd = validation.validate_zero_drift_vol_drag(device="cuda")
    fm = validation.validate_flat_market_decay(device="cuda")
    launches = read(counters)
    log(f"validation: zero-drift {json.dumps(zd)}; flat decay "
        f"{json.dumps(fm)}; launches {launches}")
    assert zd["test_passed"] and fm["all_passed"], (zd, fm)
    assert launches["compose_strategies"] == 1 and launches["gbm"] == 2


def device_profile(fn):
    """(wall ms, device busy ms, [(kernel, device ms)] largest first) of
    fn() under torch.profiler (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total
    top = sorted(((k, v / 1e3) for k, v in dev.items()),
                 key=lambda kv: -kv[1])
    return wall_ms, sum(dev.values()) / 1e3, top


def phase_profile(model):
    """Device time by kernel for one 16,384 x 30y pre-tax report chunk
    (torch.profiler), with the device's busy share of the wall; then the
    post-tax part of a one-chunk sampled report (its replay, bridge and
    tax) by stage, with the device's busy share as nvidia-smi samples it
    (torch.profiler spends minutes reducing the ~10^6 launches of its day
    loops)."""
    from letf_tpu_torch import reporting
    from letf_tpu_torch.parallel import mc_runner

    kw = dict(num_simulations=B_CHUNK, seed=3, chunk_size=B_CHUNK,
              device="cuda")
    mc_runner.monte_carlo_report(model, 30, tax_mode="none", **kw)
    wall_ms, busy_ms, top = device_profile(
        lambda: mc_runner.monte_carlo_report(model, 30, tax_mode="none",
                                             **kw))
    log(f"profile of one {B_CHUNK} x 30y report chunk: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%); by kernel: "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top[:8]))

    run = mc_runner._Run(model, 30, B_CHUNK, 3, chunk_size=B_CHUNK)
    rows = np.arange(B_CHUNK)
    fw = run.chunk(rows // 2, rows % 2 == 1)["final_wealth"]
    stages, samples = {}, []
    torch.cuda.synchronize()
    with busy_samples(samples):
        t0 = time.perf_counter()
        reporting.sampled_post_tax_tables(
            model, fw, 30, B_CHUNK, 3, None, "institutional_v1",
            run.random_start_method, run.buffer_days, run.use_antithetic,
            (10, 50, 90), device="cuda", stage_seconds=stages)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    log(f"the post-tax part of a {B_CHUNK} x 30y sampled report: wall "
        f"{wall:.3f} s, stages (s) {json.dumps(stages)}; device busy "
        f"(nvidia-smi utilization.gpu, {len(samples)} samples of 100 ms) "
        f"mean {float(np.mean(samples)) if samples else float('nan'):.1f}%")


# The TPU record's 50-year run (bench.py:522-560, BENCH_FULL_r05.json
# long_horizon_50y): one slab chunk of 4,096 trials x 50 years, key 9, the
# offset start with a 1,260-day buffer, costs on: 384 spells planned, every
# wealth finite, S2's median wealth 18,964.7 (a statistic of the JAX
# package's output on a TPU v5e).
ENVELOPE_REF_MAX_SPELLS = 384
ENVELOPE_REF_S2_P50 = 18964.7
# Printed by `JAX_PLATFORMS=cpu python3 -m tools.long_horizon_reference`:
# the JAX package's slab route (its Pallas kernels in interpret mode on the
# CPU, float32) on the record's first 1,024 trials; the sums over the first
# ENVELOPE_N trials, S1's final wealth on their even rows and S2's on every
# row.
ENVELOPE_N = 128
ENVELOPE_INT_SUMS = {'start_offset': 89022, 'regime_high_days': 407524}
ENVELOPE_S1_WEALTH = (
    7.76411874616425e-30, 1.7999051009960303e-30, 3.2777157690899136e-31, 1.9223717502293284e-19,
    0.0, 1.365912410871149e-25, 0.0, 1.0681279194457716e-09,
    5.158907573979204e-31, 0.0, 6.346331708872761e-23, 1.3158493733996454e-21,
    2.9667220098258973e-33, 1.0767686239972904e-29, 6.894829217111986e-14, 2.43648683591829e-24,
    4.93731953099541e-08, 1.6794472916851176e-14, 0.0, 2.89520802654138e-31,
    3.54472558127072e-28, 0.0, 1.3360955640655743e-26, 3.555397502693876e-16,
    3.395968679086288e-20, 6.745433563987816e-17, 1.7562824327138446e-22, 1.707264018510189e-26,
    7.721302073493741e-28, 2.8080409855768794e-18, 1.663325840432987e-22, 0.0,
    0.0, 1.3063725143103986e-33, 5.408128558362774e-19, 4.1096894042112614e-22,
    0.0, 3.1856060758034266e-13, 4.5399758101657937e-38, 1.674371076397439e-25,
    2.6676024844828494e-26, 0.0, 0.0, 1.3805580573108363e-24,
    1.7281613716000156e-23, 0.0, 0.0, 1.6375382172550272e-21,
    5.107031519595719e-20, 1.9301161938626046e-28, 0.0, 0.0,
    2.782116738232159e-26, 2.848082046070095e-20, 0.0, 1.3077317100694532e-29,
    7.53190731918085e-33, 6.189948470910298e-29, 9.02833000413479e-19, 7.152602322412474e-20,
    0.0, 2.2347956344097482e-14, 1.7149676860908625e-12, 3.0158720000276696e-33,
)
ENVELOPE_S2_WEALTH = (
    12830.685546875, 9874.4794921875, 6051.6083984375, 30427.408203125,
    411050.53125, 1457.046142578125, 12735.439453125, 107768.671875,
    300.489013671875, 1192151.625, 392.82232666015625, 57461.3671875,
    6.8606953620910645, 677017.125, 427407.5625, 8343.7353515625,
    655.529541015625, 593428.75, 11073.57421875, 260.9770812988281,
    183504.5625, 2629.2685546875, 252454.796875, 3225.238037109375,
    43556.8125, 25791.77734375, 103559.921875, 7472.97265625,
    31747.20703125, 89561.1953125, 5341.54345703125, 148453.53125,
    108447.9453125, 26878.62109375, 58038.0625, 56395.58203125,
    87.20950317382812, 586517.1875, 54007.234375, 522.2865600585938,
    22685.04296875, 23924.37890625, 641.021728515625, 233647.453125,
    108355.859375, 2866.06005859375, 421180.125, 4514.05859375,
    4636.84521484375, 403769.46875, 91969.5625, 10165.2939453125,
    1707339.5, 347.40643310546875, 3562.435791015625, 144849.453125,
    4216.46630859375, 320318.28125, 20583.046875, 84056.4140625,
    6800.61962890625, 216911.703125, 9136.5263671875, 4742.580078125,
    834.9427490234375, 145890.8125, 6631.26513671875, 56968.625,
    57444.046875, 14834.3125, 911299.375, 105.70333099365234,
    5642.9677734375, 39767.7109375, 248009.5625, 22708.931640625,
    253.73243713378906, 8475961.0, 17925.81640625, 42749.77734375,
    9097.6513671875, 61403.36328125, 140.9471893310547, 1917.1802978515625,
    304.0243835449219, 2687.55615234375, 205672.109375, 3578.31298828125,
    14822.8232421875, 23803.275390625, 5972.8427734375, 31425.279296875,
    39790.53515625, 5255.119140625, 5321.47265625, 223396.0625,
    8072.896484375, 57451.59375, 10169.001953125, 27118.525390625,
    8927.27734375, 12132.7197265625, 16430.623046875, 6597.61474609375,
    186272.90625, 1166.2073974609375, 98224.9921875, 19031.748046875,
    47018.7890625, 392.9101867675781, 157217.546875, 4742.64453125,
    59216.234375, 6731.03955078125, 90561.3515625, 9086.70703125,
    38697.8515625, 66847.296875, 29758.95703125, 55064.7421875,
    1454.161865234375, 88972.7421875, 112341.5625, 15841.0888671875,
    3521523.25, 8.159392356872559, 6700.302734375, 196189.890625,
)
# The JAX package's own reading of the record's statistic, from the same
# route on all 4,096 trials (`tools.long_horizon_reference --trials 4096`):
# S2's median final wealth and its bootstrap standard error.
ENVELOPE_JAX_S2_P50 = (18858.4189453125, 872.6282549455203)
# S1's per-trial relative difference (median, max) from the JAX package's,
# near the geometric middle between the sound reading (the port on an
# H100 80GB HBM3 at 700 W: 6.157e-6, 3.271e-4) and the nearest control
# reading of `tools.long_horizon_reference --controls` (the JAX package
# on the CPU, float32: without moment matching 0.226, 17.0; without
# trading costs 0 and 0, since S1 buys and holds).
ENVELOPE_S1_BOUNDS = (1e-3, 7e-2)
# S2's per-trial relative difference (median, max) over the first
# ENVELOPE_N rows, placed as S1's: near the geometric middle between the
# sound reading (the port on an H100 80GB HBM3 at 700 W: 1.877e-6,
# 1.099e-5) and the nearest control reading of
# `tools.long_horizon_reference --controls` (without moment matching
# 0.147, 1.036; without trading costs 0 and 0, since S2 buys and holds).
ENVELOPE_S2_BOUNDS = (5e-4, 3e-3)


def phase_envelope(model, counters):
    """The 50-year envelope, each part with the launch counters set to 0
    just before it and read just after:

    (a) the TPU record's configuration through run_monte_carlo (one slab
    chunk of 4,096 trials x 50 years, seed 9, the offset start, costs on):
    384 spells planned, every wealth finite, S2's median within 4
    bootstrap standard errors of the record's 18,964.7 (its relative gap
    logged, and its gap to the JAX package's median over the same trials,
    ENVELOPE_JAX_S2_P50), and the first ENVELOPE_N trials against the JAX
    package's slab route (ENVELOPE_*): the start-offset and regime-day
    sums exact, S1 per trial within ENVELOPE_S1_BOUNDS, S2 within
    ENVELOPE_S2_BOUNDS;
    (b) the default report, monte_carlo_report(default_sim_model(), 50,
    65,536) with its sampled taxes (K1, K2, K3, K2', K5, K7, K8 at 12,600
    days): every fan and post-tax table finite, no S2 ruin, its stages
    and launches;
    (c) exact_post_tax_all_trials at 1,024 trials x 50 years in one chunk,
    all 13 taxable strategies (K7 with its sec row in device memory): no
    non-finite trial, the first bridge fold bitwise through K7's and K8's
    plain versions, the peak device memory.
    Returns the launches of (b), the 50-year report."""
    from letf_tpu_torch import config as tcfg
    from letf_tpu_torch import reporting
    from letf_tpu_torch.ops import path_batched, sort_bridge, wash
    from letf_tpu_torch.parallel import mc_runner

    years = 50
    S = years * 252

    # (a)
    t_phase = time.perf_counter()
    spells = path_batched.plan_max_spells(model, S + 1260)
    reset(counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = mc_runner.run_monte_carlo(
        model, years, num_simulations=4096, seed=9, chunk_size=4096,
        use_antithetic=True, random_start_method="offset", apply_costs=True,
        progress=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    la = read(counters)
    fw = a.final_wealth.astype(np.float64)
    finite = float(np.isfinite(fw).mean())
    s2 = fw[:, tcfg.STRATEGY_INDEX["S2"]]
    p50 = float(np.percentile(s2, 50))
    boot = np.random.default_rng(0).integers(0, len(s2), (200, len(s2)))
    se = float(np.percentile(s2[boot], 50, axis=1).std())
    n = ENVELOPE_N
    ints = {"start_offset": int(a.start_offset[:n].sum()),
            "regime_high_days": int(a.regime_high_days[:n].sum())}
    s1 = fw[:n:2, tcfg.STRATEGY_INDEX["S1"]]
    ref = np.asarray(ENVELOPE_S1_WEALTH, np.float64)
    rel = np.abs(s1 - ref) / np.maximum(np.abs(ref), 1e-30)
    ref2 = np.asarray(ENVELOPE_S2_WEALTH, np.float64)
    rel2 = np.abs(s2[:n] - ref2) / np.maximum(np.abs(ref2), 1e-30)
    jax_p50, jax_se = ENVELOPE_JAX_S2_P50
    log(f"envelope (a): run_monte_carlo 4,096 x {years}y (seed 9, offset "
        f"start, buffer 1,260): wall {wall:.3f} s, "
        f"{4096 * S / wall:.6e} trial-days/s, launches {la}; max_spells "
        f"{spells}; finite fraction {finite}; S2 p50 {p50!r} (record "
        f"{ENVELOPE_REF_S2_P50}, relative gap "
        f"{p50 / ENVELOPE_REF_S2_P50 - 1:.3e}, bootstrap SE {se:.3f}, "
        f"{(p50 - ENVELOPE_REF_S2_P50) / se:.3f} SE); first {n} trials "
        f"against the JAX package's slab route: integer sums {ints} (JAX "
        f"{ENVELOPE_INT_SUMS}), S1 per-trial rel err median "
        f"{np.median(rel):.3e} max {rel.max():.3e}, S2 median "
        f"{np.median(rel2):.3e} max {rel2.max():.3e}; S2 p50 against the "
        f"JAX package's on the same {len(s2)} trials ({jax_p50!r}, SE "
        f"{jax_se:.3f}): relative gap {p50 / jax_p50 - 1:.3e}")
    assert spells == ENVELOPE_REF_MAX_SPELLS, spells
    assert finite == 1.0, finite
    assert abs(p50 - ENVELOPE_REF_S2_P50) <= 4 * se, (p50, se)
    assert ints == ENVELOPE_INT_SUMS, ints
    assert np.median(rel) < ENVELOPE_S1_BOUNDS[0], rel
    assert rel.max() < ENVELOPE_S1_BOUNDS[1], rel
    assert np.median(rel2) < ENVELOPE_S2_BOUNDS[0], rel2
    assert rel2.max() < ENVELOPE_S2_BOUNDS[1], rel2
    assert la["joint"] == la["window"] == la["compose_strategies"] == 1, la
    log(f"envelope (a): {time.perf_counter() - t_phase:.1f} s")

    # (b)
    t_phase = time.perf_counter()
    n_b = 65_536
    stages = {}
    reset(counters)
    GENERAL_TRIALS.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = mc_runner.monte_carlo_report(model, years, num_simulations=n_b,
                                       device="cuda", stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lb = read(counters)
    chunks = n_b // tcfg.DEVICE_CHUNK_TRIALS
    s1r, s2r = rep["strategies"]["S1"], rep["strategies"]["S2"]
    log(f"envelope (b): monte_carlo_report {n_b} x {years}y (tax_mode "
        f"{rep['tax_mode']!r}), chunks of {tcfg.DEVICE_CHUNK_TRIALS}: wall "
        f"{wall:.3f} s, post_tax_seconds {rep['post_tax_seconds']}, pre-tax "
        f"{wall - rep['post_tax_seconds']:.3f} s, "
        f"{n_b * S / wall:.6e} trial-days/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, post-tax "
        f"stages (s) {json.dumps(stages)}, launches {lb}, general path "
        f"(K5) at {GENERAL_TRIALS} trials; report "
        + json.dumps({"valid_frac": rep["valid_frac"],
                      "finite_frac": rep["finite_frac"],
                      "S1": {"p50": s1r["wealth"]["p50"],
                             "ruin_frac": s1r["ruin_frac"]},
                      "S2": {"p50": s2r["wealth"]["p50"],
                             "ruin_frac": s2r["ruin_frac"]},
                      "S7": rep["strategies"]["S7"]["post_tax"]["wealth"]}))
    for sid, st in rep["strategies"].items():
        assert all(np.isfinite(v) for v in st["wealth"].values()), sid
        e = st.get("post_tax")
        if e is not None:
            assert all(np.isfinite(v) for v in e["wealth"].values()), sid
            assert np.isfinite(e["median_tax"]) and e["median_tax"] >= 0
    assert len([s for s in rep["strategies"].values()
                if "post_tax" in s]) == 13
    assert rep["finite_frac"] == 1.0, rep["finite_frac"]
    assert s2r["ruin_frac"] == 0.0, s2r
    assert lb["joint"] == chunks + 1, lb
    assert lb["compose_strategies"] == lb["window"] == chunks, lb
    assert lb["window_tiles"] == lb["compose"] == 1, lb
    assert lb["sort_bridge"] >= 1 and lb["wash"] >= 1, lb
    assert lb["strategies"] == 0 and lb["gbm"] == 0, lb
    assert GENERAL_TRIALS and all(b > 0 for b in GENERAL_TRIALS)
    log(f"envelope (b): {time.perf_counter() - t_phase:.1f} s")

    # (c)
    t_phase = time.perf_counter()
    first, stages_c, values = {}, {}, {}
    reset(counters)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with keep_first_fold(first):
        ex = reporting.exact_post_tax_all_trials(
            model, years, 1024, chunk_size=1024, device="cuda",
            stage_seconds=stages_c, trial_values=values)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    lc = read(counters)
    equal, p_seconds = first_fold_plain(first)
    fold_shape = tuple(first["cols"][0].shape)
    del first["cols"]
    log(f"envelope (c): exact_post_tax_all_trials 1,024 x {years}y, one "
        f"chunk, 13 strategies: wall {wall:.3f} s, stages (s) "
        f"{json.dumps(stages_c)}, peak device memory {peak:.2f} GiB, "
        f"launches {lc}; K7's shared bytes and permutation in shared "
        f"memory at S={S} with a sec row: {sort_bridge._merge_limit(S, True)}, "
        f"K8's {wash.match_smem(S)}; the first fold {fold_shape} again "
        f"through the plain versions ({p_seconds:.1f} s): bitwise {equal}; "
        "S7 " + json.dumps({k: ex["S7"][k] for k in
                            ("median_tax", "pre_tax_p50", "post_tax_p50")}))
    assert len(ex) == 13
    for sid, e in ex.items():
        assert e["n_trials"] == 1024 and e["nonfinite_trials"] == 0, sid
        w, pw = values[sid]
        assert np.isfinite(w).all() and np.isfinite(pw).all(), sid
    assert fold_shape[0] == S, fold_shape
    assert equal, "K7/K8 differ from their plain versions at 50 years"
    assert lc["sort_bridge"] > 0 and lc["wash"] > 0, lc
    log(f"envelope (c): {time.perf_counter() - t_phase:.1f} s")
    return lb


# A chunk that stops on a device-side assert (an out-of-range index) under
# fault_tolerant: the containment must raise, not flag the chunk.
STICKY_CHILD = r"""
import torch
from letf_tpu_torch.models.params import default_sim_model
from letf_tpu_torch.parallel import mc_runner
real = mc_runner._Run.chunk
def chunk(self, ids, anti):
    out = real(self, ids, anti)
    if int(ids[0]) == 512:
        x = torch.zeros(4, device=self.device)
        x[torch.tensor([1 << 20], device=self.device)] = 1.0
    return out
mc_runner._Run.chunk = chunk
mc_runner.run_monte_carlo(default_sim_model(), 1, num_simulations=2048,
                          seed=1, chunk_size=1024, fault_tolerant=True,
                          device="cuda")
print("containment did not raise")
"""


# The runner phase's batch-width runs: 20 years, past the ~4,096 days
# where the card may split a day reduction across blocks, in one chunk
# of WIDTH_N trials on one device and in two shards of WIDTH_N / 2: at
# these widths torch's own reductions over a trial's days take another
# block shape on the card, so a reduction whose order follows the batch
# width makes the two runs differ.
WIDTH_N, WIDTH_YEARS, WIDTH_CHUNK = 16, 20, 16
WIDTH_MODES = ("parametric", "legacy_hybrid", "institutional_v1")


def width_pools():
    """The block-bootstrap pools of the port's offline history (built in a
    temporary cache of the port's)."""
    from letf_tpu_torch.data import fetch_historical_data
    from letf_tpu_torch.models import bootstrap

    with port_cache():
        return bootstrap.create_bootstrap_sampler(
            fetch_historical_data(force_synthetic=True))


def width_runs(model, counters, mesh, pools, modes=WIDTH_MODES, n=WIDTH_N,
               chunk=WIDTH_CHUNK):
    """run_monte_carlo at ``n`` trials x WIDTH_YEARS (5,040 days and the
    1,260-day buffer) in chunks of ``chunk``, in each engine mode of
    ``modes`` (legacy_hybrid with ``pools``), on one device and on
    ``mesh``, the launch counters set to 0 just before each run and read
    just after. Returns {mode: {"seconds": (single, mesh), "launches":
    (single, mesh), "differ": {field: trials whose bits differ}}}."""
    from letf_tpu_torch.parallel import mc_runner

    out = {}
    for mode in modes:
        kw = dict(num_simulations=n, seed=5, chunk_size=chunk,
                  engine_mode=mode, progress=False, device="cuda",
                  bootstrap_pools=pools if mode == "legacy_hybrid" else None)
        runs, secs, launches = [], [], []
        for m in (None, mesh):
            reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs.append(mc_runner.run_monte_carlo(model, WIDTH_YEARS,
                                                  mesh=m, **kw))
            torch.cuda.synchronize()
            secs.append(round(time.perf_counter() - t0, 3))
            launches.append(read(counters))
        differ = {}
        for k, v in vars(runs[0]).items():
            w = vars(runs[1])[k]
            if not isinstance(v, np.ndarray):       # sim_days, chunk_failed
                differ[k] = int(v != w)
                continue
            a, b = np.ascontiguousarray(v), np.ascontiguousarray(w)
            same = (a.view(np.uint8) == b.view(np.uint8)).reshape(
                a.shape[0], -1).all(1)
            differ[k] = int((~same).sum())
        out[mode] = {"seconds": tuple(secs), "launches": tuple(launches),
                     "differ": differ}
    return out


def width_taxes(n=4096, years=50):
    """tax/vectorized.total_tax_all_trials, whose per-trial sums the port
    leaves to torch (over a trial's 12 padded brackets, [B, Y, 12], and
    its Y tax years), on ``n`` trials x ``years`` of seeded float64 yearly
    activity on the card, and on the first 1, 2, 3, 8, 15, 16 and 1,024 of
    them alone. Returns {width: whether every output is the n-trial run's
    bits}."""
    from letf_tpu_torch.tax import vectorized

    g = torch.Generator(device="cuda").manual_seed(3)
    act = torch.rand((n, years, 4), generator=g, device="cuda",
                     dtype=torch.float64) * 4e4
    avg = torch.rand(n, generator=g, device="cuda",
                     dtype=torch.float64) * 200.0
    income = np.full(years + 1, 150_000.0)
    full = vectorized.total_tax_all_trials(act, income, 1e6, avg)
    out = {}
    for b in (1, 2, 3, 8, 15, 16, 1024):
        part = vectorized.total_tax_all_trials(act[:b], income, 1e6,
                                               avg[:b])
        out[b] = all(torch.equal(v, full[k][:b]) for k, v in part.items())
    return out


def phase_runner(model, counters):
    """Multi-device runs, checkpoint/resume and the chunk containment, on
    every visible card when there are several, else on two shards of
    cuda:0 (parallel/mesh.py), each run with the launch counters set to 0
    just before it and read just after: run_monte_carlo and
    monte_carlo_report (its sampled taxes) at 32,768 x 10 y in chunks of
    16,384 on the mesh, bit for bit their single-device runs;
    exact_post_tax_all_trials at 2,048 x 10 y in chunks of 1,024 on the
    mesh, within rtol 1e-9 of one device; 4 chunks of 16,384 x 10 y killed
    after 2 (max_chunks) and resumed from their checkpoint, bit for bit the
    uninterrupted run; fault_tolerant with a Python exception in the
    second chunk: that chunk alone flagged and NaN, the others bit for bit
    the clean run; in a subprocess, a device-side assert in a chunk under
    fault_tolerant, which must be raised, not flagged; then the batch-
    width promise at 20 y (width_runs: one chunk of 16 trials on one
    device against two shards of 8, parametric, legacy_hybrid and
    institutional_v1, the mesh bit for bit one device) and width_taxes."""
    from letf_tpu_torch import reporting
    from letf_tpu_torch.parallel import mc_runner
    from letf_tpu_torch.parallel.mesh import trial_mesh

    mesh = (trial_mesh() if torch.cuda.device_count() > 1
            else trial_mesh(["cuda:0", "cuda:0"]))
    years, n, cs, seed = 10, 32_768, 16_384, 4
    kw = dict(num_simulations=n, seed=seed, chunk_size=cs, device="cuda")
    times, launches = {}, {}

    def timed_run(name, fn, *args, **kwargs):
        reset(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times[name] = round(time.perf_counter() - t0, 3)
        launches[name] = read(counters)
        return out

    single = timed_run("run single", mc_runner.run_monte_carlo, model, years,
                       progress=False, **kw)
    multi = timed_run("run mesh", mc_runner.run_monte_carlo, model, years,
                      mesh=mesh, progress=False, **kw)
    run_equal = {k: bool(np.array_equal(np.asarray(v),
                                        np.asarray(vars(multi)[k])))
                 for k, v in vars(single).items()}
    rep_single = timed_run("report single", mc_runner.monte_carlo_report,
                           model, years, **kw)
    rep_multi = timed_run("report mesh", mc_runner.monte_carlo_report,
                          model, years, mesh=mesh, **kw)
    for r in (rep_single, rep_multi):
        r.pop("post_tax_seconds")
    ex_kw = dict(chunk_size=1024, seed=seed, device="cuda")
    ex_single = timed_run("exact_all single",
                          reporting.exact_post_tax_all_trials, model, years,
                          2048, **ex_kw)
    ex_multi = timed_run("exact_all mesh",
                         reporting.exact_post_tax_all_trials, model, years,
                         2048, mesh=mesh, **ex_kw)
    ex_rel = max(abs(ex_multi[sid][k] - v) / max(abs(v), 1e-9)
                 for sid, e in ex_single.items() for k, v in e.items()
                 if isinstance(v, float))

    rkw = dict(num_simulations=4 * cs, seed=seed, chunk_size=cs,
               progress=False, device="cuda")
    clean = timed_run("run 4 chunks", mc_runner.run_monte_carlo, model,
                      years, **rkw)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        partial = timed_run("run killed after 2", mc_runner.run_monte_carlo,
                            model, years, checkpoint_dir=d, max_chunks=2,
                            **rkw)
        files = sorted(p.name for p in Path(d).iterdir())
        resumed = timed_run("run resumed", mc_runner.run_monte_carlo, model,
                            years, checkpoint_dir=d, resume=True, **rkw)
    resume_equal = all(np.array_equal(np.asarray(v),
                                      np.asarray(vars(resumed)[k]))
                       for k, v in vars(clean).items())

    real = mc_runner._Run.chunk

    def chunk(self, ids, anti):
        if int(ids[0]) == cs // 2:          # the second chunk's first id
            raise RuntimeError("injected chunk failure")
        return real(self, ids, anti)

    mc_runner._Run.chunk = chunk
    try:
        guarded = timed_run("run fault_tolerant", mc_runner.run_monte_carlo,
                            model, years, fault_tolerant=True,
                            chunk_retries=1, **rkw)
    finally:
        mc_runner._Run.chunk = real
    bad = np.zeros(4 * cs, bool)
    bad[cs:2 * cs] = True
    keep_equal = all(np.array_equal(getattr(guarded, k)[~bad],
                                    getattr(clean, k)[~bad])
                     for k in ("final_wealth", "num_trades", "max_dd",
                               "start_offset", "regime_high_days"))
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", STICKY_CHILD], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
    times["sticky subprocess"] = round(time.perf_counter() - t0, 3)
    sticky_tail = child.stderr.strip().splitlines()[-1:] or [""]
    log(f"runner: mesh {mesh} (shards {mesh.size}); seconds {times}; "
        f"launches {json.dumps(launches)}; run mesh vs single bitwise "
        f"{run_equal}; report mesh == single {rep_multi == rep_single}; "
        f"exact_all mesh vs single max rel diff {ex_rel:.3e}; checkpoint "
        f"files after the kill {files}, partial {partial.final_wealth.shape}"
        f", resumed bitwise {resume_equal}; fault_tolerant: flagged "
        f"{int(guarded.chunk_failed.sum())} trials, the rest bitwise "
        f"{keep_equal}; device-side assert under fault_tolerant: exit "
        f"{child.returncode}, {sticky_tail[0][:200]!r}")
    assert all(run_equal.values()), run_equal
    assert rep_multi == rep_single
    assert ex_rel <= 1e-9, ex_rel
    assert len(files) == 3 and partial.final_wealth.shape[0] == 2 * cs
    assert resume_equal
    np.testing.assert_array_equal(guarded.chunk_failed, bad)
    assert np.isnan(guarded.final_wealth[bad]).all() and keep_equal
    assert child.returncode != 0, child.stdout
    assert "device-side assert" in child.stderr, child.stderr[-2000:]
    assert "flagged" not in child.stdout, child.stdout
    lm = launches["run mesh"]
    assert lm["joint"] == lm["compose_strategies"] == 2 * mesh.size, lm

    t0 = time.perf_counter()
    pools = width_pools()
    widths = width_runs(model, counters, mesh, pools)
    taxes = width_taxes()
    for mode, w in widths.items():
        log(f"runner: {mode} at {WIDTH_N} x {WIDTH_YEARS}y in chunks of "
            f"{WIDTH_CHUNK}, one device vs the mesh: seconds "
            f"{w['seconds']}, launches {json.dumps(w['launches'])}, trials "
            f"whose bits differ {w['differ']}")
    log(f"runner: total_tax_all_trials on 1-1,024 of 4,096 trials bitwise "
        f"the 4,096-trial run's: {taxes}; the width checks "
        f"{time.perf_counter() - t0:.1f} s")
    for mode, w in widths.items():
        assert not any(w["differ"].values()), (mode, w["differ"])
        single, meshed = w["launches"]
        chunks = -(-WIDTH_N // WIDTH_CHUNK)
        if mode == "institutional_v1":
            assert single["joint"] == single["compose_strategies"] == chunks
            assert meshed["joint"] == chunks * mesh.size, meshed
        else:
            assert single["strategies"] == chunks, single
            assert meshed["strategies"] == chunks * mesh.size, meshed
    assert all(taxes.values()), taxes


KERNELS = {   # name -> (source, the TPU kernel it replaces, its path)
    "joint": ("letf_tpu_torch/csrc/joint.cu",
              "letf_tpu/ops/pallas_joint.py:104", "default_report"),
    "window": ("letf_tpu_torch/csrc/window.cu",
               "letf_tpu/ops/pallas_window.py:139", "default_report"),
    "window_tiles": ("letf_tpu_torch/csrc/window.cu",
                     "letf_tpu/ops/pallas_window.py:70", "default_report"),
    "compose_strategies": ("letf_tpu_torch/csrc/compose_strategies.cu",
                           "letf_tpu/ops/pallas_strategies.py:193",
                           "default_report"),
    "strategies": ("letf_tpu_torch/csrc/strategies.cu",
                   "letf_tpu/ops/pallas_strategies.py:193",
                   "parametric_report"),
    "compose": ("letf_tpu_torch/csrc/compose.cu",
                "letf_tpu/ops/pallas_compose.py:95", "default_report"),
    "gbm": ("letf_tpu_torch/csrc/gbm.cu", "letf_tpu/ops/pallas_path.py:45",
            "headline"),
    "sort_bridge": ("letf_tpu_torch/csrc/merge.cu",
                    "letf_tpu/ops/pallas_sort.py:74", "default_report"),
    "wash": ("letf_tpu_torch/csrc/wash.cu", "letf_tpu/ops/pallas_wash.py:107",
             "default_report"),
    "draws": ("letf_tpu_torch/csrc/draws.cu",
              "none (jax.random in XLA: letf_tpu/ops/path_engine.py)",
              "parametric_report"),
    "emit_days": ("letf_tpu_torch/csrc/emit_days.cu",
                  "none (the XLA scan of letf_tpu/strategies/engine.py's "
                  "emitting path)", "default_report"),
}


def run_phase(name, fn, *args):
    """fn(*args), its seconds logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and compare the kernels at short shapes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)

    from letf_tpu_torch.models.params import default_sim_model, from_numpy
    from letf_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}, {smi}")
    t0 = time.perf_counter()
    _build.build(verbose=args.quick)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().name})")
    info = {"kernel_info": _build.kernel_info()}
    log(json.dumps(info))

    model = default_sim_model()
    model_t = from_numpy(model, "cuda", torch.float32)
    rec = run_phase("kernels", phase_kernels, model_t, args.quick)
    rec["draws"] = run_phase("draws", phase_draws, args.quick)
    rec["emit_days"] = run_phase("emit_days", phase_emit_days, model_t,
                                 args.quick)
    if args.quick:
        rec["strategies"] = phase_k4(general_channels(model_t, QUICK["sim"]))
        rec["gbm"] = phase_k6(n=65_536, years=1, reps=2, gate=False)
        log(json.dumps(rec))
        print(json.dumps(info))
        print(smi)
        return
    rec["gbm"] = run_phase("k6", phase_k6)
    run_phase("small_report", phase_small_report, model)
    run_phase("general_vs_slab", phase_general_vs_slab, model_t)
    observe_general_windows()
    ctrs = counters()
    launches = {"pretax_report": run_phase("pretax", phase_pretax, model,
                                           ctrs)}
    launches["default_report"], rep = run_phase("main_path", phase_main_path,
                                                model, ctrs)
    shared = run_phase("tax_reference", phase_tax_reference, model, rep)
    del rep
    torch.cuda.empty_cache()
    launches["exact_all"] = run_phase("exact_all", phase_exact_all, model,
                                      ctrs, shared)
    torch.cuda.empty_cache()
    launches["parametric_report"], rec["strategies"] = run_phase(
        "parametric", phase_parametric, model, ctrs)
    run_phase("parametric_small", phase_parametric_small, model)
    run_phase("jax_reference", phase_jax_reference, model)
    launches["calibrated_report"] = run_phase("calibrated", phase_calibrated,
                                              ctrs, smi)
    torch.cuda.empty_cache()
    (launches["analysis"], launches["analysis_replay"],
     analysis_rec) = phase_analysis(ctrs, smi)
    for k, r in analysis_rec.items():
        if r is not None:
            rec[k]["analysis"] = r
    torch.cuda.empty_cache()
    launches["engine_modes"] = phase_engine_modes(ctrs, smi)
    torch.cuda.empty_cache()
    run_phase("oracles", phase_oracles, model, model_t, ctrs, smi)
    torch.cuda.empty_cache()
    launches["envelope_report"] = run_phase("envelope", phase_envelope, model,
                                            ctrs)
    torch.cuda.empty_cache()
    run_phase("runner", phase_runner, model, ctrs)
    torch.cuda.empty_cache()
    launches["headline"] = run_phase("headline", phase_headline, ctrs)
    run_phase("validation", phase_validation, ctrs)
    run_phase("profile", phase_profile, model)
    assert "jax" not in sys.modules and "letf_tpu" not in sys.modules

    kernels = []
    for k, (src, replaces, path) in KERNELS.items():
        r = rec[k]
        kernels.append(dict(
            name=k, route="cuda", source=src, replaces=replaces,
            launches=launches[path][k], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            launches_path=path,
            launches_by_path={p: v[k] for p, v in launches.items()},
            **{x: r[x] for x in ("days", "plain_days", "fused", "ms_spread",
                                 "shapes", "shape",
                                 "paired_ms_spread", "equal_ms_spread",
                                 "quarter_ms_spread", "report_ms_spread",
                                 "digest_match", "analysis")
               if x in r}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(info))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
