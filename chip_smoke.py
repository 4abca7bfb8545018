#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (letf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check (one card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain at short shapes

Phases, each raising on failure:
1. The card: torch.cuda must be available; prints nvidia-smi's name and
   power limit.
2. Build: one nvcc per letf_tpu_torch/csrc/*.cu, started together, linked
   into build/letf_tpu_torch/.
3. Kernels: each CUDA kernel against its plain PyTorch version on the card,
   on the same inputs, at the main path's shapes (B=16,384 trials, 30
   years + 5-year buffer; with --quick a 252-day window and a 126-day
   buffer): K1 (joint) within rtol 1e-4 / VIX atol 1e-3, K2 (window)
   bitwise, K3 (compose + strategies) within
   compose_strategies.check_parity's bounds, K5 (compose) within rtol 1e-5
   / atol 1e-6, K7 (bridge merge, merge and valley kinds, [2S, 600] and
   [2S, 2,048] with 0/2/4 payloads) and K8 (wash matching, [S, 650])
   bitwise. Each kernel's time beside the plain version's.
4. Reports through kernels vs plain versions on the card: 1,024 trials x
   0.5 year pre-tax, and the default sampled report at 1,024 x 1 year.
5. The general path (K1, K2', K5, emitting engine) against the slab path
   (K1, K2, K3): 16,384 trials, 2 years + 2-year buffer.
6. The pre-tax report, 65,536 x 30 years (the first slice's main path).
7. Main path: the default report, monte_carlo_report(default_sim_model(),
   30, 1,048,576 trials, seed 2, chunks of 16,384, tax_mode="sampled"),
   with the launch counters reset just before and read just after; its
   pre-tax statistics against the JAX reference's, its post-tax tables
   against the reference's exact-all taxes and its sampled estimator's
   spread (phase_tax_reference).
8. torch.profiler breakdowns of one pre-tax chunk and of the post-tax part
   of a one-chunk sampled report.
The second-to-last line is the kernels JSON, the last {"ok": true, ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

B_CHUNK = 16384
QUICK = dict(sim=252, buf=126)
FULL = dict(sim=30 * 252, buf=5 * 252)


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
    ms, xk = timed(lambda: joint.joint_generate(*ja), 2)
    plain_ms, xp = timed(lambda: joint.joint_plain(*ja), 1, warm=False)
    errs = [float((a - b).abs().max()) for a, b in zip(xk, xp)]
    for c in (0, 1, 2, 4):
        torch.testing.assert_close(xk[c], xp[c], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(xk[3], xp[3], rtol=0, atol=1e-3)
    log(f"K1 joint vs plain at B={B_CHUNK} T={T}: max abs err x0..x2 "
        f"{max(errs[:3]):.3e}, vix {errs[3]:.3e}, irx {errs[4]:.3e}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rec["joint"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)
    del xp

    chans = windowed(model_t, list(xk) + [regime], offs, sim)
    del xk
    ka = k3_args(model_t, ids, sw, chans)
    ms, got = timed(lambda: k3.compose_strategies(*ka), 1)
    plain_ms, ref = timed(lambda: k3.compose_strategies_plain(*ka), 1,
                          warm=False)
    st = k3.check_parity(dict(zip(k3.OUTPUTS, got)),
                         dict(zip(k3.OUTPUTS, ref)),
                         exact=("path_finite", "vix_min", "vix_max",
                                "regime_high_days"))
    log(f"K3 compose_strategies vs plain at B={B_CHUNK} S={sim}: {st}; "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rec["compose_strategies"] = dict(max_abs_err=st["max_abs_err"], ms=ms,
                                     plain_ms=plain_ms)
    del got, ref
    rec["compose"] = phase_k5(ka)
    del chans, ka

    # K2 bitwise, NaN payloads and -0.0 included.
    g = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn((T, B_CHUNK), generator=g, device="cuda")
          for _ in range(5)]
    xs.append((torch.rand((T, B_CHUNK), generator=g, device="cuda")
               < 0.3).to(torch.float32))
    xs[0][7, 3] = float("nan")
    xs[1][11, 5] = -0.0
    woffs = torch.randint(0, T - sim + 1, (B_CHUNK,), generator=g,
                          device="cuda", dtype=torch.int32)
    bias = [torch.randn(B_CHUNK, generator=g, device="cuda")
            for _ in range(3)] + [None] * 3
    ms, wk = timed(lambda: window.window_offsets(xs, woffs, sim,
                                                 biases=bias), 5)
    plain_ms, wp = timed(lambda: window.window_plain(xs, woffs, sim,
                                                     biases=bias), 3)
    for a, b in zip(wk, wp):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    log(f"K2 window vs plain at B={B_CHUNK} T={T} S={sim}, 6 channels: "
        f"bitwise equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    rec["window"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)
    del xs, wk, wp
    torch.cuda.empty_cache()
    rec["sort_bridge"] = phase_k7(sim)
    rec["wash"] = phase_k8(sim)
    torch.cuda.empty_cache()
    return rec


# K5 against its plain version: every ETF plane, the adjusted SPY/QQQ and
# cash within rtol 1e-5 / atol 1e-6 (torch divides by a Python scalar as a
# multiply by its reciprocal on the card, the kernel divides, so the two
# differ by ulps that the tracking-error carry keeps), jump counts on at
# most one trial (a uniform within ulps of the jump probability), the
# liquidity and credit sums within rtol 1e-5.
def phase_k5(ka):
    from letf_tpu_torch.ops import compose

    ms, got = timed(lambda: compose.compose_generate(*ka), 2)
    plain_ms, ref = timed(lambda: compose.compose_plain(*ka), 1, warm=False)
    errs = [float((a - b).abs().max()) for a, b in zip(got[:4], ref[:4])]
    for a, b in zip(got[:4], ref[:4]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    jump_mismatch = int((got[4] != ref[4]).sum())
    assert jump_mismatch <= 1, jump_mismatch
    for a, b in zip(got[5:], ref[5:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
    S, B = ka[4].shape
    log(f"K5 compose vs plain at B={B} S={S}: max abs err etf "
        f"{errs[0]:.3e}, spy/qqq adj {max(errs[1:3]):.3e}, cash "
        f"{errs[3]:.3e}; jump-count mismatches {jump_mismatch}; bitwise "
        f"{bitwise}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)


def bridge_sort_inputs(g, R, S, kind, n_pay):
    """Bridge-like K7 operands [2S, R]: non-negative float32 keys with
    ties, ascending halves (the first half unsorted for "valley"), the
    unique packed secondary (tag << 24) | position, random payloads."""
    N = 2 * S
    key = torch.round(torch.randn((N, R), generator=g, device="cuda").abs()
                      * 4) / 4
    key[S:] = torch.sort(key[S:], dim=0).values
    if kind == "merge":
        key[:S] = torch.sort(key[:S], dim=0).values
    pos = torch.arange(N, device="cuda", dtype=torch.int32)
    sec = torch.where(pos >= S, pos | (1 << 24), pos)[:, None].expand(
        N, R).contiguous()
    pays = [torch.randn((N, R), generator=g, device="cuda")
            for _ in range(n_pay)]
    return key, sec, pays


def phase_k7(sim):
    """K7 against its plain version (one full stable torch.sort), bitwise:
    merge and valley at R = 600 (the sampled report's bridge batch) and
    2,048 rows of 2 x sim days, with 0, 2 and 4 payloads."""
    from letf_tpu_torch.ops import sort_bridge as k7

    g = torch.Generator(device="cuda").manual_seed(7)
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
                    out.update(ms=ms, plain_ms=plain_ms)
    return out


def phase_k8(sim, B=650):
    """K8 against its plain version, bitwise, at [sim, 650] on bridge-like
    inputs (sparse buys, sells, losses on half the sells)."""
    from letf_tpu_torch.ops import wash

    g = torch.Generator(device="cuda").manual_seed(8)

    def sparse(p, scale):
        u = torch.rand((sim, B), generator=g, device="cuda")
        v = torch.rand((sim, B), generator=g, device="cuda") * scale
        return torch.where(u < p, v, 0.0)

    buy, sell = sparse(0.25, 6.0), sparse(0.15, 8.0)
    loss = torch.where(sell > 0, sparse(0.5, 100.0), 0.0)
    ms, got = timed(lambda: wash.wash_matching(loss, sell, buy), 3)
    plain_ms, ref = timed(lambda: wash.wash_plain(loss, sell, buy), 1,
                          warm=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    log(f"K8 wash vs plain at [{sim}, {B}]: bitwise equal "
        f"({int(got[2].sum())} matched loss days); kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms)


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel of the report -- the production chunk's K1, K2,
    K3, the general path's K5 and the bridge's K7 and K8 -- through its
    plain PyTorch version (on the card), for the kernels-vs-plain
    comparison of whole reports."""
    from letf_tpu_torch.ops import compose, joint, path_batched, slab_chunk
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import sort_bridge, wash, window
    from letf_tpu_torch.tax import device_bridge

    swaps = [(path_batched, "joint_generate", joint.joint_plain),
             (path_batched, "window_offsets", window.window_plain),
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
    (5-year buffer) per trial (K3 bounds) and as a pre-tax report; and the
    default sampled report at 1,024 trials x 1 year, whose post-tax fans
    and median taxes must agree within 1% (of at least $100): the replayed
    rows, K1 and the bridge agree bitwise, K5 and K3 to ulps that flip a
    few trades."""
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.parallel import mc_runner

    kw = dict(num_simulations=1024, seed=2, chunk_size=1024, device="cuda")
    arr_k = mc_runner.run_monte_carlo(model, 0.5, **kw)
    rep_k = mc_runner.monte_carlo_report(model, 0.5, tax_mode="none", **kw)
    tax_k = mc_runner.monte_carlo_report(model, 1, **kw)
    with plain_kernels():
        arr_p = mc_runner.run_monte_carlo(model, 0.5, **kw)
        rep_p = mc_runner.monte_carlo_report(model, 0.5, tax_mode="none",
                                             **kw)
        tax_p = mc_runner.monte_carlo_report(model, 1, **kw)
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


def phase_general_vs_slab(model_t):
    """The general path (K1, K2', K5, signals, emitting engine) against
    the slab path (K1, K2, K3) on the same trials: B = 16,384, 2 years, a
    2-year buffer, the bounds of tests/test_path_batched.py:373-392."""
    from letf_tpu_torch.ops import rng
    from letf_tpu_torch.ops.path_batched import generate_paths_batched
    from letf_tpu_torch.ops.slab_chunk import slab_chunk_summaries
    from letf_tpu_torch.strategies.engine import run_strategies_batch
    from letf_tpu_torch.strategies.signals import compute_signals

    S, buf = 2 * 252, 504
    rows = torch.arange(B_CHUNK, device="cuda")
    ids, anti, key = rows // 2, rows % 2 == 1, rng.key(11, "cuda")
    t0 = time.perf_counter()
    p = generate_paths_batched(model_t, key, ids, anti, sim_days=S,
                               buffer_days=buf)
    r = run_strategies_batch(p, compute_signals(p), emit_trades=True)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    sm = slab_chunk_summaries(model_t, key, ids, anti, sim_days=S,
                              buffer_days=buf)
    fw, nt = sm["final_wealth"].cpu().numpy(), sm["num_trades"].cpu().numpy()
    rw, rt = r.final_wealth.cpu().numpy(), r.num_trades.cpu().numpy()
    rel = np.abs(fw - rw) / np.maximum(np.abs(rw), 1.0)
    stats = dict(median_rel=float(np.median(rel)),
                 frac_rel_gt_1e3=float((rel > 1e-3).mean()),
                 trades_mismatch=float((nt != rt).mean()))
    assert stats["median_rel"] < 1e-5, stats
    assert stats["frac_rel_gt_1e3"] < 0.01, stats
    assert stats["trades_mismatch"] < 0.05, stats
    for q in (10, 50, 90):
        np.testing.assert_allclose(np.percentile(fw, q, axis=0),
                                   np.percentile(rw, q, axis=0),
                                   rtol=5e-3, atol=1e-2)
    assert torch.equal(sm["valid"], p.valid)
    assert torch.equal(sm["jump_days"], p.jump_days)
    torch.testing.assert_close(sm["liq_mean"], p.liq_mean, rtol=0,
                               atol=1e-6)
    log(f"general path vs slab path at B={B_CHUNK}, 2y + 2y buffer: "
        f"{stats}; valid and jump days equal; general path + emitting "
        f"engine {t_gen:.3f} s")


def phase_pretax(model, counters):
    """The pre-tax report alone, 65,536 trials x 30 years."""
    from letf_tpu_torch.parallel import mc_runner

    n, years = 65536, 30
    for m in counters.values():
        m.LAUNCHES = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = mc_runner.monte_carlo_report(
        model, years, num_simulations=n, seed=2, chunk_size=B_CHUNK,
        tax_mode="none", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    chunks = n // B_CHUNK
    log(f"pre-tax path: monte_carlo_report {n} x {years}y, chunks of "
        f"{B_CHUNK}: wall {wall:.3f} s, "
        f"{n * years * 252 / wall:.6e} trial-days/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches}")
    check_pretax(rep, 0.0015, 0.02, 0.006)
    assert launches["joint"] == chunks, launches
    assert launches["compose_strategies"] == chunks, launches
    assert launches["window"] >= chunks, launches
    assert launches["compose"] == 0, launches


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
    for m in counters.values():
        m.LAUNCHES = 0
    stages = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = mc_runner.monte_carlo_report(
        model, years, num_simulations=n, seed=2, chunk_size=B_CHUNK,
        device="cuda", stage_seconds=stages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in counters.items()}
    chunks = n // B_CHUNK
    log(f"main path: monte_carlo_report {n} x {years}y (tax_mode "
        f"{rep['tax_mode']!r}), chunks of {B_CHUNK}: wall {wall:.3f} s, "
        f"post_tax_seconds {rep['post_tax_seconds']}, pre-tax "
        f"{wall - rep['post_tax_seconds']:.3f} s, "
        f"{n * years * 252 / wall:.6e} trial-days/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, post-tax "
        f"stages (s) {json.dumps(stages)}, launches {launches}")
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
    assert launches["window"] == chunks + 1, launches
    assert launches["compose"] == 1, launches
    assert launches["sort_bridge"] == 6, launches
    assert launches["wash"] == 3, launches
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
       and tax: their S7/S8 post-tax p50 and median tax drag (the
       reference's exact-all statistic, median of wealth minus post-tax
       wealth, i.e. of the tax capped at the wealth) must lie within 4
       bootstrap standard errors of the reference's exact-all values.
    2. The sampled estimator emulated on that subsample's exact taxes (50
       nodes at the evenly spaced sorted positions, each node's trial
       drawn among its 9 nearest in wealth, 10,000 draws): the port's
       sampled S7 p50, S7 median tax and S8 median tax must rank inside
       the emulated estimator's central 99.8%, and the reference's sampled
       values inside its central 99.98%."""
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
            stacked = [e[:, :, c].contiguous() for e in em]
            tax[sid].append(reporting.bridge_tax(stacked, assets, years,
                                                 income, tax_kw).cpu())
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
    """Device time by kernel for one 16,384 x 30y pre-tax report chunk,
    and for the post-tax part of a one-chunk sampled report (its replay,
    bridge and tax), with the device's busy share of the wall."""
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
    stages = {}
    wall_ms, busy_ms, top = device_profile(
        lambda: reporting.sampled_post_tax_tables(run, fw, 30, (10, 50, 90),
                                                  stage_seconds=stages))
    log(f"profile of the post-tax part of a {B_CHUNK} x 30y sampled "
        f"report: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), stages (s, under the profiler) "
        f"{json.dumps(stages)}; by kernel: "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top[:10]))


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
    from letf_tpu_torch.ops import _build, compose, joint, sort_bridge, wash
    from letf_tpu_torch.ops import compose_strategies as k3
    from letf_tpu_torch.ops import window

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build(verbose=args.quick)
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().name})")

    model = default_sim_model()
    model_t = from_numpy(model, "cuda", torch.float32)
    rec = phase_kernels(model_t, args.quick)
    if args.quick:
        log(json.dumps(rec))
        print(smi)
        return
    phase_small_report(model)
    phase_general_vs_slab(model_t)
    counters = {"joint": joint, "window": window, "compose_strategies": k3,
                "compose": compose, "sort_bridge": sort_bridge,
                "wash": wash}
    phase_pretax(model, counters)
    launches, rep = phase_main_path(model, counters)
    phase_tax_reference(model, rep)
    phase_profile(model)
    assert "jax" not in sys.modules

    meta = {
        "joint": ("letf_tpu_torch/csrc/joint.cu",
                  "letf_tpu/ops/pallas_joint.py:104"),
        "window": ("letf_tpu_torch/csrc/window.cu",
                   "letf_tpu/ops/pallas_window.py:139"),
        "compose_strategies": ("letf_tpu_torch/csrc/compose_strategies.cu",
                               "letf_tpu/ops/pallas_strategies.py:193"),
        "compose": ("letf_tpu_torch/csrc/compose.cu",
                    "letf_tpu/ops/pallas_compose.py:95"),
        "sort_bridge": ("letf_tpu_torch/csrc/merge.cu",
                        "letf_tpu/ops/pallas_sort.py:74"),
        "wash": ("letf_tpu_torch/csrc/wash.cu",
                 "letf_tpu/ops/pallas_wash.py:107"),
    }
    kernels = [dict(name=k, route="cuda", source=src, replaces=rep,
                    launches=launches[k], max_abs_err=rec[k]["max_abs_err"],
                    ms=rec[k]["ms"], plain_ms=rec[k]["plain_ms"])
               for k, (src, rep) in meta.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
