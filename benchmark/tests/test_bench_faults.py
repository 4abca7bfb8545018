"""Whole runs on the CPU at a tiny size, past the look for a card: a sound
run comes out correct, and a run whose timed path is broken underneath
comes out not correct, once for each fault these cells can have (one card
each, so there is no exchange between chips to leave out):

- a step that returns its state unchanged (the chunk's strategies never
  move from their initial capital);
- half of the batch left out, the rest standing in for it (in the chunk)
  or the reductions taken over the rest (in the report);
- an answer altered where it is produced (the chunk's final wealth, by 1%
  in every chunk or by 5% in one of four, or its validity flags, or one
  percentile of the report).

The tiny runs are four chunks of eight trials, two rows of each in the
comparison's sample; the cells' own limits files judge them."""

import json
import shutil
import time

import pytest
import torch

from benchmark.harness import main as hmain
from benchmark.harness import spec

MC = "letf_tpu_torch.parallel.mc_runner"
TINY = dict(loop="closed", clients=1, trials=32, years=1, tax_mode="none",
            percentiles=[10, 25, 40, 50, 60, 75, 90], check_rows=8)


@pytest.fixture
def tiny(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
    for c in b["configs"]:
        cfg = json.loads((spec.HERE.parent / c["file"]).read_text())
        cfg["chunk_trials"] = 8
        (tmp_path / f"{c['name']}.json").write_text(json.dumps(cfg))
        c["file"] = f"{c['name']}.json"
    (bench / "traffic" / "tiny.json").write_text(json.dumps(TINY))
    for w in list(b["workloads"]):
        w2 = dict(w, name=f"tiny_{w['name']}", traffic="tiny")
        b["workloads"].append(w2)
        shutil.copy(bench / "limits" / f"{w['name']}.json",
                    bench / "limits" / f"tiny_{w['name']}.json")
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"tiny_{n}" for n in m["workloads"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path, bench


def run_cell(tiny, capsys, cell, seed=2**32 + 5, seconds=0.1, trace=0):
    root, bench = tiny
    torch.set_num_threads(2)
    rc = hmain.main(["--workload", cell, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)], root,
                    time.perf_counter(), bench=bench, device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return res


def wrap(monkeypatch, attr, after):
    import importlib

    mod = importlib.import_module(MC)
    inner = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a, **k: after(inner(*a, **k),
                                                          *a, **k))


def unchanged(out, *a, **k):
    out["final_wealth"] = torch.full_like(out["final_wealth"], 10000.0)
    out["max_dd"] = torch.zeros_like(out["max_dd"])
    out["num_trades"] = torch.zeros_like(out["num_trades"])
    return out


def half_in_chunk(out, *a, **k):
    for v in out.values():
        n = v.shape[0]
        v[n // 2:] = v[:n - n // 2].clone()
    return out


def altered_in_chunk(out, *a, **k):
    out["final_wealth"] = out["final_wealth"] * 1.01
    return out


def altered_in_one_chunk(out, *a, **k):
    altered_in_one_chunk.calls += 1
    if altered_in_one_chunk.calls == 3:            # the report's second
        out["final_wealth"] = out["final_wealth"] * 1.05
    return out


def flags_flipped(out, *a, **k):
    out["valid"] = ~out["valid"]
    return out


def altered_in_report(rep, *a, **k):
    rep["strategies"]["S7"]["wealth"]["p50"] *= 1.001
    return rep


@pytest.mark.parametrize("cell", ["tiny_inst_pretax_1m",
                                  "tiny_param_pretax_16k"])
def test_a_sound_run_is_correct(tiny, capsys, cell):
    res = run_cell(tiny, capsys, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"pretax_trial_years_per_s", "setup_s"}


def test_a_traced_run_is_correct_and_reads_its_layers(tiny, capsys):
    """The traced window (the labelled first report, then its spans taken
    off) keeps the capture that the comparison reads from the last report;
    the clocks read the host's time here."""
    res = run_cell(tiny, capsys, "tiny_param_pretax_16k", seconds=45.0,
                   trace=1)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2
    assert {"draws_ms", "path_scan_ms", "device_idle_pct.pretax"} <= set(
        res["metrics"]), res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["unchanged", "half_in_chunk",
                                   "half_in_reduction", "altered_in_chunk",
                                   "altered_in_one_chunk", "flags_flipped",
                                   "altered_in_report"])
def test_a_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch,
                                            fault):
    if fault == "half_in_reduction":
        import importlib

        mod = importlib.import_module(MC)
        inner = mod.reduce_report

        def half(fw, mdd, nt, valid, repaired, path_finite, vix_ok, *a):
            h = fw.shape[0] // 2
            return inner(fw[:h], mdd[:h], nt[:h], valid[:h], repaired[:h],
                         path_finite[:h], vix_ok[:h], *a)

        monkeypatch.setattr(mod, "reduce_report", half)
    elif fault == "altered_in_report":
        wrap(monkeypatch, "monte_carlo_report", altered_in_report)
    else:
        altered_in_one_chunk.calls = 0
        wrap(monkeypatch, "slab_chunk_summaries",
             {"unchanged": unchanged, "half_in_chunk": half_in_chunk,
              "altered_in_chunk": altered_in_chunk,
              "altered_in_one_chunk": altered_in_one_chunk,
              "flags_flipped": flags_flipped}[fault])
    res = run_cell(tiny, capsys, "tiny_inst_pretax_1m")
    assert not res["correct"], res["checks"]
