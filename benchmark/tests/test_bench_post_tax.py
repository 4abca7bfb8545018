"""The default report's cell (``inst_sampled_1m``, tax mode ``sampled``):
its files join by name, its plain post-tax reference imports nothing of
the port or JAX, and whole CPU runs at a tiny traffic (16 trials x 1 y in
two chunks of eight, every trial sampled) come out correct when sound and
not correct with the timed path broken underneath: every strategy's
sampled taxes +1%, one strategy's +20%, the picks shifted by one sorted
position, a post-tax fan altered by 0.1%, the sample left out of the
report. The cell's own limits file judges them.

Two breaks stay below those limits, which the card's sound spread sets:
one strategy's taxes +1% (a strategy's median tax gap reads up to 1.9%
on sound card runs, the float32 paths' rebalances near their thresholds)
and the tax bridge in float32 (at 1 y its share coordinates are small;
at 30 y on the card its taxes read as the float64 bridge's within the
sound spread). PERF.md keeps the readings."""

import dataclasses
import importlib
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.harness import main as hmain
from benchmark.harness import spec
from benchmark.harness.main import Run

CELL = "inst_sampled_1m"
READERS = ("post_tax_ms", "post_tax_replay_ms", "post_tax_bridge_ms",
           "post_tax_syncs_per_report")
TINY = dict(loop="closed", clients=1, trials=16, years=1,
            tax_mode="sampled", percentiles=[10, 25, 40, 50, 60, 75, 90],
            check_rows=8, max_tax_sims=50, check_taxes_per_strategy=4)


def test_the_cell_and_its_files_join_by_name():
    cell = spec.load_cell(spec.HERE.parent, CELL)
    assert cell.traffic["tax_mode"] == "sampled"
    assert cell.traffic["trials"] == 1048576 and cell.traffic["years"] == 30
    assert cell.chips == 1
    assert cell.config["name"] == "institutional_taxable_30y"
    assert cell.config["post_tax"]["max_tax_sims"] == 50
    assert cell.config["reduced"] == []
    assert [m["name"] for m in cell.end_to_end] == [
        "pretax_trial_years_per_s", "setup_s"]
    assert set(READERS) <= {m["name"] for m in cell.per_layer}
    mode = spec.tax_mode("sampled")
    assert callable(mode.numbers)
    numbers = {"sample_mismatch", "pick_mismatches", "post_fan_max_gap",
               "median_tax_gap", "sample_wealth_max_gap", "tax_median_gap",
               "tax_gap_share", "tax_strategy_gap"}
    assert numbers <= set(cell.limits)
    run = Run(cell, spec.HERE)
    for name in READERS:
        assert spec.metric_reader(name).read(run) is None


def test_the_post_tax_reference_imports_neither_the_port_nor_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "for m in ('jax', 'jaxlib', 'letf_tpu', 'letf_tpu_torch'):\n"
        "    sys.modules[m] = None\n"
        "from benchmark.harness import spec\n"
        "import benchmark.reference.post_tax\n"
        "spec.tax_mode('sampled')\n"
        "print('ok')\n" % str(spec.HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "ok", out.stderr


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
    cell = next(w for w in b["workloads"] if w["name"] == CELL)
    b["workloads"].append(dict(cell, name=f"tiny_{CELL}", traffic="tiny",
                               why="tiny"))
    shutil.copy(bench / "limits" / f"{CELL}.json",
                bench / "limits" / f"tiny_{CELL}.json")
    for m in b["end_to_end"] + b["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append(f"tiny_{CELL}")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp_path, bench


def run_cell(tiny, capsys, seed=2**32 + 5):
    root, bench = tiny
    torch.set_num_threads(2)
    rc = hmain.main(["--workload", f"tiny_{CELL}", "--seed", str(seed),
                     "--seconds", "0.1", "--trace", "0"], root,
                    time.perf_counter(), bench=bench, device="cpu")
    out = capsys.readouterr()
    assert rc == 0, out.err
    return json.loads(out.out.strip().splitlines()[-1])


def test_a_sound_run_is_correct(tiny, capsys):
    res = run_cell(tiny, capsys)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["sample_mismatch"]["value"] == 0
    assert checks["post_fan_max_gap"]["value"] == 0


class _Shifted:
    """``numpy`` for ``reporting``, with its sorted-wealth positions one
    further up (the last stays the last)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def linspace(lo, hi, num, dtype=None):
        return np.minimum(np.linspace(lo, hi, num, dtype=dtype) + 1, hi)


def _report_fault(monkeypatch, change):
    mc = importlib.import_module("letf_tpu_torch.parallel.mc_runner")
    inner = mc.monte_carlo_report

    def broken(*a, **k):
        rep = inner(*a, **k)
        change(rep)
        return rep

    monkeypatch.setattr(mc, "monte_carlo_report", broken)


@pytest.mark.parametrize("fault", ["all_taxes_up_1pct", "s8_taxes_up_20pct",
                                   "picks_shifted", "post_fan_altered",
                                   "sample_missing"])
def test_a_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch,
                                            fault):
    reporting = importlib.import_module("letf_tpu_torch.reporting")
    if fault in ("all_taxes_up_1pct", "s8_taxes_up_20pct"):
        inner = reporting.bridge_tax
        f = 1.2 if fault == "s8_taxes_up_20pct" else 1.01

        def up(stacked, assets, *a, **k):
            total = inner(stacked, assets, *a, **k)
            hit = assets == (0, 1) or fault == "all_taxes_up_1pct"
            return total * f if hit else total

        monkeypatch.setattr(reporting, "bridge_tax", up)
    elif fault == "picks_shifted":
        monkeypatch.setattr(reporting, "np", _Shifted())
    elif fault == "post_fan_altered":
        def alter(rep):
            rep["strategies"]["S12"]["post_tax"]["wealth"]["p50"] *= 1.001
        _report_fault(monkeypatch, alter)
    else:
        _report_fault(monkeypatch, lambda rep: rep.pop("post_tax_sample"))
    res = run_cell(tiny, capsys)
    assert not res["correct"], res["checks"]


def test_the_configuration_and_the_traffic_sample_alike():
    cell = spec.load_cell(spec.HERE.parent, CELL)
    mode = spec.tax_mode("sampled")
    assert mode.max_tax_sims(cell) == 50
    other = dataclasses.replace(cell, config=dict(
        cell.config, post_tax=dict(cell.config["post_tax"], max_tax_sims=32)))
    with pytest.raises(ValueError, match="states 32"):
        mode.max_tax_sims(other)
