"""A configuration (with its model), a traffic mix (with its tax mode's
part of the comparison), a per-layer metric and a roofline count each join
the benchmark as new files plus new entries in BENCHMARK.json: the harness
finds them by name and no existing file changes."""

import hashlib
import json
import shutil

import pytest

from benchmark.harness import spec
from benchmark.harness.main import Run
from benchmark.harness.trace import summarize


def digest(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted(folder.rglob("*")) if p.is_file()
        and "__pycache__" not in p.parts}


@pytest.fixture
def tree(tmp_path):
    """A checkout's BENCHMARK.json and a copy of the benchmark's folder."""
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.HERE.parent / "BENCHMARK.json", tmp_path)
    return tmp_path, bench


def test_new_files_join_by_name(tree):
    root, bench = tree
    before = digest(bench)
    # the new files
    cfg = json.loads((bench / "configs" / "institutional_30y.json")
                     .read_text())
    cfg["chunk_trials"] = 8192
    cfg["model"] = "model_probe"
    (bench / "configs" / "institutional_half_chunk.json").write_text(
        json.dumps(cfg))
    (bench / "models" / "model_probe.py").write_text(
        "def program():\n    return 'program tables'\n\n\n"
        "def reference():\n    return 'reference tables'\n")
    (bench / "traffic" / "pretax_4k_2y.json").write_text(json.dumps(dict(
        loop="closed", clients=1, trials=4096, years=2, tax_mode="probe",
        percentiles=[10, 50, 90], check_rows=16)))
    (bench / "reference" / "tax_modes" / "probe.py").write_text(
        "def numbers(cell, report, seed):\n"
        "    return {'probe_gap': float(report['gap'])}\n")
    (bench / "metrics" / "k9_launches.py").write_text(
        "def read(run):\n    return run.trace.kernel('k9_kernel')[1]\n")
    (bench / "rooflines" / "k9.py").write_text(
        "KERNEL = 'k9_kernel'\n\n\ndef count(shape):\n"
        "    return 0, 4 * shape['trials'] * shape['sim_days']\n")
    # the new entries
    b = json.loads((root / "BENCHMARK.json").read_text())
    src = "https://github.com/djbm10/LETF-Monte-Carlo"
    b["configs"].append({"name": "institutional_half_chunk", "source": src,
                         "file": "benchmark/configs/"
                                 "institutional_half_chunk.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "half_chunk_4k", "config":
                           "institutional_half_chunk", "traffic":
                           "pretax_4k_2y", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "k9_launches", "unit": "launches",
                           "better": "lower", "source": "device_trace",
                           "layer": "kernels", "moves":
                           "pretax_trial_years_per_s",
                           "workloads": ["half_chunk_4k"]})
    for m in b["end_to_end"]:
        if m["name"] == "pretax_trial_years_per_s":
            m["workloads"].append("half_chunk_4k")
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell(root, "half_chunk_4k", bench)
    assert cell.config["chunk_trials"] == 8192
    assert cell.traffic["trials"] == 4096
    model = spec.model(cell.config["model"], bench)
    assert (model.program(), model.reference()) == ("program tables",
                                                     "reference tables")
    assert spec.tax_mode(cell.traffic["tax_mode"], bench).numbers(
        cell, {"gap": 0.5}, 1) == {"probe_gap": 0.5}
    assert [m["name"] for m in cell.end_to_end] == [
        "pretax_trial_years_per_s", "setup_s"]
    assert "k9_launches" in [m["name"] for m in cell.per_layer]
    run = Run(cell, bench)
    run.trace = summarize([("k9_kernel(x)", 0, 5), ("k9_kernel(x)", 6, 8)],
                          [], 0, 10)
    assert spec.metric_reader("k9_launches", bench).read(run) == 2
    # the roofline of a new kernel: bytes over the memory rate
    pct = run.roofline_pct("k9")
    want = 4 * 4096 * 504 / 3.35e12 * 2 / 7e-6 * 100
    assert pct == pytest.approx(want)
    after = digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_cell_finds_its_files():
    b = json.loads((spec.HERE.parent / "BENCHMARK.json").read_text())
    for w in b["workloads"]:
        cell = spec.load_cell(spec.HERE.parent, w["name"])
        assert cell.limits, w["name"]
        for m in cell.per_layer:
            assert hasattr(spec.metric_reader(m["name"]), "read")
        spec.engine(cell.config["engine_mode"])
        spec.tax_mode(cell.traffic["tax_mode"])
        assert hasattr(spec.model(cell.config["model"]), "reference")
    for name in ("k1", "k3"):
        assert spec.roofline(name).KERNEL
