"""BENCHMARK.json and the files it names, joined by name.

A cell (``workloads`` entry) names a configuration (``configs/<file>``,
given by the configuration's entry) and a traffic mix
(``benchmark/traffic/<traffic>.json``); its comparison limits are
``benchmark/limits/<cell>.json``; a per-layer metric's reader is
``benchmark/metrics/<metric>.py``, a kernel's roofline count
``benchmark/rooflines/<kernel>.py``. A configuration's ``model`` is
``benchmark/models/<model>.py``, its ``engine_mode`` a plain engine
``benchmark/reference/engines/<mode>.py``, and a traffic's ``tax_mode``
the comparison's part ``benchmark/reference/tax_modes/<mode>.py``. Adding
any of them is adding a file and an entry: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent.parent      # the benchmark's folder


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file, with its entry's name
    traffic: dict           # the traffic mix's file, with its name
    limits: Dict[str, float]
    end_to_end: List[dict]  # the cell's end-to-end metrics (entries)
    per_layer: List[dict]   # the cell's per-layer metrics (entries)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str, bench: Path = HERE) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json. ``bench`` is the
    benchmark's folder (where traffic, limits, metrics and rooflines lie)."""
    spec = _read_json(Path(root) / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    entry = configs[w["config"]]
    config = dict(_read_json(Path(root) / entry["file"]), name=entry["name"])
    traffic = dict(_read_json(bench / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    limits_file = bench / "limits" / f"{workload}.json"
    limits = _read_json(limits_file) if limits_file.exists() else {}
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    for m in spec["per_layer"]:
        if "workloads" not in m:
            raise KeyError(f"per-layer metric {m['name']!r} lists no "
                           "workloads: each names the cells it reads")
    layer = [m for m in spec["per_layer"] if workload in m["workloads"]]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                layer)


def load_module(path: Path, name: str) -> ModuleType:
    """A reader or count file as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench: Path = HERE) -> ModuleType:
    """``benchmark/metrics/<name>.py``: ``install(run)`` (optional, before
    the traced window) and ``read(run)`` -> a number or None."""
    return load_module(bench / "metrics" / f"{name}.py",
                       f"benchmark_metric_{name.replace('.', '_')}")


def roofline(kernel: str, bench: Path = HERE) -> ModuleType:
    """``benchmark/rooflines/<kernel>.py``: ``KERNEL`` (the device
    kernel's name as the trace gives it) and ``count(shape)`` -> (float32
    operations, bytes) of one launch."""
    return load_module(bench / "rooflines" / f"{kernel}.py",
                       f"benchmark_roofline_{kernel}")


def engine(mode: str, bench: Path = HERE) -> ModuleType:
    """``benchmark/reference/engines/<mode>.py``, the plain reference
    engine of an engine mode: ``summaries(rows, seed, years, config,
    glue=..., device=...)`` -> the rows' summaries as host arrays."""
    return load_module(bench / "reference" / "engines" / f"{mode}.py",
                       f"benchmark_engine_{mode}")


def tax_mode(mode: str, bench: Path = HERE) -> ModuleType:
    """``benchmark/reference/tax_modes/<mode>.py``, the comparison's part
    for a traffic's tax mode: ``numbers(cell, report, seed)``."""
    return load_module(bench / "reference" / "tax_modes" / f"{mode}.py",
                       f"benchmark_tax_mode_{mode}")


def model(name: str, bench: Path = HERE) -> ModuleType:
    """``benchmark/models/<name>.py``: ``program()`` (the port's model
    tables) and ``reference()`` (the plain reference's)."""
    return load_module(bench / "models" / f"{name}.py",
                       f"benchmark_model_{name}")

