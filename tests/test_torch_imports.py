"""The port imports torch and nothing of JAX, the JAX package, pandas or
the network data loaders; nothing falls back to the CPU; the port's copies
of the JAX package's tax statute, income path and tax configuration equal
their originals."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as hst

import letf_tpu_torch
from letf_tpu import income as jincome
from letf_tpu import reporting as jreporting
from letf_tpu.models.params import default_sim_model
from letf_tpu.tax import brackets as jbrackets
from letf_tpu.tax import engine as jengine
from letf_tpu_torch import income, reporting
from letf_tpu_torch.tax import brackets, engine

PKG = Path(letf_tpu_torch.__file__).resolve().parent
# The JAX package (every module of it, even those that import no JAX),
# JAX itself, and pandas with the network loaders: the card's machine has
# no pandas, and the port's data layer is its own day frame. (The data
# layer's downloads load a network loader through importlib, and only when
# they are called: no import statement names one.)
REFUSED = ("jax", "jaxlib", "letf_tpu", "pandas", "pandas_datareader",
           "yfinance")
ROOT = PKG.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in PKG.rglob("*.py"))


def chip_smoke_imports():
    """Every module chip_smoke.py imports, at the top or in a function."""
    names = set()
    for node in ast.walk(ast.parse((ROOT / "chip_smoke.py").read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    return sorted(names)


def test_port_imports_nothing_of_jax_in_a_fresh_interpreter():
    """An import hook that refuses jax, letf_tpu (the JAX package, every
    module of it, even those that import no JAX), pandas,
    pandas_datareader and yfinance is installed before anything else;
    every port module and every chip_smoke.py import must still load
    (conftest already imported jax in this process)."""
    mods = MODULES + chip_smoke_imports() + ["chip_smoke"]
    code = ("import sys\n"
            "class Refuse:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {REFUSED!r}:\n"
            "            raise ImportError('refused: ' + name)\n"
            "        return None\n"
            "sys.meta_path.insert(0, Refuse())\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            f"             {REFUSED + ('triton',)!r})\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok"), out.stdout
    assert "letf_tpu_torch.ops.strategies" in MODULES
    assert "letf_tpu_torch.ops.gbm" in MODULES
    for m in ("calibration", "data", "runner", "cli", "utils.frame",
              "models.bootstrap", "diagnose", "oracle", "strategies.host",
              "tqqq", "income", "utils.finance", "utils.profiling"):
        assert f"letf_tpu_torch.{m}" in MODULES


def test_sources_have_no_jax_import_and_no_fallback():
    """No module of the port, and not chip_smoke.py, imports jax, any
    module of the JAX package, pandas or the network loaders (the
    allow-list is empty); kernel wrappers have no torch.compile and no try
    around a build or launch."""
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                if path.parent != ROOT:
                    assert not isinstance(node, ast.Try), path
                continue
            for n in names:
                assert n.split(".")[0] not in REFUSED, (path, n)
        assert "torch.compile" not in path.read_text(), path


def test_the_one_exception_boundary():
    """utils/guard.guarded, which hands back what a call raised, is called
    only by the chunk containment and the network downloads."""
    callers = set()
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "guarded"):
                fn = next(f.name for f in ast.walk(tree)
                          if isinstance(f, ast.FunctionDef)
                          and f.lineno <= node.lineno <= f.end_lineno
                          and f.name != "probe")
                callers.add((path.relative_to(PKG).as_posix(), fn))
    assert callers == {("parallel/mc_runner.py", "_context_poisoned"),
                       ("parallel/mc_runner.py", "_dispatch_guarded"),
                       ("data.py", "fetch_fama_french_data"),
                       ("data.py", "fetch_market_data")}, callers


def test_cuda_device_without_a_card_raises():
    import torch

    from letf_tpu_torch.parallel import mc_runner

    if torch.cuda.is_available():
        pytest.skip("a card is present: the device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        mc_runner.monte_carlo_report(default_sim_model(), 1,
                                     num_simulations=8, tax_mode="none")


_money = hst.floats(0.0, 5e5, allow_nan=False)


@settings(max_examples=200, deadline=None)
@given(hst.lists(hst.tuples(_money, _money, _money, _money), min_size=1,
                 max_size=6),
       hst.sampled_from(list(engine.CapitalLossUsageStrategy)))
def test_net_core_copy_equals_the_original(years, strategy):
    """The port's _net_core over random year sequences, carrying the
    carryforwards from year to year, equals the JAX package's scalar core
    under every election."""
    jstrategy = jengine.CapitalLossUsageStrategy(strategy.value)
    cf = (0.0, 0.0)
    jcf = (0.0, 0.0)
    for sg, sl, lg, ll in years:
        got = engine._net_core(sg, sl, lg, ll, *cf, strategy, (min, max))
        ref = jengine._net_core(sg, sl, lg, ll, *jcf, jstrategy, (min, max))
        assert got == ref
        cf, jcf = got[2:4], ref[2:4]


def test_brackets_income_and_tax_config_copies_equal():
    for n in ("STATE_TAX_BRACKETS", "FEDERAL_TAX_BRACKETS_2024",
              "LTCG_BRACKETS_2024", "STANDARD_DEDUCTION_2024",
              "NIIT_THRESHOLD_2024", "NIIT_RATE"):
        assert getattr(brackets, n) == getattr(jbrackets, n), n
    for table in (brackets.FEDERAL_TAX_BRACKETS_2024["single"],
                  brackets.STATE_TAX_BRACKETS["NJ"]["married"]):
        for a, b in zip(brackets.bracket_arrays(table),
                        jbrackets.bracket_arrays(table)):
            np.testing.assert_array_equal(a, b)
    for kw in ({}, {"years_until_retirement": 7},
               {"years_until_retirement": 3, "retirement_income": 60000.0}):
        np.testing.assert_array_equal(
            income.simulate_wired_income_path(150000, 30, **kw),
            jincome.simulate_wired_income_path(150000, 30, **kw))
    assert reporting.MAX_TAX_SIMS == jreporting.MAX_TAX_SIMS
    assert reporting.STATE_TAX_INFO == jreporting.STATE_TAX_INFO
    assert reporting.DEFAULT_TAX_CONFIG == jreporting.DEFAULT_TAX_CONFIG
    cfg = dict(jreporting.DEFAULT_TAX_CONFIG, years_until_retirement=12)
    assert reporting._income_kwargs(cfg) == jreporting._income_kwargs(cfg)
