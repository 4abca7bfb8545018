"""Nothing the benchmark runs on the card imports JAX or the JAX package
(top-level module names compared whole: ``letf_tpu_torch`` is not
``letf_tpu``), and the reference imports nothing of the port."""

import ast
import subprocess
import sys

from benchmark.harness import main as hmain
from benchmark.harness import spec

BENCH = spec.HERE


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not top_level_imports(path) & set(hmain.BANNED), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "letf_tpu_torch" not in names, path
        assert not names & set(hmain.BANNED), path


def test_names_are_compared_whole(monkeypatch):
    for name in ("letf_tpu_torch", "letf_tpu_torch.ops.rng", "jaxtyping",
                 "flax_like"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert hmain.banned_modules() == []
    monkeypatch.setitem(sys.modules, "letf_tpu.config", sys)
    assert hmain.banned_modules() == ["letf_tpu"]


def test_a_run_loads_neither():
    """The modules a run loads (the harness, the port's report and its
    kernels' wrappers, the reference) hold no banned top-level name."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import main, program, checks, spec\n"
        "import letf_tpu_torch.parallel.mc_runner, letf_tpu_torch.reporting\n"
        "for m in ('institutional_v1', 'parametric'): spec.engine(m)\n"
        "import benchmark.tools.control\n"
        "print(main.banned_modules())\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
    reference_only = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.harness import spec\n"
        "for m in ('institutional_v1', 'parametric'): spec.engine(m)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'letf_tpu', 'letf_tpu_torch', 'jax'}))\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", reference_only],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
