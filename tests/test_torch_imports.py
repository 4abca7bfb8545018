"""The port imports torch and never jax; nothing falls back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

import letf_tpu_torch
from letf_tpu.models.params import default_sim_model

PKG = Path(letf_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def test_port_imports_no_jax():
    """In a fresh interpreter (conftest already imported jax here)."""
    code = ("import sys\n"
            "import letf_tpu_torch, letf_tpu_torch.parallel.mc_runner\n"
            "import letf_tpu_torch.ops.slab_chunk, letf_tpu_torch.reporting\n"
            "import letf_tpu_torch.tax.device_bridge\n"
            "import letf_tpu_torch.tax.vectorized\n"
            "import letf_tpu_torch.strategies.engine\n"
            "import letf_tpu_torch.strategies.host\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n"
            "assert 'triton' not in sys.modules\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_have_no_jax_import_and_no_fallback():
    """No module imports jax or the JAX package's jax-importing modules
    (only its NumPy-only config, model tables, reporting constants, income
    path and tax statute); kernel wrappers have no torch.compile and no try
    around a build or launch."""
    allowed = {"letf_tpu.config", "letf_tpu.models.params",
               "letf_tpu.reporting", "letf_tpu.income", "letf_tpu.tax.engine",
               "letf_tpu.tax.brackets"}
    for path in PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [f"{node.module}.{a.name}" for a in node.names]
            else:
                assert not isinstance(node, ast.Try), path
                continue
            for n in names:
                assert n.split(".")[0] != "jax", (path, n)
                if n.split(".")[0] == "letf_tpu":
                    assert any(n == a or n.startswith(a + ".")
                               for a in allowed), (path, n)
        assert "torch.compile" not in path.read_text(), path


def test_cuda_device_without_a_card_raises():
    import torch

    from letf_tpu_torch.parallel import mc_runner

    if torch.cuda.is_available():
        pytest.skip("a card is present: the device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        mc_runner.monte_carlo_report(default_sim_model(), 1,
                                     num_simulations=8, tax_mode="none")
