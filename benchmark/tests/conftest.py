"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

They run on the CPU; a test that needs a card carries the ``cuda`` marker
(as the port's tests do) and skips without one, deciding inside the test.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA "
        "kernels)")
