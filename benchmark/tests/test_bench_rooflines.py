"""The kernels' roofline counts at the main path's chunk (16,384 trials,
30 years and a 5-year buffer): K1 is bound by its bytes at 1.035 ms, K3
by its operations at 3.697 ms."""

import pytest

from benchmark.harness import spec
from benchmark.harness.peaks import PEAK_BYTES, PEAK_F32, bound_s

CHUNK = dict(trials=16384, sim_days=30 * 252, buffer_days=5 * 252)


def test_k1_bound():
    ops, nbytes = spec.roofline("k1").count(CHUNK)
    assert nbytes == 6 * 8820 * 16384 * 4 + 8 * 16384
    assert nbytes / PEAK_BYTES > ops / PEAK_F32
    assert bound_s(ops, nbytes) * 1e3 == pytest.approx(1.035, abs=5e-4)


def test_k3_bound():
    ops, nbytes = spec.roofline("k3").count(CHUNK)
    assert ops == 2000 * 7560 * 16384
    assert ops / PEAK_F32 > nbytes / PEAK_BYTES
    assert bound_s(ops, nbytes) * 1e3 == pytest.approx(3.697, abs=5e-4)


def test_kernel_names_are_the_sources():
    root = spec.HERE.parent / "letf_tpu_torch" / "csrc"
    for kernel, src in (("k1", "joint.cu"), ("k3", "compose_strategies.cu")):
        name = spec.roofline(kernel).KERNEL
        assert f"\n{name}(" in (root / src).read_text()
