"""Kernel K8 (wash-sale replacement matching) of the port: its plain
PyTorch version bitwise against ``wash_matching_pallas`` in interpret mode
and against the reference scan ``_wash_matching_scan``.

Inputs as tests/test_device_bridge.py:115 makes them: sparse buys, sells
and losses on half the sells, so losses without an eligible replacement,
used-buy exclusion, window-edge days and partial fractions all occur. The
port's layout is [S, B] (days first)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops.pallas_wash import wash_matching_pallas
from letf_tpu.tax.device_bridge import _wash_matching_scan
from letf_tpu_torch.ops.wash import wash_matching

B, S = 1024, 300


def _inputs(dtype):
    rng = np.random.default_rng(11)
    buy = np.where(rng.random((B, S)) < 0.25, rng.gamma(2.0, 3.0, (B, S)),
                   0.0)
    sell = np.where(rng.random((B, S)) < 0.15, rng.gamma(2.0, 4.0, (B, S)),
                    0.0)
    loss = np.where(rng.random((B, S)) < 0.5, rng.gamma(2.0, 50.0, (B, S)),
                    0.0)
    loss = np.where(sell > 0, loss, 0.0)
    return [a.astype(dtype) for a in (loss, sell, buy)]


def _port(arrays):
    return wash_matching(*[torch.as_tensor(a.T.copy()) for a in arrays])


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(w))


@pytest.fixture(scope="module")
def f32():
    arrays = _inputs(np.float32)
    return arrays, _port(arrays)


def test_wash_plain_matches_pallas_bitwise(f32):
    arrays, got = f32
    _equal(got, wash_matching_pallas(*[jnp.asarray(a) for a in arrays],
                                     interpret=True))
    assert got[2].sum() > 1000 and (got[1].abs() == 30).any()


def test_wash_plain_matches_scan_bitwise(f32):
    arrays, got = f32
    _equal(got, _wash_matching_scan(*[jnp.asarray(a) for a in arrays]))


def test_wash_plain_matches_scan_float64():
    arrays = _inputs(np.float64)
    _equal(_port(arrays),
           _wash_matching_scan(*[jnp.asarray(a) for a in arrays]))
