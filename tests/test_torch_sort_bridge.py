"""Kernel K7 (the bridge's column sorts) of the port: its plain PyTorch
version against ``pallas_sort.sort_bridge`` in interpret mode, bitwise.

As tests/test_pallas_sort.py does for the Pallas networks: non-negative
float32 keys with heavy ties, the bridge's unique packed secondary
(tag << 24) | position, every kind, 0/2/4/5 payloads, head_payloads_zero,
zero and +inf keys, the int32 restore-sort form, and the float64 keys of
the CPU parity suite against ``lax.sort``. The port keeps the day axis
first, so its [N, R] columns are the reference's [R, N] rows transposed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops.pallas_sort import sort_bridge as jax_sort_bridge
from letf_tpu_torch.ops.sort_bridge import sort_bridge, sort_bridge_plain


def _mk(rng, R, S, kind, n_pay, head_zero=False):
    N = 2 * S
    key = np.abs(rng.standard_normal((R, N)).astype(np.float32))
    key = np.round(key * 4) / 4
    key[:, S:] = np.sort(key[:, S:], axis=1)
    if kind == "merge":
        key[:, :S] = np.sort(key[:, :S], axis=1)
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (R, N)).copy()
    pays = [rng.standard_normal((R, N)).astype(np.float32)
            for _ in range(n_pay)]
    if head_zero:
        for p in pays:
            p[:, :S] = 0.0
    return key, sec, pays


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).T))


def _check(key, sec, pays, kind, head_zero=False):
    want = jax_sort_bridge(jnp.asarray(key), None if sec is None
                           else jnp.asarray(sec),
                           tuple(jnp.asarray(p) for p in pays), kind=kind,
                           interpret=True, head_payloads_zero=head_zero)
    got = sort_bridge(_t(key), None if sec is None else _t(sec),
                      tuple(_t(p) for p in pays), kind=kind,
                      head_payloads_zero=head_zero)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(w))


@pytest.mark.parametrize("kind", ["merge", "valley", "sort"])
@pytest.mark.parametrize("n_pay", [0, 2, 4, 5])
def test_sort_bridge_plain_bitwise(kind, n_pay):
    rng = np.random.default_rng(7)
    _check(*_mk(rng, 130, 13, kind, n_pay), kind)


def test_sort_bridge_head_payloads_zero():
    rng = np.random.default_rng(17)
    _check(*_mk(rng, 64, 24, "valley", 3, head_zero=True), "valley",
           head_zero=True)


def test_sort_bridge_zero_and_inf_keys():
    R, S = 128, 8
    N = 2 * S
    key = np.zeros((R, N), np.float32)
    key[::3, S:] = np.inf
    tag = (np.arange(N) >= S).astype(np.int32)
    sec = np.broadcast_to((tag << 24) | np.arange(N, dtype=np.int32),
                          (R, N)).copy()
    pay = np.arange(R * N, dtype=np.float32).reshape(R, N)
    for kind in ("merge", "valley"):
        _check(key, sec, [pay], kind)


def test_sort_bridge_i32_primary():
    rng = np.random.default_rng(11)
    R, N = 128, 32
    perm = np.stack([rng.permutation(N) for _ in range(R)]).astype(np.int32)
    pay = rng.standard_normal((R, N)).astype(np.float32)
    _check((perm << 2) | 1, None, [pay], "sort")


@pytest.mark.parametrize("kind", ["merge", "valley"])
def test_sort_bridge_float64_matches_lax_sort(kind):
    """The CPU parity suite's float64 keys: two stable passes (sec, then
    key) equal lax.sort(num_keys=2, is_stable=True)."""
    rng = np.random.default_rng(5)
    key, sec, pays = _mk(rng, 40, 30, kind, 2)
    key = key.astype(np.float64) + 1e-12 * (key > 1)
    pays = [p.astype(np.float64) for p in pays]
    want = jax.lax.sort((jnp.asarray(key), jnp.asarray(sec))
                        + tuple(jnp.asarray(p) for p in pays), dimension=1,
                        num_keys=2, is_stable=True)
    got = sort_bridge_plain(_t(key), _t(sec), tuple(_t(p) for p in pays),
                            kind=kind)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().T, np.asarray(w))
