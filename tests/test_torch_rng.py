"""The port's RNG: threefry ops bitwise equal to ``jax.random``
(partitionable mode), the murmur3 counter mixers bitwise equal to the
Pallas kernels' and to ``path_batched.counter_uniforms``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops import pallas_compose, pallas_joint
from letf_tpu.ops import path_batched as jpb
from letf_tpu_torch.ops import compose, rng
from letf_tpu_torch.ops.joint import six_normals
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEEDS = (0, 7, 2, 123456789, 2**40 + 5)
IDS = np.arange(0, 40000, 37)


def key_data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def trial_keys(seed):
    k = jax.random.key(seed)
    jk = jax.vmap(lambda t: jax.random.fold_in(k, t))(
        jnp.asarray(IDS, jnp.int32))
    return jk, rng.fold_in(rng.key(seed), torch.as_tensor(IDS))


def test_threefry_partitionable_mode():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bits(seed):
    np.testing.assert_array_equal(key_data(jax.random.key(seed)),
                                  rng.key(seed).numpy())
    jk, tk = trial_keys(seed)
    np.testing.assert_array_equal(key_data(jk), tk.numpy())
    for sid in (0, 1, 9):
        np.testing.assert_array_equal(
            key_data(jax.vmap(lambda k: jax.random.fold_in(k, sid))(jk)),
            rng.stream(tk, sid).numpy())
    np.testing.assert_array_equal(
        key_data(jax.vmap(lambda k: jax.random.split(k, 3))(jk)),
        rng.split(tk, 3).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.bits(
            k, (5,), dtype=jnp.uint32))(jk)).astype(np.int64),
        rng.random_bits(tk, 5).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform(seed, dtype):
    jk, tk = trial_keys(seed)
    ref = jax.vmap(lambda k: jax.random.uniform(
        k, (4,), dtype=getattr(jnp, dtype)))(jk)
    got = rng.uniform(tk, 4, getattr(torch, dtype))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_randint(seed, dtype):
    """Two draws combined modulo the span; 64-bit draws in x64 mode."""
    jk, tk = trial_keys(seed)
    for lo, hi in ((50, 1260), (31, 126), (0, 400), (0, 7), (3, 3)):
        ref = jax.vmap(lambda k: jax.random.randint(
            k, (), lo, hi, dtype=getattr(jnp, dtype)))(jk)
        got = rng.randint(tk, lo, hi, getattr(torch, dtype))
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
        assert got.dtype == getattr(torch, dtype)


def test_murmur_mixers_and_counter_uniforms():
    x = np.random.default_rng(0).integers(0, 2**32, 20000, dtype=np.uint64)
    x = x.astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(pallas_joint._mix(jnp.asarray(x))).astype(np.int64),
        rng.mix(torch.as_tensor(x.astype(np.int64))).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpb._mix_u32(jnp.asarray(x))).astype(np.int64),
        rng.mix(torch.as_tensor(x.astype(np.int64))).numpy())
    for idx in (1, 6, 16, 20, 42):
        np.testing.assert_array_equal(
            np.asarray(pallas_compose._stream_bits(jnp.asarray(x), idx))
            .astype(np.int64),
            rng.stream_bits(torch.as_tensor(x.astype(np.int64)), idx).numpy())
    jk, tk = trial_keys(7)
    for n in (64, 131):
        np.testing.assert_array_equal(
            np.asarray(jpb.counter_uniforms(jk, n)),
            rng.counter_uniforms(tk, n).numpy())


def test_counter_draws_match_the_kernels_helpers(monkeypatch):
    """Day keys and the Box-Muller / uniform / polar-t draws built on
    them. The keys and uniforms are bitwise; the transcendental draws
    (log/cos/sin/exp) agree to f32 ulps between XLA:CPU and torch."""
    # pltpu.bitcast evaluates only inside a kernel; bits >> 8 < 2**24, so
    # the value conversion below is the same uint32 -> int32 reading.
    monkeypatch.setattr(
        pallas_compose, "_bits_to_unit",
        lambda bits: ((bits >> 8).astype(jnp.int32).astype(jnp.float32)
                      * (1.0 / 16777216.0) + (0.5 / 16777216.0)))
    ids = np.arange(512, dtype=np.int32) // 2
    seed = (123, 456)
    lane = pallas_joint._mix(jnp.asarray(ids).astype(jnp.uint32)
                             * pallas_joint._GOLD ^ np.uint32(seed[0]))
    days = jnp.arange(40, dtype=jnp.uint32)
    dkeys = pallas_joint._mix(lane[None, :] ^ (days[:, None]
                                               * pallas_joint._DAY_PRIME)
                              ^ np.uint32(seed[1]))
    tl = rng.lane_keys(torch.as_tensor(ids), seed)
    td = rng.day_keys(tl, torch.arange(40), seed)
    np.testing.assert_array_equal(np.asarray(dkeys).astype(np.int64),
                                  td.numpy())
    np.testing.assert_array_equal(
        np.asarray(pallas_compose._uniforms(dkeys, 20, 1)[0]),
        compose.uniforms(td, 20, 1)[0].numpy())
    for a, b in zip(pallas_compose._normals(dkeys, 1, 6), six_normals(td)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    for df in (5.0, 10.0):
        np.testing.assert_allclose(
            np.asarray(pallas_compose._t_polar(dkeys, 32, df)),
            compose.t_polar(td, 32, df).numpy(), rtol=1e-5, atol=1e-6)
