"""The port's samplers against ``jax.random`` (partitionable threefry):
``erf_inv``, ``normal``, ``gamma`` and ``t`` in float32 and float64.

The keys, counters and uniforms are bitwise (tests/test_torch_rng.py); the
arithmetic is JAX's op for op, but XLA:CPU's ``log1p``/``log`` differ from
torch's by an ulp and XLA contracts ``u * (hi - lo) + lo`` into an FMA, so
the draws agree to a few ulps, not bit for bit. Bounds: erf_inv within 2
ulps (f32) and 32 ulps (f64, where the polynomial amplifies a 1-ulp w);
draws within a relative 2e-6 (f32) / 4e-14 (f64) plus an absolute 2e-7 /
1e-15 near zero (the FMA). A rejection flip in the gamma loop would change
a draw by far more than that: the bounds show there is none at these
seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu_torch.ops import rng
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DT = {"float32": (torch.float32, jnp.float32, np.int32, 2e-6, 2e-7),
      "float64": (torch.float64, jnp.float64, np.int64, 4e-14, 1e-15)}


def keys(seed, n=256):
    ks = jax.random.split(jax.random.key(seed), n)
    return ks, torch.as_tensor(
        np.asarray(jax.random.key_data(ks)).astype(np.int64))


def close(got, ref, dtype):
    _, _, _, rtol, atol = DT[dtype]
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    err = np.abs(got - ref)
    assert (err <= rtol * np.abs(ref) + atol).all(), float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_erf_inv_grid(dtype):
    tdt, jdt, it, _, _ = DT[dtype]
    npdt = np.dtype(dtype)
    x = np.concatenate([np.linspace(-1, 1, 40001),
                        1 - np.logspace(-15, -1, 400),
                        -1 + np.logspace(-15, -1, 400)]).astype(npdt)
    x = np.clip(x, np.nextafter(npdt.type(-1), npdt.type(0)),
                np.nextafter(npdt.type(1), npdt.type(0)))
    ref = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(x, jdt)))
    got = rng.erf_inv(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(it).astype(np.int64) - ref.view(it).astype(np.int64))
    assert ulps.max() <= (2 if dtype == "float32" else 32), ulps.max()
    assert rng.erf_inv(torch.tensor([1.0, -1.0], dtype=tdt)).isinf().all()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("seed", [0, 11])
def test_normal(dtype, seed):
    tdt, jdt, _, _, _ = DT[dtype]
    ks, tk = keys(seed)
    ref = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (40, 3), jdt))(
        ks)).reshape(len(tk), -1)
    close(rng.normal(tk, 120, tdt).numpy(), ref, dtype)
    # A later counter range is the tail of the full draw.
    np.testing.assert_array_equal(rng.normal(tk, 20, tdt, lo=100).numpy(),
                                  rng.normal(tk, 120, tdt).numpy()[:, 100:])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("alpha", [2.5, 5.0, 0.7])
def test_gamma(dtype, alpha):
    tdt, jdt, _, _, _ = DT[dtype]
    ks, tk = keys(5)
    ref = np.asarray(jax.vmap(
        lambda k: jax.random.gamma(k, alpha, (60,), jdt))(ks))
    got = rng.gamma(tk, alpha, 60, tdt)
    close(got.numpy(), ref, dtype)
    # Column blocks change no value.
    np.testing.assert_array_equal(rng.gamma(tk, alpha, 60, tdt,
                                            block=7 * len(tk)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("df", [5.0, 10.0])
def test_t(dtype, df):
    tdt, jdt, _, _, _ = DT[dtype]
    ks, tk = keys(8)
    ref = np.asarray(jax.vmap(lambda k: jax.random.t(k, df, (30, 2), jdt))(
        ks)).reshape(len(tk), -1)
    close(rng.t(tk, df, 60, tdt).numpy(), ref, dtype)
