"""Kernel K2 (random-start window): the port's plain PyTorch version is a
gather, bitwise equal to the Pallas ``window_offsets_slab`` in interpret
mode and to the numpy gather, NaN payloads and per-trial bias included.
Shapes as tests/test_path_batched.py (direct-slab and fallback windows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from letf_tpu.ops.pallas_window import window_offsets_slab
from letf_tpu_torch.ops import window
from letf_tpu_torch.utils.device import slab_to_tb
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("S", [256, 96])
def test_window_plain_bitwise(S):
    G, T = 2, 380
    B = G * 1024
    rs = np.random.default_rng(S)
    x = rs.standard_normal((G, T, 8, 128)).astype(np.float32)
    x[1, 5, 3, 7] = np.nan
    # A NaN with a payload and a negative zero must pass through unchanged.
    x[0, 17, 2, 5] = np.frombuffer(np.uint32(0x7FC01234).tobytes(),
                                   np.float32)[0]
    x[0, 30, 0, 0] = -0.0
    offs = rs.integers(0, T - S + 1, B).astype(np.int32)
    offs[0], offs[-1] = 0, T - S
    bias = rs.standard_normal((G, 8, 128)).astype(np.float32)

    ref = np.asarray(window_offsets_slab(jnp.asarray(x), jnp.asarray(offs),
                                         S, interpret=True))
    ref_b = np.asarray(window_offsets_slab(
        jnp.asarray(x), jnp.asarray(offs), S, interpret=True,
        bias=jnp.asarray(bias)))
    xt = slab_to_tb(x)                                        # [T, B]
    gather = np.take_along_axis(xt, offs[None, :] + np.arange(S)[:, None],
                                axis=0)
    bias_b = bias.reshape(B)

    got, got_b = window.window_offsets(
        [torch.from_numpy(xt.copy())] * 2, torch.from_numpy(offs), S,
        biases=[None, torch.from_numpy(bias_b.copy())])
    assert window.LAUNCHES == 0          # CPU tensors run the plain version

    def bits(a):
        return np.ascontiguousarray(a).view(np.uint32)

    np.testing.assert_array_equal(bits(got.numpy()), bits(gather))
    np.testing.assert_array_equal(bits(got.numpy()), bits(slab_to_tb(ref)))
    np.testing.assert_array_equal(bits(got_b.numpy()),
                                  bits(gather + bias_b[None, :]))
    np.testing.assert_array_equal(bits(got_b.numpy()),
                                  bits(slab_to_tb(ref_b)))


def test_general_path_window_series_bitwise():
    """Kernel K2' on the general path: ``path_batched.window_series`` on
    [T, B] channels equals ``window_offsets_pallas`` ([C, T, B], interpret
    mode) bit for bit, NaN payload included (test_path_batched.py:109's
    shapes), and skips the window when T == S."""
    from letf_tpu.ops.pallas_window import window_offsets_pallas
    from letf_tpu_torch.ops.path_batched import window_series

    T, S, C, B = 380, 256, 6, 256
    x = jax.random.normal(jax.random.key(0), (C, T, B), jnp.float32)
    x = x.at[0, 3, 7].set(jnp.nan)
    offs = np.random.default_rng(1).integers(0, T - S + 1, B).astype(
        np.int32)
    offs[0], offs[1] = 0, T - S
    ref = np.asarray(window_offsets_pallas(x, jnp.asarray(offs), S,
                                           interpret=True))
    xt = [torch.as_tensor(np.array(x[c])) for c in range(C)]
    got = window_series(xt, torch.as_tensor(offs), S)
    for c in range(C):
        assert got[c].numpy().view(np.int32).tobytes() == \
            ref[c].view(np.int32).tobytes()
    same = window_series(xt, torch.zeros(B, dtype=torch.int32), T)
    assert all(a is b for a, b in zip(same, xt))
