"""Frozen copy of ``letf_tpu_torch/ops/rng.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Counter-based RNG of the port, bit-exact with the JAX package.

Two families, both computed on int64 tensors that hold uint32 values
(CPU torch has no ``>>`` on uint32):

- threefry2x32 keys and draws, bit-exact with ``jax.random`` in JAX's
  partitionable mode (``jax_threefry_partitionable=True``, the default of
  jax 0.9): ``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform``,
  ``randint``. A key is an int64 tensor ``[..., 2]`` holding the two
  uint32 words of
  ``jax.random.key_data``. The stream discipline of
  ``letf_tpu/ops/rng.py`` (``trial_key``, ``stream``, stream ids) is kept.
- the murmur3 counter mixers of the Pallas kernels and of the regime
  spells: ``mix`` / ``bits_to_unit`` (``letf_tpu/ops/pallas_joint.py``)
  and ``counter_uniforms`` (``letf_tpu/ops/path_batched.py``). The CUDA
  kernels carry the same mixer in ``csrc/counter_rng.cuh``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Stream ids (letf_tpu/ops/rng.py).
START = 0
REGIME = 1
JOINT_EPS = 2
JOINT_CHI = 3
VIX_NOISE = 4
IRX_NOISE = 5
STRESS_NORM = 6
STRESS_JUMP = 7
TRACKING = 8
BOOTSTRAP = 9
LHS = 10           # Latin hypercube stratification (no engine draws it)

# murmur3 finalizer constants and counter salts (pallas_joint.py:66-69).
GOLD = 0x9E3779B9
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
DAY_PRIME = 0x7FEB352D

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _as_u32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2); int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` key data: [seed >> 32, seed & 0xFFFFFFFF]."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash of the counter (0, data) under the key.
    ``data`` (int or tensor) broadcasts against ``keys[..., 0]``."""
    d = _as_u32(data, keys.device)
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split`` (fold-like in partitionable mode): key i is the
    hash of the counter (0, i). Returns ``[..., num, 2]``."""
    i = torch.arange(num, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([b1, b2], dim=-1)


def _bit_pairs(keys: torch.Tensor, n: int, lo: int = 0):
    """Partitionable ``random_bits`` core: both threefry output words for
    the flat counters lo..lo+n-1 (high counter word 0, counters < 2**32)."""
    i = torch.arange(lo, lo + n, dtype=torch.int64, device=keys.device)
    return threefry2x32(keys[..., 0, None], keys[..., 1, None],
                        torch.zeros_like(i), i)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``[..., n]`` uint32 values (b1 ^ b2)."""
    b1, b2 = _bit_pairs(keys, n)
    return b1 ^ b2


def _unit_floats(keys: torch.Tensor, n: int, dtype: torch.dtype,
                 lo: int = 0) -> torch.Tensor:
    """The [1, 2) mantissa fill of ``jax.random.uniform`` minus 1, for the
    flat counters lo..lo+n-1: ``[..., n]`` in [0, 1)."""
    b1, b2 = _bit_pairs(keys, n, lo)
    if dtype == torch.float32:
        fb = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
        f = fb.view(torch.float32) - 1.0
    elif dtype == torch.float64:
        # (b1 << 32 | b2) >> 12 without leaving the int64 range.
        fb = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        f = fb.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform: unsupported dtype {dtype}")
    return f


def uniform(keys: torch.Tensor, n: int = 1,
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), dtype, minval, maxval)`` per key:
    ``[..., n]``, max(minval, f * (maxval - minval) + minval) of the
    mantissa fill f in [0, 1). float32 uses 32 random bits, float64 64
    (x64 mode)."""
    f = _unit_floats(keys, n, dtype)
    if (minval, maxval) != (0.0, 1.0):
        f = f * (maxval - minval) + minval
    return torch.clamp_min(f, minval)


def randint(keys: torch.Tensor, minval, maxval,
            dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``jax.random.randint(k, (), minval, maxval, dtype)`` per key:
    ``[...]``. Two draws (the key split in two) combined modulo the span,
    with 32-bit draws for int32 and 64-bit draws for int64 (x64 mode)."""
    ks = split(keys, 2)
    span = torch.as_tensor(maxval, dtype=torch.int64, device=keys.device) \
        - torch.as_tensor(minval, dtype=torch.int64, device=keys.device)
    span = torch.where(span <= 0, torch.ones_like(span), span)
    if dtype == torch.int32:
        hi = random_bits(ks[..., 0, :], 1)[..., 0]
        lo = random_bits(ks[..., 1, :], 1)[..., 0]
        hi_mod, lo_mod = hi % span, lo % span
        mult = (2 ** 16) % span
    elif dtype == torch.int64:
        h1, h2 = _bit_pairs(ks[..., 0, :], 1)
        l1, l2 = _bit_pairs(ks[..., 1, :], 1)
        w = (2 ** 32) % span                       # one 32-bit word's weight
        hi_mod = ((h1[..., 0] % span) * w + h2[..., 0] % span) % span
        lo_mod = ((l1[..., 0] % span) * w + l2[..., 0] % span) % span
        mult = w
    else:
        raise TypeError(f"randint: unsupported dtype {dtype}")
    mult = (mult * mult) % span
    off = (hi_mod * mult + lo_mod) % span
    return (torch.as_tensor(minval, dtype=torch.int64, device=keys.device)
            + off).to(dtype)


def trial_key(run_key: torch.Tensor, trial_ids) -> torch.Tensor:
    return fold_in(run_key, trial_ids)


def stream(tk: torch.Tensor, stream_id: int) -> torch.Tensor:
    return fold_in(tk, stream_id)


# ---- murmur3 counter mixers ----

def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for uint32 values in int64 without overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * (c & 0xFFFF)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 (pallas_joint._mix)."""
    x = x ^ (x >> 16)
    x = mul_u32(x, M1)
    x = x ^ (x >> 13)
    x = mul_u32(x, M2)
    return x ^ (x >> 16)


def bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in (0, 1): top 24 bits + half-ulp offset
    (pallas_joint._bits_to_unit)."""
    return ((bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
            + (0.5 / 16777216.0))


def lane_keys(ids: torch.Tensor, seed_words) -> torch.Tensor:
    """Per-trial counter key of the kernels: mix(id * GOLD ^ s0)."""
    s0 = int(seed_words[0]) & MASK32
    return mix(mul_u32(_as_u32(ids), GOLD) ^ s0)


def day_keys(lane_key: torch.Tensor, days: torch.Tensor,
             seed_words) -> torch.Tensor:
    """Per-(day, trial) counter key, ``[T, B]``:
    mix(lane_key ^ (day * DAY_PRIME) ^ s1)."""
    s1 = int(seed_words[1]) & MASK32
    d = mul_u32(_as_u32(days), DAY_PRIME)
    return mix(lane_key[None, :] ^ d[:, None] ^ s1)


def stream_bits(day_key: torch.Tensor, idx: int) -> torch.Tensor:
    """Counter bits of draw index ``idx`` (pallas_compose._stream_bits)."""
    return mix((day_key + ((GOLD * idx) & MASK32)) & MASK32)


def counter_uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """[B] threefry keys -> [B, n] float32 uniforms in (0, 1) by the murmur
    counter expansion (path_batched.counter_uniforms)."""
    lane = mix(mul_u32(keys[..., 0], GOLD) ^ keys[..., 1])
    ctr = mul_u32(torch.arange(n, dtype=torch.int64, device=keys.device),
                  DAY_PRIME)
    bits = mix(mix(lane[:, None] ^ ctr[None, :]))
    return bits_to_unit(bits)
