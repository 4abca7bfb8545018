"""Counter-based RNG of the port, bit-exact with the JAX package.

Two families, both computed on int64 tensors that hold uint32 values
(CPU torch has no ``>>`` on uint32):

- threefry2x32 keys and draws, bit-exact with ``jax.random`` in JAX's
  partitionable mode (``jax_threefry_partitionable=True``, the default of
  jax 0.9): ``key``, ``fold_in``, ``split``, ``random_bits``, ``uniform``,
  ``randint``; ``gumbel``, ``normal``, ``gamma`` and ``t`` on them (their
  logs and polynomials an ulp or a few from XLA's). A key is an int64
  tensor ``[..., 2]`` holding the two uint32 words of
  ``jax.random.key_data``. The stream discipline of
  ``letf_tpu/ops/rng.py`` (``trial_key``, ``stream``, stream ids) is kept.
  ``normal``, ``gamma`` and ``t`` launch ``csrc/draws.cu`` for CUDA keys
  (one thread a draw, the rejection loops inside the thread, bitwise the
  torch twin ``_normal_plain``, ``_gamma_plain``, ``_t_plain`` on the
  card) and run the twin for CPU keys.
- the murmur3 counter mixers of the Pallas kernels and of the regime
  spells: ``mix`` / ``bits_to_unit`` (``letf_tpu/ops/pallas_joint.py``)
  and ``counter_uniforms`` (``letf_tpu/ops/path_batched.py``). The CUDA
  kernels carry the same mixer in ``csrc/counter_rng.cuh``.
"""

from __future__ import annotations

import math

import torch

from letf_tpu_torch.ops import _build
from letf_tpu_torch.utils import profiling

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


def gumbel(keys: torch.Tensor, n: int = 1,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,), dtype)`` per key: ``[..., n]``. jax
    0.9's default mode is "low" (``jax_high_dynamic_range_gumbel`` is
    off): -log(-log(u)) of the uniform on [tiny, 1). The uniforms are
    bitwise JAX's; the two logs are torch's (an ulp from XLA's)."""
    u = uniform(keys, n, dtype, minval=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


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


# ---- samplers: normal, gamma, t (jax._src.random) ----

# XLA's erf_inv (chlo decomposition; M. Giles, "Approximating the erfinv
# function"): Horner coefficients, highest degree first.
_ERFINV_F32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
     1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_ERFINV_F64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's erf_inv in the dtype of x (f32: one of two degree-8 fits by
    w = -log1p(-x^2) < 5; f64: three fits split at w = 6.25 and 16);
    +-1 map to +-inf."""
    w = -torch.log1p(-x * x)
    if x.dtype == torch.float32:
        small, big = _ERFINV_F32
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt, small[0], big[0]).to(x.dtype)
        for a, b in zip(small[1:], big[1:]):
            p = torch.where(lt, a, b).to(x.dtype) + p * w
    elif x.dtype == torch.float64:
        c6, c16, cbig = _ERFINV_F64
        l6, l16 = w < 6.25, w < 16.0

        def coef(i):
            c = torch.full_like(x, c6[i])
            if i < len(c16):
                c = torch.where(l6, c, c16[i])
            if i < len(cbig):
                c = torch.where(l16, c, cbig[i])
            return c

        w = torch.where(l6, w - 3.125,
                        torch.sqrt(w) - torch.where(l16, 3.25, 5.0))
        p = coef(0)
        for i in range(1, len(cbig)):
            p = coef(i) + p * w
        for i in range(len(cbig), len(c16)):
            p = torch.where(l16, coef(i) + p * w, p)
        for i in range(len(c16), len(c6)):
            p = torch.where(l6, coef(i) + p * w, p)
    else:
        raise TypeError(f"erf_inv: unsupported dtype {x.dtype}")
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _blocks(B: int, n: int, block: int):
    """Column ranges [lo, hi) of at most ``block`` draws over B keys."""
    cols = max(1, block // max(B, 1))
    return [(lo, min(n, lo + cols)) for lo in range(0, n, cols)]


# ---- the samplers' entries: the kernel for CUDA keys, the twin for CPU ----

LAUNCHES = 0      # csrc/draws.cu entry calls by normal, gamma and t
_KERNEL_DTYPES = {torch.float32: 0, torch.float64: 1}


def _launch(entry: str, keys: torch.Tensor, n: int, dtype: torch.dtype,
            *args) -> torch.Tensor:
    """One ``csrc/draws.cu`` launch over the flat draws of keys [..., 2]:
    ``[..., n]`` in ``dtype``, on the current stream, with no read of a
    device value. Counts ``fused_draws`` (and no ``draw_rounds``: the
    rejection loops run inside the kernel's threads)."""
    global LAUNCHES
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{entry}: unsupported dtype {dtype} on CUDA")
    if keys.dtype != torch.int64:
        raise TypeError(f"{entry}: keys must be int64, got {keys.dtype}")
    flat = keys.reshape(-1, 2).contiguous()
    out = torch.empty((flat.shape[0], n), dtype=dtype, device=keys.device)
    if out.numel():
        rc = getattr(_build.library(), entry)(
            flat.data_ptr(), flat.shape[0], n, *args,
            _KERNEL_DTYPES[dtype], out.data_ptr(), _build.stream_of(out))
        _build.check(rc, entry)
        LAUNCHES += 1
    profiling.count("fused_draws", out.numel())
    return out.reshape(*keys.shape[:-1], n)


def normal(keys: torch.Tensor, n: int = 1,
           dtype: torch.dtype = torch.float32, lo: int = 0,
           block: int = 1 << 24) -> torch.Tensor:
    """``jax.random.normal(k, shape, dtype)`` per key for the flat counters
    lo..lo+n-1 of the shape: ``[..., n]``. CUDA keys launch
    ``csrc/draws.cu``; CPU keys run the twin ``_normal_plain`` in column
    blocks of at most ``block`` draws (memory only; no value changes)."""
    if keys.is_cuda:
        return _launch("letf_draw_normal", keys, n, dtype, lo)
    profiling.count("plain_draws", keys.numel() // 2 * n)
    return _normal_plain(keys, n, dtype, lo, block)


def gamma(keys: torch.Tensor, alpha: float, n: int,
          dtype: torch.dtype = torch.float32,
          block: int = 1 << 24) -> torch.Tensor:
    """``jax.random.gamma(k, alpha, shape, dtype)`` per key [B, 2], the
    shape's n elements flat: ``[B, n]`` (``_gamma_impl``: one split key per
    element). CUDA keys launch ``csrc/draws.cu``, each thread running its
    element's rejection loop; CPU keys run the twin ``_gamma_plain``."""
    if keys.is_cuda:
        profiling.count("draw_rounds", 0)
        return _launch("letf_draw_gamma", keys, n, dtype, float(alpha),
                       int(alpha >= 1.0))
    profiling.count("plain_draws", keys.shape[0] * n)
    return _gamma_plain(keys, alpha, n, dtype, block)


def t(keys: torch.Tensor, df: float, n: int,
      dtype: torch.dtype = torch.float32,
      block: int = 1 << 24) -> torch.Tensor:
    """``jax.random.t(k, df, shape, dtype)`` per key [B, 2], flat: ``[B,
    n]``: z * sqrt((df/2) / gamma(df/2)) of (normal key, gamma key) =
    split(key). CUDA keys launch ``csrc/draws.cu``; CPU keys run the twin
    ``_t_plain``."""
    if keys.is_cuda:
        profiling.count("draw_rounds", 0)
        # The rows' split keys, written by the entry's first kernel.
        row_keys = torch.empty((keys.numel() // 2, 4), dtype=torch.int32,
                               device=keys.device)
        return _launch("letf_draw_t", keys, n, dtype, float(df),
                       row_keys.data_ptr())
    profiling.count("plain_draws", keys.shape[0] * n)
    return _t_plain(keys, df, n, dtype, block)


# ---- the twin: the samplers as torch ops ----

def _normal_plain(keys: torch.Tensor, n: int = 1,
                  dtype: torch.dtype = torch.float32, lo: int = 0,
                  block: int = 1 << 24) -> torch.Tensor:
    lead = keys.shape[:-1]
    flat = keys.reshape(-1, 2)
    out = torch.empty((flat.shape[0], n), dtype=dtype, device=keys.device)
    one = torch.ones((), dtype=dtype, device=keys.device)
    minval = torch.nextafter(-one, torch.zeros_like(one))
    sqrt2 = torch.tensor(math.sqrt(2.0), dtype=dtype, device=keys.device)
    for a, b in _blocks(flat.shape[0], n, block):
        f = _unit_floats(flat, b - a, dtype, lo + a)
        u = torch.maximum(minval, f * (one - minval) + minval)
        out[:, a:b] = sqrt2 * erf_inv(u)
    return out.reshape(*lead, n)


def _scalar_normal(keys, dtype):
    return _normal_plain(keys, 1, dtype)[..., 0]


def _gamma_one(keys: torch.Tensor, alpha: float,
               dtype: torch.dtype) -> torch.Tensor:
    """``jax._src.random._gamma_one`` over flat element keys [M, 2]
    (Marsaglia-Tsang): each rejection round takes split(key, 3) -> (next
    key, x key, U key), an inner loop redraws the normal while v <= 0 with
    split(x key), and the accepted elements are frozen. alpha < 1 is
    boosted to alpha + 1 and scaled by U^(1/alpha). Each round of either
    loop waits for the device (a boolean index) and counts one
    ``draw_rounds`` on the open span."""
    dev = keys.device
    a0 = torch.tensor(alpha, dtype=dtype, device=dev)
    boost = alpha >= 1.0
    a = a0 if boost else a0 + 1.0
    third = torch.tensor(1.0 / 3.0, dtype=dtype, device=dev)
    d = a - third
    c = third / torch.sqrt(d)
    sq = torch.tensor(0.0331, dtype=dtype, device=dev)
    k2 = split(keys, 2)
    key, subkey = k2[:, 0].clone(), k2[:, 1]
    M = keys.shape[0]
    V = torch.empty(M, dtype=dtype, device=dev)
    active = torch.arange(M, device=dev)
    while active.numel():
        profiling.count("draw_rounds")
        k3 = split(key[active], 3)
        key[active] = k3[:, 0]
        kx = k3[:, 1].clone()
        x = torch.zeros(active.numel(), dtype=dtype, device=dev)
        v = torch.full_like(x, -1.0)
        inner = torch.arange(active.numel(), device=dev)
        while inner.numel():
            profiling.count("draw_rounds")
            s2 = split(kx[inner], 2)
            kx[inner] = s2[:, 0]
            xi = _scalar_normal(s2[:, 1], dtype)
            vi = 1.0 + xi * c
            x[inner] = xi
            v[inner] = vi
            inner = inner[vi <= 0.0]
        X = x * x
        Vv = (v * v) * v
        U = uniform(k3[:, 2], 1, dtype)[:, 0]
        rejected = ((U >= 1.0 - sq * (X * X))
                    & (torch.log(U) >= X * 0.5
                       + d * ((1.0 - Vv) + torch.log(Vv))))
        V[active] = Vv
        active = active[rejected]
    out = (d * V) * 1.0
    if not boost:
        u = 1.0 - uniform(subkey, 1, dtype)[:, 0]
        out = (d * V) * torch.pow(u, 1.0 / a0)
    return out


def _gamma_cols(keys, alpha: float, lo: int, hi: int, dtype):
    """Gamma draws of the flat elements lo..hi-1: element j's key is
    split(key, n)[j], i.e. the threefry hash of the counter (0, j)."""
    j = torch.arange(lo, hi, dtype=torch.int64, device=keys.device)
    b1, b2 = threefry2x32(keys[:, 0, None], keys[:, 1, None],
                          torch.zeros_like(j), j)
    ek = torch.stack([b1, b2], dim=-1).reshape(-1, 2)
    return _gamma_one(ek, alpha, dtype).reshape(keys.shape[0], hi - lo)


def _gamma_plain(keys: torch.Tensor, alpha: float, n: int,
                 dtype: torch.dtype = torch.float32,
                 block: int = 1 << 24) -> torch.Tensor:
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=keys.device)
    for lo, hi in _blocks(keys.shape[0], n, block):
        out[:, lo:hi] = _gamma_cols(keys, alpha, lo, hi, dtype)
    return out


def _t_plain(keys: torch.Tensor, df: float, n: int,
             dtype: torch.dtype = torch.float32,
             block: int = 1 << 24) -> torch.Tensor:
    ks = split(keys, 2)
    half = torch.tensor(df, dtype=dtype, device=keys.device) / 2.0
    out = torch.empty((keys.shape[0], n), dtype=dtype, device=keys.device)
    for lo, hi in _blocks(keys.shape[0], n, block):
        z = _normal_plain(ks[:, 0], hi - lo, dtype, lo=lo)
        g = _gamma_cols(ks[:, 1], float(half), lo, hi, dtype)
        out[:, lo:hi] = z * torch.sqrt(half / g)
    return out


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
