"""Stable two-key column sorts of the tax bridge (kernel K7).

Port of ``letf_tpu/ops/pallas_sort.py::sort_bridge``: a stable sort of each
column of ``[N, R]`` tensors (N = 2 S, R trials; the port keeps the day axis
first) by a primary key and a unique int32 secondary, carrying payloads.
The result is ``lax.sort(..., num_keys=2, is_stable=True)`` bit for bit.

Kinds, as in the reference:
- ``"merge"``: both halves (rows [0, S) and [S, 2S)) ascending -- the
  merge kernel (``csrc/merge.cu``) alone.
- ``"valley"``: the first half unsorted, the second ascending -- the first
  half is sorted with ``torch.sort(stable=True)``, then merged.
  ``head_payloads_zero`` says the first half's payloads are all zero, so
  only key and sec are permuted there and the kernel reads no head
  payload.
- ``"sort"``: unsorted -- ``torch.sort(stable=True)`` alone.

The kernel takes each array's two halves as separate [S, R] tensors (no
concatenation), moves them trial-major, merges one trial a block in
shared memory and moves the result back (see the source). It takes a half
of at most 14,528 days with a secondary (``_merge_limit``; the
reference's 50-year horizon is 12,600) and raises ``ValueError`` beyond.
The reference uses ``lax.sort`` at exactly the two places the port uses
``torch.sort``; its power-of-two padding fed the TPU's bitonic network and
is not needed. The kernel moves 64-bit keys and payloads, since the bridge
computes in float64 (a float32 share coordinate near 10^7 shares is one
share apart): float64 non-negative keys (compared by their int64 bits, as
the reference compares its float32 ones by their int32 bits) or int64,
with float64/int64 payloads and the int32 secondary; past 9,685 days a
half it reads the secondary from device memory on key ties. The plain
version also takes the reference's 32-bit words, and compares float64
keys in IEEE total order, which is the int64 bit order on non-negative
keys. ``sort_bridge`` launches the kernel on CUDA tensors and runs
``sort_bridge_plain`` (one full stable sort) on CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from letf_tpu_torch.ops import _build

LAUNCHES = 0            # merge-kernel launches by sort_bridge on CUDA tensors
MAX_ARRAYS = 8          # key + sec + six payloads per kernel launch
MAX_SMEM = 232448       # shared bytes a block can use (csrc/merge.cu)
_I64_MAGNITUDE = 0x7FFFFFFFFFFFFFFF


def _order_key(key, sec):
    """int64 keys whose ascending order is the (key, sec) order: key bits
    in the high word and sec in the low word for 32-bit keys; the float64
    total-order key alone otherwise (sec then needs a second pass)."""
    if key.dtype == torch.float64:
        bits = key.view(torch.int64)
        return torch.where(bits < 0, bits ^ _I64_MAGNITUDE, bits)
    k = (key.view(torch.int32) if key.dtype == torch.float32
         else key).to(torch.int64)
    if sec is None:
        return k
    return (k << 32) | (sec.to(torch.int64) & 0xFFFFFFFF)


def _stable_perm(key, sec):
    """Row permutation [N, R] that stably sorts each column by (key, sec)."""
    ok = _order_key(key, sec)
    if key.dtype == torch.float64 and sec is not None:
        p1 = torch.sort(sec, dim=0, stable=True).indices
        p2 = torch.sort(torch.gather(ok, 0, p1), dim=0, stable=True).indices
        return torch.gather(p1, 0, p2)
    return torch.sort(ok, dim=0, stable=True).indices


def _permute(arrays, perm):
    return [None if a is None else torch.gather(a, 0, perm) for a in arrays]


def _result(key, sec, pays):
    return (key, *(() if sec is None else (sec,)), *pays)


def sort_bridge_plain(key, sec, payloads=(), kind: str = "merge",
                      head_payloads_zero: bool = False):
    """Plain PyTorch K7: one full stable sort of every column by
    (key, sec) -- what every kind computes. Returns (key, sec, *payloads),
    or (key, *payloads) when ``sec`` is None."""
    del kind, head_payloads_zero
    perm = _stable_perm(key, sec)
    key, sec, *pays = _permute([key, sec, *payloads], perm)
    return _result(key, sec, pays)


_WORDS = (torch.float64, torch.int64)    # the kernel's key and payload words


def _merge_limit(S: int, has_sec: bool):
    """(shared bytes, permutation in shared memory) of the merge kernel at
    S days a half, as csrc/merge.cu's merge_smem (the sec row stays in
    shared memory only where it fits beside the keys); ValueError beyond
    what it takes."""
    keys = 8 * 2 * S
    sec_in_smem = has_sec and keys + 4 * 2 * S <= MAX_SMEM
    rows = keys + (4 * 2 * S if sec_in_smem else 0)
    if rows > MAX_SMEM or 2 * S > 65536:
        raise ValueError(
            f"sort_bridge: a half of {S} days needs {rows} bytes of shared "
            f"memory for its 64-bit key"
            f"{' and sec' if has_sec else ''} rows; the merge kernel takes "
            f"at most {MAX_SMEM} (and 32,768 days)")
    return rows, rows + 4 * S <= MAX_SMEM


def _merge_halves(heads, tails, has_sec: bool):
    """The K7 kernel on CUDA columns: ``heads[c]`` and ``tails[c]`` the
    two halves [S, R] of array c (key, sec when ``has_sec``, payloads),
    each half ascending by (key, sec); a payload's head is None when it is
    all zero. Returns the merged [2S, R] arrays."""
    global LAUNCHES
    S, R = tails[0].shape
    if not 0 < len(tails) <= MAX_ARRAYS or len(heads) != len(tails):
        raise ValueError(f"merge_halves: 1 to {MAX_ARRAYS} arrays")
    if heads[0] is None or (has_sec and heads[1] is None):
        raise ValueError("merge_halves: the key and sec heads are needed")
    if -(-R // 32) > 65535:
        raise ValueError(f"merge_halves: {R} columns, at most "
                         f"{65535 * 32}")
    _, perm_in_smem = _merge_limit(S, has_sec)
    dev = tails[0].device
    checks = {}
    for c, (h, t) in enumerate(zip(heads, tails)):
        want = (torch.int32,) if has_sec and c == 1 else _WORDS
        for part, a in (("head", h), ("tail", t)):
            if a is None:
                continue
            if a.shape != (S, R):
                raise ValueError(f"merge_halves: array {c} {part} "
                                 f"{tuple(a.shape)}, expected {(S, R)}")
            if a.dtype not in want:
                raise TypeError(
                    f"merge_halves: array {c} has dtype {a.dtype}; the "
                    f"kernel takes {want}")
            checks[f"{part}{c}"] = (a, a.dtype)
    _build.check_cuda("merge_halves", dev, **checks)
    outs = [torch.empty((2 * S, R), dtype=t.dtype, device=dev)
            for t in tails]
    width = [4 if has_sec and c == 1 else 8 for c in range(len(tails))]
    tm = torch.empty(R * 2 * S * sum(width), dtype=torch.uint8, device=dev)
    perm = (None if perm_in_smem else
            torch.empty((R, 2 * S), dtype=torch.int16, device=dev))
    head_zero = sum(1 << c for c, h in enumerate(heads) if h is None)

    def arr(ts):
        return (ctypes.c_void_p * MAX_ARRAYS)(
            *[0 if t is None else t.data_ptr() for t in ts])

    ins_h, ins_t, outs_a = arr(heads), arr(tails), arr(outs)
    rc = _build.library().letf_merge(
        len(tails), ctypes.cast(ins_h, ctypes.c_void_p),
        ctypes.cast(ins_t, ctypes.c_void_p),
        ctypes.cast(outs_a, ctypes.c_void_p), int(has_sec), head_zero, S, R,
        tm.data_ptr(), 0 if perm is None else perm.data_ptr(),
        _build.stream_of(tails[0]))
    _build.check(rc, "letf_merge")
    LAUNCHES += 1
    return outs


def sort_bridge(key, sec, payloads=(), kind: str = "merge",
                head_payloads_zero: bool = False):
    """K7 on the device of the inputs (see the module docstring). key
    [N, R] float64 (non-negative) or int64 with float64/int64 payloads
    (on CPU tensors also float32 or int32 with float32/int32 payloads);
    sec [N, R] int32 unique per column or None. On CUDA tensors the merge
    and valley kinds launch the kernel, which raises ``ValueError`` for a
    half longer than it takes (``_merge_limit``) and ``TypeError`` for
    32-bit words."""
    if kind not in ("merge", "valley", "sort"):
        raise ValueError(f"sort_bridge: kind {kind!r}")
    if key.device.type == "cpu":
        return sort_bridge_plain(key, sec, payloads, kind, head_payloads_zero)
    if kind == "sort":
        perm = _stable_perm(key, sec)
        key, sec, *pays = _permute([key, sec, *payloads], perm)
        return _result(key, sec, pays)
    N = key.shape[0]
    if N % 2:
        raise ValueError(f"sort_bridge: N {N} must be even")
    S = N // 2
    has_sec = sec is not None
    arrays = [key, *((sec,) if has_sec else ()), *payloads]
    tails = [a[S:] for a in arrays]
    if kind == "valley":
        _merge_limit(S, has_sec)
        perm = _stable_perm(key[:S], sec[:S] if has_sec else None)
        heads = _permute([key[:S], *((sec[:S],) if has_sec else ())]
                         + ([None] * len(payloads) if head_payloads_zero
                            else [p[:S] for p in payloads]), perm)
    else:
        heads = [a[:S] for a in arrays]
    key, *rest = _merge_halves(heads, tails, has_sec)
    sec = rest.pop(0) if has_sec else None
    return _result(key, sec, rest)
