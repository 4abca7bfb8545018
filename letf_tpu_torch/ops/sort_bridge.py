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
  only key and sec are permuted there.
- ``"sort"``: unsorted -- ``torch.sort(stable=True)`` alone.

The reference uses ``lax.sort`` at exactly the two places the port uses
``torch.sort``; its power-of-two padding fed the TPU's bitonic network and
is not needed. Keys: float32 non-negative (compared by their int32 bits, as
the reference does) or int32; float64 keys (the CPU parity suite) compare
in IEEE total order. ``sort_bridge`` launches the kernel on CUDA tensors
and runs ``sort_bridge_plain`` (one full stable sort) on CPU ones.
"""

from __future__ import annotations

import ctypes

import torch

from letf_tpu_torch.ops import _build

LAUNCHES = 0            # merge-kernel launches by sort_bridge on CUDA tensors
MAX_ARRAYS = 8          # key + sec + six payloads per kernel launch
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


def _merge_halves(key, sec, payloads=()):
    """The K7 kernel on CUDA columns whose two halves are each ascending by
    (key, sec); returns the merged (key, sec, *payloads)."""
    global LAUNCHES
    arrays = [key, *(() if sec is None else (sec,)), *payloads]
    N, R = key.shape
    if N % 2 or not 0 < len(arrays) <= MAX_ARRAYS:
        raise ValueError(f"merge_halves: N {N} must be even, at most "
                         f"{MAX_ARRAYS} arrays")
    dev = key.device
    checks = {}
    for c, a in enumerate(arrays):
        if a.shape != (N, R):
            raise ValueError(f"merge_halves: array {c} {tuple(a.shape)}")
        if a.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"merge_halves: array {c} has dtype {a.dtype}; "
                            "the kernel moves 32-bit words")
        checks[f"a{c}"] = (a, a.dtype)
    _build.check_cuda("merge_halves", dev, **checks)
    outs = [torch.empty_like(a) for a in arrays]

    def arr(ts):
        return (ctypes.c_void_p * MAX_ARRAYS)(*[t.data_ptr() for t in ts])

    ins_a, outs_a = arr(arrays), arr(outs)
    rc = _build.library().letf_merge(
        len(arrays), ctypes.cast(ins_a, ctypes.c_void_p),
        ctypes.cast(outs_a, ctypes.c_void_p), int(sec is not None), N // 2,
        R, _build.stream_of(key))
    _build.check(rc, "letf_merge")
    LAUNCHES += 1
    return outs[0], (None if sec is None else outs[1]), \
        outs[1 if sec is None else 2:]


def sort_bridge(key, sec, payloads=(), kind: str = "merge",
                head_payloads_zero: bool = False):
    """K7 on the device of the inputs (see the module docstring). key
    [N, R] float32 (non-negative) or int32, sec [N, R] int32 unique per
    column or None, payloads [N, R] float32/int32."""
    if kind not in ("merge", "valley", "sort"):
        raise ValueError(f"sort_bridge: kind {kind!r}")
    if key.device.type == "cpu":
        return sort_bridge_plain(key, sec, payloads, kind, head_payloads_zero)
    if kind == "sort":
        perm = _stable_perm(key, sec)
        key, sec, *pays = _permute([key, sec, *payloads], perm)
        return _result(key, sec, pays)
    payloads = list(payloads)
    if kind == "valley":
        S = key.shape[0] // 2
        perm = _stable_perm(key[:S], None if sec is None else sec[:S])
        head = _permute([key[:S], None if sec is None else sec[:S]]
                        + ([] if head_payloads_zero
                           else [p[:S] for p in payloads]), perm)
        key = torch.cat([head[0], key[S:]])
        sec = None if sec is None else torch.cat([head[1], sec[S:]])
        if not head_payloads_zero:
            payloads = [torch.cat([h, p[S:]])
                        for h, p in zip(head[2:], payloads)]
    key, sec, pays = _merge_halves(key, sec, payloads)
    return _result(key, sec, pays)
