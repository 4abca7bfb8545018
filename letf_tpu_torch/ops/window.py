"""Per-trial random-start windowing (kernels K2 and K2').

Port of ``letf_tpu/ops/pallas_window.py::_window_kernel_4d`` (K2, entry
``window_offsets_slab``, the production chunk's) and of ``_window_kernel``
(K2', entries ``_window_tiles`` and ``window_offsets_pallas``, the general
path's): ``out[s, b] = x[s + off[b], b] (+ bias[b])``, bitwise a gather,
NaN payloads included. The TPU kernels' shift-select tree and lookahead
tails worked around the lack of a fast gather; on the GPU both are one
kernel (``csrc/window.cu``: each block streams a 32-trial strip's rows
through a shared-memory ring, so reads and writes are whole lines), up to
six channels per launch, behind the one wrapper ``window_offsets``.

Layout ``[T, B]`` in, ``[S, B]`` out. Offsets must lie in [0, T - S].
"""

from __future__ import annotations

import ctypes

import torch

from letf_tpu_torch.ops import _build

LAUNCHES = 0            # kernel launches by window_offsets on CUDA tensors
MAX_CHANNELS = 6


def window_plain(xs, offs, sim_days: int, biases=None):
    """Plain PyTorch K2: a gather per channel, plus the per-trial bias
    where one is given. xs: list of [T, B] f32; offs [B] int;
    biases: list of [B] f32 or None. Returns a list of [S, B] f32."""
    biases = biases or [None] * len(xs)
    idx = (torch.arange(sim_days, device=offs.device)[:, None]
           + offs.to(torch.int64)[None, :])
    out = []
    for x, b in zip(xs, biases):
        w = torch.gather(x, 0, idx)
        out.append(w if b is None else w + b[None, :])
    return out


def window_offsets(xs, offs, sim_days: int, biases=None):
    """K2 on the device of the inputs: one CUDA launch for up to six
    channels on CUDA tensors, ``window_plain`` on CPU tensors."""
    global LAUNCHES
    biases = list(biases) if biases is not None else [None] * len(xs)
    if offs.device.type == "cpu":
        return window_plain(xs, offs, sim_days, biases)
    if not 0 < len(xs) <= MAX_CHANNELS or len(biases) != len(xs):
        raise ValueError(f"window_offsets: 1..{MAX_CHANNELS} channels")
    T, B = xs[0].shape
    if not 0 < sim_days <= T:
        raise ValueError(f"window_offsets: sim_days {sim_days}, T {T}")
    dev = offs.device
    checks = {"offs": (offs, torch.int32)}
    for c, (x, b) in enumerate(zip(xs, biases)):
        if x.shape != (T, B):
            raise ValueError(f"window_offsets: channel {c} {tuple(x.shape)}")
        checks[f"x{c}"] = (x, torch.float32)
        if b is not None:
            if b.shape != (B,):
                raise ValueError(f"window_offsets: bias {c} must be [B]")
            checks[f"bias{c}"] = (b, torch.float32)
    if offs.shape != (B,):
        raise ValueError("window_offsets: offs must be [B]")
    _build.check_cuda("window_offsets", dev, **checks)
    outs = [torch.empty((sim_days, B), dtype=torch.float32, device=dev)
            for _ in xs]

    def arr(ts):
        return (ctypes.c_void_p * MAX_CHANNELS)(
            *[t.data_ptr() if t is not None else None for t in ts])

    xs_a, outs_a, bias_a = arr(xs), arr(outs), arr(biases)
    lib = _build.library()
    rc = lib.letf_window(len(xs), ctypes.cast(xs_a, ctypes.c_void_p),
                         ctypes.cast(outs_a, ctypes.c_void_p),
                         ctypes.cast(bias_a, ctypes.c_void_p),
                         offs.data_ptr(), T, sim_days, B,
                         _build.stream_of(offs))
    _build.check(rc, "letf_window")
    LAUNCHES += 1
    return outs
