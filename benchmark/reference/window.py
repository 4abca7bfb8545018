"""Frozen copy of ``letf_tpu_torch/ops/window.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Per-trial random-start windowing (kernels K2 and K2').

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

import torch




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


# The plain version stands wherever the port dispatches to its kernel.
window_offsets = window_plain
