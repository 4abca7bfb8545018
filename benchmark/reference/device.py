"""Frozen copy of ``letf_tpu_torch/utils/device.py`` at commit dc793a5, part
of the benchmark's plain reference: it imports nothing of the port, and
where the port launches a CUDA kernel this copy runs the kernel's plain
version. What the benchmark's engines do not run was left out.

Device and dtype policy of the port.

- ``resolve_device``: the explicit device of a public entry. Asking for
  CUDA without a card raises; nothing switches to the CPU on its own.
- ``glue_dtype``: the float type of the converted model tables and of the
  glue around the kernels. float64 on the CPU (the JAX test suite runs in
  x64 mode, tests/conftest.py), float32 on the card (JAX's default mode,
  as the TPU production path runs). The same switch picks the bit width of
  the threefry ``randint``/``uniform`` draws, as JAX's x64 flag does.
- Kernels and their plain versions always compute in float32.
- ``to_tb`` / ``from_tb``: the port's per-day layout is ``[T, B]`` with
  trials contiguous, so each day's loads and stores coalesce across a warp.
"""

from __future__ import annotations

import torch


def index_dtype(dtype: torch.dtype) -> torch.dtype:
    """Integer type of threefry randint draws: int64 where JAX would run
    in x64 mode (float64 glue), int32 otherwise."""
    return torch.int64 if dtype == torch.float64 else torch.int32


