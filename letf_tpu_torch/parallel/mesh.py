"""The trial mesh: the devices a run's trial axis is split over.

Port of ``letf_tpu/parallel/mesh.py``. Monte Carlo over independent trials
is pure data parallelism: each shard runs the whole engine on a contiguous
slice of a chunk's trials (where the JAX package places ``P("trials")``),
and a chunk's only cross-device traffic is the gather of its summaries.
The JAX design is single-controller, and so is this one: one process
drives every shard from one host loop, with no ``torch.distributed`` (a
collective would carry nothing that the host gather does not).

A ``TrialMesh`` is an ordered tuple of ``torch.device``, one per shard.
Repeats are allowed, so that one card (or the CPU) can hold several
shards. ``trial_sharding`` and ``replicated`` have no counterpart: a
shard's slice is the rows it is handed, and the model, key, pools,
cashflows and anchors are copied to each distinct device of the mesh by
the runner.
"""

from __future__ import annotations

import torch


class TrialMesh(tuple):
    """An ordered tuple of ``torch.device``, one per shard."""

    def __new__(cls, devices):
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("a trial mesh needs at least one device")
        return super().__new__(cls, devs)

    @property
    def size(self) -> int:
        return len(self)

    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in first-seen order."""
        return tuple(dict.fromkeys(self))

    def __repr__(self) -> str:
        return f"TrialMesh({', '.join(str(d) for d in self)})"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def trial_mesh(devices=None) -> TrialMesh:
    """The mesh over ``devices`` (``torch.device``, strings or CUDA
    ordinals), by default every visible CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("trial_mesh: no CUDA device is visible; "
                               "pass the devices (e.g. ['cpu', 'cpu'])")
    return TrialMesh(devices)


def as_mesh(mesh):
    """``mesh`` checked: None (one device) or a ``TrialMesh``."""
    if mesh is None or isinstance(mesh, TrialMesh):
        return mesh
    raise TypeError(f"mesh must be a TrialMesh (parallel.mesh.trial_mesh), "
                    f"got {type(mesh).__name__}")


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
