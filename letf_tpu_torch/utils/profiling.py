"""Tracing/profiling: step timer + torch.profiler hooks.

The port's copy of ``letf_tpu/utils/profiling.py``. The reference's
observability is a wall-clock step timer printed at exit
(letf/__init__.py:25-32,176-188); ``StepTimer`` is a copy. The device
hooks are the JAX package's on torch's profiler: ``device_trace`` records
a ``torch.profiler`` trace of a block (CPU and, where there is a card,
CUDA activity) and writes it to ``log_dir`` as a Chrome trace;
``annotate`` names a range on both the profiler's timeline and, with a
card, the NVTX one.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import torch


class StepTimer:
    """Labelled wall-clock step timer with a percentage breakdown."""

    def __init__(self):
        self._steps: List[Tuple[str, float]] = []
        self._t0 = time.time()

    def step(self, label: str) -> None:
        now = time.time()
        if self._steps:
            prev_label, prev_start = self._steps[-1]
            print(f"  [{now - prev_start:7.1f}s] {prev_label}")
        self._steps.append((label, now))

    def summary(self) -> None:
        total = time.time() - self._t0
        print("\nTIMING SUMMARY")
        for i in range(len(self._steps) - 1):
            label, start = self._steps[i]
            _, end = self._steps[i + 1]
            pct = (end - start) / total * 100 if total > 0 else 0
            print(f"  {label:<40s} {end - start:8.1f}s ({pct:5.1f}%)")
        print(f"  {'TOTAL':<40s} {total:8.1f}s")


class device_trace:
    """Record a torch.profiler trace (operators and, with a card, its
    kernels) around a ``with`` block; on leaving it is written to
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto). The block gets the profiler."""

    def __init__(self, log_dir: str = "letf_tpu_torch_trace"):
        self.log_dir = log_dir
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.start()
        return self.prof

    def __exit__(self, *exc):
        self.prof.stop()
        path = os.path.join(self.log_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        print(f"  [profiler] trace written to {path}")
        return False


class annotate:
    """A named range on the profiler's timeline (``record_function``) and,
    where there is a card, on the NVTX timeline, around a ``with``
    block."""

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)
        self.nvtx = torch.cuda.is_available()

    def __enter__(self):
        self.rf.__enter__()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        return self.rf.__exit__(*exc)
