"""Hooks of the traced run, installed from outside the program: a module
attribute is swapped for a wrapper and restored afterwards, as the port's
own smoke test times its kernels.

- ``DeviceClock``: CUDA events around every call, read after the window;
- ``span``: a ``torch.profiler.record_function`` label around every call,
  which names the host's activity in the trace's idle gaps."""

from __future__ import annotations

import functools
import importlib
import time
from typing import Callable, List, Tuple

from benchmark.harness.trace import SPAN_PREFIX


class Swaps:
    """Module attributes swapped for wrappers, restored in reverse."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []

    def swap(self, module: str, attr: str,
             wrap: Callable[[Callable], Callable]) -> None:
        mod = importlib.import_module(module)
        inner = getattr(mod, attr)
        setattr(mod, attr, functools.wraps(inner)(wrap(inner)))
        self._saved.append((mod, attr, inner))

    def restore(self) -> None:
        while self._saved:
            mod, attr, inner = self._saved.pop()
            setattr(mod, attr, inner)


class _HostEvent:
    """A CUDA event's stand-in where there is no card (the CPU tests): the
    host's clock at ``record``."""

    def __init__(self, enable_timing: bool = True):
        self.t = 0.0

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


class DeviceClock:
    """The device time of every call of ``module.attr``, by report."""

    def __init__(self, swaps: Swaps, module: str, attr: str,
                 report_index: Callable[[], int]):
        import torch

        self.marks: List[Tuple[int, object, object]] = []
        self.cuda = torch.cuda.is_available()
        event = torch.cuda.Event if self.cuda else _HostEvent

        def wrap(inner):
            def timed(*args, **kw):
                a = event(enable_timing=True)
                b = event(enable_timing=True)
                a.record()
                out = inner(*args, **kw)
                b.record()
                self.marks.append((report_index(), a, b))
                return out
            return timed

        swaps.swap(module, attr, wrap)

    def calls_ms(self) -> List[Tuple[int, float]]:
        """[(report index, milliseconds)] of every call (synchronizes)."""
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        return [(k, a.elapsed_time(b)) for k, a, b in self.marks]


def span(swaps: Swaps, module: str, attr: str) -> None:
    """Label every call of ``module.attr`` in the profiler trace."""
    from torch.profiler import record_function

    label = f"{SPAN_PREFIX}{module.rsplit('.', 1)[-1]}.{attr}"

    def wrap(inner):
        def labelled(*args, **kw):
            with record_function(label):
                return inner(*args, **kw)
        return labelled

    swaps.swap(module, attr, wrap)
