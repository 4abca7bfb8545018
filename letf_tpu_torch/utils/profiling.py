"""Tracing/profiling: the port's span tracer and torch.profiler hooks.

The tracer names the layers of the report path. ``span(name)`` is a
context manager around one layer's work; ``count(name, n)`` adds to a
counter of the innermost open span. Tracing is off unless turned on
(``enable()`` / ``disable()``, or a ``with tracing():`` block); off,
``span`` returns one shared no-op context and ``count`` returns at once,
so the off path takes no clock, records no event and allocates nothing.

On, a span records its name, its id, its parent's id, the id of the
report it belongs to (each outermost ``report`` span opens a new one,
which its descendants share), its host start and end in
``time.time_ns()`` (Unix-epoch nanoseconds, the clock of the profiler's
events, so a span lies beside the device trace), a pair of CUDA events
on the current stream (a host-clock stand-in where CUDA has not been
initialised) and its counters. Everything stays in memory;
``records()`` reads the events' elapsed times and returns the finished
spans, ``reset()`` drops them. On the profiler's timeline each span is a
host operation named ``letf.<name>`` (``_RecordFunctionFast``: a
``cpu_op``, with no echo over the device's kernels).

Counters: ``syncs`` is every host-device synchronisation made while
tracing is on, charged to the span open in the thread that made it
(torch's sync debug mode warns at each synchronising call; the tracer
counts the warnings and drops them). Other modules count their own
events (``ops/rng``: ``draw_rounds``, the twin's gamma rejection rounds,
0 from the kernel; ``fused_draws`` and ``plain_draws``, the elements the
samplers' kernel and their torch twin drew).

The open span is a context variable: each thread has its own stack, and
``utils/guard.guarded`` hands the caller's span to its worker thread.

``device_trace`` records a ``torch.profiler`` trace of a block (CPU and,
where there is a card, CUDA activity) with tracing on and writes it to
``log_dir`` as a Chrome trace; ``annotate`` names a range on both the
profiler's timeline and, with a card, the NVTX one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch

PREFIX = "letf."                    # span names on the profiler's timeline
SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class SpanRecord:
    """One finished span. ``device_ms`` is the time between its two
    events on the stream it opened on (host milliseconds where it ran
    without CUDA events)."""
    name: str
    id: int
    parent: Optional[int]
    report: Optional[int]
    thread: int
    start_ns: int = 0
    end_ns: int = 0
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _HostEvent:
    """A CUDA event's stand-in without CUDA: the host's clock."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


class _Tracer:
    """The process's spans: on/off, the finished spans, and the hooks
    tracing installs (sync debug mode and its warnings)."""

    def __init__(self):
        self.on = False
        self.finished: List[SpanRecord] = []
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.report_ids = itertools.count(1)
        self.current: contextvars.ContextVar = contextvars.ContextVar(
            "letf_span", default=None)
        self.saved_warnings = None      # state tracing replaced, restored
        self.saved_show = None          # when it is turned off
        self.saved_sync_mode = None


_T = _Tracer()
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "token", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        parent = _T.current.get()
        report = parent.report if parent is not None else None
        if report is None and self.name == "report":
            report = next(_T.report_ids)
        rec = self.rec = SpanRecord(
            self.name, next(_T.ids), parent.id if parent is not None
            else None, report, threading.get_ident())
        self.token = _T.current.set(rec)
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + rec.name)
        self.rf.__enter__()
        ev = ((torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              if torch.cuda.is_initialized() else (_HostEvent(),
                                                   _HostEvent()))
        rec.events = ev
        rec.start_ns = time.time_ns()
        ev[0].record()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.events[1].record()
        rec.end_ns = time.time_ns()
        self.rf.__exit__(*exc)
        _T.current.reset(self.token)
        _T.finished.append(rec)
        return False


def span(name: str):
    """A context manager around one layer's work (a no-op when tracing is
    off)."""
    if not _T.on:
        return _NOOP
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span."""
    if not _T.on:
        return
    rec = _T.current.get()
    if rec is not None:
        with _T.lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


def _show(message, category, filename, lineno, file=None, line=None):
    """The warnings hook while tracing: a synchronising call counts on the
    open span (shown only where sync debug mode was on before tracing);
    any other warning goes on to the hook that was there."""
    if str(message).startswith(SYNC_WARNING):
        count("syncs")
        if not _T.saved_sync_mode:
            return
    _T.saved_show(message, category, filename, lineno, file, line)


def enable() -> None:
    """Turn tracing on (a no-op when it is on)."""
    if _T.on:
        return
    _T.saved_warnings = warnings.catch_warnings()
    _T.saved_warnings.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    _T.saved_show = warnings.showwarning
    warnings.showwarning = _show
    if torch.cuda.is_available():
        _T.saved_sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _T.on = True


def disable() -> None:
    """Turn tracing off (a no-op when it is off); finished spans stay."""
    if not _T.on:
        return
    _T.on = False
    if _T.saved_sync_mode is not None:
        torch.cuda.set_sync_debug_mode(_T.saved_sync_mode)
        _T.saved_sync_mode = None
    _T.saved_warnings.__exit__(None, None, None)
    _T.saved_warnings = _T.saved_show = None


class tracing:
    """Tracing on inside a ``with`` block (and left as it was after
    it)."""

    def __enter__(self):
        self.was = _T.on
        enable()
        return self

    def __exit__(self, *exc):
        if not self.was:
            disable()
        return False


def records() -> List[SpanRecord]:
    """The finished spans in the order they started, each with its
    ``device_ms`` (waits for the device to reach each span's end)."""
    done = list(_T.finished)
    for rec in done:
        if rec.events is not None:
            a, b = rec.events
            if isinstance(b, torch.cuda.Event):
                b.synchronize()
            rec.device_ms = a.elapsed_time(b)
            rec.events = None
    return sorted(done, key=lambda r: (r.start_ns, r.id))


def reset() -> None:
    """Drop the finished spans."""
    _T.finished.clear()


class device_trace:
    """Record a torch.profiler trace (operators, the port's spans and,
    with a card, its kernels) around a ``with`` block, tracing on inside
    it; on leaving it is written to ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto). The block gets the profiler."""

    def __init__(self, log_dir: str = "letf_tpu_torch_trace"):
        self.log_dir = log_dir
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.tracing = tracing()

    def __enter__(self):
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.start()
        self.tracing.__enter__()
        return self.prof

    def __exit__(self, *exc):
        self.tracing.__exit__(*exc)
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
