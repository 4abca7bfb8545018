"""The traced report's profiler trace, reduced: device busy time as the
union of the device operations' intervals, the idle gaps between them
labelled by what the host was doing, and device time by kernel.

The reductions work on plain (name, start, end) tuples in microseconds,
so the tests can drive them without a card."""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[str, float, float]          # (name, start_us, end_us)

SPAN_PREFIX = "bench:"    # record_function labels of the harness's spans


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of intervals (time in which any ran)."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] outside the intervals."""
    out, t = [], lo
    for s, e in union(intervals):
        s, e = max(s, lo), min(e, hi)
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_at(t: float, host: Sequence[Interval]) -> str:
    """What the host was doing at ``t``: the innermost harness span open
    then and the innermost other host event open then (the latest-started
    of each kind)."""
    span = op = None
    for name, s, e in host:
        if s <= t < e:
            if name.startswith(SPAN_PREFIX):
                if span is None or s >= span[1]:
                    span = (name[len(SPAN_PREFIX):], s)
            elif op is None or s >= op[1]:
                op = (name, s)
    parts = [p[0] for p in (span, op) if p is not None]
    return " / ".join(parts) if parts else "host outside any traced call"


def idle_by_label(device: Sequence[Interval], host: Sequence[Interval],
                  lo: float, hi: float) -> Dict[str, float]:
    """Idle microseconds of [lo, hi], summed by the host's activity at the
    start of each gap."""
    spans = [h for h in host if h[0].startswith(SPAN_PREFIX)]
    ops = sorted((h for h in host if not h[0].startswith(SPAN_PREFIX)),
                 key=lambda h: h[1])
    starts = [h[1] for h in ops]
    out: Dict[str, float] = {}
    for g0, g1 in gaps(((s, e) for _, s, e in device), lo, hi):
        i = bisect.bisect_right(starts, g0)
        # host ops are short or nested: those open at the gap's start are
        # among the last few thousand that started before it.
        near = [h for h in ops[max(0, i - 4096):i] if h[2] > g0]
        lab = label_at(g0, [h for h in spans if h[1] <= g0 < h[2]] + near)
        out[lab] = out.get(lab, 0.0) + (g1 - g0)
    return out


def by_name(device: Sequence[Interval]) -> Dict[str, Tuple[float, int]]:
    """{name: (device microseconds, launches)}."""
    out: Dict[str, Tuple[float, int]] = {}
    for name, s, e in device:
        us, n = out.get(name, (0.0, 0))
        out[name] = (us + (e - s), n + 1)
    return out


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


@dataclasses.dataclass
class TraceSummary:
    window_s: float                       # the traced span (host clock)
    busy_s: float                         # union of device operations
    kernels: Dict[str, Tuple[float, int]]  # name -> (device s, launches)
    idle: Dict[str, float]                # host label -> idle seconds
    events: int                           # device operations traced

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        ``pattern``."""
        s = n = 0
        for name, (sec, k) in self.kernels.items():
            if pattern in name:
                s, n = s + sec, n + k
        return s, n

    def breakdown(self) -> dict:
        return {"device_ops": top({k: v[0] for k, v in
                                   self.kernels.items()}),
                "idle_gaps": top(self.idle)}


def summarize(device: Sequence[Interval], host: Sequence[Interval],
              lo: float, hi: float) -> TraceSummary:
    """The reductions of one traced span [lo, hi] (microseconds)."""
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in device
           if e > lo and s < hi]
    kern = {k: (us * 1e-6, n) for k, (us, n) in by_name(dev).items()}
    idle = {k: us * 1e-6 for k, us in
            idle_by_label(dev, host, lo, hi).items()}
    return TraceSummary((hi - lo) * 1e-6,
                        busy_us((s, e) for _, s, e in dev) * 1e-6,
                        kern, idle, len(dev))


def from_profiler(prof, wall_s: float) -> TraceSummary:
    """The reductions of a finished torch.profiler run over one report:
    its window is ``wall_s``, the report's time on the host's clock (from
    just inside the profiler to the device's last operation), placed over
    the traced events so that it ends with the last of them. The
    device-side echoes of the harness's spans (user annotations on the
    device timeline) are not device operations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns() / 1e3
        e = s + ev.duration_ns() / 1e3
        name = ev.name()
        if ev.device_type() != cuda:
            host.append((name, s, e))
        elif not name.startswith(SPAN_PREFIX):  # not a span's echo
            device.append((name, s, e))
    ends = [e for _, _, e in device + host]
    hi = max(ends) if ends else 0.0
    return summarize(device, host, hi - wall_s * 1e6, hi)
