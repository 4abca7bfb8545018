"""The measured window: one client in a closed loop.

The client issues report k (seed ``--seed + k``) as soon as report k - 1
has returned, and issues none once ``seconds`` have passed since the first
was issued; the window ends when the last report issued has returned. The
rate is every completed report's trial-years over the whole window (end
of the last report minus the issue of the first): a stall or a failed
report counts as time, and only a completed report counts as work.
"""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback
from typing import Callable, List


@dataclasses.dataclass
class Window:
    start: float                 # issue of the first report (host clock)
    end: float                   # return of the last report
    attempted: int
    failed: int
    work: float                  # trial-years of the completed reports
    report_seconds: List[float]  # each report's issue-to-return time

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def rate(self) -> float:
        """Trial-years a second over the whole window."""
        return self.work / self.seconds


def closed_loop(issue: Callable[[int], float], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run ``issue(k)`` for k = 0, 1, ... back to back; ``issue`` returns
    the trial-years of report k once its result is on the host, or raises
    when the report failed."""
    start = clock()
    end = start
    k = failed = 0
    work = 0.0
    times = []
    while k == 0 or end - start < seconds:
        t0 = clock()
        try:
            work += issue(k)
        except Exception:                       # a failed report is counted
            failed += 1
            traceback.print_exc(file=sys.stderr)
        end = clock()
        times.append(end - t0)
        k += 1
    return Window(start, end, k, failed, work, times)
