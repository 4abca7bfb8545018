"""The port's one exception boundary.

``guarded(fn, timeout)`` runs ``fn`` on a worker thread and hands back
what it returned or what it raised, as a value: the chunk containment of
``parallel/mc_runner.run_monte_carlo`` (each chunk attempt under its
timeout) and the network downloads of ``data.py`` (a failed download is
reported and yields no data, as the reference's loaders do) are its only
callers. Nothing else in the port catches an exception, so no failure of
the card or of a kernel is hidden by a fallback.
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Callable, Optional, Tuple


def guarded(fn: Callable[[], Any], timeout: Optional[float] = None
            ) -> Tuple[Any, Optional[BaseException]]:
    """(fn()'s value, None), (None, the exception fn raised), or (None, a
    TimeoutError) when fn has not returned within ``timeout`` seconds; the
    thread is then left to finish and its result is dropped."""
    ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    fut = ex.submit(fn)
    done, _ = concurrent.futures.wait([fut], timeout=timeout)
    ex.shutdown(wait=False)
    if not done:
        return None, TimeoutError(f"no result within {timeout} s")
    err = fut.exception()
    return (None, err) if err is not None else (fut.result(), None)
