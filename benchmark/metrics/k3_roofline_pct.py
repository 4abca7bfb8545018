"""K3's share of its roofline in the traced report: the least time of
its launches (``benchmark/rooflines/k3.py`` at the chunk's shape, against
``harness/peaks.py``) over their device time in the profiler trace."""


def read(run):
    return run.roofline_pct("k3")
