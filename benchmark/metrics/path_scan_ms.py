"""Device milliseconds of the per-trial engine's path math in one report
(``ops/path_engine.path_from_innovations``: the parametric t draws, the
VIX, stress, funding, leverage and tracking-error day scans, the window):
CUDA events around every call, summed per report, the mean over the
traced window's reports after the profiled first one."""

TARGET = ("letf_tpu_torch.ops.path_engine", "path_from_innovations")


def install(run):
    run.clock(*TARGET)


def read(run):
    per = run.per_report_ms(*TARGET)
    return sum(per.values()) / len(per) if per else None
