"""Device milliseconds of the per-trial engine's draws in one report
(``ops/path_engine.draw_innovations``: the threefry normal, gamma and t
draws): CUDA events around every call, summed per report, the mean over
the traced window's reports after the profiled first one."""

TARGET = ("letf_tpu_torch.ops.path_engine", "draw_innovations")


def install(run):
    run.clock(*TARGET)


def read(run):
    per = run.per_report_ms(*TARGET)
    return sum(per.values()) / len(per) if per else None
