"""The device's idle share of a pre-tax report: 100 x (1 - the union of
its device operations' intervals over the report's time on the host's
clock), read from the traced window's device-only report (no host
operations or spans traced, so the host keeps nearly its own pace)."""


def read(run):
    return run.trace.idle_pct if run.trace is not None else None
