"""Share of the samplers' draws that the fused kernel drew in one report:
the port's ``fused_draws`` counter (``ops/rng._launch``: the elements
``csrc/draws.cu`` drew for ``normal``, ``gamma`` and ``t``) over it plus
``plain_draws`` (the elements the torch twin drew), each summed over the
report's spans; the mean over the traced window's reports after the
profiled ones. None where no span of a report counted either (a port
without the counters)."""

from benchmark.metrics import _program_spans as ps


def install(run):
    ps.install(run)


def share(spans):
    fused = ps.counter("fused_draws")(spans)
    plain = ps.counter("plain_draws")(spans)
    if fused is None and plain is None:
        return None
    total = (fused or 0.0) + (plain or 0.0)
    return (fused or 0.0) / total if total else None


def read(run):
    return ps.per_report(run, share)
