"""Host-device synchronisations of a report's post-tax part: the port's
``syncs`` counter summed over the ``post_tax`` span and the spans under
it, the mean over the traced window's reports after the profiled ones.
None where the report has no ``post_tax`` span."""

from benchmark.metrics import _post_tax_spans as pt
from benchmark.metrics import _program_spans as ps


def install(run):
    pt.install(run)


def read(run):
    def syncs(spans):
        sub = pt.under_post_tax(spans)
        if sub is None:
            return None
        return float(sum(s.counters.get("syncs", 0) for s in sub))
    return ps.per_report(run, syncs)
