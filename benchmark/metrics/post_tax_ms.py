"""Host milliseconds of a report's post-tax part: the port's ``post_tax``
span (``monte_carlo_report``: the sampled tables' pick, replay, bridge,
tax and interpolation, and the tables' assembly), the mean over the
traced window's reports after the profiled ones. None where the report
has no such span."""

from benchmark.metrics import _post_tax_spans as pt


def install(run):
    pt.install(run)


def read(run):
    return pt.host_ms(run, ("post_tax",))
