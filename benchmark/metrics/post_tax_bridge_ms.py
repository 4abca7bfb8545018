"""Host milliseconds of the sampled tables' exact taxes: the port's
``bridge`` (the float64 device bridge, K7 and K8) and ``tax`` (the
vectorized statute) spans under ``post_tax``, both bridge groups, the
mean over the traced window's reports after the profiled ones."""

from benchmark.metrics import _post_tax_spans as pt


def install(run):
    pt.install(run)


def read(run):
    return pt.host_ms(run, ("bridge", "tax"))
