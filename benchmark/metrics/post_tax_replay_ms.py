"""Host milliseconds of the sampled tables' replay: the port's ``replay``
span under ``post_tax`` (the picked rows' general path with journal
emission: K1, K2', K5 and the emitting engine's torch day loops), the
mean over the traced window's reports after the profiled ones."""

from benchmark.metrics import _post_tax_spans as pt


def install(run):
    pt.install(run)


def read(run):
    return pt.host_ms(run, ("replay",))
