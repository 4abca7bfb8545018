"""What the post-tax readers share: a report's ``post_tax`` span
(``parallel/mc_runner.monte_carlo_report``) and the spans under it (the
stages of ``reporting.sampled_post_tax_tables``: ``pick_rows``,
``replay`` with the general path's spans, ``bridge``, ``tax``,
``interp_reduce``). A report without a ``post_tax`` span has nothing to
read: the readers leave their metrics out."""

from __future__ import annotations

from typing import List, Optional

from benchmark.metrics import _program_spans as ps


def install(run) -> None:
    ps.install(run)


def under_post_tax(spans) -> Optional[List]:
    """The report's ``post_tax`` span and its descendants, or None."""
    roots = [s for s in spans if s.name == "post_tax"]
    if not roots:
        return None
    keep = {s.id for s in roots}
    out = list(roots)
    for s in sorted(spans, key=lambda s: (s.start_ns, s.id)):
        if s.parent in keep and s.id not in keep:
            keep.add(s.id)
            out.append(s)
    return out


def host_ms(run, names) -> Optional[float]:
    """The mean over reports of the host ms of the spans named ``names``
    under ``post_tax``."""
    def value(spans):
        sub = under_post_tax(spans)
        if sub is None:
            return None
        return sum(s.host_ms for s in sub if s.name in names)
    return ps.per_report(run, value)
