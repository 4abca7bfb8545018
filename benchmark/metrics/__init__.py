"""One file a per-layer metric, named as the metric: ``install(run)``
(optional; hooks for the traced window) and ``read(run)`` -> the number,
or None where the run has nothing to read (the metric is then left out)."""
