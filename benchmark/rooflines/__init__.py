"""One file a kernel: ``KERNEL`` (its name in the device trace) and
``count(shape)`` -> (float32 operations, bytes) of one launch, counted from
the work the algorithm needs at the call's shapes, so that a rewrite of
the kernel cannot move its own yardstick. ``shape``: ``trials`` (trials a
launch), ``sim_days`` and ``buffer_days``."""
