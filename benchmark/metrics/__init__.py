"""Per-layer metrics, one file a metric, named as the metric is in
``BENCHMARK.json`` and loaded by path (``harness.reader``).  A reader defines
``NAME``, ``UNIT``, ``LAYER`` and ``MOVES`` (as ``BENCHMARK.json`` states them)
and ``read(ctx)`` -> a number, or ``None`` where it finds nothing to read (the
metric is then left out).  ``ctx`` is built in ``harness.run``.  Later changes
add readers and never edit one."""
