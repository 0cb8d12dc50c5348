"""Per-layer metrics: one reader a file, ``read(ctx) -> float | None``
(``ctx`` is ``harness.Context``). A reader that finds nothing to read
returns None and the metric is left out of the run's line."""
