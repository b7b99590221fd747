"""Per-layer metrics: one module a metric, named as in BENCHMARK.json,
each with ``read(obs) -> float | None`` over a
:class:`benchmark.harness.session.Observation`. A reader that finds
nothing to read returns None, and the metric is left out of the line."""
