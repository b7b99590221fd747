"""spatial_idle_ms: milliseconds a round in which the device was idle
while the host was inside the spatial update's span
(``update_spatial``), from the profiled rounds; the innermost spans that
hold it go to standard error."""

from benchmark.metrics._span_idle import layer_idle_ms


def read(obs):
    return layer_idle_ms(obs, "spatial", "spatial_idle_ms")
