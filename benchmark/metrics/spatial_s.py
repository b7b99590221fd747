"""spatial_s: seconds a round in the spatial update
(update_spatial): the mean over the traced run's
spanned rounds, each span closed by a synchronisation."""

from benchmark.metrics._stage import mean_span


def read(obs):
    return mean_span(obs, "spatial")
