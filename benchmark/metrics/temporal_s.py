"""temporal_s: seconds a round in the temporal update
(update_temporal): the mean over the traced run's
spanned rounds, each span closed by a synchronisation."""

from benchmark.metrics._stage import mean_span


def read(obs):
    return mean_span(obs, "temporal")
