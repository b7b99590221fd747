"""Seconds a round of one layer's synchronised span."""

import statistics


def mean_span(obs, stage: str):
    s = obs.spans.get(stage)
    return statistics.fmean(s) if s else None
