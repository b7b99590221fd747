"""k6_roofline: K6 (``ring_stencil``)'s roofline share, in percent: the
least time its launches of the profiled rounds could take on the card
(each at the ring model's grid of the configuration, ``peaks``) over
their device time. Nothing is read without a ring background, or where
the program's launch count or the profile's differ (the shapes of the
launches are then not known)."""

from benchmark.harness import peaks


def read(obs):
    prof = obs.profile
    geo = peaks.ring_geometry(obs.config)
    if prof is None or geo is None:
        return None
    match = (lambda n: "ring_stencil" in n)
    n = prof.count(match)
    if n == 0 or n != prof.launches.get("ring_stencil", 0):
        return None
    t_bound, _ = peaks.bound_s(*peaks.ring_stencil_cost(*geo))
    return 100.0 * n * t_bound / prof.device_time_s(match)
