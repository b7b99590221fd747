"""idle_share: the percentage of the profiled window in which nothing ran
on the device: 1 - (the union of its kernels' and copies' intervals) /
(the window)."""


def read(obs):
    prof = obs.profile
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)
