"""kernels_ms: milliseconds a round of the port's own CUDA kernels on the
device, from the profiled rounds. A kernel is the port's when its name
holds one of ``cuda_build.KERNELS`` (less a ``_flat`` or ``_htw``
layout suffix: K5 and K7 share ``ring_banded_kernel``). The profile's
launches of each must equal the program's own count
(``cuda_build.LAUNCHES`` over the same rounds); where they do not, the
profiler dropped events and nothing is read."""

import sys


def stems(names):
    out = {}
    for k in names:
        stem = k
        for suffix in ("_flat", "_htw"):
            stem = stem[:-len(suffix)] if stem.endswith(suffix) else stem
        out.setdefault(stem, []).append(k)
    return out


def read(obs):
    prof = obs.profile
    if prof is None:
        return None
    total = 0.0
    for stem, names in stems(obs.kernel_names).items():
        match = (lambda n, s=stem: s in n)
        seen = prof.count(match)
        counted = sum(prof.launches.get(k, 0) for k in names)
        if seen != counted:
            print(f"kernels_ms: the profile holds {seen} launches of "
                  f"{stem}, the program counted {counted}", file=sys.stderr)
            return None
        total += prof.device_time_s(match)
    if not sum(prof.launches.values()):
        return None
    return total / prof.rounds * 1e3
