"""comm_ms: milliseconds a round of the collectives' kernels (NCCL's,
named ``nccl...``) on rank 0's device, from the profiled rounds. NCCL's
kernels spin while they wait for a slower peer, so the waits are in it
too. A run without NCCL kernels (no mesh, or gloo's host transport)
reads nothing."""

import re

NCCL = re.compile(r"nccl", re.IGNORECASE)


def read(obs):
    prof = obs.profile
    if prof is None or not prof.count(lambda n: bool(NCCL.search(n))):
        return None
    return prof.device_time_s(lambda n: bool(NCCL.search(n))) \
        / prof.rounds * 1e3
