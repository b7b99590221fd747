"""gemm_ms: milliseconds a round of the library's matrix products
(cuBLAS and its CUTLASS kernels, named gemm or gemv) on the device, from
the profiled rounds."""

import re

GEMM = re.compile(r"gemm|gemv", re.IGNORECASE)


def read(obs):
    prof = obs.profile
    if prof is None or not prof.count(lambda n: bool(GEMM.search(n))):
        return None
    return prof.device_time_s(lambda n: bool(GEMM.search(n))) \
        / prof.rounds * 1e3
