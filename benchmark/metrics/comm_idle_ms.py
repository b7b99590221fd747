"""comm_idle_ms: milliseconds a round in which rank 0's device was idle
while its host was inside a span of the collectives (``comm.*``:
``cnmf_e_tpu_torch/parallel/comm.py``), from the profiled rounds, read
as ``background_idle_ms`` reads its layer's spans; the innermost spans
that hold it go to standard error. A program without those spans, or a
profile whose span edges do not pair, reads nothing."""

import sys

from benchmark.metrics._span_idle import idle, innermost, intersect, spans
from benchmark.metrics._span_idle import union

PREFIX = "comm."


def read(obs):
    prof = obs.profile
    if prof is None or not prof.device:
        return None
    sp = spans(prof)
    if sp is None:
        print("comm_idle_ms: the profile's span edges do not pair",
              file=sys.stderr)
        return None
    mine = union((a, b) for name, a, b in sp if name.startswith(PREFIX))
    if not mine:
        return None
    pieces = intersect(idle(prof), mine)
    ms = sum(b - a for a, b in pieces) / prof.rounds / 1e3
    parts = sorted(innermost(sp, pieces).items(), key=lambda kv: -kv[1])
    print(f"comm_idle_ms: {ms!r} ms a round idle; by innermost span, ms a "
          "round: " + ", ".join(f"{n} {v / prof.rounds / 1e3!r}"
                                for n, v in parts), file=sys.stderr)
    return ms
