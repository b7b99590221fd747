"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run_cell.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout. Needs the CUDA devices the cell asks for
and exits with code 2, printing no result, where they are missing. The
last line of standard output is the result (JSON); the numbers of the
check, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark.harness import session
    result, notes, _ = session.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_PROCESS)
    session.refuse_forbidden("before the result")
    for line in notes:
        print(line, file=sys.stderr)
    for k, c in result["checks"].items():
        v = "not finite" if c["value"] is None else repr(c["value"])
        print(f"check {k} {v} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
