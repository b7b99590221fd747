"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--out DIR]

Each reading is one run of the cell as ``run_cell.py`` makes it (the
inputs from the seed, a warm-up round, a window of one round, the plain
reference's round and every candidate number of the check), in this
process. For each of ``--seeds`` the program's round is judged (the
lower readings); for each of ``--control-seeds`` the control takes its
place: the reference's round with TF32 products
(``entries/<round>.py::control_round``), judged against the float32
reference (the upper readings). One JSON line a reading on standard
output, and in ``DIR/calibrate_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import inputs, session, spec  # noqa: E402


def readings(name: str, seed: int, control: bool, device=None) -> dict:
    round_fn = None
    if control:
        cell = spec.load(name)
        entry = importlib.import_module(
            f"benchmark.entries.{cell.config['round']}")
        ref = importlib.import_module(
            f"benchmark.references.{cell.config['round']}")
        rows, _ = inputs.check_sample(cell.config, cell.traffic,
                                      cell.limits, seed)
        round_fn = entry.control_round(ref, cell.config["params"], rows)
    t0 = time.perf_counter()
    res, _, nums = session.run(name, seed, 0.0, False, t0, device=device,
                               round_fn=round_fn)
    return {"cell": name, "seed": seed,
            "side": "control" if control else "program",
            "correct": res["correct"], "wall_s": time.perf_counter() - t0,
            "numbers": nums}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    out = None
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        out = open(os.path.join(args.out,
                                f"calibrate_{args.workload}.jsonl"), "a")
    jobs = [(int(s), False) for s in args.seeds.split(",") if s] + \
        [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in jobs:
        line = json.dumps(readings(args.workload, seed, control))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    session.refuse_forbidden("calibration")
    return 0


if __name__ == "__main__":
    sys.exit(main())
