"""A checkout root of tiny cells for the CPU tests: BENCHMARK.json and the
benchmark's data files copied, every configuration cut to H x W x T and
every traffic to K neurons on a finer lattice."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.harness import spec

DATA = ("configs", "traffic", "limits")


def tiny_root(tmp: Path, H: int = 48, W: int = 48, T: int = 300,
              K: int = 8) -> Path:
    root = Path(tmp) / "checkout"
    for d in DATA:
        shutil.copytree(spec.HERE / d, root / "benchmark" / d)
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for p in (root / "benchmark" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(H=H, W=W, T=T)
        p.write_text(json.dumps(c))
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(K=K)
        p.write_text(json.dumps(t))
    return root
