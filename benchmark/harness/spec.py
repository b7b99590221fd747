"""Find a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists the cells
(``workloads``), the configurations and the metrics. A cell's
configuration is the file its ``configs`` entry names; its traffic is
``benchmark/traffic/<traffic>.json``; the limits of its check are
``benchmark/limits/<cell>.json``; its metrics are the entries of
``end_to_end`` and ``per_layer`` that list the cell (or list no cells),
a per-layer metric read by ``benchmark/metrics/<name>.py``, where
``<name>`` is the metric's name up to its first dot (``gemm_ms`` and
``gemm_ms.host_paced`` are one quantity, moving different end-to-end
metrics). Adding a cell, a configuration or a metric is adding those
files and entries.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
HERE = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    here = root / HERE.name
    return Cell(
        name=name, chips=int(w["chips"]), config=config,
        traffic=_read(here / "traffic" / f"{w['traffic']}.json"),
        limits=_read(here / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])
