"""Tests that need the card (marked ``card``; each skips without one, as
decided inside the fixture). Run them on the card with

    python3 -m pytest benchmark -m card -q

The control on the card (the reference with the card's TF32 products)
fails the limits where the port passes, at a size a test holds; a
checkout that holds only the benchmark's own files gives no result."""

import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.entries import update_round as entry
from benchmark.harness import inputs, session, spec
from benchmark.references import update_round as ref
from benchmark.tests.tiny import tiny_root


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.card
@pytest.mark.parametrize("cell", ["round_1p_ring_k2000",
                                  "round_2p_svd_k1000"])
def test_port_passes_and_control_fails_on_the_card(card, tmp_path, cell):
    root = tiny_root(tmp_path, H=128, W=128, T=1000, K=64)
    seed = 2 ** 31 + 3
    res, _, _ = session.run(cell, seed, 1.0, False, time.perf_counter(),
                            device=card, root=root)
    assert res["correct"] is True
    c = spec.load(cell, root)
    rows, _ = inputs.check_sample(c.config, c.traffic, c.limits, seed)
    res, _, _ = session.run(cell, seed, 0.0, False, time.perf_counter(),
                            device=card, root=root,
                            round_fn=entry.control_round(
                                ref, c.config["params"], rows))
    assert res["correct"] is False


@pytest.mark.card
def test_only_the_benchmarks_files_give_no_result(card, tmp_path):
    """A directory holding only BENCHMARK.json and the files under
    ``paths``: the port is missing, the run exits non-zero and prints no
    result."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / spec.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run_cell.py", "--workload",
         "round_1p_ring_k300", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
