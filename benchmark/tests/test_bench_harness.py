"""The harness's arithmetic and data on the CPU: cells found by name, a
new cell picked up without edits, the rate of a hand-made window, K6's
operations and bytes at hand-worked shapes, the trace's reductions and
the readers, and the result line's keys."""

import json
import re
import time

import pytest
import torch

from benchmark.harness import peaks, session, spec, trace
from benchmark.metrics import (gemm_ms, idle_share, k6_roofline,
                               kernels_ms)
from benchmark.tests.tiny import tiny_root

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("name", CELLS)
def test_cells_found_by_name(name):
    cell = spec.load(name)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert cell.traffic["K"] > 0 and cell.limits["limits"]
    per_layer = {session.base_name(m["name"]) for m in cell.per_layer}
    ring = cell.config["params"]["background"]["model"] == "ring"
    assert ("k6_roofline" in per_layer) == ring
    assert {session.base_name(m["name"]) for m in cell.end_to_end} == {
        "round_mpfps", "peak_mem_gib", "setup_s"}
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert (spec.HERE / "metrics"
                / f"{session.base_name(m['name'])}.py").exists()


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load("no_such_cell")


def test_new_cell_is_picked_up_without_edits(tmp_path):
    """A cell added as data: a traffic file, a limits file and an entry
    in BENCHMARK.json; no file of the harness changes."""
    root = tiny_root(tmp_path)
    here = root / "benchmark"
    t = json.loads((here / "traffic" / "planted_k300.json").read_text())
    t.update(K=5)
    (here / "traffic" / "planted_k5.json").write_text(json.dumps(t))
    (here / "limits" / "round_1p_ring_k5.json").write_text(
        (here / "limits" / "round_1p_ring_k300.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "round_1p_ring_k5",
                               "config": "cnmfe_1p_ring_512",
                               "traffic": "planted_k5", "chips": 1,
                               "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load("round_1p_ring_k5", root)
    assert cell.traffic["K"] == 5
    # metrics that list their cells leave the new one out until listed
    assert not cell.per_layer
    res, _, _ = session.run("round_1p_ring_k5", 7, 0.01, False,
                         time.perf_counter(), device="cpu", root=root)
    assert res["correct"] and res["attempted"] >= 1


def test_benchmark_json_keeps_to_its_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).exists()
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("config", [c["file"] for c in BENCH["configs"]])
def test_configs_are_the_presets_they_name(config):
    from benchmark.entries import update_round
    c = json.loads((spec.ROOT / config).read_text())
    update_round.params(c)            # raises where the file differs
    bench = {b["file"]: b for b in BENCH["configs"]}[config]
    assert sorted(bench["reduced"]) == sorted(c["reduced"])


def test_round_mpfps_of_a_hand_made_window():
    config = {"H": 512, "W": 512, "T": 6000}
    # three rounds of 512 * 512 * 6000 pixel-frames in 12 s
    assert session.mpfps(3, config, 12.0) == pytest.approx(393.216)
    assert session.mpfps(1, {"H": 2, "W": 5, "T": 100}, 1e-6) == \
        pytest.approx(1000.0)


def test_k6_operations_and_bytes_at_hand_worked_shapes():
    # radius 1: the 8 neighbours at distance [1, 2)
    assert peaks.ring_taps(1) == 8
    flops, nbytes = peaks.ring_stencil_cost(2, 4, 4, 1)
    assert flops == 17 * 32                     # (2 R + 1) T H W
    assert nbytes == 4 * (2 * 32 + 16 * 8 + 16)  # X, out, w, w0
    t, by = peaks.bound_s(flops, nbytes)
    assert by == "bytes" and t == pytest.approx(832 / 3.35e12)
    # the 1p cells: radius 18 on the 2x grid is radius 9, R = 56
    assert peaks.ring_taps(9) == 56
    flops, nbytes = peaks.ring_stencil_cost(6000, 256, 256, 9)
    assert flops == 113 * 6000 * 65536
    assert nbytes == 4 * (2 * 6000 * 65536 + 65536 * 56 + 65536)
    assert peaks.ring_geometry(spec.load("round_1p_ring_k300").config) \
        == (8000, 256, 256, 9)
    assert peaks.ring_geometry(
        spec.load("round_2p_svd_k1000").config) is None


def _profile():
    """Two rounds, window [0, 100] us: a K6 launch, a GEMM and a K1
    launch, overlapping copies, idle 20-30 and 70-100."""
    dev = [("ring_stencil_regs_kernel<9>", 0.0, 10.0),
           ("sm80_xmma_gemm_f32f32", 5.0, 20.0),
           ("void hals_sweeps_kernel<16>", 30.0, 60.0),
           ("Memcpy DtoH", 55.0, 70.0)]
    host = [("bench.stage.background", 0.0, 27.0),
            ("aten::item", 21.0, 29.0),
            ("bench.stage.spatial", 27.0, 100.0),
            ("aten::copy_", 72.0, 75.0)]
    return trace.Profile(window=(0.0, 100.0), device=dev, host=host,
                         rounds=2, launches={"ring_stencil": 1,
                                             "hals_sweeps": 1})


def test_trace_reductions():
    prof = _profile()
    assert prof.busy() == [(0.0, 20.0), (30.0, 70.0)]
    assert prof.busy_s() == pytest.approx(60e-6)
    gaps = prof.idle_gaps()
    assert gaps[0][0] == "spatial: after aten::copy_"
    assert gaps[0][1] == pytest.approx(30e-6)
    assert gaps[1][0] == "background: aten::item"
    assert prof.top_ops(1)[0][0] == "void hals_sweeps_kernel<16>"


def _obs(prof, config=None):
    config = config or spec.load("round_1p_ring_k300").config
    return session.Observation(config, {}, prof,
                               ("hals_sweeps", "oasis_chunk_pools",
                                "ring_stencil", "ring_banded_flat",
                                "ring_banded_htw"))


def test_readers_on_a_hand_made_trace():
    prof = _profile()
    obs = _obs(prof)
    assert idle_share.read(obs) == pytest.approx(40.0)
    assert gemm_ms.read(obs) == pytest.approx(15e-3 / 2)
    assert kernels_ms.read(obs) == pytest.approx(40e-3 / 2)
    t_bound, _ = peaks.bound_s(*peaks.ring_stencil_cost(8000, 256, 256, 9))
    assert k6_roofline.read(obs) == pytest.approx(
        100 * t_bound / 10e-6)
    # the profile dropped a launch: nothing is read
    prof.launches["hals_sweeps"] = 2
    assert kernels_ms.read(obs) is None
    # no ring background: no K6 roofline
    assert k6_roofline.read(_obs(
        prof, spec.load("round_2p_svd_k1000").config)) is None


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(tmp_path, traced):
    # the traced run profiles the plain versions' many small CPU ops
    root = tiny_root(tmp_path, H=32, W=32, T=128, K=4) if traced \
        else tiny_root(tmp_path)
    res, notes, _ = session.run("round_1p_ring_k300", 2 ** 31 + 11, 0.01,
                             traced, time.perf_counter(), device="cpu",
                             root=root)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) \
        + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = spec.load("round_1p_ring_k300", root)
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["metrics"]) == {
            f"{m}.host_paced" for m in ("background_s", "spatial_s",
                                        "temporal_s", "idle_share")}
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["checks"]) == set(cell.limits["limits"])
    json.dumps(res)


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        session.require_card(1)
    assert e.value.code == 2
