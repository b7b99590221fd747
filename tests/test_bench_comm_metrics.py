"""The parallel layer's readers (``benchmark/metrics/comm_ms.py`` and
``comm_idle_ms.py``) on hand-made traces: NCCL's kernels counted by
name, the idle time inside the ``comm.*`` spans put down to them once
however they nest, the other layers' readers unmoved by them, and
nothing read where there is nothing to read (no NCCL kernel, no
``comm.*`` span, edges that do not pair, no device)."""

import pytest

from benchmark.harness import session, spec, trace
from benchmark.metrics import (_span_idle, background_idle_ms, comm_idle_ms,
                               comm_ms, spatial_idle_ms)

B, E = _span_idle.BEGIN, _span_idle.END
CELL = "round_1p_ring_k2000_mesh4"


def _edge(kind, name, t):
    return (kind + name, t, t + 0.5)


def _profile(host, device=None, rounds=1):
    """Window [0, 100] us; by default the device busy 0-10 (a GEMM),
    40-50 (an all-reduce of NCCL's) and 90-100, so idle 10-40 and
    50-90."""
    dev = device if device is not None else [
        ("sm80_xmma_gemm_f32f32", 0.0, 10.0),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)",
         40.0, 50.0),
        ("void elementwise_kernel", 90.0, 100.0)]
    return trace.Profile(window=(0.0, 100.0), device=dev, host=host,
                         rounds=rounds)


def _obs(prof):
    return session.Observation(spec.load(CELL).config, {}, prof, ())


def test_comm_ms_counts_nccl_kernels():
    dev = [("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", 0.0, 10.0),
           ("ncclKernel_AllGather_RING_LL_Sum_int8_t(x)", 20.0, 26.0),
           ("sm80_xmma_gemm_f32f32", 30.0, 60.0),
           ("void at::native::elementwise_kernel", 60.0, 62.0)]
    assert comm_ms.read(_obs(_profile([], dev, rounds=2))) == \
        pytest.approx(16e-3 / 2)


def test_comm_ms_without_nccl_reads_nothing():
    dev = [("sm80_xmma_gemm_f32f32", 0.0, 10.0),
           ("Memcpy DtoH (Device -> Pageable)", 20.0, 26.0)]
    assert comm_ms.read(_obs(_profile([], dev))) is None
    assert comm_ms.read(session.Observation({}, {}, None, ())) is None


def test_comm_idle_is_the_idle_inside_comm_spans(capsys):
    # update_spatial 5-95 holds every idle stretch (10-40, 50-90);
    # comm.all_reduce 15-45 holds 15-40; comm.halo_rows 60-80 holds
    # 60-80, and comm.all_gather 65-70 nests in it
    host = [_edge(B, "update_spatial", 5.0),
            _edge(B, "comm.all_reduce", 15.0),
            _edge(E, "comm.all_reduce", 44.5),
            _edge(B, "comm.halo_rows", 60.0),
            _edge(B, "comm.all_gather", 65.0),
            _edge(E, "comm.all_gather", 69.5),
            _edge(E, "comm.halo_rows", 79.5),
            _edge(E, "update_spatial", 94.5)]
    obs = _obs(_profile(host, rounds=2))
    assert comm_idle_ms.read(obs) == pytest.approx(45e-3 / 2)
    err = capsys.readouterr().err
    assert "comm_idle_ms: " in err and "comm.halo_rows" in err
    # the layer that holds them reads all of its idle, as before
    assert spatial_idle_ms.read(obs) == pytest.approx(70e-3 / 2)
    assert background_idle_ms.read(obs) is None


@pytest.mark.parametrize("host", [
    [],
    [_edge(B, "update_spatial", 20.0), _edge(E, "update_spatial", 30.0)],
    [_edge(B, "comm.all_gather", 20.0)],
    [_edge(B, "update_spatial", 20.0), _edge(B, "comm.all_gather", 25.0),
     _edge(E, "update_spatial", 30.0), _edge(E, "comm.all_gather", 35.0)],
], ids=["no_spans", "no_comm_span", "begin_alone", "crossed"])
def test_comm_idle_reads_nothing_without_paired_comm_spans(host):
    assert comm_idle_ms.read(_obs(_profile(host))) is None


def test_comm_idle_without_a_device_reads_nothing():
    host = [_edge(B, "comm.all_reduce", 20.0),
            _edge(E, "comm.all_reduce", 30.0)]
    assert comm_idle_ms.read(_obs(_profile(host, device=[]))) is None
    assert comm_idle_ms.read(session.Observation({}, {}, None, ())) is None


def test_the_parallel_metrics_read_the_mesh_cell_alone():
    import json
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    mine = {m["name"]: m for m in bench["per_layer"]
            if session.base_name(m["name"]) in ("comm_ms", "comm_idle_ms")}
    assert len(mine) == 2
    for m in mine.values():
        assert m["layer"] == "parallel" and m["workloads"] == [CELL]
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]
                              if CELL in e.get("workloads", [CELL])}
    cell = spec.load(CELL)
    assert cell.chips == 4
    assert {m["name"] for m in cell.per_layer} >= set(mine)
    assert "k6_roofline" not in {session.base_name(m["name"])
                                 for m in cell.per_layer}
