"""The idle-time readers (``background_idle_ms``, ``spatial_idle_ms``,
``temporal_idle_ms``) on hand-made traces: idle time cut at a span's
edges, nested spans counted once, the innermost span named, and nothing
read where the edges do not pair or no span of the layer is there."""

import pytest

from benchmark.harness import session, spec, trace
from benchmark.metrics import (_span_idle, background_idle_ms, gemm_ms,
                               idle_share, kernels_ms, spatial_idle_ms,
                               temporal_idle_ms)

B, E = _span_idle.BEGIN, _span_idle.END


def _edge(kind, name, t):
    return (kind + name, t, t + 0.5)


def _profile(host, rounds=1):
    """Window [0, 100] us; the device busy 0-10, 40-50 and 90-100, so
    idle 10-40 and 50-90."""
    dev = [("sm80_xmma_gemm_f32f32", 0.0, 10.0),
           ("void hals_sweeps_kernel<16>", 40.0, 50.0),
           ("void elementwise_kernel", 90.0, 100.0)]
    return trace.Profile(window=(0.0, 100.0), device=dev, host=host,
                         rounds=rounds, launches={"hals_sweeps": 1})


def _obs(prof):
    return session.Observation(spec.load("round_1p_ring_k300").config, {},
                               prof, ("hals_sweeps",))


def test_idle_is_cut_at_the_spans_edges():
    # update_background 20-45 holds idle 20-40; subtract_background 45-60
    # holds 50-60; update_spatial 60-95 holds 60-90
    host = [_edge(B, "update_background", 20.0),
            ("aten::as_strided", 21.0, 22.0),
            _edge(E, "update_background", 44.5),
            _edge(B, "subtract_background", 45.0),
            _edge(E, "subtract_background", 59.5),
            _edge(B, "update_spatial", 60.0),
            _edge(E, "update_spatial", 94.5)]
    obs = _obs(_profile(host, rounds=2))
    assert background_idle_ms.read(obs) == pytest.approx(30e-3 / 2)
    assert spatial_idle_ms.read(obs) == pytest.approx(30e-3 / 2)
    assert temporal_idle_ms.read(obs) is None


def test_nested_spans_are_counted_once(capsys):
    # update_temporal 5-95 holds all the idle (70 us); hals.color 15-35
    # and oasis.deconvolve 55-85 nest in it, hals.sweeps in hals.color
    host = [_edge(B, "update_temporal", 5.0),
            _edge(B, "hals.color", 15.0),
            _edge(B, "hals.sweeps", 20.0),
            _edge(E, "hals.sweeps", 24.5),
            _edge(E, "hals.color", 34.5),
            _edge(B, "oasis.deconvolve", 55.0),
            _edge(E, "oasis.deconvolve", 84.5),
            _edge(E, "update_temporal", 94.5)]
    prof = _profile(host)
    assert temporal_idle_ms.read(_obs(prof)) == pytest.approx(70e-3)
    err = capsys.readouterr().err
    assert "temporal_idle_ms: " in err
    sp = _span_idle.spans(prof)
    parts = _span_idle.innermost(
        sp, _span_idle.intersect(_span_idle.idle(prof), [(5.0, 95.0)]))
    assert parts == pytest.approx({"hals.color": 15.0, "hals.sweeps": 5.0,
                                   "oasis.deconvolve": 30.0,
                                   "update_temporal": 20.0})
    assert sum(parts.values()) == pytest.approx(70.0)


@pytest.mark.parametrize("host", [
    [_edge(B, "update_spatial", 20.0)],
    [_edge(E, "update_spatial", 20.0)],
    [_edge(B, "update_spatial", 20.0), _edge(B, "hals.color", 25.0),
     _edge(E, "update_spatial", 30.0), _edge(E, "hals.color", 35.0)],
], ids=["begin_alone", "end_alone", "crossed"])
def test_unmatched_edges_read_nothing(host):
    obs = _obs(_profile(host))
    for reader in (background_idle_ms, spatial_idle_ms, temporal_idle_ms):
        assert reader.read(obs) is None


def test_no_spans_or_no_device_read_nothing():
    host = [("aten::as_strided", 21.0, 22.0), ("bench.stage.spatial",
                                                0.0, 100.0)]
    obs = _obs(_profile(host))
    for reader in (background_idle_ms, spatial_idle_ms, temporal_idle_ms):
        assert reader.read(obs) is None
    # a run without a device (the CPU's) has no device idle to read
    spanned = [_edge(B, "update_spatial", 20.0),
               _edge(E, "update_spatial", 30.0)]
    prof = _profile(spanned)
    prof.device = []
    assert spatial_idle_ms.read(_obs(prof)) is None


def test_span_edges_leave_the_other_readers_as_they_were():
    plain = _obs(_profile([("aten::copy_", 72.0, 75.0)]))
    spanned = _obs(_profile([("aten::copy_", 72.0, 75.0),
                             _edge(B, "update_spatial", 20.0),
                             _edge(E, "update_spatial", 30.0)]))
    for reader in (idle_share, gemm_ms, kernels_ms):
        assert reader.read(spanned) == reader.read(plain)
