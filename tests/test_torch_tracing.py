"""The port's spans (``utils/profiling.py::span``): nothing while no
profiler records, instant begin and end events that pair and nest while
one does, never a synchronisation, and the layer and sub-spans of one
model-update round (``models/pipeline.py:229-236``) on the CPU."""

import ast
import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from cnmf_e_tpu_torch import cuda_build
from cnmf_e_tpu_torch.config import BackgroundParams, CNMFEParams
from cnmf_e_tpu_torch.models.background import (subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState, RingWeights
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.ring_kernels import ring_offsets
from cnmf_e_tpu_torch.utils import profiling
from cnmf_e_tpu_torch.utils.profiling import (SPAN_BEGIN, SPAN_END,
                                              SPAN_TRACK, StageTimer,
                                              paired_spans, profiler_trace,
                                              span)
from cnmf_e_tpu_torch.utils.simulate import simulate_movie

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cnmf_e_tpu_torch")
CPU = [torch.profiler.ProfilerActivity.CPU]


def _events(prof):
    return [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events()]


def _spans(prof):
    return paired_spans(_events(prof))


def test_span_records_nothing_without_a_profiler(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    ctx = span("ring.neighbor_index")
    assert ctx is span("hals.color")        # one shared no-op context
    with ctx:
        pass
    with StageTimer(device="cpu").stage("noise"):
        pass
    assert calls == []


def test_span_never_synchronizes(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: synced.append(a))
    with span("off"):
        torch.ones(4).sum()
    with torch.profiler.profile(activities=CPU):
        with span("outer"):
            with span("inner"):
                torch.ones(4).sum()
    assert synced == []


def test_edges_pair_and_nest_under_the_profiler():
    with torch.profiler.profile(activities=CPU) as prof:
        with span("outer"):
            with span("inner"):
                torch.ones(8) @ torch.ones(8)
            with span("inner"):
                torch.ones(8).sum()
    names = [e[0] for e in _events(prof)]
    assert names.count(SPAN_BEGIN + "inner") == 2
    assert names.count(SPAN_END + "outer") == 1
    # the edges are instant: the work between them is not inside them
    for name, t0, t1, _ in _events(prof):
        if name.startswith(SPAN_BEGIN):
            inside = [n for n, a, b, _ in _events(prof)
                      if t0 < a and b < t1 and n != name]
            assert inside == []
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["outer", "inner", "inner"]
    outer, first, second = spans
    assert outer[1] < first[1] < first[2] < second[1] < second[2] \
        < outer[2]
    # an end without its begin, or a begin without its end, pairs nothing
    lone = [(SPAN_END + "x", 0.0, 1.0, 1), (SPAN_BEGIN + "y", 2.0, 3.0, 1)]
    assert paired_spans(lone) == []


def test_a_span_closes_on_an_exception():
    with torch.profiler.profile(activities=CPU) as prof:
        with pytest.raises(ValueError):
            with span("outer"):
                with span("failing"):
                    raise ValueError("inside")
    assert [s[0] for s in _spans(prof)] == ["outer", "failing"]


def _round_inputs(model: str):
    """A small movie and a start state near its truth, for the ring or
    the svd background (one OASIS pass a trace: the plain version's many
    small ops are slow to profile)."""
    gt = simulate_movie(seed=5, H=24, W=24, T=120, K=4, gSig=2.0, sn=0.05,
                        min_dist=8.0, spike_rate=0.05)
    bg = (BackgroundParams(model="ring", ring_radius=5, ssub=2)
          if model == "ring" else BackgroundParams(model="svd", rank=1))
    p = CNMFEParams(background=bg)
    p = dataclasses.replace(p, temporal=dataclasses.replace(
        p.temporal, deconv=dataclasses.replace(p.temporal.deconv,
                                               optimize_b=False)))
    Y = torch.as_tensor(gt.Y, dtype=torch.float32)
    T, H, W = Y.shape
    A = torch.as_tensor(gt.A, dtype=torch.float32)
    C = torch.as_tensor(gt.C, dtype=torch.float32)
    K = A.shape[0]
    Wr = None
    if model == "ring":
        Hs, Ws, r = -(-H // 2), -(-W // 2), 2
        R = ring_offsets(r).shape[0]
        Wr = RingWeights(w=torch.full((Hs * Ws, R), 1.0 / R),
                         w0=torch.zeros(Hs * Ws))
    st = CNMFEState(A=A, C=C, C_raw=C, S=torch.zeros_like(C),
                    active=torch.ones(K, dtype=torch.bool),
                    g=torch.full((K, 1), 0.9), neuron_sn=torch.zeros(K),
                    b0=torch.zeros(H, W), W=Wr)
    return Y, st, p, noise_psd_frames(Y)


SUBSPANS = {
    "ring": {"ring.residual", "ring.downsample", "ring.outlier_clamp",
             "ring.neighbor_index", "ring.normal_equations", "ring.solve"},
    "svd": {"lowrank.fit"},
}
LAYERS = ["update_background", "subtract_background", "update_spatial",
          "update_temporal"]


@pytest.mark.parametrize("model", ["ring", "svd"])
def test_a_round_opens_and_closes_its_spans(model):
    Y, st, p, sn = _round_inputs(model)
    with torch.profiler.profile(activities=CPU) as prof:
        st = update_background(Y, st, p, sn_pix=sn)
        Ysig = subtract_background(Y, st, p)
        st = update_spatial(Ysig, st, p, sn_pix=sn)
        st = update_temporal(Ysig, st, p)
    events = _events(prof)
    edges = [e for e in events if e[0].startswith((SPAN_BEGIN, SPAN_END))]
    spans = paired_spans(events)
    assert 2 * len(spans) == len(edges)        # every edge paired
    names = [s[0] for s in spans]
    assert [n for n in names if n in LAYERS] == LAYERS
    layer = {n: (a, b) for n, a, b, _ in spans if n in LAYERS}
    sub = {"update_background": SUBSPANS[model],
           "update_spatial": {"spatial.search", "hals.products",
                              "hals.color", "hals.sweeps",
                              "spatial.post_process"},
           "update_temporal": {"hals.products", "hals.color",
                               "hals.sweeps", "temporal.baseline",
                               "temporal.noise", "oasis.deconvolve"}}
    for lay, want in sub.items():
        a, b = layer[lay]
        inside = {n for n, s0, s1, _ in spans
                  if a < s0 and s1 < b}
        assert want <= inside, (lay, want - inside)
    assert np.isfinite(st.C.numpy()).all()


def _span_names():
    """Every name the package passes to ``span``, ``timed`` or a
    ``stage``, as a literal."""
    out = set()
    for root, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(root, f)).read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = getattr(fn, "id", None) or getattr(fn, "attr", None)
                args = node.args
                arg = (args[0] if name in ("span", "stage") and args
                       else args[1] if name == "timed" and len(args) > 1
                       else None)
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    out.add(arg.value)
    return out


def test_span_names_hold_no_kernel_name():
    names = _span_names()
    assert {"update_background", "ring.neighbor_index", "hals.color",
            "oasis.deconvolve"} <= names
    stems = {re.sub(r"_(flat|htw)$", "", k) for k in cuda_build.KERNELS}
    for name in names | set(LAYERS):
        assert not re.search(r"gemm|gemv", name, re.IGNORECASE), name
        assert not any(s in name for s in stems), name


def test_profiler_trace_writes_the_spans_as_ranges(tmp_path):
    timer = StageTimer(device="cpu")
    with profiler_trace(str(tmp_path / "tr"), device="cpu"):
        with timer.stage("noise"):
            with span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        with span("inner"):
            pass
    assert timer.counts == {"noise": 1}
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events
              if e.get("pid") == SPAN_TRACK and e.get("ph") == "X"]
    assert sorted(e["name"] for e in ranges) == ["inner", "inner", "noise"]
    noise = next(e for e in ranges if e["name"] == "noise")
    first = min((e for e in ranges if e["name"] == "inner"),
                key=lambda e: e["ts"])
    assert noise["ts"] < first["ts"]
    assert first["ts"] + first["dur"] < noise["ts"] + noise["dur"]
    assert any(e.get("ph") == "M" and e.get("pid") == SPAN_TRACK
               for e in events)


def test_profiler_flag_is_the_one_spans_read():
    """``span`` reads ``torch.autograd.profiler._is_profiler_enabled``;
    it is set exactly while a ``torch.profiler`` session records."""
    flag = lambda: profiling._autograd_profiler._is_profiler_enabled
    assert not flag()
    with torch.profiler.profile(activities=CPU):
        assert flag()
        assert isinstance(span("x"), profiling._Span)
    assert not flag()
