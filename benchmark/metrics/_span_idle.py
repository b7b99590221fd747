"""The device's idle time inside the program's own spans, from the
profiled rounds.

The port marks each span's edges as instant host events named
``cnmfe.begin/<name>`` and ``cnmfe.end/<name>``
(``cnmf_e_tpu_torch/utils/profiling.py::span``), on the profiler's clock
and with no device event of their own. Idle time is the profiled window
less the union of the device's kernels and copies (``Profile.busy``).
A layer is the spans of the model functions it calls; its idle time is
the idle time inside the union of those spans, whatever sub-spans it
falls in. Where the edges do not pair, or no span of the layer is found
(a program without spans, or a run with no device), nothing is read.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

BEGIN, END = "cnmfe.begin/", "cnmfe.end/"
LAYERS = {"background": ("update_background", "subtract_background"),
          "spatial": ("update_spatial",),
          "temporal": ("update_temporal",)}

Interval = Tuple[float, float]


def spans(prof) -> Optional[List[Tuple[str, float, float]]]:
    """(name, start, end) of every span of the profile, from the start of
    its begin edge to the end of its end edge, or None where an edge has
    no partner (the spans of one thread nest)."""
    edges = sorted((e for e in prof.host if e[0].startswith((BEGIN, END))),
                   key=lambda e: (e[1], e[2]))
    stack: List[Tuple[str, float]] = []
    out = []
    for name, t0, t1 in edges:
        if name.startswith(BEGIN):
            stack.append((name[len(BEGIN):], t0))
            continue
        if not stack or stack[-1][0] != name[len(END):]:
            return None
        base, start = stack.pop()
        out.append((base, start, t1))
    return None if stack else out


def union(intervals) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle(prof) -> List[Interval]:
    """The stretches of the window with nothing on the device."""
    lo, hi = prof.window
    edges = [lo] + [t for ab in prof.busy() for t in ab] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    i = j = 0
    out = []
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def innermost(sp, pieces: List[Interval]) -> Dict[str, float]:
    """The length of ``pieces`` (sorted, disjoint) put down to the
    innermost span around each part of them, by span name; a part inside
    no span is left out."""
    edges = sorted([(a, 1, i) for i, (_, a, _) in enumerate(sp)]
                   + [(b, 0, i) for i, (_, _, b) in enumerate(sp)])
    out: Dict[str, float] = {}
    stack: List[int] = []
    k = 0

    def put(t0, t1):
        if stack and t1 > t0:
            name = sp[stack[-1]][0]
            out[name] = out.get(name, 0.0) + (t1 - t0)

    def step():
        nonlocal k
        _, opens, i = edges[k]
        if opens:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        k += 1
    for a, b in pieces:
        while k < len(edges) and edges[k][0] <= a:
            step()
        t = a
        while k < len(edges) and edges[k][0] < b:
            put(t, edges[k][0])
            t = edges[k][0]
            step()
        put(t, b)
    return out


def layer_idle_ms(obs, layer: str, metric: str) -> Optional[float]:
    """Milliseconds a round of device idle inside ``layer``'s spans, with
    the innermost spans that hold it written to standard error."""
    prof = obs.profile
    if prof is None or not prof.device:
        return None
    sp = spans(prof)
    if sp is None:
        print(f"{metric}: the profile's span edges do not pair",
              file=sys.stderr)
        return None
    mine = union((a, b) for name, a, b in sp if name in LAYERS[layer])
    if not mine:
        return None
    pieces = intersect(idle(prof), mine)
    ms = sum(b - a for a, b in pieces) / prof.rounds / 1e3
    parts = sorted(innermost(sp, pieces).items(), key=lambda kv: -kv[1])
    print(f"{metric}: {ms!r} ms a round idle; by innermost span, ms a "
          "round: " + ", ".join(f"{n} {v / prof.rounds / 1e3!r}"
                                for n, v in parts), file=sys.stderr)
    return ms
