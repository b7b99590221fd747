"""Tracing / profiling hooks (port of ``cnmf_e_tpu/utils/profiling.py``).

A stage timer whose stages end with the device's queued work done
(``torch.cuda.synchronize``), a ``torch.profiler`` trace context that
writes a Chrome trace, and :func:`span`, which marks a stretch of the
program's host work in that trace.

Spans are on exactly while a ``torch.profiler`` session records. Each
edge is an instant profiler event (``cnmfe.begin/<name>``,
``cnmfe.end/<name>``): a ``record_function`` entered and left at once,
which launches nothing, so it lands on the profiler's clock beside the
device's events and adds no device event of its own (a range that
enclosed launches would put an annotation on the device timeline that
covers the gaps between them). A span never synchronises: the device's
idle time inside it is what it shows.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_BEGIN = "cnmfe.begin/"
SPAN_END = "cnmfe.end/"
SPAN_TRACK = "cnmfe spans"
_OFF = contextlib.nullcontext()


def _mark(name: str) -> None:
    with torch.profiler.record_function(name):
        pass


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _mark(SPAN_BEGIN + self.name)

    def __exit__(self, *exc):
        _mark(SPAN_END + self.name)
        return False


def span(name: str):
    """A context that marks its block as the span ``name`` while a
    ``torch.profiler`` session records, and otherwise does nothing but
    read the profiler's flag (no formatting, allocation or
    synchronisation)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def paired_spans(events) -> List[Tuple[str, float, float, object]]:
    """(name, start, end, thread) of the spans whose edges pair among
    ``events``: (name, start, end, thread) tuples in one clock, of which
    those that are no span edge are ignored. Edges pair per thread,
    innermost first; an edge without its partner is dropped."""
    out = []
    stacks: Dict[object, list] = {}
    for name, t0, t1, tid in sorted(
            (e for e in events
             if e[0].startswith((SPAN_BEGIN, SPAN_END))),
            key=lambda e: (e[1], e[2])):
        stack = stacks.setdefault(tid, [])
        if name.startswith(SPAN_BEGIN):
            stack.append((name[len(SPAN_BEGIN):], t0))
            continue
        base = name[len(SPAN_END):]
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == base:
                out.append((base, stack[i][1], t1, tid))
                del stack[i:]
                break
    return sorted(out, key=lambda s: s[1])


def _add_span_track(path: str) -> None:
    """Append the paired spans of the Chrome trace at ``path`` to it as
    complete events, a row per host thread under a process of their own
    (``SPAN_TRACK``)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace.get("traceEvents", [])
    edges = [(e["name"], e["ts"], e["ts"] + e.get("dur", 0.0),
              e.get("tid")) for e in events
             if e.get("ph") == "X" and isinstance(e.get("name"), str)]
    added = [{"ph": "M", "name": "process_name", "pid": SPAN_TRACK,
              "tid": 0, "args": {"name": SPAN_TRACK}}]
    added += [{"ph": "X", "cat": "span", "name": name, "pid": SPAN_TRACK,
               "tid": tid, "ts": t0, "dur": t1 - t0}
              for name, t0, t1, tid in paired_spans(edges)]
    trace["traceEvents"] = events + added
    with open(path, "w") as f:
        json.dump(trace, f)


class StageTimer:
    """Accumulates wall time per named stage. Each stage ends when
    ``device`` (the card unless the caller passes ``device="cpu"``) has
    finished the work queued in it. A stage is also the :func:`span` of
    its name."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float, count: int = 1,
            nbytes: int = 0) -> None:
        """Add a time measured elsewhere (such as CUDA events on a copy
        stream) and the bytes it moved to stage ``name``."""
        self.times[name] = self.times.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + count
        self.bytes[name] = self.bytes.get(name, 0) + nbytes

    def report(self) -> str:
        lines = ["stage timings:"]
        for k in sorted(self.times, key=lambda k: -self.times[k]):
            lines.append(f"  {k:<28s} {self.times[k]:8.3f}s "
                         f"(x{self.counts[k]})")
        return "\n".join(lines)


def timed(timer: Optional[StageTimer], name: str):
    """``timer.stage(name)``, or nothing without a timer."""
    return contextlib.nullcontext() if timer is None else timer.stage(name)


@contextlib.contextmanager
def profiler_trace(logdir: str, device="cuda"):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's when ``device`` is a CUDA device) and write
    ``<logdir>/trace.json`` (Chrome / Perfetto format), with the
    program's spans (:func:`span`) as ranges on a track of their own."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_span_track(path)
