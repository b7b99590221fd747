"""What the traced run reads: synchronised spans around the round's
layers, and a ``torch.profiler`` trace of whole rounds (device activity,
its union, the idle gaps and what the host was doing in them).

Spans are the benchmark's own, around the calls into each layer, each
closed by ``torch.cuda.synchronize`` (``utils/profiling.py::StageTimer``'s
arithmetic); the profiled rounds run with no synchronisation of the
benchmark's inside them, so that the idle share is the program's own.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "bench.window"
STAGE = "bench.stage."


class Spans:
    """Per-stage seconds of each round, each stage closed by a
    synchronisation of ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds: Dict[str, List[float]] = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


def labelled(name: str):
    """A profiler label around one stage of a round."""
    return torch.profiler.record_function(STAGE + name)


@dataclass
class Profile:
    """A traced window in the profiler's clock (microseconds)."""
    window: Tuple[float, float]
    device: List[Tuple[str, float, float]]       # (kernel or copy, t0, t1)
    host: List[Tuple[str, float, float]]         # host ops and labels
    rounds: int
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's activity intervals in the window."""
        lo, hi = self.window
        spans = sorted((max(a, lo), min(b, hi)) for _, a, b in self.device
                       if b > lo and a < hi)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for n, a, b in self.device if match(n)) / 1e6

    def count(self, match: Callable[[str], bool]) -> int:
        return sum(1 for n, _, _ in self.device if match(n))

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, float] = {}
        for name, a, b in self.device:
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return [[k[:160], v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches of the window with nothing on the device,
        each named by the stage and the innermost host op running at its
        middle, or else the last host op that began before it
        ("after ...": the host ran Python between ops)."""
        lo, hi = self.window
        edges = [lo] + [t for ab in self.busy() for t in ab] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        out = []
        for dur, a, b in gaps:
            mid = 0.5 * (a + b)
            stage, op, op_len = "window", None, float("inf")
            last, last_t = "nothing", float("-inf")
            for name, h0, h1 in self.host:
                if name.startswith(STAGE):
                    if h0 <= mid <= h1:
                        stage = name[len(STAGE):]
                elif h0 <= mid <= h1 and h1 - h0 < op_len:
                    op, op_len = name, h1 - h0
                elif last_t < h0 <= mid:
                    last, last_t = name, h0
            label = op if op is not None else f"after {last}"
            out.append([f"{stage}: {label}"[:160], dur / 1e6])
        return out


def profile(run_rounds: Callable[[], int], device) -> Profile:
    """Trace ``run_rounds`` (which runs whole rounds and returns how
    many) under torch.profiler, closed by one synchronisation inside the
    traced window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            n = run_rounds()
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    window, dev_ev, host_ev = None, [], []
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the labels' own spans on the device timeline are no work
            if e.name != WINDOW and not e.name.startswith(STAGE):
                dev_ev.append((e.name, t0, t1))
        elif e.name == WINDOW:
            window = (t0, t1)
        else:
            host_ev.append((e.name, t0, t1))
    if window is None:
        raise RuntimeError("the profiler recorded no traced window")
    return Profile(window=window, device=dev_ev, host=host_ev, rounds=n)
