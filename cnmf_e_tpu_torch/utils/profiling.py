"""Tracing / profiling hooks (port of ``cnmf_e_tpu/utils/profiling.py``).

A stage timer whose stages end with the device's queued work done
(``torch.cuda.synchronize``), and a ``torch.profiler`` trace context that
writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage. Each stage ends when
    ``device`` (the card unless the caller passes ``device="cpu"``) has
    finished the work queued in it."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
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
    ``<logdir>/trace.json`` (Chrome / Perfetto format)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
