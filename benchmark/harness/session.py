"""One run of one cell: set-up, the measured window, the check.

Set-up (``setup_s``, from the start of the process): the port and the
card, the kernels (built into the checkout on a checkout's first run),
the movie and start state made on the device from the seed, the pixel
noise, and one warm-up round.

The window (``--trace 0``): rounds back to back, each from the cell's
start state, for ``--seconds`` on the host's clock, then one
``torch.cuda.synchronize``; no other synchronisation than the program's
own. ``round_mpfps`` is the pixel-frames of the rounds done over the
window's seconds; ``peak_mem_gib`` the allocator's peak in the window
(reset at the end of set-up).

The traced run (``--trace 1``): rounds with a synchronised span around
each layer for half of ``--seconds`` (at least two), then three rounds
under the profiler with none; the per-layer metrics read both.

The check: once the window has closed and its memory has been read,
the program's state is dropped but for the outputs judged, the plain
reference recomputes the last round from the same movie and start
state, and every number of ``benchmark/limits/<cell>.json`` is held to
its limit.
"""

from __future__ import annotations

import importlib
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from benchmark.harness import inputs, judge, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "cnmf_e_tpu")
PROFILED_ROUNDS = 3


class NoCard(SystemExit):
    pass


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is a JAX one or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    found = forbidden_modules()
    if found:
        print(f"{when}: the process has loaded {found}", file=sys.stderr)
        raise SystemExit(3)


def require_card(chips: int) -> torch.device:
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); {n} available",
              file=sys.stderr)
        raise NoCard(2)
    return torch.device("cuda:0")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Observation:
    """What the per-layer metrics read."""
    config: dict
    spans: Dict[str, List[float]]
    profile: Optional[trace.Profile]
    kernel_names: tuple


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them (the
    roofline shares are against the peaks at 700 W)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10).stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def base_name(name: str) -> str:
    """A metric's quantity: its name up to the first dot. Cells whose
    end-to-end metric differs (``round_mpfps.host_paced`` beside
    ``round_mpfps``) read one quantity under two names, each with its
    own bound or its own ``moves``."""
    return name.split(".")[0]


def _metric(name: str):
    return importlib.import_module(f"benchmark.metrics.{base_name(name)}")


def pixel_frames(config: dict) -> int:
    return config["H"] * config["W"] * config["T"]


def mpfps(rounds: int, config: dict, seconds: float) -> float:
    """Millions of pixel-frames a second: the rounds' H W T each over the
    window's seconds."""
    return rounds * pixel_frames(config) / seconds / 1e6


def run(name: str, seed: int, seconds: float, traced: bool,
        t_process: float, device=None, round_fn: Optional[Callable] = None,
        root=spec.ROOT):
    """(the result line's object, lines for standard error, every
    candidate number of the check). ``device=None`` requires the card
    the cell asks for; ``round_fn`` replaces the entry's round (tests
    plant faults with it, and the calibration puts the control in the
    program's place with it)."""
    steps = [("imports", time.perf_counter())]
    cell = spec.load(name, root)
    if device is None:
        device = require_card(cell.chips)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
        sync(dev)
    steps.append(("context", time.perf_counter()))
    entry = importlib.import_module(
        f"benchmark.entries.{cell.config['round']}")
    ref = importlib.import_module(
        f"benchmark.references.{cell.config['round']}")
    from cnmf_e_tpu_torch import cuda_build
    if cuda:
        cuda_build.load_library()
    steps.append(("port and kernels", time.perf_counter()))
    do_round = round_fn or entry.round_
    p = entry.params(cell.config)
    Y, start, sn_pix = inputs.make_inputs(cell.config, cell.traffic, seed,
                                          device, ref)
    st0 = entry.start_state(start, p)
    sync(device)
    steps.append(("inputs", time.perf_counter()))
    out = do_round(Y, st0, p, sn_pix)
    sync(device)
    del out
    steps.append(("warm-up round", time.perf_counter()))
    setup_s = steps[-1][1] - t_process
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    obs = Observation(cell.config, {}, None, tuple(cuda_build.KERNELS))
    rounds = 0
    if not traced:
        sync(device)
        t0 = time.perf_counter()
        while True:
            out = do_round(Y, st0, p, sn_pix)
            rounds += 1
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        window_s = time.perf_counter() - t0
    else:
        spans = trace.Spans(device)
        t0 = time.perf_counter()
        while rounds < 2 or time.perf_counter() - t0 < seconds / 2:
            out = do_round(Y, st0, p, sn_pix, spans.stage)
            rounds += 1
        obs.spans = spans.seconds

        def profiled():
            nonlocal out
            for _ in range(PROFILED_ROUNDS):
                out = do_round(Y, st0, p, sn_pix, trace.labelled)
            return PROFILED_ROUNDS
        before = dict(cuda_build.LAUNCHES)
        obs.profile = trace.profile(profiled, device)
        obs.profile.launches = {k: cuda_build.LAUNCHES[k] - before[k]
                                for k in before}
        rounds += PROFILED_ROUNDS
        window_s = obs.profile.window_s
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    refuse_forbidden("the window has closed")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # the check, after the memory is read and with the program's state
    # dropped but for what is judged
    rows, frames = inputs.check_sample(cell.config, cell.traffic,
                                       cell.limits, seed)
    prog = entry.outputs(out, rows)
    del out, st0
    if cuda:
        torch.cuda.empty_cache()
    params = cell.config["params"]
    ref_out = ref.run_round(Y, start, sn_pix, params, rows)
    bg = params["background"]
    A0 = start["A"] * start["active"][:, None, None]
    C0 = start["C"] * start["active"][:, None]
    B_prog = judge.guarded(lambda: ref.background_frames(
        prog, Y, A0, C0, frames, bg, ref.Precision()))
    B_ref = ref.background_frames(ref_out, Y, A0, C0, frames, bg,
                                  ref.Precision())
    nums = judge.numbers(prog, ref_out, B_prog, B_ref)
    check_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    correct, checks = judge.verdict(nums, cell.limits["limits"])

    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    result = {"correct": bool(correct), "attempted": rounds,
              "failed": 0 if correct else 1}
    if not traced:
        metrics = {
            "round_mpfps": {"value": mpfps(rounds, cell.config, window_s),
                            "unit": "Mpf/s"},
            "peak_mem_gib": {"value": peak / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[base_name(m["name"])]
                   for m in cell.end_to_end}
    else:
        metrics = {}
        for m in cell.per_layer:
            v = _metric(m["name"]).read(obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                        "count": cell.chips,
                        "memory_peak_bytes": max(peak, setup_peak)}
    if traced:
        prof = obs.profile
        result["device"].update(busy_s=prof.busy_s(), window_s=window_s)
        result["breakdown"] = {"device_ops": prof.top_ops(),
                               "idle_gaps": prof.idle_gaps()}
    # a number that is not finite (a missing output) prints as null
    result["checks"] = {k: {"value": c["value"] if math.isfinite(c["value"])
                            else None, "limit": c["limit"]}
                        for k, c in checks.items()}
    t_prev = t_process
    parts = []
    for what, t in steps:
        parts.append(f"{what} {t - t_prev!r}")
        t_prev = t
    notes = [f"card: {kind}; seed {seed}; rounds {rounds}; window "
             f"{window_s!r} s; setup {setup_s!r} s",
             "setup's steps, seconds: " + ", ".join(parts),
             f"memory peaks, GiB: set-up {setup_peak / 2 ** 30!r}, window "
             f"{peak / 2 ** 30!r}, check {check_peak / 2 ** 30!r}",
             "numbers not compared: " + ", ".join(
                 f"{k} {v!r}" for k, v in nums.items()
                 if k not in checks)]
    if traced:
        tot = [sum(v) for v in zip(*obs.spans.values())]
        q = statistics.quantiles(tot, n=4)
        notes.append(f"spanned rounds {len(tot)}: seconds a round, "
                     f"median {statistics.median(tot)!r}, quartiles "
                     f"{q[0]!r} {q[2]!r}, min {min(tot)!r} max {max(tot)!r}")
        notes.append(f"launches over the profiled rounds: "
                     f"{obs.profile.launches}")
        if cuda:
            notes.append(f"card and power limit: {power_limit()}")
    return result, notes, nums
