"""Where the HALS sweep kernel (K1) spends its time, on one NVIDIA GPU.

    python3 scripts_torch/k1_costs.py

At the spatial factor's shapes (K = 192, d = 256·256) it times one
``hals_sweeps`` launch with n_iter = 1 and with n_iter = 11 on hand-built
schedules, with and without a support mask, and prints for each schedule
the kernel's device time at n_iter = 1 and the cost of one more sweep
((t11 - t1) / 10; torch.profiler, medians of 7). A schedule of no steps
gives the fixed cost of a launch (the X tile's load, the mask pass and
the store); free steps of 1 to 64 rows give the cost of one step by its row
count, and three 64-row steps a whole sweep, whose bound is 2·K²·d FP32
operations at 67 TFLOP/s.

At the temporal factor's shapes (K = 192, d = T = 2000, the coloured
schedule of chip_smoke.py phase 2) it times the launch at n_iter = 1 and 4
with the tile width forced to 16, 8 and 4 columns (125, 250 and 500 CTAs)
beside the width ``_tiling`` picks: the kernel's device time, and CUDA
events around the call, which also count the wrapper's host time.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (exits when there is no card)
from cnmf_e_tpu_torch import cuda_build  # noqa: E402
from cnmf_e_tpu_torch.ops import hals_kernels  # noqa: E402
from cnmf_e_tpu_torch.ops.coloring import (  # noqa: E402
    class_step_schedule, greedy_color)


def cuda_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_ms(fn, reps: int = 7) -> float:
    """Median device milliseconds of the K1 kernels over ``reps`` calls of
    ``fn``, by torch.profiler: the kernels alone (a masked call's compacted
    body and dense fallback summed), without the wrapper's host time,
    which CUDA events around one short call also count."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):          # a profile now and then records no kernel
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and "hals_sweeps_" in e.name)
        times = [(b - a) / 1e3 for a, b in events]
        if times and len(times) % reps == 0:
            per = len(times) // reps
            return statistics.median(sum(times[i:i + per])
                                     for i in range(0, len(times), per))
    raise SystemExit(f"k1_costs: profiled {len(times)} K1 kernels, not "
                     f"{reps}")


def schedule(steps, free, dev):
    """(starts, ends, free, n_steps) of the given (start, end) steps."""
    i32 = dict(dtype=torch.int32, device=dev)
    if not steps:
        z = torch.zeros(1, **i32)
        return z, z, z, torch.tensor(0, **i32)
    return (torch.tensor([s for s, _ in steps], **i32),
            torch.tensor([e for _, e in steps], **i32),
            torch.full((len(steps),), int(free), **i32),
            torch.tensor(len(steps), **i32))


def temporal_widths(dev):
    """The coloured temporal launch at d = T = 2000 by tile width."""
    A, C, Y, gen = chip_smoke.slice_problem()
    K = A.shape[0]
    Af = A.reshape(K, -1)
    V = Af @ Af.T
    colors = greedy_color((V != 0) & ~torch.eye(K, dtype=torch.bool,
                                                  device=dev))
    order = torch.argsort(colors, stable=True)
    sched = class_step_schedule(colors[order], block=64)
    U = (Af @ Y)[order].contiguous()
    V = V[order][:, order].contiguous()
    X = (C + 0.1 * torch.randn(C.shape, generator=gen, device=dev)
         )[order].contiguous()
    ones = torch.ones(K, device=dev)
    d = X.shape[1]
    tiling = hals_kernels._tiling
    picked = tiling(K, d, hals_kernels._sm_count(0))
    sizes = [hi - lo for lo, hi, _ in hals_kernels._step_rows(sched, K, 64)]
    print(f"K1 temporal at K={K} d={d}: {int(sched[3])} steps of "
          f"{sizes} rows; _tiling picks TD={picked[0]}; bound "
          f"of one sweep {2.0 * K * K * d / 67e12 * 1e3:.4f} ms", flush=True)
    try:
        for td in (16, 8, 4):
            hals_kernels._tiling = lambda K_, d_, n_, td=td: (td, picked[1])
            fns = [lambda n=n: hals_kernels.hals_sweeps(
                U, V, X, ones, sched, None, n, 64, False) for n in (1, 4)]
            (e1, e4), (k1, k4) = ([cuda_ms(f) for f in fns],
                                  [kernel_ms(f) for f in fns])
            print(f"temporal TD={td} ({-(-d // td)} CTAs): kernel n_iter=1 "
                  f"{k1:.4f} ms, n_iter=4 {k4:.4f} ms, one more sweep "
                  f"{(k4 - k1) / 3:.4f} ms; CUDA events around the call "
                  f"n_iter=1 {e1:.4f} ms, n_iter=4 {e4:.4f} ms", flush=True)
    finally:
        hals_kernels._tiling = tiling


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k1_costs: no CUDA device")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda_build.load_library()
    K, d = 192, 256 * 256
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.rand((K, d), generator=g, device=dev)
    U = torch.randn((K, d), generator=g, device=dev)
    F = torch.randn((K, 64), generator=g, device=dev)
    V = F @ F.T / 64 + torch.eye(K, device=dev)
    M = torch.rand((K, d), generator=g, device=dev) < 0.3
    ones = torch.ones(K, device=dev)
    TD, KC = hals_kernels._tiling(K, d, hals_kernels._sm_count(0))
    print(f"K1 costs at K={K} d={d}, TD={TD} KC={KC}; bound of one sweep "
          f"{2.0 * K * K * d / 67e12 * 1e3:.4f} ms", flush=True)
    cases = [("no steps", [], True)]
    cases += [(f"1 free step of {n} rows", [(0, n)], True)
              for n in (1, 8, 16, 32, 64)]
    cases += [("3 free steps of 64 rows (a sweep)",
               [(0, 64), (64, 128), (128, 192)], True),
              ("1 in-order step of 16 rows", [(0, 16)], False),
              ("1 in-order step of 32 rows", [(0, 32)], False)]
    for name, steps, free in cases:
        sched = schedule(steps, free, dev)
        for mask in (M, None):
            t1, t11 = (kernel_ms(lambda n=n: hals_kernels.hals_sweeps(
                U, V, X, ones, sched, mask, n, 64, True)) for n in (1, 11))
            print(f"{name}, mask={mask is not None}: kernel n_iter=1 "
                  f"{t1:.4f} ms, one more sweep {(t11 - t1) / 10:.4f} ms",
                  flush=True)
    temporal_widths(dev)


if __name__ == "__main__":
    main()
