"""Profile one run of a cell of ``chip_smoke.py`` on one NVIDIA GPU.

    python3 scripts_torch/profile_cells.py [--cell colored_every_5] [--out DIR]

Cells: ``fit`` (phase 4: ``CNMFE.fit`` with the 1p preset on the simulated
256x256x2000 movie, ``n_outer=2``), ``fit_local_ellipse`` (phase 9a: the
same fit with the local background and the ellipse search) and the three
step variants of phase 5
(bench.py's hals_iter_throughput: 256x256x2000, K = 192, radius 13,
n_hals = 1, ``chain=10``). Runs the cell once to warm up, once timed
(CUDA events for a step, the host clock after a synchronise for the fit),
then once under torch.profiler. Prints the device time by op and kernel
(the top 25), the device time and launches of each of the port's own
kernels, the device busy time (the union of the kernels' intervals)
against the profiled wall, and the share of the wall the device sat idle;
with ``--out DIR`` it also writes them to ``DIR/profile_<cell>.txt``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (exits when there is no card)
from cnmf_e_tpu_torch.convert import step_state_from_numpy  # noqa: E402
from cnmf_e_tpu_torch.models.pipeline import CNMFE  # noqa: E402
from cnmf_e_tpu_torch.parallel.step import make_update_step  # noqa: E402

STEPS = {v[0]: v[1] for v in chip_smoke.STEP_VARIANTS}
FITS = ("fit", "fit_local_ellipse")


def cell_runner(cell: str, dev):
    """(description, a function that runs the cell once)."""
    if cell in FITS:
        gt, params = chip_smoke.fit_problem()
        if cell == "fit_local_ellipse":
            params = chip_smoke.local_ellipse(params)
        Y = torch.as_tensor(gt.Y, device=dev)
        return (f"{cell} preset_1p 256x256x2000 K_max=192 n_outer=2",
                lambda: CNMFE(params, device=dev).fit(Y, n_outer=2))
    H = W = 256
    T, K, radius, chain = 2000, 192, chip_smoke.RADIUS, 10
    Y_np, d = chip_smoke.step_problem(H, W, T, K, radius)
    Y = torch.as_tensor(Y_np, device=dev)
    st = step_state_from_numpy(d, dev)
    step = make_update_step(None, H, W, T, radius=radius, n_hals=1,
                            chain=chain, **STEPS[cell])
    return (f"step {cell} {H}x{W}x{T} K={K} radius={radius} n_hals=1 "
            f"chain={chain}", lambda: step(Y, st))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="colored_every_5",
                    choices=[*FITS, *STEPS])
    ap.add_argument("--out", help="a directory for the table")
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    what, run = cell_runner(args.cell, dev)
    run()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    run()
    b.record()
    torch.cuda.synchronize()
    if args.cell in FITS:
        timed = f"unprofiled {time.perf_counter() - t0:.3f} s (host clock)"
    else:
        timed = (f"unprofiled {a.elapsed_time(b) / 10:.3f} ms per "
                 f"iteration (CUDA events)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device busy: the union of the kernels' intervals on the card (the
    # averaged table counts an op's kernels under the op and again under
    # the kernel's own name)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a0, a1 in spans:
        if a1 > end:
            busy_us += a1 - max(a0, end)
            end = a1
    busy_ms = busy_us / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    # the port's kernels, by their names in csrc/ (K1's three bodies all
    # match hals_sweeps_, K6's two ring_stencil_; K5 and K7 share one)
    ours = {k: [0, 0.0] for k in ("hals_sweeps_",
                                  "oasis_chunk_pools_kernel",
                                  "oasis_pool_merge_kernel",
                                  "oasis_reconstruct_kernel",
                                  "ring_stencil_",
                                  "ring_banded_kernel")}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in ours:
            if k in e.name:
                ours[k][0] += 1
                ours[k][1] += (e.time_range.end - e.time_range.start) / 1e3
    table += "\nthe port's kernels: " + ", ".join(
        f"{k} {n} launches {ms:.3f} ms" for k, (n, ms) in ours.items())
    head = (f"{what} on {torch.cuda.get_device_name(0)}: {timed}; "
            f"profiled wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
            f"(union of {len(spans)} device intervals), idle share "
            f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    print(head)
    print(table)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"profile_{args.cell}.txt"),
                  "w") as f:
            f.write(head + "\n" + table + "\n")


if __name__ == "__main__":
    main()
