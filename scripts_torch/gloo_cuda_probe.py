"""Which gloo collectives take CUDA tensors, and what a copy through
pinned host buffers costs beside gloo's own CUDA all-gather (the
transport of ``cnmf_e_tpu_torch/parallel/comm.py`` rests on both).

    python3 scripts_torch/gloo_cuda_probe.py [--mb 26.6] [--reps 20]

Each collective runs in a spawn of its own on two gloo ranks on the card
(``parallel/launch.py``): gloo aborts the process, and does not raise,
where it cannot carry a CUDA tensor (``gloo::IoException ... Bad
address``), so one collective's abort cannot hide the others' results.
Then, on two ranks, an all-gather of a float32 tensor of ``--mb``
megabytes (the default is the halo exchange of the update step at
256x256x2000 on a 2 x 2 mesh: 2 x 1000 x 13 x 256 floats) is timed as
gloo carries it (``dist.all_gather`` on the CUDA tensor) and through
pinned host buffers copied by hand, median of
``--reps`` by the host clock after a device synchronisation. Prints the
card's name and power limit first. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from cnmf_e_tpu_torch.parallel.launch import spawn  # noqa: E402

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "all_to_all_single", "all_to_all", "send_recv")


def one_op(mesh, op):
    """``op`` on CUDA tensors on every rank: whether the result is right."""
    dev = mesh.device
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.full((4,), float(r + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = bool((x == n * (n + 1) / 2).all())
    elif op == "broadcast":
        dist.broadcast(x, 0)
        ok = bool((x == 1).all())
    elif op == "all_gather":
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
        ok = all(bool((o == i + 1).all()) for i, o in enumerate(out))
    elif op == "all_gather_into_tensor":
        out = torch.empty(4 * n, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = bool((out.reshape(n, 4)[:, 0].cpu()
                   == torch.arange(1, n + 1)).all())
    elif op == "all_to_all_single":
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, torch.arange(4.0, device=dev) + 4 * r)
        ok = bool((out.cpu() == torch.tensor(
            [2.0 * r + 4 * q + i for q in range(n) for i in range(2)])).all())
    elif op == "all_to_all":
        out = [torch.empty(2, device=dev) for _ in range(n)]
        dist.all_to_all(out, [torch.full((2,), float(r), device=dev)
                              for _ in range(n)])
        ok = all(bool((o == q).all()) for q, o in enumerate(out))
    else:
        if r == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
        ok = bool((x == 1).all())
    torch.cuda.synchronize()
    dist.barrier()
    return ok


def gather_times(mesh, numel, reps):
    """Median seconds of an all-gather of ``numel`` floats: gloo's own
    CUDA form and the pinned-host staging."""
    n = dist.get_world_size()
    x = torch.randn(numel, device=mesh.device)

    def native():
        out = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(out, x)
        return torch.cat(out)

    def staged():
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        out = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(out, host)
        return torch.cat(out).to(mesh.device)

    res = {}
    for name, fn in (("native", native), ("staged", staged),
                     ("native_again", native), ("staged_again", staged)):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        res[name] = statistics.median(times)
    same = bool(torch.equal(native(), staged()))
    return res, same


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=2 * 1000 * 13 * 256 * 4 / 1e6)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gloo_cuda_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    accepts = {}
    for op in OPS:
        try:
            ok = spawn(one_op, 2, 1, backend="gloo", device="cuda",
                       args=(op,), timeout=120)
            accepts[op] = "right" if all(ok) else "wrong result"
        except Exception as e:   # a rank's abort: report it, probe the next
            accepts[op] = f"failed: {type(e).__name__}"
        print(f"gloo on CUDA tensors: {op}: {accepts[op]}", flush=True)
    numel = int(args.mb * 1e6 / 4)
    times, same = spawn(gather_times, 2, 1, backend="gloo", device="cuda",
                        args=(numel, args.reps), timeout=300)[0]
    print(f"all_gather of {numel * 4 / 1e6:.1f} MB on 2 gloo ranks, median "
          f"of {args.reps} (host clock, device synchronised): " +
          ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in times.items()) +
          f"; results equal {same}", flush=True)
    print(json.dumps({"accepts": accepts, "all_gather_s": times}))


if __name__ == "__main__":
    main()
