"""Run a function on every rank of a (patch, frame) mesh of local
processes.

    results = spawn(fn, n_patch=4, n_frame=2, backend="gloo", device="cpu",
                    args=(...,))

starts n_patch x n_frame processes by the ``spawn`` start method; each
joins a process group (rendezvous through a ``file://`` path in a fresh
temporary directory, so concurrent spawns never share a port), builds the
mesh with :func:`~cnmf_e_tpu_torch.parallel.mesh.make_mesh` and returns
``fn(mesh, *args)``; ``spawn`` returns those values in rank order. ``fn``
must be importable by module path (the children import it afresh), and
its value picklable. The counterpart of ``jax.distributed`` and of the
JAX tests' worker processes (``tests/multihost_worker.py``).

Deadlines: every process group has a ``pg_timeout`` (a collective that
waits for a dead or hung peer raises), and the whole run a ``timeout``
after which every rank is killed and ``spawn`` raises ``TimeoutError``.
A rank's exception ends the other ranks and is raised in the caller.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cnmf_e_tpu_torch.parallel.mesh import make_mesh


def _rank_main(rank, world, n_patch, n_frame, backend, device, tmp,
               pg_timeout, fn):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=pg_timeout))
    try:
        args = torch.load(os.path.join(tmp, "args.pt"), weights_only=False)
        out = fn(make_mesh(n_patch, n_frame, device), *args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n_patch: int = 1, n_frame: int = 1, backend: str = "gloo",
          device="cuda", args: tuple = (), timeout: float = 120.0,
          pg_timeout: float = 60.0) -> list:
    """``fn(mesh, *args)`` on each rank of an n_patch x n_frame mesh of
    processes on this host; their values in rank order. ``device``: the
    card unless the caller passes ``"cpu"`` (each rank then runs on one
    thread)."""
    world = n_patch * n_frame
    with tempfile.TemporaryDirectory(prefix="cnmfe_mesh_") as tmp:
        # the arguments travel by file: a child reads its start-up pipe
        # only once it has imported fn's module, and a pipe full of
        # arguments would hold the parent until then, child by child
        torch.save(tuple(args), os.path.join(tmp, "args.pt"))
        ctx = mp.start_processes(
            _rank_main, args=(world, n_patch, n_frame, backend, str(device),
                              tmp, pg_timeout, fn),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=min(1.0, max(
                    0.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks of {fn.__module__}."
                                       f"{fn.__name__} did not finish in "
                                       f"{timeout:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
