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

    mesh = ResidentMesh(n_patch=2, n_frame=2)
    value = mesh.call(fn, *args)            # rank 0's fn(mesh, *args)
    mesh.close()

keeps the ranks up between calls, for a function repeated on blocks that
each rank holds (the model-update round of ``benchmark/entries``): the
calling process is rank 0, on ``cuda:0`` (or the CPU), and n - 1 worker
processes started by the ``spawn`` method are the others, worker r on
``cuda:r``. A call is announced to each worker through its pipe as the
function's module, name and ``args`` (small values; tensors travel
between ranks by the collectives, and :func:`scatter` and
:func:`broadcast` ship rank 0's tensors at set-up, in chunks); every rank
then runs it in lock-step on its own mesh, and keeps what it stores
between calls. The backend follows the devices: NCCL where every rank has
a card of its own, gloo where ranks share a card or run on the CPU. The
deadlines are ``spawn``'s: every group has ``pg_timeout``; a worker that
raises reports its traceback, ends, and the call raises it in the caller
after ending the others, as it does when rank 0's part raises; a worker
must report within ``timeout`` of rank 0's part ending (and of start-up);
``close()``, also run at exit, kills a rank still alive after its grace,
and a call after it raises. With NCCL, a rank 0 that waits on its card
for a peer that died ends at ``pg_timeout``, by NCCL's watchdog.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import importlib
import multiprocessing.connection
import os
import shutil
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import Mesh, make_mesh


def _join(rank, world, backend, tmp, pg_timeout) -> None:
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=pg_timeout))


def _take_device(rank, world, device) -> torch.device:
    """This rank's device: card ``rank`` modulo the host's cards, with a
    share of the host's cores, or the CPU with one thread."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.set_num_threads(1)
    return device


def _end(procs, grace: float) -> None:
    """Every process of ``procs`` ended: each has until ``grace`` seconds
    from now to leave, and is killed after."""
    deadline = time.monotonic() + grace
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
        if proc.is_alive():
            proc.kill()
        proc.join()


def _rank_main(rank, world, n_patch, n_frame, backend, device, tmp,
               pg_timeout, fn):
    device = _take_device(rank, world, device)
    _join(rank, world, backend, tmp, pg_timeout)
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
            _end(ctx.processes, 0.0)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


# --------------------------------------------------------------------- #
# a resident mesh
# --------------------------------------------------------------------- #
def _worker_main(rank, world, n_patch, n_frame, backend, device, tmp,
                 pg_timeout, conn):
    device = _take_device(rank, world, device)
    conn.send(("ready", None, 0.0))
    _join(rank, world, backend, tmp, pg_timeout)
    mesh = make_mesh(n_patch, n_frame, device)
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        module, name, args = msg
        try:
            getattr(importlib.import_module(module), name)(mesh, *args)
        except BaseException:
            conn.send(("error", traceback.format_exc(), time.time()))
            # at once: the peers' sockets close, and a gloo peer waiting
            # on this rank raises
            os._exit(1)
        conn.send(("done", None, 0.0))
    dist.destroy_process_group()


def backend_for(device, world: int) -> str:
    """NCCL where each of ``world`` ranks has a card of its own, gloo
    where ranks share a card or run on the CPU."""
    if torch.device(device).type == "cuda" \
            and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


class ResidentMesh:
    """An ``n_patch`` x ``n_frame`` mesh whose ranks stay up between
    calls, the caller being rank 0 (the module docstring). ``device``: the
    card unless the caller passes ``"cpu"``."""

    GRACE = 10.0        # seconds a worker has to leave after close()

    def __init__(self, n_patch: int = 1, n_frame: int = 1, device="cuda",
                 timeout: float = 120.0, pg_timeout: float = 60.0):
        if dist.is_initialized():
            raise RuntimeError("this process is in a process group already")
        world = n_patch * n_frame
        device = torch.device(device)
        backend = backend_for(device, world)
        if device.type == "cuda":
            device = torch.device("cuda", 0)
        self.backend, self.timeout = backend, timeout
        self.mesh: Optional[Mesh] = None
        self._closed = False
        self._tmp = tempfile.mkdtemp(prefix="cnmfe_mesh_")
        self._workers, self._conns, self._errors = [], [], []
        atexit.register(self.close)
        ctx = mp.get_context("spawn")
        try:
            for r in range(1, world):
                here, there = ctx.Pipe()
                proc = ctx.Process(
                    target=_worker_main, daemon=True,
                    args=(r, world, n_patch, n_frame, backend, str(device),
                          self._tmp, pg_timeout, there))
                proc.start()
                there.close()
                self._workers.append(proc)
                self._conns.append(here)
            self._replies("start-up")
            _join(0, world, backend, self._tmp, pg_timeout)
            self.mesh = make_mesh(n_patch, n_frame, device)
        except BaseException:
            self.close(failed=True)
            raise

    def _replies(self, what: str) -> None:
        """One reply from every worker within ``timeout``; a worker's
        error, or its end, raised as a RuntimeError."""
        waiting = dict(zip(range(1, len(self._conns) + 1), self._conns))
        deadline = time.monotonic() + self.timeout
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(waiting)} did not "
                                   f"finish {what} in {self.timeout:.0f} s")
            sentinels = {self._workers[r - 1].sentinel: r for r in waiting}
            ready = multiprocessing.connection.wait(
                list(waiting.values()) + list(sentinels), timeout=left)
            for obj in ready:
                r = sentinels.get(obj)
                if r is None:
                    r = next(q for q, c in waiting.items() if c is obj)
                    try:
                        kind, text, when = obj.recv()
                    except EOFError:
                        kind, text, when = "error", "its pipe closed", 0.0
                    if kind == "error":
                        self._errors.append((when, r, text))
                        raise RuntimeError(f"rank {r} failed in {what}:\n"
                                           f"{text}")
                    waiting.pop(r)
                elif r in waiting and not waiting[r].poll():
                    code = self._workers[r - 1].exitcode
                    raise RuntimeError(f"rank {r} ended in {what} "
                                       f"(exit code {code})")

    def call(self, fn: Callable, *args, **here):
        """``fn(mesh, *args)`` on every rank; rank 0's value. ``fn`` is a
        module-level function (the workers import it by name), ``args``
        small picklable values; ``here``: keyword arguments for rank 0's
        call alone (a stage context, tensors rank 0 ships)."""
        if self._closed:
            raise RuntimeError("the mesh is closed")
        if "<locals>" in fn.__qualname__:
            raise ValueError(f"{fn.__qualname__} is not importable by name")
        what = f"{fn.__module__}.{fn.__qualname__}"
        try:
            for conn in self._conns:
                conn.send((fn.__module__, fn.__qualname__, args))
            out = fn(self.mesh, *args, **here)
            self._replies(what)
            return out
        except BaseException as exc:
            err = self._first_error()
            self.close(failed=True)
            if err is None:
                raise
            raise RuntimeError(f"rank {err[0]} failed in {what}:\n"
                               f"{err[1]}") from exc

    def _first_error(self):
        """(rank, traceback) of the worker that failed first, of those
        whose error waits in their pipe (a worker sends it before it
        ends; a peer of a failed rank may fail after it), or None."""
        errors = list(self._errors)
        for r, conn in enumerate(self._conns, start=1):
            try:
                if conn.poll(0.2):
                    kind, text, when = conn.recv()
                    if kind == "error":
                        errors.append((when, r, text))
            except (EOFError, OSError):
                continue
        return min(errors)[1:] if errors else None

    def close(self, failed: bool = False) -> None:
        """End every rank: the workers leave (killed after ``GRACE``, at
        once after a failure) and rank 0 leaves the group. Idempotent."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        _end(self._workers, 0.0 if failed else self.GRACE)
        for conn in self._conns:
            conn.close()
        if dist.is_initialized():
            abort = getattr(dist.distributed_c10d, "_abort_process_group",
                            None)
            if failed and self.backend == "nccl" and abort is not None:
                # a collective may wait on the card for a killed peer
                abort()
            else:
                dist.destroy_process_group()
        self.mesh = None
        shutil.rmtree(self._tmp, ignore_errors=True)

    def alive(self) -> list:
        """The worker processes still running."""
        return [p for p in self._workers if p.is_alive()]


# the dtypes a header can name, by index
_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_HEADER = 10                # the header's int64 entries: dtype, ndim, shape
CHUNK_BYTES = 1 << 28       # the largest piece of one broadcast


def _header(x: Optional[torch.Tensor], mesh: Mesh):
    """(shape, dtype) of rank 0's ``x``, on every rank (one small
    broadcast of a tensor: nothing of the port pickles)."""
    h = torch.zeros(_HEADER, dtype=torch.int64, device=mesh.device)
    if mesh.rank == 0:
        if x.dim() > _HEADER - 2:
            raise ValueError(f"a {x.dim()}-d tensor does not fit the header")
        h[0], h[1] = _DTYPES.index(x.dtype), x.dim()
        h[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    v = comm.broadcast(h).tolist()
    return tuple(v[2:2 + v[1]]), _DTYPES[v[0]]


def _send(x: Optional[torch.Tensor], mesh: Mesh, keep: bool):
    """Rank 0's tensor ``x`` in chunks of whole rows along its first
    axis, each broadcast to every rank; returned (contiguous, on the
    rank's device) where ``keep``, else None."""
    shape, dtype = _header(x, mesh)
    wire = torch.uint8 if dtype == torch.bool else dtype
    row = max(1, int(torch.Size(shape[1:]).numel())
              * torch.empty((), dtype=wire).element_size())
    rows = shape[0] if shape else 1
    step = max(1, CHUNK_BYTES // row)
    if mesh.rank == 0:
        x = x.to(mesh.device)
        out = x.contiguous().clone() if keep else None
        if x.dim() == 0:
            x = x[None]
        for i in range(0, rows, step):
            piece = x[i:i + step].contiguous()
            comm.broadcast(piece.view(wire) if wire != dtype else piece)
        return out
    full = torch.empty((rows,) + tuple(shape[1:]), dtype=wire,
                       device=mesh.device)
    scratch = None if keep else torch.empty(
        (min(step, rows),) + tuple(shape[1:]), dtype=wire,
        device=mesh.device)
    for i in range(0, rows, step):
        n = min(step, rows - i)
        comm.broadcast(full[i:i + n] if keep else scratch[:n])
    if not keep:
        return None
    full = full.view(dtype) if wire != dtype else full
    return full.reshape(shape)


def broadcast(x: Optional[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Rank 0's tensor ``x`` (None on the other ranks) on every rank, on
    its device, shipped in chunks of ``CHUNK_BYTES``."""
    return _send(x, mesh, keep=True)


def scatter(x: Optional[torch.Tensor],
            cut: Callable[[torch.Tensor, Mesh], torch.Tensor],
            mesh: Mesh) -> torch.Tensor:
    """This rank's block of rank 0's tensor ``x`` (None on the other
    ranks). ``cut(x, m)`` is the block of the rank at ``m``'s coordinates,
    made on rank 0 (``m`` is ``mesh`` with that rank's p and f, as
    ``mesh.shard_movie`` reads them). The blocks are broadcast from rank 0
    in turn, in chunks; each rank keeps its own, and rank 0 a copy of
    its own."""
    mine = None
    for f in range(mesh.n_frame):
        for p in range(mesh.n_patch):
            m = dataclasses.replace(mesh, p=p, f=f)
            blk = cut(x, m) if mesh.rank == 0 else None
            if m.rank == 0:
                # nobody else needs rank 0's block
                if mesh.rank == 0:
                    mine = blk.to(mesh.device).contiguous().clone()
                continue
            got = _send(blk, mesh, keep=m.rank == mesh.rank)
            if m.rank == mesh.rank:
                mine = got
    return mine
