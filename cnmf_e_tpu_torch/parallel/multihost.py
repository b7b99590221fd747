"""Multi-host ingest: every rank reads only its own block of a movie store
(port of ``cnmf_e_tpu/parallel/multihost.py``).

  * :func:`init_distributed` — ``torch.distributed.init_process_group``
    (a no-op returning 0 for a single process, so the same program runs
    on 1..N hosts);
  * :func:`frame_range_for_process` — this rank's [start, stop) frames;
  * :func:`load_sharded_movie` — this rank's (T/frame, H/patch, W) block
    read from a :class:`~cnmf_e_tpu_torch.io.store.MovieStore`, the
    trailing frame shard zero-padded to the others' length
    (``multihost.py:84-88``).

On the JAX side the blocks assemble into one global array
(``make_array_from_process_local_data``); here each rank keeps its block,
which is what the mesh step and ``fit_streaming(mesh=...)`` take.
"""

from __future__ import annotations

import datetime
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cnmf_e_tpu_torch.io.store import MovieStore


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: str = "gloo",
                     timeout: float = 60.0) -> int:
    """Join the default process group and return this process's rank.
    Single process (no ``init_method`` and one rank or none given): a
    no-op returning 0, so a program can call it unconditionally. Give
    ``init_method`` (``tcp://host:port`` or ``file://path``), the world
    size and the rank yourself: nothing on the host announces a cluster."""
    if init_method is None and world_size in (None, 1):
        return 0
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.get_rank()


def frame_range_for_process(T: int, mesh) -> Tuple[int, int]:
    """The [start, stop) frames this rank owns under the (frame, patch)
    movie layout: shards of ceil(T / n_frame) frames, the last one
    shorter when n_frame does not divide T."""
    per = -(-T // mesh.n_frame)
    lo = mesh.f * per
    return min(lo, T), min(lo + per, T)


def load_sharded_movie(store: MovieStore, mesh,
                       dtype=torch.float32) -> torch.Tensor:
    """This rank's (ceil(T / n_frame), H / n_patch, W) block of the
    store's movie on the mesh's device: only its frames and rows are
    read, and frames past T are zeros."""
    T, H, W = store.shape
    h0, h1 = mesh.rows(H)
    lo, hi = frame_range_for_process(T, mesh)
    per = -(-T // mesh.n_frame)
    out = np.zeros((per, h1 - h0, W), np.float32)
    fpb = store.frames_per_block
    t = lo
    while t < hi:
        blk, off = divmod(t, fpb)
        data = store.read_block(blk)
        n = min(hi - t, data.shape[0] - off)
        out[t - lo:t - lo + n] = data[off:off + n, h0:h1]
        t += n
    return torch.as_tensor(out, device=mesh.device).to(dtype)
