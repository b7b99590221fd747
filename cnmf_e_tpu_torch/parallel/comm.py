"""The collectives of the (patch, frame) mesh, written out.

The JAX package leaves them to GSPMD, which inserts them where a sharded
contraction or stencil needs them (``cnmf_e_tpu/parallel/step.py:120-124,
198-202, 262-267``). The port calls them by name on ``torch.distributed``
process groups:

  * :func:`psum` — the sum of a Gram or a partial sum over the 'frame' or
    the 'patch' axis of a :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh`
    (identity without a mesh);
  * :func:`all_gather_cat` — the blocks of every member, concatenated
    along one dimension, sizes equal or given;
  * :func:`halo_rows` — a slab's rows [h0 - r, h1 + r) from its patch
    neighbours, outside the field of view zeros (the ring, the boxes, the
    correlation image) or copies of the edge row (the replicate-padded
    filters and the clamped resize), across several slabs when a slab
    holds fewer than r rows;
  * :func:`frame_mean`, :func:`norm` — a mean over the frame-sharded
    time axis, an l2 norm over a sharded axis;
  * :func:`argmax_rows` — per row, the flat index of the maximum of a
    row-sharded image, ties to the lowest index (``argmax``'s rule);
  * :func:`traces_to_neurons` / :func:`traces_to_frames` — the trace
    reshard: K over 'patch' with whole traces (the deconvolution), and
    back to T over 'frame';
  * :func:`broadcast` — a tensor of one rank written into every rank's.

No function here pickles: the model's state travels as tensors only.

Transport: the functions use three collectives, all-reduce, all-gather
and broadcast, which both backends carry with CUDA tensors as they are:
NCCL on the card, gloo through its own host buffers. Gloo aborts the
process (it does not raise) on all-to-all and on send/recv of CUDA
tensors, so the halo exchange is an all-gather of the slabs' edge rows;
and its own CUDA all-gather beat a copy through pinned host buffers made
here (``scripts_torch/gloo_cuda_probe.py`` measures both), so nothing is
staged by hand. :func:`broadcast` is the set-up's:
``launch.ResidentMesh`` ships each rank its blocks with it. ``STATS``
counts the bytes each rank hands to the collectives, the host seconds
spent inside these functions (waiting for the other ranks included) and
their calls, in all and by kind (``STATS["kinds"]``: ``all_reduce``,
``all_gather``, ``broadcast``).

Spans: each collective call is the span ``comm.<kind>``
(``utils/profiling.py::span``), and the halo exchange and the trace
reshard are ``comm.halo_rows``, ``comm.traces_to_neurons`` and
``comm.traces_to_frames`` around theirs; like every span they never
synchronise, and without a mesh no span opens.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cnmf_e_tpu_torch.utils.profiling import span

STATS = {"bytes": 0, "seconds": 0.0, "calls": 0, "kinds": {}}


def reset_stats() -> None:
    STATS.update(bytes=0, seconds=0.0, calls=0, kinds={})


class _counted:
    """One collective call of ``kind`` handing over ``nbytes``: counted in
    ``STATS`` with its host seconds, and the span ``comm.<kind>``."""

    def __init__(self, kind: str, nbytes: int):
        STATS["bytes"] += nbytes
        k = STATS["kinds"].setdefault(kind, {"bytes": 0, "calls": 0})
        k["bytes"] += nbytes
        k["calls"] += 1
        self.span = span("comm." + kind)

    def __enter__(self):
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        STATS["seconds"] += time.perf_counter() - self.t0
        STATS["calls"] += 1
        self.span.__exit__(*exc)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    x = x.contiguous()
    with _counted("all_reduce", _nbytes(x)):
        dist.all_reduce(x, op=op, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the members of ``group`` (in place where
    ``x`` is contiguous; the result is returned)."""
    return _reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the members of ``group``."""
    return _reduce(x, group, dist.ReduceOp.MAX)


def all_reduce_min(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the members of ``group``."""
    return _reduce(x, group, dist.ReduceOp.MIN)


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` summed over the mesh axis ``axis`` ("frame" or "patch");
    ``x`` unchanged without a mesh."""
    return x if mesh is None else all_reduce_sum(x, mesh.group(axis))


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the mesh axis ``axis``;
    ``x`` unchanged without a mesh."""
    return x if mesh is None else all_reduce_max(x, mesh.group(axis))


def pmin(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the mesh axis ``axis``;
    ``x`` unchanged without a mesh."""
    return x if mesh is None else all_reduce_min(x, mesh.group(axis))


def frame_mean(x: torch.Tensor, dim: int, mesh, keepdim: bool = False,
               n: Optional[int] = None) -> torch.Tensor:
    """The mean of ``x`` along ``dim``, the time axis sharded over 'frame':
    the sum over 'frame' over the whole length ``n`` (by default that of
    equal blocks; pass it where the blocks differ, as the strided frames
    of a stride grid do). Without a mesh, or on a single 'frame' rank,
    ``x.mean`` itself, so a 1 x 1 mesh rounds as one process does."""
    if mesh is None or mesh.n_frame == 1:
        return x.mean(dim=dim, keepdim=keepdim)
    if n is None:
        n = x.shape[dim] * mesh.n_frame
    return all_reduce_sum(x.sum(dim=dim, keepdim=keepdim),
                          mesh.frame_group) / n


def norm(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """The l2 norm of ``x`` along ``dim``, an axis sharded over the mesh
    axis ``axis``: the root of the squares summed over it. Without a
    mesh, or on a single rank of ``axis``, ``torch.linalg.norm`` itself."""
    if mesh is None or dist.get_world_size(mesh.group(axis)) == 1:
        return torch.linalg.norm(x, dim=dim)
    return torch.sqrt(all_reduce_sum((x * x).sum(dim=dim),
                                     mesh.group(axis)))


def argmax_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Per leading index, the flat index into the full (H, W) field of
    view of the maximum of ``x`` (..., Hp, W), this rank's rows of it;
    ties go to the lowest flat index, as ``argmax`` breaks them. The
    local maxima and their global indices are gathered over 'patch'; the
    slabs lie in row order, so the first slab holding the maximum holds
    its lowest index."""
    Hp, W = x.shape[-2:]
    flat = x.reshape(x.shape[:-2] + (-1,))
    idx = flat.argmax(dim=-1)
    val = torch.gather(flat, -1, idx[..., None])[..., 0]
    if mesh is None:
        return idx
    idx = idx + mesh.p * Hp * W
    both = torch.stack([val, idx.to(val.dtype)], dim=-1)[None]
    allp = all_gather_cat(both, 0, mesh.patch_group)    # (n_patch, ..., 2)
    best = allp[..., 0].argmax(dim=0)
    # flat indices below 2^24 travel exactly in float32
    return torch.gather(allp[..., 1], 0, best[None])[0].long()


def all_gather_cat(x: torch.Tensor, dim: int, group,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Every member's ``x``, in rank order, concatenated along ``dim``.
    ``sizes``: each member's extent along ``dim`` where they differ
    (default: all equal to this one's); shorter blocks travel
    zero-padded."""
    n = dist.get_world_size(group)
    if sizes is None:
        sizes = [x.shape[dim]] * n
    m = max(sizes)
    if x.shape[dim] < m:
        x = F.pad(x, [0, 0] * (x.dim() - 1 - dim % x.dim())
                  + [0, m - x.shape[dim]])
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    with _counted("all_gather", _nbytes(x)):
        dist.all_gather(parts, x, group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)],
                     dim=dim)


def halo_rows(x: torch.Tensor, r: int, mesh,
              edge: str = "zeros") -> torch.Tensor:
    """The slab ``x`` (..., Hp, W), this rank's rows [h0, h1) of the
    field of view, extended by the ``r`` rows above and below it: rows
    [h0 - r, h1 + r), from the patch neighbours; outside the field of
    view zeros, or with ``edge="replicate"`` copies of its first and last
    row (``F.pad(mode="replicate")``). Where a slab holds fewer than
    ``r`` rows the halo spans several slabs. One all-gather of every
    slab's edge rows over 'patch'."""
    if r <= 0:
        return x
    if edge not in ("zeros", "replicate"):
        raise ValueError(f"halo edge {edge!r}")
    with span("comm.halo_rows"):
        Hp = x.shape[-2]
        n, p = mesh.n_patch, mesh.p
        e = min(r, Hp)
        edges = torch.stack([x[..., :e, :], x[..., Hp - e:, :]])
        # (n, 2, ..., e, W): every patch rank's top and bottom edge rows
        allp = all_gather_cat(edges[None], 0, mesh.patch_group)
        hops = -(-r // e)
        if edge == "zeros":
            top = bottom = torch.zeros_like(edges[0])
        else:
            top = allp[0, 0][..., :1, :].expand_as(edges[0])
            bottom = allp[n - 1, 1][..., e - 1:, :].expand_as(edges[0])
        above = torch.cat([allp[q, 1] if q >= 0 else top
                           for q in range(p - hops, p)], dim=-2)
        below = torch.cat([allp[q, 0] if q < n else bottom
                           for q in range(p + 1, p + 1 + hops)], dim=-2)
        return torch.cat([above[..., above.shape[-2] - r:, :], x,
                          below[..., :r, :]], dim=-2)


def traces_to_neurons(x: torch.Tensor, mesh) -> torch.Tensor:
    """(K, T/frame) traces to this patch rank's K/n_patch whole traces
    (K/n_patch, T): its rows, gathered over 'frame'. ``x`` unchanged
    without a mesh."""
    if mesh is None:
        return x
    with span("comm.traces_to_neurons"):
        k0, k1 = mesh.neurons(x.shape[0])
        return all_gather_cat(x[k0:k1], 1, mesh.frame_group)


def traces_to_frames(x: torch.Tensor, T: int, mesh) -> torch.Tensor:
    """The inverse of :func:`traces_to_neurons`: (K/n_patch, T) whole
    traces back to (K, T/frame), this rank's frames of every neuron,
    gathered over 'patch' (every member of a patch group holds the same
    frames)."""
    if mesh is None:
        return x
    with span("comm.traces_to_frames"):
        t0, t1 = mesh.frames(T)
        return all_gather_cat(x[:, t0:t1], 0, mesh.patch_group)


def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``x`` of the rank ``src`` written into ``x`` on every member of
    ``group`` (the default group: every rank), in place; ``x`` must be
    contiguous and shaped alike on every member."""
    with _counted("broadcast", _nbytes(x)):
        dist.broadcast(x, src=src, group=group)
    return x

