"""HALS block-coordinate updates for the spatial (A) and temporal (C)
factors (port of ``cnmf_e_tpu/ops/hals.py``; reference
``HALS_spatial.m:26-46`` and ``HALS_temporal.m:58-107``).

The Grams U and V are plain matmuls; the sweeps run in the HALS kernel
(:mod:`cnmf_e_tpu_torch.ops.hals_kernels`) on row-major factors, on a
colour-class schedule or, for the uncoloured step of
``parallel/step.py``, on the in-order block grid. ``hals_spatial`` and
``hals_temporal`` keep the JAX package's (d, K) layout.

``mesh``: Y holds this rank's pixels and frames, A its pixels and C its
frames. The spatial update sums C's mean, C C^T and C Y^T over 'frame'
and runs K1 on the rank's pixels; the temporal update sums A^T A and
A^T Y over 'patch' and runs K1 on the rank's frames; the colourings run
on graphs summed over 'patch', the same on every rank
(``parallel/step.py``'s mesh branch does the same).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cnmf_e_tpu_torch.ops.coloring import (class_step_schedule,
                                           greedy_color, overlap_adjacency)
from cnmf_e_tpu_torch.ops.hals_kernels import (block_grid_schedule,
                                               hals_sweeps)
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import span


_BLOCK = 64                 # rows per sweep step of one colour class


def hals_spatial_sweeps_rows(U: torch.Tensor, V: torch.Tensor,
                             A: torch.Tensor,
                             mask: Optional[torch.Tensor] = None,
                             n_iter: int = 5, block: int = 16,
                             schedule: Optional[Tuple] = None
                             ) -> torch.Tensor:
    """Gauss-Seidel spatial sweeps on the row-major factor: U = Ysig_c C^T
    and A, mask (K, d); V = C C^T (K, K) (``hals.py:102-135`` of the JAX
    package). With no schedule the rows update in order, ``block`` rows a
    step; a class schedule needs rows in colored order."""
    K = A.shape[0]
    if schedule is None:
        schedule = block_grid_schedule(K, block, A.device)
    return hals_sweeps(U, V, A, gate=torch.ones(K, device=A.device),
                       schedule=schedule, mask=mask, n_iter=n_iter,
                       block=block, relu=True)


def hals_temporal_sweeps(U: torch.Tensor, V: torch.Tensor, C: torch.Tensor,
                         n_iter: int = 5,
                         active: Optional[torch.Tensor] = None,
                         schedule: Optional[Tuple] = None,
                         block: int = 16) -> torch.Tensor:
    """Gauss-Seidel temporal sweeps given U = A^T Y (K, T) and V = A^T A;
    rows with ``active`` False keep their traces (``hals.py:178-246`` of
    the JAX package). With no schedule the rows update in order, ``block``
    rows a step; a class schedule needs rows in colored order."""
    if schedule is None:
        schedule = block_grid_schedule(C.shape[0], block, C.device)
    gate = (torch.ones(C.shape[0], device=C.device) if active is None
            else active)
    return hals_sweeps(U, V, C, gate=gate, schedule=schedule, n_iter=n_iter,
                       block=block, relu=False)


def _colored(coupling_adj: torch.Tensor):
    """(order, inverse, schedule) of the greedy colouring of an overlap
    graph: rows of one class become contiguous and share sweep steps."""
    colors = greedy_color(coupling_adj)
    order = torch.argsort(colors, stable=True)
    inverse = torch.argsort(order)
    return order, inverse, class_step_schedule(colors[order], block=_BLOCK)


def hals_spatial(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, n_iter: int = 5,
                 colored: bool = True, mesh=None) -> torch.Tensor:
    """Update A given C: A <- max(0, A + (U - A V) / diag(V)) per neuron,
    with means removed from Y and C (``HALS_spatial.m:28-32``).

    Y: (d, T); A: (d, K); C: (K, T); mask: optional (d, K) search
    locations. With ``colored`` (which needs the mask) neurons are
    ordered by a greedy colouring of the mask-overlap graph so
    non-overlapping neurons share a sweep step (``update_order.m:1-21``);
    otherwise they update in order, 16 rows a step, as in the JAX
    package's default."""
    T = Y.shape[-1] * (1 if mesh is None else mesh.n_frame)
    with span("hals.products"):
        Ymean = comm.frame_mean(Y, 1, mesh, keepdim=True)
        Cmean = comm.frame_mean(C, 1, mesh, keepdim=True)
        # row-major (K, d) operands straight from the products, so the
        # kernel reads them without a transposing copy
        U = (comm.psum(C @ Y.T, mesh, "frame")
             - T * (Cmean @ Ymean.T))                       # (K, d)
        V = (comm.psum(C @ C.T, mesh, "frame")
             - T * (Cmean @ Cmean.T))                       # (K, K)
    if not (colored and mask is not None):
        with span("hals.sweeps"):
            return hals_spatial_sweeps_rows(
                U, V, A.T, mask=None if mask is None else mask.T,
                n_iter=n_iter).T
    with span("hals.color"):
        order, inverse, sched = _colored(overlap_adjacency(mask.T, mesh))
    with span("hals.sweeps"):
        out = hals_spatial_sweeps_rows(U[order], V[order][:, order],
                                       A.T[order], mask=mask.T[order],
                                       n_iter=n_iter, block=_BLOCK,
                                       schedule=sched)
        return out[inverse].T


def hals_temporal(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                  n_iter: int = 5, active: Optional[torch.Tensor] = None,
                  colored: bool = True, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Update C given A: c_k <- c_k + (U_k - V_k C) / aa_k (no
    deconvolution). Y: (d, T); A: (d, K); C: (K, T). Returns
    (C_raw, aa = diag(A^T A)).

    With ``colored`` neurons are ordered by a greedy colouring of the
    footprint overlap graph (disjoint footprints give exact-zero V
    entries); otherwise they update in order, 16 rows a step, as in the
    JAX package's default."""
    with span("hals.products"):
        U = comm.psum(A.T @ Y, mesh, "patch")               # (K, T)
        V = comm.psum(A.T @ A, mesh, "patch")               # (K, K)
    if not colored:
        with span("hals.sweeps"):
            return (hals_temporal_sweeps(U, V, C, n_iter=n_iter,
                                         active=active), torch.diagonal(V))
    K = V.shape[0]
    with span("hals.color"):
        adj = (V != 0) & ~torch.eye(K, dtype=torch.bool, device=V.device)
        order, inverse, sched = _colored(adj)
    with span("hals.sweeps"):
        act = None if active is None else active[order]
        out = hals_temporal_sweeps(U[order], V[order][:, order], C[order],
                                   n_iter=n_iter, active=act,
                                   schedule=sched, block=_BLOCK)
        return out[inverse], torch.diagonal(V)


def hals_nmf(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
             n_iter: int = 10, mask: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternate one in-order spatial and one in-order temporal HALS sweep
    ``n_iter`` times, traces clipped at 0 (the rank-1 merge refits and
    the simple init refinement of the reference,
    ``merge_neurons_dist_corr.m:180-187``). Y: (d, T); A: (d, K);
    C: (K, T); mask: optional (d, K) support of A."""
    for _ in range(n_iter):
        A = hals_spatial(Y, A, C, mask=mask, n_iter=1, colored=False)
        C, _ = hals_temporal(Y, A, C, n_iter=1, colored=False)
        C = torch.clamp(C, min=0.0)
    return A, C
