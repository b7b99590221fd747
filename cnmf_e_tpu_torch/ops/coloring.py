"""Overlap-graph coloring for order-free Gauss-Seidel HALS updates (port of
``cnmf_e_tpu/ops/coloring.py``; reference ``utilities/update_order.m``).

Rows of one color class never interact in a HALS sweep (disjoint
footprints give exact-zero temporal Gram entries; disjoint search masks
decouple the spatial update), so the HALS kernel updates a whole class
step in one vectorized pass. The schedule keeps the JAX package's 8-row
anchoring so both packages produce the same steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.parallel import comm


def overlap_adjacency(support: torch.Tensor, mesh=None) -> torch.Tensor:
    """Boolean overlap graph (K, K) of the row supports of ``support``
    (K, d), zero diagonal (``update_order.m:4-5``). ``mesh``: ``support``
    holds this rank's pixels; the overlap counts are summed over 'patch',
    so every rank holds the same graph."""
    S = (support > 0).to(torch.float32)
    O = comm.psum(S @ S.T, mesh, "patch")
    eye = torch.eye(S.shape[0], dtype=torch.bool, device=S.device)
    return (O > 0) & ~eye


def greedy_color(adj: torch.Tensor) -> torch.Tensor:
    """Greedy sequential coloring: row k takes the smallest color unused
    by its lower-indexed neighbors. adj: (K, K) bool, symmetric. Returns
    int32 colors on adj's device.

    The K steps are inherently sequential and each is O(K) work, so they
    run on the host after one (K, K) copy instead of as K rounds of tiny
    device launches."""
    a = adj.detach().cpu().numpy()
    K = a.shape[0]
    colors = np.full(K, K, np.int64)
    for k in range(K):
        used = np.zeros(K + 1, bool)
        used[colors[a[k]]] = True
        colors[k] = int(np.argmin(used[:K]))
    return torch.as_tensor(colors.astype(np.int32), device=adj.device)


def color_order(adj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse): the permutation that makes the rows of each
    colour class of :func:`greedy_color` contiguous, and its inverse.
    Apply as ``X[order]`` before the sweeps and ``X[inverse]`` after."""
    order = torch.argsort(greedy_color(adj), stable=True)
    return order, torch.argsort(order)


def block_free_flags(coupling: torch.Tensor, block: int = 16,
                     gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-block independence flags (ceil(K / block),) int32 for the
    free-step path of the HALS sweeps. coupling: (K, K), the temporal
    Gram V or the mask-overlap Gram; a block is free iff every
    off-diagonal entry among its gated rows is exactly zero (rows with
    gate == 0 never update, so their couplings do not count)."""
    K = coupling.shape[0]
    nb = -(-K // block)
    Kp = nb * block
    Cg = coupling
    if gate is not None:
        g = gate.to(Cg.dtype)
        Cg = Cg * g[:, None] * g[None, :]
    Cg = torch.nn.functional.pad(Cg, (0, Kp - K, 0, Kp - K))
    idx = torch.arange(Kp, device=Cg.device).reshape(nb, block)
    Bd = Cg[idx[:, :, None], idx[:, None, :]]               # (nb, B, B)
    off = ~torch.eye(block, dtype=torch.bool, device=Cg.device)
    return (~((Bd != 0) & off).any(dim=(1, 2))).to(torch.int32)


def class_step_schedule(colors: torch.Tensor, block: int,
                        n_cap: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Class-aligned sweep schedule for the HALS kernel (rows already in
    colored order): one step per ``block`` rows of each color class, the
    step grid anchored at the 8-aligned class start; step j updates rows
    [starts[j], ends[j]) clipped to its ``block``-row window. If the steps
    overflow ``n_cap`` (default ceil(K/block) + 32) the schedule falls back
    to the plain block grid with per-block independence flags.

    Returns (starts, ends, free, n_steps): three (n_cap,) int32 tensors and
    an int32 scalar tensor; unused slots hold start = end = K."""
    K = colors.shape[0]
    dev = colors.device
    cs = colors.long()
    nb = -(-K // block)
    if n_cap is None:
        n_cap = nb + 32
    n_cap = max(n_cap, nb)
    counts = torch.bincount(cs, minlength=K)[:K]
    cstart = torch.cumsum(counts, 0) - counts
    cend = cstart + counts
    r = torch.arange(K, device=dev)
    cs8 = (cstart // 8) * 8
    opens = (r == cstart[cs]) | ((r > cstart[cs])
                                 & ((r - cs8[cs]) % block == 0))
    step_of_open = torch.cumsum(opens.long(), 0) - 1
    n_steps = opens.sum()
    fits = n_steps <= n_cap

    big = K
    # opening rows past the capacity drop into the spare slot n_cap
    slot = torch.where(opens & (step_of_open < n_cap), step_of_open,
                       torch.full_like(r, n_cap))
    starts_cls = torch.full((n_cap + 1,), big, dtype=torch.long, device=dev)
    starts_cls[slot] = r
    ends_cls = torch.full((n_cap + 1,), big, dtype=torch.long, device=dev)
    ends_cls[slot] = cend[cs]
    starts_cls, ends_cls = starts_cls[:n_cap], ends_cls[:n_cap]
    free_cls = torch.ones((n_cap,), dtype=torch.long, device=dev)

    jj = torch.arange(n_cap, device=dev)
    starts_blk = torch.where(jj < nb, jj * block, big)
    ends_blk = torch.where(jj < nb, K, big)
    first_color = cs[torch.clamp(starts_blk, 0, K - 1)]
    last_row = torch.clamp(torch.minimum(starts_blk + block,
                                         torch.tensor(K, device=dev)) - 1,
                           0, K - 1)
    free_blk = (cs[last_row] == first_color).long() * (jj < nb).long()

    i32 = torch.int32
    starts = torch.where(fits, starts_cls, starts_blk).to(i32)
    ends = torch.where(fits, ends_cls, ends_blk).to(i32)
    free = torch.where(fits, free_cls, free_blk).to(i32)
    n_used = torch.where(fits, n_steps, torch.tensor(nb, device=dev)).to(i32)
    return starts, ends, free, n_used
