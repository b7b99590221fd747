"""Order statistics (port of ``cnmf_e_tpu/ops/stats.py``).

The medians here are the JAX package's value-space BISECTION medians, not
``torch.median``: both converge to the ceil(n/2)-th smallest element, but
the bisection result is the upper bracket after ``iters`` halvings, and
the pipeline's thresholds and baselines depend on exactly that value.
:func:`median_mid` is the averaging median of ``jnp.median``.

``mesh``: the reduced axis is the time axis, sharded over the mesh's
'frame' axis. The bisection only counts, so its mesh form sums the counts
``(x <= mid)`` over 'frame' and takes the brackets by an all-reduced
minimum and maximum: the same brackets as one process, so the same bits.
"""

from __future__ import annotations

import torch

from cnmf_e_tpu_torch.parallel import comm


def _count(b: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The number of True entries of ``b`` along ``dim`` (keepdim),
    summed over 'frame' under a mesh."""
    n = b.sum(dim=dim, keepdim=True)
    return n if mesh is None else comm.psum(n.to(torch.int32), mesh,
                                            "frame")


def fast_median(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
                iters: int = 30, mesh=None) -> torch.Tensor:
    """Median along ``dim`` by value-space bisection (within
    (max - min) / 2^iters of the ceil(n/2)-th smallest element)."""
    dim = dim % x.ndim
    n = x.shape[dim] * (1 if mesh is None else mesh.n_frame)
    target = (n + 1) // 2
    lo = comm.pmin(x.amin(dim=dim, keepdim=True), mesh, "frame")
    hi = comm.pmax(x.amax(dim=dim, keepdim=True), mesh, "frame")
    lo = lo - torch.clamp(1e-6 * lo.abs(), min=1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = _count(x <= mid, dim, mesh) >= target
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    return hi if keepdim else hi.squeeze(dim)


def submedian_mean(x: torch.Tensor, dim: int = -1,
                   mesh=None) -> torch.Tensor:
    """Mean of the samples strictly below the median (the per-trace
    baseline estimator of ``HALS_temporal.m:79``)."""
    med = fast_median(x, dim=dim, keepdim=True, mesh=mesh)
    below = x < med
    s = comm.psum(torch.where(below, x, 0.0).sum(dim=dim), mesh, "frame")
    n = _count(below, dim, mesh).squeeze(dim).clamp(min=1)
    return s / n


def fast_median_masked(x: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                       iters: int = 20, mesh=None) -> torch.Tensor:
    """Bisection median of the entries where ``mask`` is True (broadcast
    against ``x``); rows with no selected entry give 0."""
    dim = dim % x.ndim
    mask = torch.broadcast_to(mask, x.shape)
    n = _count(mask, dim, mesh)
    target = (n + 1) // 2
    big = comm.pmax(x.abs().max(), mesh, "frame") + 1.0
    lo = comm.pmin(torch.where(mask, x, big).amin(dim=dim, keepdim=True),
                   mesh, "frame")
    hi = comm.pmax(torch.where(mask, x, -big).amax(dim=dim, keepdim=True),
                   mesh, "frame")
    lo = lo - torch.clamp(1e-6 * lo.abs(), min=1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = _count(mask & (x <= mid), dim, mesh) >= target
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    return torch.where(n > 0, hi, 0.0).squeeze(dim)


def median_mid(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle elements for even n."""
    n = x.shape[dim]
    xs = torch.sort(x, dim=dim).values
    lo = xs.narrow(dim, (n - 1) // 2, 1)
    hi = xs.narrow(dim, n // 2, 1)
    return (0.5 * (lo + hi)).squeeze(dim)
