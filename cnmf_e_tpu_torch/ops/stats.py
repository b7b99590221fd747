"""Order statistics (port of ``cnmf_e_tpu/ops/stats.py``).

The medians here are the JAX package's value-space BISECTION medians, not
``torch.median``: both converge to the ceil(n/2)-th smallest element, but
the bisection result is the upper bracket after ``iters`` halvings, and
the pipeline's thresholds and baselines depend on exactly that value.
:func:`median_mid` is the averaging median of ``jnp.median``.
"""

from __future__ import annotations

import torch


def fast_median(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
                iters: int = 30) -> torch.Tensor:
    """Median along ``dim`` by value-space bisection (within
    (max - min) / 2^iters of the ceil(n/2)-th smallest element)."""
    dim = dim % x.ndim
    n = x.shape[dim]
    target = (n + 1) // 2
    lo = x.amin(dim=dim, keepdim=True)
    hi = x.amax(dim=dim, keepdim=True)
    lo = lo - torch.clamp(1e-6 * lo.abs(), min=1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (x <= mid).sum(dim=dim, keepdim=True) >= target
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    return hi if keepdim else hi.squeeze(dim)


def submedian_mean(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Mean of the samples strictly below the median (the per-trace
    baseline estimator of ``HALS_temporal.m:79``)."""
    med = fast_median(x, dim=dim, keepdim=True)
    below = x < med
    s = torch.where(below, x, 0.0).sum(dim=dim)
    n = below.sum(dim=dim).clamp(min=1)
    return s / n


def fast_median_masked(x: torch.Tensor, mask: torch.Tensor, dim: int = -1,
                       iters: int = 20) -> torch.Tensor:
    """Bisection median of the entries where ``mask`` is True (broadcast
    against ``x``); rows with no selected entry give 0."""
    dim = dim % x.ndim
    mask = torch.broadcast_to(mask, x.shape)
    n = mask.sum(dim=dim, keepdim=True)
    target = (n + 1) // 2
    big = x.abs().max() + 1.0
    lo = torch.where(mask, x, big).amin(dim=dim, keepdim=True)
    hi = torch.where(mask, x, -big).amax(dim=dim, keepdim=True)
    lo = lo - torch.clamp(1e-6 * lo.abs(), min=1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (mask & (x <= mid)).sum(dim=dim, keepdim=True) >= target
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
