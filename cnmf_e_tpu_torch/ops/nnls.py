"""Batched nonnegative least squares by FISTA (port of
``cnmf_e_tpu/ops/nnls.py``; the role of the per-pixel active-set NNLS of
``nnls_spatial.m:34-60``).

Every problem of a batch runs the same fixed number of accelerated
projected-gradient steps on its normal equations. FISTA's momentum
sequence t_k does not depend on the data, so it is evaluated on the host
in float32, as the JAX package evaluates it on the device, and each step
costs three tensor operations.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from cnmf_e_tpu_torch.parallel import comm


def fista_momenta(n_iter: int) -> List[float]:
    """The momentum weights (t_k - 1) / t_{k+1} of ``n_iter`` FISTA steps
    from t_0 = 1, t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2, in float32."""
    t = np.float32(1.0)
    out = []
    for _ in range(n_iter):
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        out.append(float((t - np.float32(1.0)) / t_new))
        t = t_new
    return out


def nnls_fista(G: torch.Tensor, b: torch.Tensor,
               x0: Optional[torch.Tensor] = None,
               n_iter: int = 100) -> torch.Tensor:
    """Solve min_x 1/2 x^T G x - b^T x s.t. x >= 0, batched.

    G: (..., K, K) PSD Grams (or one (K, K) shared by the batch); b:
    (..., K). Step 1/L with L the largest absolute row sum of each G. An
    all-zero warm start falls back, per problem, to the first projected
    gradient step from zero."""
    L = torch.clamp(G.abs().sum(dim=-1).amax(dim=-1), min=1e-12)
    step = (1.0 / L)[..., None]
    default = torch.clamp(b * step, min=0.0)
    if x0 is None:
        x = default
    else:
        x = torch.where((x0 > 0).any(dim=-1, keepdim=True),
                        torch.clamp(x0, min=0.0), default)
    z = x
    for coef in fista_momenta(n_iter):
        grad = (G @ z[..., None])[..., 0] - b
        x_new = torch.clamp(z - step * grad, min=0.0)
        z = torch.lerp(x, x_new, 1.0 + coef)
        x = x_new
    return x


def nnls_pixels(C: torch.Tensor, Y: torch.Tensor,
                A0: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                n_iter: int = 100, mesh=None) -> torch.Tensor:
    """Per-pixel NNLS for the spatial update: A = argmin ||Y - A C||_F^2,
    A >= 0. C: (K, T); Y: (d, T); the optional search-location mask (d, K)
    freezes the coordinates outside it at zero. One Gram C C^T serves
    every pixel. ``mesh``: C and Y are this rank's frames (and Y its
    pixels); C C^T and Y C^T are summed over 'frame', and the rank solves
    its pixels."""
    G = comm.psum(C @ C.T, mesh, "frame")              # (K, K)
    B = comm.psum(Y @ C.T, mesh, "frame")              # (d, K)
    if mask is not None:
        B = torch.where(mask, B, 0.0)
    step = 1.0 / torch.clamp(G.abs().sum(dim=-1).amax(), min=1e-12)
    x = (torch.clamp(B * step, min=0.0) if A0 is None
         else torch.clamp(A0, min=0.0))
    if mask is not None:
        x = torch.where(mask, x, 0.0)
    z = x
    for coef in fista_momenta(n_iter):
        x_new = torch.clamp(z - step * (z @ G - B), min=0.0)
        if mask is not None:
            x_new = torch.where(mask, x_new, 0.0)
        z = torch.lerp(x, x_new, 1.0 + coef)
        x = x_new
    return x
