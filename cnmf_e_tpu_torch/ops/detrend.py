"""Detrending of slow baseline drift (port of ``cnmf_e_tpu/ops/detrend.py``).

Reference: ``endoscope/detrend_data.m`` — cubic B-spline basis regression
(``bsplineM.m``) or blockwise local-min subtraction, both as batched linear
algebra over the trace axis (the basis is built in numpy on the host).

``mesh``: the trace axis is this rank's frames (T/frame of them): the
spline's products with the basis are summed over 'frame' (each rank
multiplies its frames by its rows of the whole basis), and each block's
minimum is the least of the ranks' minima over 'frame'.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.parallel import comm


def bspline_basis(T: int, n_knots: int, order: int = 4) -> np.ndarray:
    """Cubic B-spline basis on [0, T) with uniformly spaced knots.

    Equivalent role to ``bsplineM((1:T)', linspace(1,T,nk), 4)``. Returns
    (T, n_basis) with n_basis = n_knots + order - 2.
    """
    n_knots = max(int(n_knots), 2)
    # clamped knot vector
    interior = np.linspace(0, T - 1, n_knots)
    knots = np.concatenate([[interior[0]] * (order - 1), interior,
                            [interior[-1]] * (order - 1)])
    t = np.arange(T, dtype=np.float64)
    n_basis = len(knots) - order

    # Cox-de Boor recursion
    B = np.zeros((T, len(knots) - 1))
    for i in range(len(knots) - 1):
        B[:, i] = ((t >= knots[i]) & (t < knots[i + 1])).astype(float)
    B[-1, np.searchsorted(knots, T - 1, "right") - 1 - (order - 1)] = 1.0
    for k in range(2, order + 1):
        Bn = np.zeros((T, len(knots) - k))
        for i in range(len(knots) - k):
            d1 = knots[i + k - 1] - knots[i]
            d2 = knots[i + k] - knots[i + 1]
            left = (t - knots[i]) / d1 * B[:, i] if d1 > 0 else 0.0
            right = (knots[i + k] - t) / d2 * B[:, i + 1] if d2 > 0 else 0.0
            Bn[:, i] = left + right
        B = Bn
    # fix the right endpoint (half-open support convention)
    B[-1] = 0.0
    B[-1, -1] = 1.0
    return B[:, :n_basis].astype(np.float32)


def _frames(T: int, mesh) -> Tuple[int, int]:
    return (0, T) if mesh is None else mesh.frames(T)


def detrend_spline(Y: torch.Tensor, n_knots: int = 5, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares B-spline detrend along the last axis.

    Y: (..., T). Returns (Y_detrended, trend).
    """
    T = Y.shape[-1] * (1 if mesh is None else mesh.n_frame)
    X = torch.as_tensor(bspline_basis(T, n_knots), device=Y.device)
    G = X.T @ X + 1e-6 * torch.eye(X.shape[1], device=Y.device)
    t0, t1 = _frames(T, mesh)
    Xl = X[t0:t1]
    coef = comm.psum(Y @ Xl, mesh, "frame") @ torch.linalg.inv(G)
    trend = coef @ Xl.T
    return Y - trend, trend


def detrend_local_min(Y: torch.Tensor, n_blocks: int = 5, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise local-min subtraction (detrend_data.m 'local_min' branch):
    split the trace into n_blocks blocks and subtract each block's min."""
    if mesh is not None and mesh.n_frame > 1:
        Tl = Y.shape[-1]
        T = Tl * mesh.n_frame
        k = -(-T // n_blocks)
        t0, _ = mesh.frames(T)
        block = torch.as_tensor((np.arange(t0, t0 + Tl) // k),
                                device=Y.device)
        # each block's minimum over this rank's frames (+inf where it
        # holds none of them), then the least over 'frame'
        own = torch.stack([
            torch.where(block == b, Y, torch.inf).amin(dim=-1)
            for b in range(n_blocks)], dim=-1)
        mins = comm.pmin(own, mesh, "frame")
        trend = torch.gather(mins, -1, block.expand(Y.shape))
        return Y - trend, trend
    T = Y.shape[-1]
    k = -(-T // n_blocks)
    Tpad = k * n_blocks
    pad = Tpad - T
    Yp = torch.cat([Y, Y[..., -1:].expand(Y.shape[:-1] + (pad,))],
                   dim=-1) if pad else Y
    blocks = Yp.reshape(Y.shape[:-1] + (n_blocks, k))
    mins = blocks.amin(dim=-1, keepdim=True)
    out = (blocks - mins).reshape(Y.shape[:-1] + (Tpad,))[..., :T]
    trend = torch.broadcast_to(mins, blocks.shape).reshape(
        Y.shape[:-1] + (Tpad,))[..., :T]
    return out, trend


def detrend(Y: torch.Tensor, n_knots: int = 5, method: str = "spline",
            mesh=None) -> torch.Tensor:
    if n_knots <= 1:
        return Y
    if method == "spline":
        return detrend_spline(Y, n_knots, mesh)[0]
    return detrend_local_min(Y, n_knots, mesh)[0]
