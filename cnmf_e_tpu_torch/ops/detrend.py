"""Detrending of slow baseline drift (port of ``cnmf_e_tpu/ops/detrend.py``).

Reference: ``endoscope/detrend_data.m`` — cubic B-spline basis regression
(``bsplineM.m``) or blockwise local-min subtraction, both as batched linear
algebra over the trace axis (the basis is built in numpy on the host).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def detrend_spline(Y: torch.Tensor, n_knots: int = 5
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Least-squares B-spline detrend along the last axis.

    Y: (..., T). Returns (Y_detrended, trend).
    """
    T = Y.shape[-1]
    X = torch.as_tensor(bspline_basis(T, n_knots), device=Y.device)
    G = X.T @ X + 1e-6 * torch.eye(X.shape[1], device=Y.device)
    coef = (Y @ X) @ torch.linalg.inv(G)
    trend = coef @ X.T
    return Y - trend, trend


def detrend_local_min(Y: torch.Tensor, n_blocks: int = 5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise local-min subtraction (detrend_data.m 'local_min' branch):
    split the trace into n_blocks blocks and subtract each block's min."""
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


def detrend(Y: torch.Tensor, n_knots: int = 5, method: str = "spline"
            ) -> torch.Tensor:
    if n_knots <= 1:
        return Y
    if method == "spline":
        return detrend_spline(Y, n_knots)[0]
    return detrend_local_min(Y, n_knots)[0]
