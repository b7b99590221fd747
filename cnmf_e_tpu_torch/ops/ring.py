"""Ring background model: per-pixel ridge regression on a ring of
neighbors (port of the parts of ``cnmf_e_tpu/ops/ring.py`` that
``CNMFE.fit`` reaches; reference ``fit_ring_model.m:41-127``,
``get_nhood.m``).

Every pixel has the same ring-offset pattern (out-of-FOV neighbors are
zero and their weights pinned to 0), so the d small normal-equation solves
batch into one gather -> Gram -> Cholesky pipeline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops.filters import box_downsample, resize_linear


def ring_offsets(radius: int) -> np.ndarray:
    """(R, 2) int32 pixel offsets (dy, dx) at distance in
    [radius, radius + 1)."""
    r = int(np.ceil(radius)) + 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    R = np.sqrt(x ** 2 + y ** 2)
    sel = (R >= radius) & (R < radius + 1)
    return np.stack([y[sel], x[sel]], axis=1).astype(np.int32)


def _neighbor_index(H: int, W: int, offsets: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat gather indices (H*W, R) into the zero-padded (H+2m)*(W+2m)
    frame, and the in-FOV validity mask (H*W, R)."""
    m = int(np.abs(offsets).max())
    yy, xx = np.mgrid[0:H, 0:W]
    ny = yy.reshape(-1, 1) + offsets[None, :, 0]
    nx = xx.reshape(-1, 1) + offsets[None, :, 1]
    valid = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
    flat = (ny + m) * (W + 2 * m) + (nx + m)
    return flat.astype(np.int64), valid


def _ssub_geometry(H: int, W: int, radius: int, ssub: int):
    if ssub <= 1:
        return H, W, radius
    return -(-H // ssub), -(-W // ssub), max(int(round(radius / ssub)), 1)


def fit_ring_weights(Bf: torch.Tensor, H: int, W: int, radius: int,
                     ridge_eps: float = 1e-5,
                     chunk: int = 1024) -> RingWeights:
    """Fit every pixel's ring regression with intercept. Bf: (T', H, W),
    centred, clamped and frame-subsampled by the caller. Ridge:
    (G + eps tr(G) I) w = X y over the augmented [ring, 1] design
    (``fit_ring_model.m:104``)."""
    T = Bf.shape[0]
    dev = Bf.device
    offsets = ring_offsets(radius)
    R = offsets.shape[0]
    m = int(np.abs(offsets).max())
    idx, valid = _neighbor_index(H, W, offsets)
    d = H * W
    Bf_flat = F.pad(Bf, (m, m, m, m)).reshape(T, -1)
    y_flat = Bf.reshape(T, d)
    idx_t = torch.as_tensor(idx, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    TB = min(512, T)
    eye = torch.eye(R + 1, dtype=torch.float32, device=dev)
    sols = []
    for p0 in range(0, d, chunk):
        ic = idx_t[p0:p0 + chunk]
        vc = valid_t[p0:p0 + chunk].to(torch.float32)
        P = ic.shape[0]
        G = torch.zeros((P, R, R), dtype=torch.float32, device=dev)
        sx = torch.zeros((P, R), dtype=torch.float32, device=dev)
        Xy = torch.zeros((P, R), dtype=torch.float32, device=dev)
        sy = torch.zeros((P,), dtype=torch.float32, device=dev)
        for t0 in range(0, T, TB):
            X = Bf_flat[t0:t0 + TB][:, ic] * vc[None]       # (tb, P, R)
            yb = y_flat[t0:t0 + TB, p0:p0 + P]              # (tb, P)
            Xp = X.permute(1, 2, 0)                         # (P, R, tb)
            G = G + Xp @ Xp.transpose(1, 2)
            sx = sx + X.sum(dim=0)
            Xy = Xy + (Xp @ yb.T[:, :, None])[..., 0]
            sy = sy + yb.sum(dim=0)
        cnt = torch.full((P, 1, 1), float(max(T, 1)), device=dev)
        Gfull = torch.cat([torch.cat([G, sx[:, :, None]], dim=2),
                           torch.cat([sx[:, None, :], cnt], dim=2)], dim=1)
        rhs = torch.cat([Xy, sy[:, None]], dim=1)
        tr = torch.diagonal(Gfull, dim1=1, dim2=2).sum(dim=1)
        Lc = torch.linalg.cholesky(Gfull + (ridge_eps * tr)[:, None, None]
                                   * eye)
        sols.append(torch.cholesky_solve(rhs[..., None], Lc)[..., 0])
    sol = torch.cat(sols, dim=0)
    return RingWeights(w=torch.where(valid_t, sol[:, :R], 0.0),
                       w0=sol[:, R].contiguous())


def apply_ring(weights: RingWeights, X: torch.Tensor, H: int, W: int,
               radius: int, include_intercept: bool = True) -> torch.Tensor:
    """The ring prediction W X (+ w0) of a (T, H, W) movie, as a sum of R
    weighted shifts of the zero-padded movie."""
    offsets = ring_offsets(radius)
    m = int(np.abs(offsets).max())
    Xp = F.pad(X, (m, m, m, m))
    w_img = weights.w.reshape(H, W, -1)
    out = torch.zeros_like(X)
    for r, (dy, dx) in enumerate(offsets):
        shifted = Xp[:, m + dy:m + dy + H, m + dx:m + dx + W]
        out = out + w_img[None, :, :, r] * shifted
    if include_intercept:
        out = out + weights.w0.reshape(1, H, W)
    return out


def fit_ring_model(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                   radius: int, W_old: Optional[RingWeights] = None,
                   sn: Optional[torch.Tensor] = None,
                   thresh_outlier: float = 10.0,
                   frame_cap_factor: int = 100, ridge_eps: float = 1e-5,
                   ssub: int = 1
                   ) -> Tuple[RingWeights, torch.Tensor, torch.Tensor]:
    """Full ring-background fit. Y: (T, H, W); A: (K, H, W); C: (K, T).
    Returns (weights, b0 (H, W), Bf used for the fit).

      b0 = mean(Y) - A mean(C)                       (fit_ring_model.m:41-44)
      Bf = (Y - mean(Y)) - A (C - mean(C)), box-downsampled by ssub
      outlier clamp at W_old(Bf) + thresh_outlier sn (fit_ring_model.m:50-56)
      frame stride-subsample to frame_cap_factor * R (fit_ring_model.m:58-91)
    """
    T, H, W = Y.shape
    K = A.shape[0]
    Ymean = Y.mean(dim=0)
    Cmean = C.mean(dim=-1)
    b0 = Ymean - (Cmean @ A.reshape(K, -1)).reshape(H, W)
    Cc = C - Cmean[:, None]
    Bf = (Y - Ymean[None]) - (Cc.T @ A.reshape(K, -1)).reshape(T, H, W)
    Hs, Ws, radius_s = _ssub_geometry(H, W, radius, ssub)
    if ssub > 1:
        Bf = box_downsample(Bf, ssub=ssub)
    if W_old is not None and sn is not None and np.isfinite(thresh_outlier):
        sn_s = box_downsample(sn[None], ssub=ssub)[0] if ssub > 1 else sn
        pred = apply_ring(W_old, Bf, Hs, Ws, radius_s,
                          include_intercept=False)
        Bf = torch.where(Bf > pred + thresh_outlier * sn_s[None], pred, Bf)
    R = ring_offsets(radius_s).shape[0]
    nmax = frame_cap_factor * R
    Bf_fit = Bf[::int(np.ceil(T / nmax))] if T > nmax else Bf
    weights = fit_ring_weights(Bf_fit, Hs, Ws, radius_s, ridge_eps=ridge_eps)
    return weights, b0, Bf_fit


def reconstruct_ring_background(weights: RingWeights, Y: torch.Tensor,
                                A: torch.Tensor, C: torch.Tensor,
                                b0: torch.Tensor, radius: int,
                                ssub: int = 1) -> torch.Tensor:
    """B = W (Y - b0 - A C) + w0 + b0 (``Sources2D.m:1247-1355``); with
    ssub > 1 the ring predicts on the coarse grid and upsamples
    bilinearly."""
    T, H, W = Y.shape
    K = A.shape[0]
    X = Y - b0[None] - (C.T @ A.reshape(K, -1)).reshape(T, H, W)
    if ssub <= 1:
        return apply_ring(weights, X, H, W, radius) + b0[None]
    Hs, Ws, radius_s = _ssub_geometry(H, W, radius, ssub)
    Bs = apply_ring(weights, box_downsample(X, ssub=ssub), Hs, Ws, radius_s)
    return resize_linear(Bs, (H, W)) + b0[None]
