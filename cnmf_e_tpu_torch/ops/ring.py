"""Ring background model: per-pixel ridge regression on a ring of
neighbors (port of ``cnmf_e_tpu/ops/ring.py``; reference
``fit_ring_model.m:41-127``, ``local_background.m``, ``get_nhood.m``).

Every pixel has the same ring-offset pattern (out-of-FOV neighbors are
zero and their weights pinned to 0), so the d small normal-equation solves
batch into one gather -> Gram -> Cholesky pipeline. The ring apply runs in
the stencil kernel of :mod:`cnmf_e_tpu_torch.ops.ring_kernels`.

``mesh``: the movie and the weights are this rank's blocks (T/frame,
H/patch, W) and (H/patch W, ...), on the ``ssub`` grid where there is
one. Every ring apply takes the ring's reach in halo rows from the patch
neighbours and runs K6 on the padded slab (:func:`apply_ring`); the ring
fit (its strided frames) and the local fit (all frames, with the event
mask) gather them over 'frame' and fit the rank's pixels from its slab
and a halo (:func:`fit_ring_weights_mesh`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops.filters import box_downsample, resize_linear
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.ring_kernels import (apply_ring_stencil,
                                               ring_offsets)
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import span


def _neighbor_index(H: int, W: int, offsets: np.ndarray,
                    fov_rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat gather indices (H*W, R) into the zero-padded (H+2m)*(W+2m)
    frame, and the in-FOV validity mask (H*W, R); ``fov_rows``: the rows
    [lo, hi) of the H that lie in the field of view (default all)."""
    m = int(np.abs(offsets).max())
    lo, hi = (0, H) if fov_rows is None else fov_rows
    yy, xx = np.mgrid[0:H, 0:W]
    ny = yy.reshape(-1, 1) + offsets[None, :, 0]
    nx = xx.reshape(-1, 1) + offsets[None, :, 1]
    valid = (ny >= lo) & (ny < hi) & (nx >= 0) & (nx < W)
    flat = (ny + m) * (W + 2 * m) + (nx + m)
    return flat.astype(np.int64), valid


def _ssub_geometry(H: int, W: int, radius: int, ssub: int):
    if ssub <= 1:
        return H, W, radius
    return -(-H // ssub), -(-W // ssub), max(int(round(radius / ssub)), 1)


def fit_ring_weights(Bf: torch.Tensor, H: int, W: int, radius: int,
                     ridge_eps: float = 1e-5, chunk: int = 1024,
                     mask: Optional[torch.Tensor] = None,
                     intercept: bool = True,
                     neighbor_cutoff: float = 1.0,
                     rows: Optional[Tuple[int, int]] = None,
                     fov_rows: Optional[Tuple[int, int]] = None
                     ) -> RingWeights:
    """Fit every pixel's ring regression. Bf: (T', H, W), centred, clamped
    and frame-subsampled by the caller. Ridge: (G + eps tr(G) I) w = X y
    over the augmented [ring, 1] design (``fit_ring_model.m:104``).

    ``mask``: optional (T', H, W) per-pixel sample weights; frame t enters
    pixel p's normal equations with weight mask[t, p]
    (``local_background.m:113-116`` leaves out a pixel's event frames).
    ``intercept=False`` fits w alone and returns w0 = 0.
    ``neighbor_cutoff < 1``: keep only the neighbours whose slope
    Xy / diag(G) is at most that per-pixel linear quantile
    (``local_background.m:118-125``); the others get a unit diagonal and
    a zero right-hand side, so their weight solves to 0.

    ``rows``: fit only the pixels of Bf's rows [r0, r1) and return their
    weights ((r1 - r0) W of them); ``fov_rows``: Bf's rows that lie in the
    field of view (taps on the others are out of it). A mesh rank fits
    its slab from Bf with a halo of ring rows this way
    (``models/streaming.py``)."""
    T = Bf.shape[0]
    dev = Bf.device
    offsets = ring_offsets(radius)
    R = offsets.shape[0]
    m = int(np.abs(offsets).max())
    r0, r1 = (0, H) if rows is None else rows
    d = (r1 - r0) * W
    with span("ring.neighbor_index"):
        idx, valid = _neighbor_index(H, W, offsets, fov_rows)
        idx_t = torch.as_tensor(idx[r0 * W:r1 * W], device=dev)
        valid_t = torch.as_tensor(valid[r0 * W:r1 * W], device=dev)
        # freed here, not on return: unmapping the host arrays takes
        # milliseconds at a 256x256 grid, and belongs to this step
        del idx, valid
    Bf_flat = F.pad(Bf, (m, m, m, m)).reshape(T, -1)
    # contiguous, as a whole field of view's rows are: a slab's rows
    # inside a halo would be a strided view, which the card reduces in
    # another order
    y_flat = Bf[:, r0:r1].reshape(T, d).contiguous()
    m_flat = (None if mask is None
              else mask[:, r0:r1].to(torch.float32).reshape(T, d))
    TB = min(512, T)
    eye_r = torch.eye(R, dtype=torch.float32, device=dev)
    eye = torch.eye(R + 1 if intercept else R, dtype=torch.float32,
                    device=dev)
    sols = []
    for p0 in range(0, d, chunk):
        with span("ring.normal_equations"):
            ic = idx_t[p0:p0 + chunk]
            vc = valid_t[p0:p0 + chunk].to(torch.float32)
            P = ic.shape[0]
            G = torch.zeros((P, R, R), dtype=torch.float32, device=dev)
            sx = torch.zeros((P, R), dtype=torch.float32, device=dev)
            Xy = torch.zeros((P, R), dtype=torch.float32, device=dev)
            sy = torch.zeros((P,), dtype=torch.float32, device=dev)
            cnt = (torch.full((P,), float(T), device=dev) if m_flat is None
                   else torch.zeros((P,), device=dev))
            for t0 in range(0, T, TB):
                X = Bf_flat[t0:t0 + TB][:, ic] * vc[None]       # (tb, P, R)
                yb = y_flat[t0:t0 + TB, p0:p0 + P]              # (tb, P)
                if m_flat is not None:
                    mb = m_flat[t0:t0 + TB, p0:p0 + P]
                    X = X * mb[:, :, None]
                    yb = yb * mb
                    cnt = cnt + mb.sum(dim=0)
                Xp = X.permute(1, 2, 0)                         # (P, R, tb)
                G = G + Xp @ Xp.transpose(1, 2)
                sx = sx + X.sum(dim=0)
                Xy = Xy + (Xp @ yb.T[:, :, None])[..., 0]
                sy = sy + yb.sum(dim=0)
        with span("ring.solve"):
            if neighbor_cutoff < 1.0:
                ratio = Xy / torch.clamp(torch.diagonal(G, dim1=1, dim2=2),
                                         min=1e-12)
                thr = torch.quantile(ratio, neighbor_cutoff, dim=-1,
                                     keepdim=True)
                keep = (ratio <= thr).to(torch.float32)
                G = G * keep[:, :, None] * keep[:, None, :] \
                    + eye_r[None] * (1.0 - keep)[:, :, None]
                Xy = Xy * keep
                sx = sx * keep
            if intercept:
                cnt = torch.clamp(cnt, min=1.0)[:, None, None]
                Gfull = torch.cat([torch.cat([G, sx[:, :, None]], dim=2),
                                   torch.cat([sx[:, None, :], cnt], dim=2)],
                                  dim=1)
                rhs = torch.cat([Xy, sy[:, None]], dim=1)
            else:
                Gfull, rhs = G, Xy
            tr = torch.diagonal(Gfull, dim1=1, dim2=2).sum(dim=1)
            # a pixel without an in-FOV neighbour has a zero system, which
            # does not factor; its weights are all masked to 0 below, as in
            # the JAX package (cho_factor leaves NaN there), so no check
            Lc, _ = torch.linalg.cholesky_ex(
                Gfull + (ridge_eps * tr)[:, None, None] * eye)
            sol = torch.cholesky_solve(rhs[..., None], Lc)[..., 0]
            if not intercept:
                sol = torch.cat([sol, torch.zeros((P, 1), device=dev)], dim=1)
        sols.append(sol)
    sol = torch.cat(sols, dim=0)
    return RingWeights(w=torch.where(valid_t, sol[:, :R], 0.0),
                       w0=sol[:, R].contiguous())


def stride_grid(T: int, stride: int, mesh) -> Tuple[int, list]:
    """This rank's first local frame on the global stride grid (frames 0,
    stride, 2 stride, ...) and the grid frames each 'frame' rank holds
    (None without a mesh)."""
    if mesh is None:
        return 0, None
    Tl = T // mesh.n_frame

    def n_in(a, b):
        return len(range(-(-a // stride) * stride, b, stride))
    return ((-(mesh.f * Tl)) % stride,
            [n_in(g * Tl, (g + 1) * Tl) for g in range(mesh.n_frame)])


def fit_ring_weights_mesh(Bf: torch.Tensor, H: int, W: int, radius: int,
                          mesh, grid_sizes: Optional[list] = None,
                          ridge_eps: float = 1e-5,
                          mask: Optional[torch.Tensor] = None,
                          **kw) -> RingWeights:
    """The ring weights of this rank's pixels from its rows and frames of
    the (centred, clamped, strided) residual ``Bf`` (T'/frame, H/patch,
    W) of an H-row field of view: the slab takes the ring's reach in halo
    rows from its patch neighbours, the frames of the other 'frame' ranks
    (``grid_sizes`` of them each, default equal), and fits its own rows
    (:func:`fit_ring_weights` with ``rows`` and ``fov_rows``). ``mask``:
    this rank's block of the per-pixel sample weights, gathered over
    'frame' as bytes (only the slab's own rows enter its normal
    equations); ``kw``: :func:`fit_ring_weights`' ``intercept`` and
    ``neighbor_cutoff``. Without a mesh, the whole field of view's fit.

    Gathering the frames sums every pixel's normal equations over all T
    in the one process's order; all-reducing each pixel's partial Grams
    over 'frame' instead would move (R + 1) R floats a pixel, more than
    its frames at the fits' sizes (PERF.md)."""
    if mesh is None:
        return fit_ring_weights(Bf, H, W, radius, ridge_eps=ridge_eps,
                                mask=mask, **kw)
    Hl = Bf.shape[1]
    h0 = mesh.p * Hl
    reach = int(np.abs(ring_offsets(radius)[:, 0]).max())
    Bp = comm.all_gather_cat(comm.halo_rows(Bf, reach, mesh), 0,
                             mesh.frame_group, grid_sizes)
    if mask is not None:
        mask = F.pad(comm.all_gather_cat(mask.to(torch.uint8), 0,
                                         mesh.frame_group, grid_sizes),
                     (0, 0, reach, reach))
    return fit_ring_weights(
        Bp, Hl + 2 * reach, W, radius, ridge_eps=ridge_eps, mask=mask,
        rows=(reach, reach + Hl),
        fov_rows=(max(reach - h0, 0), min(reach + H - h0, Hl + 2 * reach)),
        **kw)


def apply_ring(weights: RingWeights, X: torch.Tensor, H: int, W: int,
               radius: int, include_intercept: bool = True,
               mesh=None) -> torch.Tensor:
    """The ring prediction W X (+ w0) of a (T, H, W) movie. Every ring
    apply of the port goes through the stencil kernel K6 (CUDA tensors)
    or its plain version (CPU tensors); without the intercept, w0 is
    zeros, as ``ring_apply_auto`` passes it (``pallas_ring.py:167-170``).

    ``mesh``: X, w and w0 are this rank's blocks (T/frame, H/patch, W)
    and (H/patch W, ...) of an H-row field of view. The slab takes the
    ring's reach in rows from its patch neighbours (``comm.halo_rows``),
    K6 runs on the padded slab with zero weights on the halo rows, and
    the halo rows of the result are dropped."""
    w0 = weights.w0 if include_intercept else torch.zeros_like(weights.w0)
    if mesh is None:
        return apply_ring_stencil(weights.w, w0, X, H, W, radius)
    Hp = X.shape[1]
    reach = int(np.abs(ring_offsets(radius)[:, 0]).max())
    Xp = comm.halo_rows(X, reach, mesh)
    pad = reach * W
    out = apply_ring_stencil(F.pad(weights.w, (0, 0, pad, pad)),
                             F.pad(w0, (pad, pad)), Xp, Hp + 2 * reach, W,
                             radius)
    return out[:, reach:reach + Hp].contiguous()


def fit_ring_model(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                   radius: int, W_old: Optional[RingWeights] = None,
                   sn: Optional[torch.Tensor] = None,
                   thresh_outlier: float = 10.0,
                   frame_cap_factor: int = 100, ridge_eps: float = 1e-5,
                   ssub: int = 1, mesh=None
                   ) -> Tuple[RingWeights, torch.Tensor, torch.Tensor]:
    """Full ring-background fit. Y: (T, H, W); A: (K, H, W); C: (K, T).
    Returns (weights, b0 (H, W), Bf used for the fit).

      b0 = mean(Y) - A mean(C)                       (fit_ring_model.m:41-44)
      Bf = (Y - mean(Y)) - A (C - mean(C)), box-downsampled by ssub
      outlier clamp at W_old(Bf) + thresh_outlier sn (fit_ring_model.m:50-56)
      frame stride-subsample to frame_cap_factor * R (fit_ring_model.m:58-91)

    ``mesh``: Y, A, C and sn are this rank's blocks and the weights, b0
    and Bf returned are too (the module docstring); a slab's rows are a
    multiple of ``ssub``."""
    T, H, W = Y.shape
    K = A.shape[0]
    Hf, Tf = H, T                       # the field of view's rows, frames
    if mesh is not None:
        Hf, Tf = H * mesh.n_patch, T * mesh.n_frame
    with span("ring.residual"):
        Ymean = comm.frame_mean(Y, 0, mesh)
        Cmean = comm.frame_mean(C, -1, mesh)
        b0 = Ymean - (Cmean @ A.reshape(K, -1)).reshape(H, W)
        Cc = C - Cmean[:, None]
        Bf = (Y - Ymean[None]) - (Cc.T @ A.reshape(K, -1)).reshape(T, H, W)
    Hs, Ws, radius_s = _ssub_geometry(Hf, W, radius, ssub)
    if ssub > 1:
        with span("ring.downsample"):
            Bf = box_downsample(Bf, ssub=ssub)
    if W_old is not None and sn is not None and np.isfinite(thresh_outlier):
        with span("ring.outlier_clamp"):
            sn_s = box_downsample(sn[None], ssub=ssub)[0] if ssub > 1 \
                else sn
            pred = apply_ring(W_old, Bf, Hs, Ws, radius_s,
                              include_intercept=False, mesh=mesh)
            Bf = torch.where(Bf > pred + thresh_outlier * sn_s[None], pred,
                             Bf)
    R = ring_offsets(radius_s).shape[0]
    nmax = frame_cap_factor * R
    stride = int(np.ceil(Tf / nmax)) if Tf > nmax else 1
    first, sizes = stride_grid(Tf, stride, mesh)
    Bf_fit = Bf[first::stride] if stride > 1 else Bf
    weights = fit_ring_weights_mesh(Bf_fit, Hs, Ws, radius_s, mesh, sizes,
                                    ridge_eps=ridge_eps)
    return weights, b0, Bf_fit


def local_background(Y: torch.Tensor, radius: int,
                     sn: Optional[torch.Tensor] = None,
                     thresh: float = 3.0, ssub: int = 1,
                     neighbor_cutoff: float = 1.0, ridge_eps: float = 1e-5,
                     mesh=None
                     ) -> Tuple[torch.Tensor, RingWeights, torch.Tensor]:
    """Event-masked ring background (``local_background.m:66-138``): it
    needs no neuron model. The movie is centred to per-pixel mean 1;
    samples above the uniform ring average by more than ``thresh * sn``
    are calcium events, replaced by that average and left out of the
    pixel's normal equations; the ring regression (no intercept) is fit
    on the cleaned movie and predicts the background of every frame; the
    movie mean restores the DC offset (``local_background.m:148-150``).
    With ``ssub > 1`` all of it runs on the box-downsampled grid and the
    prediction is upsampled bilinearly.

    Y: (T, H, W). Returns (Yest (T, H, W), weights, b0 (H, W)).

    ``mesh``: Y and ``sn`` are this rank's blocks (T/frame, H/patch, W)
    and so is what it returns; the slab's rows are a multiple of
    ``ssub``. The mean is summed over 'frame', the annulus and the
    prediction run K6 on the halo-padded slab (:func:`apply_ring`), the
    event mask and the cleaned movie stay on the rank, and the weights
    are fitted over all T frames, gathered over 'frame' with the ring's
    reach in halo rows (:func:`fit_ring_weights_mesh`)."""
    T, H, W = Y.shape
    Hf = H if mesh is None else H * mesh.n_patch
    Ymean = comm.frame_mean(Y, 0, mesh)
    Yc = Y - Ymean[None] + 1.0
    Hs, Ws, radius_s = _ssub_geometry(Hf, W, radius, ssub)
    if ssub > 1:
        Yc = box_downsample(Yc, ssub=ssub)
        if sn is not None:
            sn = box_downsample(sn[None], ssub=ssub)[0]
    if sn is None:
        sn = noise_psd_frames(Yc, mesh=mesh)
    # the annulus average (local_background.m:66-70) as a ring apply with
    # uniform weights over each pixel's in-FOV neighbours
    _, valid = _neighbor_index(Hs, Ws, ring_offsets(radius_s))
    n_valid = np.maximum(valid.sum(axis=1, keepdims=True), 1)
    w_unif = valid / n_valid
    if mesh is not None:
        d = Yc.shape[1] * Ws
        w_unif = w_unif[mesh.p * d:(mesh.p + 1) * d]
    w_unif = torch.as_tensor(w_unif, dtype=torch.float32, device=Y.device)
    Yconv = apply_ring(RingWeights(w=w_unif, w0=torch.zeros_like(
        w_unif[:, 0])), Yc, Hs, Ws, radius_s, include_intercept=False,
        mesh=mesh)
    event = (Yc - Yconv) > thresh * sn[None]
    Yfit = torch.where(event, Yconv, Yc)
    del Yc, Yconv
    weights = fit_ring_weights_mesh(Yfit, Hs, Ws, radius_s, mesh,
                                    ridge_eps=ridge_eps, mask=~event,
                                    intercept=False,
                                    neighbor_cutoff=neighbor_cutoff)
    del event
    Yest = apply_ring(weights, Yfit, Hs, Ws, radius_s,
                      include_intercept=False, mesh=mesh)
    if ssub > 1:
        Yest = resize_linear(Yest, (H, W), mesh=mesh)
    b0 = Ymean - comm.frame_mean(Yest, 0, mesh)
    return Yest + b0[None], weights, b0


def reconstruct_ring_background(weights: RingWeights, Y: torch.Tensor,
                                A: torch.Tensor, C: torch.Tensor,
                                b0: torch.Tensor, radius: int,
                                ssub: int = 1, mesh=None) -> torch.Tensor:
    """B = W (Y - b0 - A C) + w0 + b0 (``Sources2D.m:1247-1355``); with
    ssub > 1 the ring predicts on the coarse grid and upsamples
    bilinearly. ``mesh``: every argument is this rank's block, and so is
    B."""
    T, H, W = Y.shape
    K = A.shape[0]
    X = Y - b0[None] - (C.T @ A.reshape(K, -1)).reshape(T, H, W)
    if ssub <= 1:
        return apply_ring(weights, X, H, W, radius, mesh=mesh) + b0[None]
    Hf = H if mesh is None else H * mesh.n_patch
    Hs, Ws, radius_s = _ssub_geometry(Hf, W, radius, ssub)
    Bs = apply_ring(weights, box_downsample(X, ssub=ssub), Hs, Ws, radius_s,
                    mesh=mesh)
    return resize_linear(Bs, (H, W), mesh=mesh) + b0[None]
