"""Spatial filtering and resampling (port of ``cnmf_e_tpu/ops/filters.py``
without the TPU's banded-matmul filter).

Movies are (T, H, W). ``filter_movie`` is the JAX package's conv form: an
edge-padded correlation with the flipped PSF, i.e. a true convolution with
the PSF (``greedyROI_endoscope.m:104-127``).

``mesh``: the movie is this rank's slab of rows (T/frame, H/patch, W).
The filter and the resize read rows past the slab's edges; the slab takes
them from its patch neighbours, with the field of view's edge rows
copied past its border (``comm.halo_rows(edge="replicate")``), as the
one-process padding and the resize's clamp read them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.parallel import comm


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.n_patch > 1


def gaussian_psf(gSig: float, center_psf: bool = True,
                 size: int | None = None) -> np.ndarray:
    """The (possibly center-surround) gaussian PSF as a numpy array: with
    ``center_psf`` the PSF is restricted to its central disc and
    mean-subtracted over it (an annulus-subtracted matched filter)."""
    if gSig <= 0:
        return np.ones((1, 1), np.float32)
    if size is None:
        size = int(np.ceil(gSig * 4 + 1))
    half = (size - 1) / 2.0
    y, x = np.mgrid[-half:half + 1, -half:half + 1][:, :size, :size]
    psf = np.exp(-(x ** 2 + y ** 2) / (2.0 * gSig ** 2))
    psf /= psf.sum()
    if center_psf:
        ind = psf >= psf[:, 0].max()
        psf = psf - psf[ind].mean()
        psf[~ind] = 0.0
    return psf.astype(np.float32)


def filter_movie(Y: torch.Tensor, psf: np.ndarray,
                 mesh=None) -> torch.Tensor:
    """2-D filter each frame of ``Y`` (T, H, W) with replicate padding."""
    if psf.shape == (1, 1):
        return Y * float(psf[0, 0])
    kh, kw = psf.shape
    ph, pw = kh // 2, kw // 2
    if _sharded(mesh):
        r = max(ph, kh - 1 - ph)
        Yh = comm.halo_rows(Y, r, mesh, edge="replicate")
        Yh = Yh[:, r - ph:r + Y.shape[1] + kh - 1 - ph]
        Yp = F.pad(Yh[:, None], (pw, kw - 1 - pw, 0, 0), mode="replicate")
    else:
        Yp = F.pad(Y[:, None], (pw, kw - 1 - pw, ph, kh - 1 - ph),
                   mode="replicate")
    weight = torch.as_tensor(psf[::-1, ::-1].copy(),
                             device=Y.device)[None, None]
    return F.conv2d(Yp, weight)[:, 0]


def neighbor_kernel(dmin: float = 1.0, dmax: float = 2.0) -> np.ndarray:
    """Ring-of-neighbors indicator (``correlation_image.m:57-70``):
    pixels at distance in [dmin, dmax)."""
    r = int(np.ceil(dmax)) - 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    R = np.sqrt(x ** 2 + y ** 2)
    return ((R >= dmin) & (R < dmax)).astype(np.float32)


def box_downsample(Y: torch.Tensor, ssub: int = 1,
                   tsub: int = 1) -> torch.Tensor:
    """Spatio-temporal box down-sampling of a (T, H, W) movie
    (``dsData.m:33-43``): a ragged spatial edge is edge-padded into the
    last bin; trailing frames short of a full ``tsub`` bin are dropped.
    A mesh rank's block pools alone when its rows are a multiple of
    ``ssub`` and its frames of ``tsub`` (``CNMFE(mesh=...)`` requires
    both, else a ValueError names them): no bin crosses blocks."""
    T, H, W = Y.shape
    if ssub > 1:
        Hs, Ws = -(-H // ssub), -(-W // ssub)
        Yp = F.pad(Y[:, None], (0, Ws * ssub - W, 0, Hs * ssub - H),
                   mode="replicate")[:, 0]
        Y = Yp.reshape(T, Hs, ssub, Ws, ssub).mean(dim=(2, 4))
    if tsub > 1:
        Ts = T // tsub
        Y = Y[:Ts * tsub].reshape((Ts, tsub) + tuple(Y.shape[1:])).mean(dim=1)
    return Y


def resize_linear(X: torch.Tensor, out_hw, mesh=None) -> torch.Tensor:
    """Bilinear resize of the last two axes with half-pixel centres — the
    ``jax.image.resize(..., method="linear")`` upsample (edge samples take
    the border value).

    ``mesh``: X is this rank's slab of coarse rows and ``out_hw`` the
    slab's output size, an integer multiple of X's rows: the slab takes
    one coarse row from each neighbour (the edge row itself past the
    field of view, which is the resize's clamp), is resized at the same
    scale, and the output rows of the halo are dropped."""
    lead = X.shape[:-2]
    if _sharded(mesh):
        hs = X.shape[-2]
        up = out_hw[0] // hs
        Xh = comm.halo_rows(X, 1, mesh, edge="replicate")
        out = resize_linear(Xh, ((hs + 2) * up, out_hw[1]))
        return out[..., up:up + out_hw[0], :].contiguous()
    Xf = X.reshape((-1, 1) + tuple(X.shape[-2:]))
    out = F.interpolate(Xf, size=tuple(out_hw), mode="bilinear",
                        align_corners=False)
    return out.reshape(lead + tuple(out_hw))


def resize_linear_last(X: torch.Tensor, n: int) -> torch.Tensor:
    """Linear resize of the last axis to ``n`` samples, half-pixel centres
    (``jax.image.resize`` of a (K, T) array to (K, n), ``"linear"``)."""
    lead = X.shape[:-1]
    out = F.interpolate(X.reshape(-1, 1, X.shape[-1]), size=n,
                        mode="linear", align_corners=False)
    return out.reshape(lead + (n,))


def spatial_upsample(A: torch.Tensor, ssub: int, out_hw) -> torch.Tensor:
    """Bilinear upsample of footprints (K, Hs, Ws) -> (K, H, W)."""
    if ssub == 1:
        return A
    return resize_linear(A, out_hw)
