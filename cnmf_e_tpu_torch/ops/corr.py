"""Correlation image and peak-to-noise ratio maps (port of
``cnmf_e_tpu/ops/corr.py``; reference ``correlation_image.m:38-77``,
``correlation_image_endoscope.m:50-96``).

The random projection of :func:`local_correlation_projected` comes from
a CPU ``torch.Generator`` seeded with ``seed`` and is then moved to the
movie's device, so the card and the CPU project alike; it is not the
JAX package's ``jax.random`` draw."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.ops.filters import (filter_movie, gaussian_psf,
                                          neighbor_kernel)
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.stats import fast_median
from cnmf_e_tpu_torch.parallel import comm


def correlation_image(Y: torch.Tensor, kernel: Optional[np.ndarray] = None,
                      center: bool = True, mesh=None) -> torch.Tensor:
    """Mean correlation of each pixel with its neighbors. Y: (T, H, W).

    ``mesh``: Y is this rank's block (T/frame, H/patch, W); the means
    over time are summed over 'frame', the neighbour taps read ``kh // 2``
    halo rows of the normalised movie from the patch neighbours (zeros
    past the field of view, as the one-process padding), and the result
    is this rank's rows."""
    if kernel is None:
        kernel = neighbor_kernel(1.0, 2.0)
    if center:
        Y = Y - comm.frame_mean(Y, 0, mesh, keepdim=True)
    denom = torch.sqrt(comm.frame_mean(Y * Y, 0, mesh, keepdim=True))
    X = Y / torch.clamp(denom, min=1e-12)
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    T, H, W = X.shape
    h0, Hf = (0, H) if mesh is None else (mesh.p * H, mesh.n_patch * H)
    if mesh is None or mesh.n_patch == 1:
        Xp = F.pad(X, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    else:
        r = max(ph, kh - 1 - ph)
        Xp = comm.halo_rows(X, r, mesh)[:, r - ph:r + H + kh - 1 - ph]
        Xp = F.pad(Xp, (pw, kw - 1 - pw, 0, 0))
    Xs = torch.zeros_like(X)
    taps = np.argwhere(kernel != 0)
    for dy, dx in taps:
        Xs = Xs + float(kernel[dy, dx]) * Xp[:, dy:dy + H, dx:dx + W]
    # in-FOV neighbor count per pixel (this rank's rows of the FOV's)
    ones = np.zeros((Hf + kh - 1, W + kw - 1), np.float32)
    ones[ph:ph + Hf, pw:pw + W] = 1.0
    count = np.zeros((Hf, W), np.float32)
    for dy, dx in taps:
        count += kernel[dy, dx] * ones[dy:dy + Hf, dx:dx + W]
    count = torch.as_tensor(np.maximum(count[h0:h0 + H], 1.0),
                            device=Y.device)
    return comm.frame_mean(Xs * X, 0, mesh) / count


def correlation_pnr(Y: torch.Tensor, gSig: float = 3.0,
                    center_psf: bool = True, noise_thresh_sig: float = 3.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Cn, PNR) maps of the band-passed, median-centred movie."""
    HY = filter_movie(Y, gaussian_psf(gSig, center_psf))
    HY = HY - fast_median(HY, dim=0, keepdim=True)
    sn = noise_psd_frames(HY)
    pnr = HY.amax(dim=0) / torch.clamp(sn, min=1e-12)
    HY_thr = torch.where(HY >= noise_thresh_sig * sn[None], HY, 0.0)
    cn = torch.nan_to_num(correlation_image(HY_thr, center=False))
    return cn, pnr


def local_correlation_projected(Y: torch.Tensor, k: int = 1000,
                                seed: int = 0) -> torch.Tensor:
    """Correlation image from a random temporal projection (reference
    option ``K`` of ``correlation_image.m:38-44``): the T centred frames
    are projected onto k Gaussian vectors scaled by 1/sqrt(T), and the
    neighbour correlation is taken over the k projections."""
    T = Y.shape[0]
    k = min(k, T)
    gen = torch.Generator().manual_seed(seed)
    R = torch.randn((T, k), generator=gen, dtype=Y.dtype).to(Y.device) \
        / math.sqrt(T)
    Yc = (Y - Y.mean(dim=0, keepdim=True)).reshape(T, -1)
    P = (R.T @ Yc).reshape((k,) + tuple(Y.shape[1:]))
    return correlation_image(P, center=False)
