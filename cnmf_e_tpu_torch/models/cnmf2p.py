"""Vanilla (2-photon) CNMF pipeline (port of
``cnmf_e_tpu/models/cnmf2p.py``; BASELINE config 1, ``demo_script.m``).

Reference flow: ``preprocess_data.m`` (NaN interpolation, saturation
mask, pixel noise), ``greedyROI.m`` (gaussian-blob greedy init with a
windowed rank-1 refinement), ``update_spatial_components.m`` (per-pixel
noise-constrained lasso, the role of ``lars_regression_noise.m``),
``update_temporal_components.m`` (HALS then constrained foopsi) and
``merge_components.m``. As in the JAX package:

  * greedyROI peels seeds in rounds of non-conflicting energy maxima;
  * the per-pixel LARS path is a batched nonnegative lasso solved by
    FISTA, with a per-pixel lambda bisection to the noise budget
    ||y - C^T a||^2 <= sn^2 T, on each pixel's search locations (the
    JAX package regresses every pixel on every trace; see ``CNMF``);
  * the temporal update is HALS sweeps (the HALS kernel) then the
    configured deconvolution (constrained AR(1) by default, every solve
    through the OASIS solve entry).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.config import CNMFEParams, DeconvParams, MergeParams
from cnmf_e_tpu_torch.models.merge import merge_neurons
from cnmf_e_tpu_torch.models.state import CNMFEState, compact, empty_state
from cnmf_e_tpu_torch.ops.filters import filter_movie, gaussian_psf
from cnmf_e_tpu_torch.ops.hals import hals_temporal
from cnmf_e_tpu_torch.ops.lowrank import nmf_hals
from cnmf_e_tpu_torch.ops.morphology import search_locations_dilate
from cnmf_e_tpu_torch.ops.nnls import fista_momenta, nnls_pixels
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from cnmf_e_tpu_torch.ops.stats import median_mid
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import timed

SEARCH_RADIUS = 2       # dilation of a footprint into its search locations


# --------------------------------------------------------------------- #
# preprocessing (preprocess_data.m:37-60)
# --------------------------------------------------------------------- #

def _last_valid(good: torch.Tensor) -> torch.Tensor:
    """Index of the last finite sample at or before each t (T, ...), -1
    where there is none."""
    t = torch.arange(good.shape[0], dtype=torch.int32, device=good.device)
    t = t.reshape((-1,) + (1,) * (good.ndim - 1))
    return torch.cummax(torch.where(good, t, -1), dim=0).values


def interp_missing_data(Y: torch.Tensor) -> torch.Tensor:
    """Fill NaNs along time (axis 0) with the mean of the nearest finite
    samples before and after, or the one that exists (the role of
    ``interp_missing_data.m``'s per-pixel interpolation)."""
    good = torch.isfinite(Y)
    if bool(good.all()):
        return Y
    T = Y.shape[0]
    fi = _last_valid(good)
    bi = (T - 1) - _last_valid(good.flip(0)).flip(0)
    fhas, bhas = fi >= 0, bi < T
    ffill = Y.gather(0, fi.clamp(min=0).long())
    bfill = Y.gather(0, bi.clamp(max=T - 1).long())
    fill = torch.where(fhas & bhas, 0.5 * (ffill + bfill),
                       torch.where(fhas, ffill, torch.where(bhas, bfill, 0.0)))
    return torch.where(good, Y, fill)


def find_unsaturated_pixels(Y: torch.Tensor, frac: float = 0.005
                            ) -> torch.Tensor:
    """Mask of pixels NOT pinned at the sensor ceiling
    (``find_unsaturatedPixels.m``): saturated when more than ``frac`` of a
    pixel's samples equal the movie's maximum."""
    pinned = (Y >= Y.max()).to(torch.float32).mean(dim=0)
    return pinned <= frac


def preprocess_data(Y: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """NaN interpolation, saturation mask and per-pixel noise (the P
    struct)."""
    Y = interp_missing_data(Y)
    return Y, {"sn_pix": noise_psd_frames(Y),
               "unsaturated": find_unsaturated_pixels(Y)}


# --------------------------------------------------------------------- #
# classic greedy initialization (greedyROI.m)
# --------------------------------------------------------------------- #

def _refine_boxes(Y: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  gSiz: int, gSig: float, n_iter: int = 5
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed rank-1 (a, c) refinement around each seed (greedyROI.m's
    shape iterations): the box minus its per-pixel temporal median, then
    ``n_iter`` alternating nonnegative least-squares updates, the
    footprint confined to the gaussian's exp(-2) disc. Returns (a (N, B,
    B), c (N, T))."""
    B = 2 * gSiz + 1
    T = Y.shape[0]
    off = torch.arange(B, device=Y.device)
    Yp = F.pad(Y, (gSiz, gSiz, gSiz, gSiz))
    box = Yp[:, (rows[:, None] + off)[:, :, None],
             (cols[:, None] + off)[:, None, :]]           # (T, N, B, B)
    box = box.permute(1, 0, 2, 3).reshape(rows.shape[0], T, B * B)
    box = box - median_mid(box, dim=1)[:, None, :]
    yy, xx = np.mgrid[0:B, 0:B] - gSiz
    gauss = torch.as_tensor(np.exp(-(yy ** 2 + xx ** 2) / (2.0 * gSig ** 2)),
                            dtype=Y.dtype, device=Y.device).reshape(-1)
    support = (gauss > np.exp(-2.0)).to(Y.dtype)
    a = gauss.expand(rows.shape[0], -1)
    c = torch.zeros((rows.shape[0], T), dtype=Y.dtype, device=Y.device)
    for _ in range(n_iter):
        c = (box @ a[:, :, None])[..., 0] / torch.clamp(
            (a * a).sum(dim=-1, keepdim=True), min=1e-12)
        c = torch.clamp(c, min=0.0)
        a = torch.clamp((c[:, None, :] @ box)[:, 0], min=0.0) / torch.clamp(
            (c * c).sum(dim=-1, keepdim=True), min=1e-12)
        a = a * support
    return a.reshape(-1, B, B), c


def greedy_roi(Y: torch.Tensor, K: int, gSig: float = 5.0,
               gSiz: Optional[int] = None, n_iter: int = 5,
               seeds_per_round: int = 16
               ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Classic greedy init: take the brightest gaussian-filtered energy
    maxima, refine a rank-1 component in a window around each, subtract,
    repeat. Returns (A (K', H, W), C (K', T), centres (K', 2)), K' <= K.

    The seeds of a round are its top-n local maxima of positive energy
    (ties to the lower flat index, as ``lax.top_k``); the boxes are
    scattered into the field of view on the device, and the only
    synchronisation per round is the count of positive maxima, the stop
    test."""
    T, H, W = Y.shape
    gSiz = gSiz or int(np.ceil(2 * gSig + 1))
    psf = gaussian_psf(gSig, center_psf=False)
    Yw = Y - median_mid(Y, dim=0)[None]
    wnd = max(3, gSiz // 2) | 1
    B = 2 * gSiz + 1
    off = torch.arange(B, device=Y.device)
    A_list, C_list, ctr_list = [], [], []
    found = 0
    while found < K:
        n = min(seeds_per_round, K - found)
        energy = (torch.clamp(filter_movie(Yw, psf), min=0.0) ** 2).sum(0)
        vmax = F.max_pool2d(energy[None, None], wnd, stride=1,
                            padding=wnd // 2)[0, 0]
        score = torch.where(energy >= vmax, energy, -torch.inf).reshape(-1)
        top = torch.sort(score, descending=True, stable=True)
        vals, idx = top.values[:n], top.indices[:n]
        # values are sorted, so the positive ones are a prefix
        n_acc = int((vals > 0).sum())
        if n_acc == 0:
            break
        rows, cols = idx[:n_acc] // W, idx[:n_acc] % W
        a_box, c = _refine_boxes(Yw, rows, cols, gSiz, gSig, n_iter)
        # each box into a padded field of view, then the FOV cut out
        canvas = torch.zeros((n_acc, H + 2 * gSiz, W + 2 * gSiz),
                             dtype=Y.dtype, device=Y.device)
        canvas[torch.arange(n_acc, device=Y.device)[:, None, None],
               (rows[:, None] + off)[:, :, None],
               (cols[:, None] + off)[:, None, :]] = a_box
        A_full = canvas[:, gSiz:gSiz + H, gSiz:gSiz + W]
        Yw = Yw - (c.T @ A_full.reshape(n_acc, -1)).reshape(T, H, W)
        A_list.append(A_full)
        C_list.append(c)
        ctr_list.append(torch.stack([rows, cols], dim=1))
        found += n_acc
    if not A_list:
        return (torch.zeros((0, H, W), device=Y.device),
                torch.zeros((0, T), device=Y.device), np.zeros((0, 2)))
    return (torch.cat(A_list), torch.cat(C_list),
            torch.cat(ctr_list).cpu().numpy())


# --------------------------------------------------------------------- #
# noise-constrained spatial lasso (update_spatial_components.m + LARS)
# --------------------------------------------------------------------- #

def lasso_noise_constrained(C: torch.Tensor, Y: torch.Tensor,
                            sn: torch.Tensor, mask: Optional[torch.Tensor],
                            n_bisect: int = 12, n_fista: int = 60,
                            mesh=None) -> torch.Tensor:
    """Per-pixel nonnegative lasso: min ||a||_1 s.t. ||y - C^T a||^2 <=
    sn^2 T. C: (K, T) regressors; Y: (d, T); sn: (d,); mask: optional
    (d, K) support. Every pixel at once: a bisection on each pixel's
    lambda (the RSS grows with lambda) around ``n_fista`` FISTA steps of
    min 1/2 ||y - C^T a||^2 + lam ||a||_1, a >= 0. ``mesh``: C and Y are
    this rank's frames (Y and sn its pixels); C C^T, Y C^T and ||y||^2
    are summed over 'frame', the budget takes the whole T, and the rank
    solves its pixels."""
    T = C.shape[1] * (1 if mesh is None else mesh.n_frame)
    G = comm.psum(C @ C.T, mesh, "frame")              # (K, K)
    B = comm.psum(Y @ C.T, mesh, "frame")              # (d, K)
    if mask is not None:
        B = torch.where(mask, B, 0.0)
    step = 1.0 / torch.clamp(G.abs().sum(dim=-1).amax(), min=1e-12)
    budget = sn * sn * T
    momenta = fista_momenta(n_fista)
    ynorm = comm.psum((Y * Y).sum(dim=-1), mesh, "frame")

    def fista(lam):
        x = torch.zeros_like(B)
        z = x
        for coef in momenta:
            x_new = torch.clamp(z - step * (z @ G - B + lam[:, None]),
                                min=0.0)
            if mask is not None:
                x_new = torch.where(mask, x_new, 0.0)
            z = torch.lerp(x, x_new, 1.0 + coef)
            x = x_new
        return x

    def rss_of(x):
        # ||y||^2 - 2 x.B + x G x^T, per pixel
        return ynorm - 2.0 * (x * B).sum(dim=-1) + ((x @ G) * x).sum(dim=-1)

    lo = torch.zeros_like(sn)
    hi = B.abs().amax(dim=-1) + 1e-6                   # lam >= max|B|: a = 0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        over = rss_of(fista(mid)) > budget             # lambda too big
        hi = torch.where(over, mid, hi)
        lo = torch.where(over, lo, mid)
    return fista(lo)


# --------------------------------------------------------------------- #
# full pipeline
# --------------------------------------------------------------------- #

class CNMF:
    """Vanilla CNMF for 2p data (the reference's ``demo_script.m`` flow).
    Every tensor it builds lives on ``device``: the card by default;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.

    Each pixel's spatial regression is restricted to the neurons whose
    footprint, dilated by :data:`SEARCH_RADIUS` pixels, covers it (and to
    every background component), as ``update_spatial_components.m`` does
    with ``determine_search_location``. The JAX package's ``CNMF``
    regresses every pixel on every trace; there the footprints take up
    residual background over the whole field of view once it holds more
    than a few neurons (recall 0.15 against 40 planted neurons at
    128x128x600)."""

    def __init__(self, K: int = 30, gSig: float = 5.0, nb: int = 2,
                 merge_thr: float = 0.8,
                 deconv: Optional[DeconvParams] = None,
                 spatial_method: str = "lasso", device="cuda"):
        self.K = K
        self.gSig = gSig
        self.nb = nb
        self.merge_thr = merge_thr
        self.deconv = deconv or DeconvParams(method="constrained",
                                             model="ar1")
        self.spatial_method = spatial_method
        self.device = torch.device(device)
        self.state: Optional[CNMFEState] = None
        self.b: Optional[torch.Tensor] = None   # (nb, H, W)
        self.f: Optional[torch.Tensor] = None   # (nb, T)

    def _background(self, resid: torch.Tensor, n_iter: int) -> None:
        T, H, W = resid.shape
        bW, bH = nmf_hals(torch.clamp(resid.reshape(T, -1).T, min=0.0),
                          self.nb, n_iter=n_iter)
        self.b = bW.T.reshape(self.nb, H, W)
        self.f = bH

    def fit(self, Y, n_outer: int = 2, verbose: bool = False,
            timer=None) -> CNMFEState:
        """Fit a movie Y (T, H, W), numpy or tensor. ``timer``: optional
        :class:`cnmf_e_tpu_torch.utils.profiling.StageTimer`, which sums
        the seconds of the stages init, spatial, temporal, deconv,
        background and merge."""
        with timed(timer, "init"):
            Y = torch.as_tensor(Y, device=self.device).to(torch.float32)
            T, H, W = Y.shape
            Y, P = preprocess_data(Y)
            sn_pix = P["sn_pix"]
            # greedyROI, a rank-nb background, then HALS refinement
            A0, C0, _ = greedy_roi(Y, self.K, gSig=self.gSig)
            K_found = A0.shape[0]
            self._background(
                Y - (C0.T @ A0.reshape(K_found, -1)).reshape(T, H, W), 30)
            K_cap = int(2 ** np.ceil(np.log2(max(K_found, 4))))
            state = empty_state(K_cap, H, W, T, device=self.device)
            active = state.active.clone()
            active[:K_found] = True
            state = state.replace(
                A=torch.cat([A0, state.A[K_found:]]),
                C=torch.cat([torch.clamp(C0, min=0.0), state.C[K_found:]]),
                C_raw=torch.cat([C0, state.C_raw[K_found:]]), active=active)
        if verbose:
            print(f"[cnmf] init: {K_found} components")
        params = CNMFEParams(merge=MergeParams(merge_thr=self.merge_thr))
        Yd = Y.reshape(T, -1).T                          # (d, T)
        for it in range(n_outer):
            # ---- spatial: noise-constrained lasso on [C; f] --------------
            with timed(timer, "spatial"):
                regs = torch.cat([state.masked_C(), self.f], dim=0)
                K = state.K_max
                near = search_locations_dilate(
                    state.masked_A(), radius=SEARCH_RADIUS) \
                    & state.active[:, None, None]
                mask = torch.cat([near.reshape(K, -1).T, torch.ones(
                    (Yd.shape[0], self.nb), dtype=torch.bool,
                    device=Yd.device)], dim=1)
                if self.spatial_method == "lasso":
                    coef = lasso_noise_constrained(regs, Yd,
                                                   sn_pix.reshape(-1), mask)
                else:
                    coef = nnls_pixels(regs, Yd, mask=mask)
                self.b = coef[:, K:].T.reshape(self.nb, H, W)
                state = state.replace(A=coef[:, :K].T.reshape(K, H, W)
                                      * state.active[:, None, None])
            # ---- temporal: HALS, then the deconvolution ------------------
            with timed(timer, "temporal"):
                Ysig = Yd - (self.f.T @ self.b.reshape(self.nb, -1)).T
                C_raw, _ = hals_temporal(
                    Ysig, state.masked_A().reshape(state.K_max, -1).T,
                    state.masked_C(), n_iter=3, active=state.active,
                    colored=False)
                del Ysig
            with timed(timer, "deconv"):
                res = deconvolve(C_raw, self.deconv)
                act = state.active[:, None]
                state = state.replace(
                    C=res.c * act, C_raw=(C_raw - res.b[:, None]) * act,
                    S=res.s * act, g=res.g[:, :state.g.shape[1]])
            # ---- background refresh, then merge ---------------------------
            with timed(timer, "background"):
                A = state.masked_A().reshape(state.K_max, -1)
                self._background(
                    Y - (state.masked_C().T @ A).reshape(T, H, W), 20)
            with timed(timer, "merge"):
                state, nm = merge_neurons(state, params, "dist_corr")
            if verbose:
                print(f"[cnmf] iter {it}: merged {int(nm)}, "
                      f"{int(state.n_active())} components")
        self.state = compact(state)
        return self.state
