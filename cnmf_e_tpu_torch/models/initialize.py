"""Greedy Corr+PNR initialization in batched rounds (port of
``cnmf_e_tpu/models/initialize.py``; reference ``greedyROI_endoscope.m``,
``extract_ac.m``).

Each round takes the top local maxima of the Cn * PNR search image (exact
non-max suppression by a max filter), extracts every seed's footprint and
trace at once, deconvolves the traces as one batch, accepts the good seeds
into free neuron slots, peels them from the movie, and refreshes the
band-passed movie by the rank-N update of the filtered footprints.

``mesh``: :func:`initialize_greedy` on this rank's block (T/frame,
H/patch, W) of the movie, for the first init and for the residual pick.
The search image's statistics reduce over 'frame' and its (H, W) values
are gathered over 'patch', so every rank picks the same seeds. Each seed
is extracted by the patch ranks that hold its centre row, from their
slabs extended by ``gSiz`` halo rows, with every sum over time summed
over 'frame'; the boxes and whole traces are gathered over 'patch', and
the deconvolution splits the seeds evenly over 'patch'. The placement,
the peel and the refresh of the band-passed movie then update each
rank's rows and frames from the replicated boxes and traces.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState, empty_state
from cnmf_e_tpu_torch.ops.corr import correlation_image
from cnmf_e_tpu_torch.ops.detrend import detrend
from cnmf_e_tpu_torch.ops.filters import (box_downsample, filter_movie,
                                          gaussian_psf, resize_linear,
                                          resize_linear_last)
from cnmf_e_tpu_torch.ops.morphology import (circular_constraint,
                                             connectivity_constraint)
from cnmf_e_tpu_torch.ops.noise import (estimate_baseline_noise, noise_psd,
                                        noise_psd_frames)
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from cnmf_e_tpu_torch.ops.stats import (fast_median, fast_median_masked,
                                        median_mid)
from cnmf_e_tpu_torch.parallel import comm


class ExtractResult(NamedTuple):
    a: torch.Tensor        # (N, B, B) footprint inside the box
    c_raw: torch.Tensor    # (N, T) baseline-subtracted raw trace
    ok: torch.Tensor       # (N,) success flag
    sn: torch.Tensor       # (N,) trace noise


def _boxes(M: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
           gSiz: int, halo: bool = False) -> torch.Tensor:
    """(N, T, B*B) boxes of side B = 2 gSiz + 1 centred at (rows, cols),
    zero outside the FOV. ``halo``: M's rows already carry ``gSiz`` halo
    rows above and below (a mesh rank's slab), and ``rows`` count from
    its first row inside them."""
    B = 2 * gSiz + 1
    Mp = F.pad(M, (gSiz, gSiz) + ((0, 0) if halo else (gSiz, gSiz)))
    off = torch.arange(B, device=M.device)
    r = (rows[:, None] + off)[:, :, None]                 # (N, B, 1)
    c = (cols[:, None] + off)[:, None, :]                 # (N, 1, B)
    box = Mp[:, r, c]                                     # (T, N, B, B)
    return box.permute(1, 0, 2, 3).reshape(rows.shape[0], M.shape[0], B * B)


def extract_ac_batch(HY: torch.Tensor, Y: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, gSiz: int, min_pixel: int = 5,
                     corr_thr: float = 0.9,
                     bg_corr_thr: float = 0.3, mesh=None) -> ExtractResult:
    """Batched ``extract_ac`` (``extract_ac.m:19-95``) of every seed.

    HY/Y: (T, H, W) filtered / raw movies; rows/cols: (N,) seed centres.
    The trace is the mean of the box pixels correlating > corr_thr with the
    seed; the footprint is the per-pixel LS coefficient on [1, median
    background, trace]; out-of-FOV pixels have NaN correlation and drop
    out of both pixel sets.

    ``mesh``: HY and Y are this rank's frames of a slab of rows that
    holds every seed's box (``gSiz`` halo rows above and below its own,
    from ``comm.halo_rows``), and ``rows`` count from the slab's first row
    inside the halo; the sums over time are summed over 'frame', and the
    returned traces are whole (gathered over 'frame')."""
    B = 2 * gSiz + 1
    halo = mesh is not None
    hy = _boxes(HY, rows, cols, gSiz, halo)               # (N, T, P)
    yy = _boxes(Y, rows, cols, gSiz, halo)
    y0 = hy[:, :, gSiz * B + gSiz]                        # (N, T)
    hy_c = hy - comm.frame_mean(hy, 1, mesh, keepdim=True)
    y0_c = y0 - comm.frame_mean(y0, 1, mesh, keepdim=True)
    denom = (comm.norm(hy_c, 1, mesh, "frame") * torch.clamp(
        comm.norm(y0_c, 1, mesh, "frame"), min=1e-12)[:, None])
    corr = comm.psum((hy_c.transpose(1, 2) @ y0_c[:, :, None])[..., 0],
                     mesh, "frame") / torch.where(
        denom > 0, denom, torch.nan)                      # (N, P)
    in_mask = corr > corr_thr
    n_in = in_mask.sum(dim=1)
    ci = torch.where(in_mask[:, None, :], hy, 0.0).sum(dim=2) / \
        torch.clamp(n_in, min=1)[:, None]                 # (N, T)
    y_bg = fast_median_masked(yy, (corr < bg_corr_thr)[:, None, :], dim=2)

    X = torch.stack([torch.ones_like(ci), y_bg, ci], dim=2)     # (N, T, 3)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    G = comm.psum(X.transpose(1, 2) @ X, mesh, "frame") + 1e-6 * eye
    coef = torch.linalg.solve(G, comm.psum(X.transpose(1, 2) @ yy, mesh,
                                           "frame"))    # (N, 3, P)
    ai = torch.clamp(coef[:, 2], min=0.0).reshape(-1, B, B)
    ai = connectivity_constraint(circular_constraint(ai), se_size=3)
    if mesh is not None and mesh.n_frame > 1:
        ci = comm.all_gather_cat(ci, 1, mesh.frame_group)

    npix = (ai > 0).sum(dim=(1, 2))
    b_hist, sn_hist = estimate_baseline_noise(ci)
    sn_psd = noise_psd(ci)
    med = median_mid(ci, dim=1)[:, None]
    below = ci < med
    b_sub = torch.where(below, ci, 0.0).sum(dim=1) / \
        torch.clamp(below.sum(dim=1), min=1)
    ci_out = ci - torch.where(sn_hist <= sn_psd, b_hist, b_sub)[:, None]
    sn = torch.minimum(sn_hist, sn_psd)
    ok = ((npix >= min_pixel) & (torch.linalg.norm(ci, dim=1) > 0)
          & torch.isfinite(ai).all(dim=(1, 2))
          & torch.isfinite(ci_out).all(dim=1))
    return ExtractResult(a=ai, c_raw=ci_out, ok=ok, sn=sn)


def _local_maxima_topk(v: torch.Tensor, n: int, vmin: float, nms_dist: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-n local maxima of v (H, W) that are the maximum within
    +-nms_dist and above vmin; ties in value go to the lower flat index
    (``lax.top_k``), and of two exactly tied maxima closer than nms_dist
    the lower-ranked one is dropped."""
    H, W = v.shape
    w = 2 * nms_dist + 1
    vmax = F.max_pool2d(v[None, None], (w, 1), stride=1,
                        padding=(nms_dist, 0))
    vmax = F.max_pool2d(vmax, (1, w), stride=1, padding=(0, nms_dist))[0, 0]
    is_max = (v >= vmax) & (v > vmin)
    score = torch.where(is_max, v, -torch.inf).reshape(-1)
    order = torch.sort(score, descending=True, stable=True)
    vals, idx = order.values[:n], order.indices[:n]
    rows, cols = idx // W, idx % W
    valid = vals > -torch.inf
    dr = rows[:, None] - rows[None, :]
    dc = cols[:, None] - cols[None, :]
    close = (dr * dr + dc * dc) < nms_dist * nms_dist
    ar = torch.arange(idx.shape[0], device=v.device)
    lower = ar[:, None] > ar[None, :]
    conflict = (close & lower & valid[None, :]).any(dim=1)
    return rows, cols, valid & ~conflict


def _pixel_traces(HY: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                  mesh) -> torch.Tensor:
    """The whole traces (T, N) of the pixels (rows, cols) of HY; under a
    mesh each comes from the patch rank holding its row (the others add
    zeros over 'patch') and is gathered over 'frame'."""
    if mesh is None:
        return HY[:, rows, cols]
    Hl = HY.shape[1]
    loc = rows - mesh.p * Hl
    own = (loc >= 0) & (loc < Hl)
    x = torch.where(own[None], HY[:, torch.clamp(loc, 0, Hl - 1), cols],
                    0.0)
    x = comm.psum(x, mesh, "patch")
    return comm.all_gather_cat(x, 0, mesh.frame_group)


def _weak_signal_test(HY: torch.Tensor, rows: torch.Tensor,
                      cols: torch.Tensor, mesh=None) -> torch.Tensor:
    """Seed traces must have max(diff) >= 3 std(diff)
    (``greedyROI_endoscope.m:286-293``). The difference crosses the
    frame blocks' seams, so a mesh gathers the traces whole first."""
    d = torch.diff(_pixel_traces(HY, rows, cols, mesh), dim=0)  # (T-1, N)
    return d.amax(dim=0) >= 3.0 * d.std(dim=0, unbiased=False)


def _search_image(HY, Ysig, searched, min_corr, min_pnr, mesh=None):
    """(Cn, PNR, masked search value) of the current filtered residual;
    under a mesh this rank's rows of each (``searched``: the whole
    field of view's)."""
    pnr = comm.pmax(HY.amax(dim=0), mesh, "frame") / torch.clamp(Ysig,
                                                                 min=1e-12)
    HY_thr = torch.where(HY >= 3.0 * Ysig[None], HY, 0.0)
    cn = torch.nan_to_num(correlation_image(HY_thr, center=False,
                                            mesh=mesh))
    if mesh is not None:
        Hl = HY.shape[1]
        searched = searched[mesh.p * Hl:(mesh.p + 1) * Hl]
    v = torch.where((cn < min_corr) | (pnr < min_pnr) | searched, 0.0,
                    cn * pnr)
    return cn, pnr, v


def _mark_searched(searched, rows, cols, valid):
    """Mark the valid seed pixels; invalid seeds land in a dropped
    corner."""
    H, W = searched.shape
    s = torch.zeros((H + 1, W + 1), dtype=torch.bool, device=rows.device)
    s[torch.where(valid, rows, H), torch.where(valid, cols, W)] = True
    return searched | s[:H, :W]


def _place_footprints_masked(A, searched, a_boxes, rows, cols, slots, take,
                             gSiz: int, mesh=None):
    """Paste the (N, B, B) boxes into full-FOV images (N, H, W), write
    them into slots ``slots`` of A (slot K_max = dropped), and mark the
    core pixels (> half max) of taken seeds as searched. ``mesh``: A is
    this rank's rows; the boxes, ``searched`` and the returned images
    are the whole field of view's, on every rank."""
    K, _, W = A.shape
    H = searched.shape[0]
    N, B, _ = a_boxes.shape
    dev = A.device
    pad = torch.zeros((N, H + 2 * gSiz, W + 2 * gSiz), dtype=A.dtype,
                      device=dev)
    off = torch.arange(B, device=dev)
    n_idx = torch.arange(N, device=dev)[:, None, None]
    pad[n_idx, (rows[:, None] + off)[:, :, None],
        (cols[:, None] + off)[:, None, :]] = a_boxes
    full_A = pad[:, gSiz:gSiz + H, gSiz:gSiz + W]
    A_pad = torch.cat([A, torch.zeros_like(A[:1])])
    A_pad[slots] = _my_rows(full_A, A.shape[1], mesh)
    core = (full_A > 0.5 * full_A.amax(dim=(1, 2), keepdim=True)) \
        & take[:, None, None]
    return A_pad[:K], searched | core.any(dim=0), full_A


def _my_rows(X: torch.Tensor, Hl: int, mesh) -> torch.Tensor:
    """This patch rank's rows of full-FOV images (..., H, W)."""
    if mesh is None:
        return X
    return X[..., mesh.p * Hl:(mesh.p + 1) * Hl, :]


def _my_frames(X: torch.Tensor, Tl: int, mesh) -> torch.Tensor:
    """This frame rank's frames of whole traces (..., T)."""
    if mesh is None:
        return X
    return X[..., mesh.f * Tl:(mesh.f + 1) * Tl]


def refilter(Y: torch.Tensor, psf: np.ndarray, mesh=None) -> torch.Tensor:
    """The band-passed, median-centred movie: filter_movie(Y, psf) less
    its per-pixel median over time."""
    HY = filter_movie(Y, psf, mesh=mesh)
    return HY - fast_median(HY, dim=0, keepdim=True, mesh=mesh)


def _init_prolog(Y_work: torch.Tensor, gSig: float, center_psf: bool,
                 mesh=None):
    """Band-pass, per-pixel median centring and per-pixel noise."""
    HY = refilter(Y_work, gaussian_psf(gSig, center_psf), mesh=mesh)
    return HY, noise_psd_frames(HY, mesh=mesh)


def _scatter_rows(x: torch.Tensor, slots: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """x with rows ``slots`` set to ``val``; slot len(x) is dropped."""
    xp = torch.cat([x, torch.zeros_like(x[:1])])
    xp[slots] = val.to(x.dtype)
    return xp[:x.shape[0]]


def _extract_mesh(HY, Y_work, rows, cols, gSiz, mesh, **kw
                  ) -> ExtractResult:
    """:func:`extract_ac_batch` of every seed on a mesh: the patch ranks
    holding a seed's centre row extract it from their slabs with ``gSiz``
    halo rows (zeros past the field of view, as ``_boxes`` pads), and the
    results are gathered over 'patch' in seed order, on every rank."""
    Tl, Hl, _ = HY.shape
    B = 2 * gSiz + 1
    HYh = comm.halo_rows(HY, gSiz, mesh)
    Yh = comm.halo_rows(Y_work, gSiz, mesh)
    owner = rows // Hl
    sizes = torch.bincount(owner, minlength=mesh.n_patch).tolist()
    mine = torch.nonzero(owner == mesh.p).flatten()
    T = Tl * mesh.n_frame
    width = B * B + T + 2
    if mine.numel():
        r = extract_ac_batch(HYh, Yh, rows[mine] - mesh.p * Hl, cols[mine],
                             gSiz, mesh=mesh, **kw)
        part = torch.cat([r.a.reshape(-1, B * B), r.c_raw,
                          r.ok.to(HY.dtype)[:, None], r.sn[:, None]], dim=1)
    else:
        part = torch.zeros((0, width), dtype=HY.dtype, device=HY.device)
    allp = comm.all_gather_cat(part, 0, mesh.patch_group, sizes)
    order = torch.argsort(owner, stable=True)         # rows of allp
    x = torch.empty_like(allp)
    x[order] = allp
    # contiguous copies: on the card a reduction over rows that start off
    # a 16-byte boundary sums in another order than over fresh rows
    return ExtractResult(a=x[:, :B * B].reshape(-1, B, B).contiguous(),
                         c_raw=x[:, B * B:B * B + T].contiguous(),
                         ok=x[:, B * B + T] > 0.5,
                         sn=x[:, B * B + T + 1].contiguous())


def _deconvolve_split(c_raw, deconv, sn, mesh):
    """``deconvolve`` of whole traces (N, T), N split evenly over 'patch'
    under a mesh and the results gathered: (c, s, g). ``sn``: the traces'
    noise, or None (``deconvolve`` estimates it)."""
    if mesh is None:
        d = deconvolve(c_raw, deconv, sn=sn)
        return d.c, d.s, d.g
    N, T = c_raw.shape
    n0, n1 = (N * mesh.p // mesh.n_patch, N * (mesh.p + 1) // mesh.n_patch)
    d = deconvolve(c_raw[n0:n1], deconv,
                   sn=None if sn is None else sn[n0:n1])
    sizes = [N * (q + 1) // mesh.n_patch - N * q // mesh.n_patch
             for q in range(mesh.n_patch)]
    x = comm.all_gather_cat(torch.cat([d.c, d.s, d.g], dim=1), 0,
                            mesh.patch_group, sizes)
    return (x[:, :T].contiguous(), x[:, T:2 * T].contiguous(),
            x[:, 2 * T:].contiguous())


def _init_round(state: CNMFEState, HY, Y_work, Ysig, searched, n_found,
                min_corr, min_pnr, *, psf, gSiz, n_seeds, min_pixel,
                corr_thr, deconv, nms_dist, mesh=None):
    """One greedy round: seed search -> extraction -> deconvolution ->
    acceptance into free slots -> peel -> band-passed movie refresh.
    Returns (state, Y_work, HY, searched, report (N, 4) [row, col, taken,
    valid], n_found). ``mesh``: HY, Y_work, Ysig and the state are this
    rank's blocks, ``searched`` the whole field of view's."""
    K_max = state.K_max
    Tl, Hl, W = Y_work.shape
    _, _, v = _search_image(HY, Ysig, searched, min_corr, min_pnr, mesh)
    if mesh is not None:
        v = comm.all_gather_cat(v, 0, mesh.patch_group)
    vmin = float(np.float32(min_corr) * np.float32(min_pnr))
    rows, cols, valid = _local_maxima_topk(v, n_seeds, vmin, nms_dist)
    valid = valid & _weak_signal_test(HY, rows, cols, mesh)
    kw = dict(min_pixel=min_pixel, corr_thr=corr_thr)
    res = (extract_ac_batch(HY, Y_work, rows, cols, gSiz, **kw)
           if mesh is None else
           _extract_mesh(HY, Y_work, rows, cols, gSiz, mesh, **kw))
    ok = res.ok & valid
    N = rows.shape[0]
    if deconv is not None:
        c_use, s_use, g_use = _deconvolve_split(res.c_raw, deconv, res.sn,
                                                mesh)
    else:
        c_use = torch.clamp(res.c_raw, min=0.0)
        s_use = torch.zeros_like(res.c_raw)
        g_use = torch.full((N, 1), 0.9, device=Y_work.device)
    gp = state.g.shape[1]
    if g_use.shape[1] < gp:
        g_use = F.pad(g_use, (0, gp - g_use.shape[1]))

    rank = torch.cumsum(ok.long(), 0) - 1
    slot = n_found + rank
    take = ok & (slot < K_max)
    slots = torch.where(take, slot, K_max)
    A_new, searched2, full_A = _place_footprints_masked(
        state.A, searched, res.a, rows, cols, slots, take, gSiz, mesh)
    state = state.replace(
        A=A_new,
        C=_scatter_rows(state.C, slots, _my_frames(c_use, Tl, mesh)),
        C_raw=_scatter_rows(state.C_raw, slots,
                            _my_frames(res.c_raw, Tl, mesh)),
        S=_scatter_rows(state.S, slots, _my_frames(s_use, Tl, mesh)),
        g=_scatter_rows(state.g, slots, g_use[:, :gp]),
        neuron_sn=_scatter_rows(state.neuron_sn, slots, res.sn),
        active=_scatter_rows(state.active, slots,
                             torch.ones_like(take)))

    c_eff = torch.where(take[:, None], c_use, 0.0)
    Y_new = Y_work - (_my_frames(c_eff, Tl, mesh).T @ _my_rows(
        full_A, Hl, mesh).reshape(N, -1)).reshape(Tl, Hl, W)
    fA = _my_rows(filter_movie(full_A, psf), Hl, mesh)
    c_med = torch.where(take, fast_median(c_eff, dim=-1), 0.0)
    HY_new = HY - (_my_frames(c_eff - c_med[:, None], Tl, mesh).T
                   @ fA.reshape(N, -1)).reshape(Tl, Hl, W)
    searched2 = _mark_searched(searched2, rows, cols, valid)
    report = torch.stack([rows, cols, take.long(), valid.long()], dim=1)
    return (state, Y_new, HY_new, searched2, report,
            n_found + take.long().sum())


def check_mesh_options(params: CNMFEParams, mesh, block_shape) -> None:
    """Raise a ValueError when ``seeds_per_round`` does not divide over
    'patch', or when this rank's block (T/frame, H/patch, W) does not
    pool alone: its frames not a multiple of ``init.tsub``, its rows not
    a multiple of ``init.ssub``."""
    ip = params.init
    if ip.seeds_per_round % mesh.n_patch:
        raise ValueError(f"seeds_per_round = {ip.seeds_per_round} is not "
                         f"divisible by the {mesh.n_patch} ranks of the "
                         f"'patch' axis")
    Tl, Hl = block_shape[:2]
    if Tl % ip.tsub:
        raise ValueError(f"T / n_frame = {Tl} is not a multiple of "
                         f"init.tsub = {ip.tsub}")
    if Hl % ip.ssub:
        raise ValueError(f"H / n_patch = {Hl} is not a multiple of "
                         f"init.ssub = {ip.ssub}")


def _init_downsampled(Y: torch.Tensor, params: CNMFEParams, K_max: int,
                      min_corr, min_pnr, verbose: bool, mesh
                      ) -> Tuple[CNMFEState, dict]:
    """The init on the box-downsampled movie, its footprints and raw
    traces resized back linearly and its traces refined by one
    deconvolution at the full rate (``greedyROI_endoscope.m:464-487``).
    ``mesh``: Y is this rank's block, whose frames and rows pool alone;
    the footprints resize on the slab with a halo row
    (``resize_linear(mesh=)``), the traces along time whole (gathered
    over 'frame'), and the deconvolution splits them over 'patch'."""
    ip = params.init
    Tl, Hl, W = Y.shape
    T = Tl * (1 if mesh is None else mesh.n_frame)
    ip_ds = dataclasses.replace(
        ip, ssub=1, tsub=1, gSig=max(ip.gSig / ip.ssub, 0.0),
        gSiz=max(int(ip.gSiz // ip.ssub), 3))
    st_ds, info = initialize_greedy(
        box_downsample(Y.to(torch.float32), ssub=ip.ssub, tsub=ip.tsub),
        params.replace(init=ip_ds), K_max=K_max, min_corr=min_corr,
        min_pnr=min_pnr, verbose=verbose, mesh=mesh)
    C_ds = st_ds.C_raw
    if mesh is not None:
        C_ds = comm.all_gather_cat(C_ds, 1, mesh.frame_group)
    C_full = resize_linear_last(C_ds, T)                  # whole traces
    st = empty_state(st_ds.K_max, Hl, W, Tl, p=st_ds.g.shape[1],
                     device=Y.device).replace(
        A=resize_linear(st_ds.A, (Hl, W), mesh=mesh),
        C=_my_frames(torch.clamp(C_full, min=0.0), Tl, mesh),
        C_raw=_my_frames(C_full, Tl, mesh).contiguous(),
        active=st_ds.active, g=st_ds.g, neuron_sn=st_ds.neuron_sn)
    # refine the traces at the full rate with one deconvolution pass
    if ip.deconv_at_init and params.temporal.deconv.enabled:
        c, s, _ = _deconvolve_split(C_full, params.temporal.deconv, None,
                                    mesh)
        act = st.active[:, None]
        st = st.replace(C=torch.where(act, _my_frames(c, Tl, mesh), 0.0),
                        S=torch.where(act, _my_frames(s, Tl, mesh), 0.0))
    return st, info


def initialize_greedy(Y: torch.Tensor, params: CNMFEParams,
                      K_max: Optional[int] = None,
                      state: Optional[CNMFEState] = None,
                      min_corr: Optional[float] = None,
                      min_pnr: Optional[float] = None,
                      verbose: bool = False,
                      mesh=None) -> Tuple[CNMFEState, dict]:
    """Batched greedy init on a (T, H, W) movie (raw, or the residual
    Y - AC - B for the residual pick). With ``state`` given, new neurons
    append into its free slots. Returns (state, info) with the final Cn /
    PNR maps and the seed log. With ``init.ssub/tsub > 1`` (and no
    ``state``) the init runs on the box-downsampled movie and its
    footprints and raw traces are resized back linearly
    (``greedyROI_endoscope.m:464-487``); ``init.nk > 1`` detrends each
    pixel first (``initComponents_parallel.m:341-346``).

    ``mesh``: Y and ``state`` are this rank's blocks (the module
    docstring), ``seeds_per_round`` divides over 'patch', and the state
    returned is this rank's blocks; the report, ``n_found`` and the Cn /
    PNR maps (whole) are the same on every rank. With ``init.ssub`` or
    ``init.tsub`` the rank's frames and rows pool alone (a multiple of
    each), and ``init.nk`` detrends the rank's frames with the basis
    products summed over 'frame' (``ops/detrend.py``)."""
    ip = params.init
    T, H, W = Y.shape
    dev = Y.device
    K_max = K_max or ip.max_neurons
    Tl, Hl = T, H
    if mesh is not None:
        check_mesh_options(params, mesh, Y.shape)
        T, H = T * mesh.n_frame, H * mesh.n_patch
    if (ip.ssub > 1 or ip.tsub > 1) and state is None:
        return _init_downsampled(Y, params, K_max, min_corr, min_pnr,
                                 verbose, mesh)
    gSiz = int(ip.gSiz)
    if min_corr is None:
        min_corr = ip.min_corr
    if min_pnr is None:
        min_pnr = ip.min_pnr
    if state is None:
        # the AR order of the trace model sets the width of g
        p_ar = 2 if params.temporal.deconv.model in ("ar2", "exp2") else 1
        state = empty_state(K_max, Hl, W, Tl, p=p_ar, device=dev)
    else:
        K_max = state.K_max
    Y_work = Y.to(torch.float32)
    if ip.nk > 1:
        Y_work = detrend(Y_work.permute(1, 2, 0), ip.nk, ip.detrend_method,
                         mesh).permute(2, 0, 1).contiguous()
    HY, Ysig = _init_prolog(Y_work, ip.gSig, ip.center_psf, mesh)

    searched = torch.zeros((H, W), dtype=torch.bool, device=dev)
    if ip.bd > 0:
        bd = ip.bd
        searched[:bd] = True
        searched[-bd:] = True
        searched[:, :bd] = True
        searched[:, -bd:] = True

    n_found = int(state.active.sum())
    deconv_cfg = (params.temporal.deconv
                  if ip.deconv_at_init and params.temporal.deconv.enabled
                  else None)
    round_kw = dict(psf=gaussian_psf(ip.gSig, ip.center_psf), gSiz=gSiz,
                    n_seeds=ip.seeds_per_round,
                    min_pixel=max(ip.min_pixel, 5),
                    corr_thr=ip.corr_pixel_thr, deconv=deconv_cfg,
                    nms_dist=max(gSiz // 2, 4), mesh=mesh)

    # A round's report is read two rounds after it ran, and the stop test
    # applies to it then — the JAX package's speculative dispatch order.
    # The rounds run in the meantime are part of the result. Under a mesh
    # every rank reads the same reports, so all stop at the same round.
    seeds_log = []
    nf_dev = torch.tensor(n_found, device=dev)
    pending = []
    lag = 2
    stop = False
    for rnd in range(ip.max_rounds):
        state, Y_work, HY, searched, report, nf_dev = _init_round(
            state, HY, Y_work, Ysig, searched, nf_dev, min_corr, min_pnr,
            **round_kw)
        pending.append((rnd, report))
        while pending and (len(pending) > lag or rnd == ip.max_rounds - 1):
            r, rep = pending.pop(0)
            rep = rep.cpu().numpy()
            taken = np.nonzero(rep[:, 2])[0]
            seeds_log.extend((r, int(rep[i, 0]), int(rep[i, 1]))
                             for i in taken)
            n_found += len(taken)
            if verbose:
                print(f"init round {r}: +{len(taken)} neurons "
                      f"(total {n_found})")
            if len(taken) == 0 or n_found >= K_max:
                stop = True
                break
        if stop:
            break
    for r, rep in pending:
        rep = rep.cpu().numpy()
        for i in np.nonzero(rep[:, 2])[0]:
            seeds_log.append((r, int(rep[i, 0]), int(rep[i, 1])))
            n_found += 1

    cn, pnr, _ = _search_image(HY, Ysig, torch.zeros_like(searched),
                               min_corr, min_pnr, mesh)
    if mesh is not None:
        cn = comm.all_gather_cat(cn, 0, mesh.patch_group)
        pnr = comm.all_gather_cat(pnr, 0, mesh.patch_group)
    info = {"Cn": cn, "PNR": pnr, "seeds": seeds_log, "n_found": n_found,
            "residual_Y": Y_work}
    return state, info
