"""Spatial (A) update on search-location-masked supports (port of
``cnmf_e_tpu/models/spatial.py``; reference
``update_spatial_parallel.m``): HALS, HALS with the 3-sigma pixel gate of
``HALS_spatial_thresh.m``, per-pixel NNLS, or the noise-constrained
nonnegative lasso in the role of ``lars_regression_noise.m``.

``mesh``: every algorithm and search method on this rank's blocks: the
dilated masks grow across slabs (``search_locations_dilate(mesh=)``),
the ellipses take their moments summed over 'patch'; HALS sums its
Grams over 'frame' (``ops/hals.py``), NNLS and the lasso sum C C^T,
Y C^T and ||y||^2 over 'frame' and solve the rank's pixels, and the
3-sigma gate of ``hals_thresh`` takes C's mean and norm (and the
fallback noise floor's variance) over 'frame'. The shape priors run on
the footprints gathered over 'patch'
(``ops/morphology.py::on_gathered``)."""

from __future__ import annotations

from typing import Optional

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.hals import hals_spatial
from cnmf_e_tpu_torch.ops.morphology import (circular_constraint,
                                             connectivity_constraint,
                                             on_gathered,
                                             search_locations_dilate,
                                             search_locations_ellipse)
from cnmf_e_tpu_torch.ops.nnls import nnls_pixels
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import span


def _frame_std(x: torch.Tensor, mesh) -> torch.Tensor:
    """The standard deviation (no correction) along the last axis, sharded
    over 'frame': its mean and the squares about it summed over
    'frame'. Without a mesh, or on one 'frame' rank, ``std`` itself."""
    if mesh is None or mesh.n_frame == 1:
        return x.std(dim=-1, correction=0)
    mu = comm.frame_mean(x, -1, mesh, keepdim=True)
    return torch.sqrt(comm.frame_mean((x - mu) ** 2, -1, mesh))


def update_spatial(Ysignal: torch.Tensor, state: CNMFEState,
                   params: CNMFEParams,
                   sn_pix: Optional[torch.Tensor] = None,
                   mesh=None) -> CNMFEState:
    """Update footprints given traces. Ysignal: (T, H, W) = Y - B.

    ``sn_pix``: optional (H, W) per-pixel noise sigma, the noise floor of
    ``hals_thresh`` and ``lars``; without it the residual's standard
    deviation stands in, which overestimates the floor while signal is
    unmodelled."""
    with span("update_spatial"):
        sp = params.spatial
        T, H, W = Ysignal.shape
        K = state.K_max
        A = state.masked_A()
        C = state.masked_C()
        with span("spatial.search"):
            if sp.search_method == "dilate":
                masks = search_locations_dilate(A, radius=sp.dilate_radius,
                                                mesh=mesh)
            elif sp.search_method == "ellipse":
                masks = search_locations_ellipse(A, mesh=mesh)
            else:
                masks = torch.ones_like(A, dtype=torch.bool)
            masks = masks & state.active[:, None, None]
        Yd = Ysignal.reshape(T, H * W).T                 # (d, T)
        Ad = A.reshape(K, H * W).T                       # (d, K)
        Md = masks.reshape(K, H * W).T
        if sp.algorithm in ("hals", "hals_thresh"):
            Ad = hals_spatial(Yd, Ad, C, mask=Md, n_iter=sp.n_iter,
                              mesh=mesh)
            if sp.algorithm == "hals_thresh":
                # zero a_dk where a_dk ||C_k - mean|| < 3 sn_d
                # (HALS_spatial_thresh.m:37,51)
                Cc = C - comm.frame_mean(C, -1, mesh, keepdim=True)
                cnorm = torch.sqrt(comm.psum((Cc * Cc).sum(dim=-1), mesh,
                                             "frame"))
                sn_d = (sn_pix.reshape(-1, 1) if sn_pix is not None
                        else _frame_std(Yd - Ad @ C, mesh)[:, None])
                Ad = torch.where(Ad * cnorm[None, :] > 3.0 * sn_d, Ad, 0.0)
        elif sp.algorithm == "nnls":
            Ad = nnls_pixels(C, Yd, A0=Ad, mask=Md, n_iter=20 * sp.n_iter,
                             mesh=mesh)
        elif sp.algorithm == "lars":
            from cnmf_e_tpu_torch.models.cnmf2p import lasso_noise_constrained
            sn_d = (sn_pix.reshape(-1) if sn_pix is not None
                    else _frame_std(Yd - Ad @ C, mesh))
            Ad = lasso_noise_constrained(C, Yd, sn_d, Md, mesh=mesh)
        else:
            raise ValueError(f"unknown spatial algorithm {sp.algorithm!r}")
        with span("spatial.post_process"):
            A_new = post_process_spatial(Ad.T.reshape(K, H, W), params,
                                         mesh)
        return state.replace(A=A_new * state.active[:, None, None])


def post_process_spatial(A: torch.Tensor, params: CNMFEParams,
                         mesh=None) -> torch.Tensor:
    """Keep each footprint's peak-connected blob; optional circular
    prior (``post_process_spatial.m``). ``mesh``: A is this rank's rows,
    gathered once for both priors."""
    sp = params.spatial
    if not (sp.connected or sp.circular):
        return A

    def priors(A):
        if sp.connected:
            A = connectivity_constraint(A, se_size=3)
        if sp.circular:
            A = circular_constraint(A)
        return A
    return on_gathered(priors, A, mesh)
