"""Spatial (A) update on search-location-masked supports (port of
``cnmf_e_tpu/models/spatial.py``; reference
``update_spatial_parallel.m``): HALS, HALS with the 3-sigma pixel gate of
``HALS_spatial_thresh.m``, per-pixel NNLS, or the noise-constrained
nonnegative lasso in the role of ``lars_regression_noise.m``.

``mesh``: HALS with the dilated search locations on this rank's blocks:
the masks dilate across slabs (``search_locations_dilate(mesh=)``), the
HALS Grams are summed over 'frame' (``ops/hals.py``), and the shape
priors run on the footprints gathered over 'patch'
(``ops/morphology.py::on_gathered``). Other algorithms and search
methods take no mesh."""

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


def check_mesh_options(params: CNMFEParams) -> None:
    """Raise NotImplementedError naming the spatial option that takes no
    mesh."""
    sp = params.spatial
    if sp.algorithm != "hals":
        raise NotImplementedError(f"spatial.algorithm = {sp.algorithm!r} "
                                  f"takes no mesh")
    if sp.search_method == "ellipse":
        raise NotImplementedError("spatial.search_method = 'ellipse' takes "
                                  "no mesh")


def update_spatial(Ysignal: torch.Tensor, state: CNMFEState,
                   params: CNMFEParams,
                   sn_pix: Optional[torch.Tensor] = None,
                   mesh=None) -> CNMFEState:
    """Update footprints given traces. Ysignal: (T, H, W) = Y - B.

    ``sn_pix``: optional (H, W) per-pixel noise sigma, the noise floor of
    ``hals_thresh`` and ``lars``; without it the residual's standard
    deviation stands in, which overestimates the floor while signal is
    unmodelled."""
    sp = params.spatial
    if mesh is not None:
        check_mesh_options(params)
    T, H, W = Ysignal.shape
    K = state.K_max
    A = state.masked_A()
    C = state.masked_C()
    if sp.search_method == "dilate":
        masks = search_locations_dilate(A, radius=sp.dilate_radius,
                                        mesh=mesh)
    elif sp.search_method == "ellipse":
        masks = search_locations_ellipse(A)
    else:
        masks = torch.ones_like(A, dtype=torch.bool)
    masks = masks & state.active[:, None, None]
    Yd = Ysignal.reshape(T, H * W).T                 # (d, T)
    Ad = A.reshape(K, H * W).T                       # (d, K)
    Md = masks.reshape(K, H * W).T
    if sp.algorithm in ("hals", "hals_thresh"):
        Ad = hals_spatial(Yd, Ad, C, mask=Md, n_iter=sp.n_iter, mesh=mesh)
        if sp.algorithm == "hals_thresh":
            # zero a_dk where a_dk ||C_k - mean|| < 3 sn_d
            # (HALS_spatial_thresh.m:37,51)
            Cc = C - C.mean(dim=-1, keepdim=True)
            cnorm = torch.sqrt((Cc * Cc).sum(dim=-1))
            sn_d = (sn_pix.reshape(-1, 1) if sn_pix is not None
                    else (Yd - Ad @ C).std(dim=-1, correction=0,
                                           keepdim=True))
            Ad = torch.where(Ad * cnorm[None, :] > 3.0 * sn_d, Ad, 0.0)
    elif sp.algorithm == "nnls":
        Ad = nnls_pixels(C, Yd, A0=Ad, mask=Md, n_iter=20 * sp.n_iter)
    elif sp.algorithm == "lars":
        from cnmf_e_tpu_torch.models.cnmf2p import lasso_noise_constrained
        sn_d = (sn_pix.reshape(-1) if sn_pix is not None
                else (Yd - Ad @ C).std(dim=-1, correction=0))
        Ad = lasso_noise_constrained(C, Yd, sn_d, Md)
    else:
        raise ValueError(f"unknown spatial algorithm {sp.algorithm!r}")
    A_new = post_process_spatial(Ad.T.reshape(K, H, W), params, mesh)
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
