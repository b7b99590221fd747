"""Spatial (A) update, HALS on dilated search locations (port of the
``algorithm="hals"`` path of ``cnmf_e_tpu/models/spatial.py``; reference
``update_spatial_parallel.m``)."""

from __future__ import annotations

from typing import Optional

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.hals import hals_spatial
from cnmf_e_tpu_torch.ops.morphology import (circular_constraint,
                                             connectivity_constraint,
                                             search_locations_dilate)


def update_spatial(Ysignal: torch.Tensor, state: CNMFEState,
                   params: CNMFEParams,
                   sn_pix: Optional[torch.Tensor] = None) -> CNMFEState:
    """Update footprints given traces. Ysignal: (T, H, W) = Y - B.
    ``sn_pix`` is accepted for the JAX signature; the HALS path does not
    read it."""
    sp = params.spatial
    if sp.algorithm != "hals" or sp.search_method not in ("dilate", "none"):
        raise NotImplementedError(
            f"spatial {sp.algorithm}/{sp.search_method} is not ported")
    T, H, W = Ysignal.shape
    K = state.K_max
    A = state.masked_A()
    C = state.masked_C()
    if sp.search_method == "dilate":
        masks = search_locations_dilate(A, radius=sp.dilate_radius)
    else:
        masks = torch.ones_like(A, dtype=torch.bool)
    masks = masks & state.active[:, None, None]
    Yd = Ysignal.reshape(T, H * W).T                 # (d, T)
    Ad = A.reshape(K, H * W).T                       # (d, K)
    Md = masks.reshape(K, H * W).T
    Ad = hals_spatial(Yd, Ad, C, mask=Md, n_iter=sp.n_iter)
    A_new = post_process_spatial(Ad.T.reshape(K, H, W), params)
    return state.replace(A=A_new * state.active[:, None, None])


def post_process_spatial(A: torch.Tensor,
                         params: CNMFEParams) -> torch.Tensor:
    """Keep each footprint's peak-connected blob; optional circular
    prior (``post_process_spatial.m``)."""
    sp = params.spatial
    if sp.connected:
        A = connectivity_constraint(A, se_size=3)
    if sp.circular:
        A = circular_constraint(A)
    return A
