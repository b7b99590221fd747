"""Background update and evaluation: the ring model or the event-masked
local ring model (1p), or the low-rank svd/nmf model (2p) (port of
``cnmf_e_tpu/models/background.py``; reference
``update_background_parallel.m``).

``mesh``: every model on this rank's blocks: the ring and the local
models with halo rows from the patch neighbours (``ops/ring.py``), the
low-rank ones with their products summed over the mesh
(``ops/lowrank.py``). The state is this rank's blocks, and so is what
each function returns."""

from __future__ import annotations

from typing import Optional

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.lowrank import fit_lowrank_model
from cnmf_e_tpu_torch.ops.filters import box_downsample, resize_linear
from cnmf_e_tpu_torch.ops.ring import (_ssub_geometry, apply_ring,
                                       fit_ring_model, local_background,
                                       reconstruct_ring_background)
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import span


def _neuron_free(Y: torch.Tensor, state: CNMFEState) -> torch.Tensor:
    """Ybg = Y - A C over the active neurons."""
    T, H, W = Y.shape
    A = state.masked_A()
    return Y - (state.masked_C().T @ A.reshape(A.shape[0], -1)
                ).reshape(T, H, W)


def update_background(Y: torch.Tensor, state: CNMFEState,
                      params: CNMFEParams,
                      sn_pix: Optional[torch.Tensor] = None,
                      mesh=None) -> CNMFEState:
    """Refit the background model given the current (A, C). Y: (T, H, W)."""
    with span("update_background"):
        bp = params.background
        if bp.model == "ring":
            weights, b0, _ = fit_ring_model(
                Y, state.masked_A(), state.masked_C(), radius=bp.ring_radius,
                W_old=state.W, sn=sn_pix, thresh_outlier=bp.thresh_outlier,
                frame_cap_factor=bp.frame_cap_factor, ridge_eps=bp.ridge_eps,
                ssub=bp.ssub, mesh=mesh)
            return state.replace(W=weights, b0=b0)
        if bp.model == "local":
            # on Ybg = Y - A C, so transients the event mask misses cannot
            # bias the ring weights (Sources2D.m:1717-1733, localBG)
            _, weights, b0 = local_background(
                _neuron_free(Y, state), radius=bp.ring_radius, sn=sn_pix,
                ssub=bp.ssub, ridge_eps=bp.ridge_eps, mesh=mesh)
            return state.replace(W=weights, b0=b0)
        b, f, b0 = fit_lowrank_model(Y, state.masked_A(), state.masked_C(),
                                     rank=bp.rank, mode=bp.model, mesh=mesh)
        return state.replace(b=b, f=f, b0=b0)


def background_of(Y: torch.Tensor, state: CNMFEState,
                  params: CNMFEParams, mesh=None) -> torch.Tensor:
    """The current background estimate B (T, H, W)."""
    bp = params.background
    if bp.model in ("ring", "local") and state.W is None:
        return torch.broadcast_to(state.b0[None], Y.shape)
    if bp.model == "ring":
        return reconstruct_ring_background(
            state.W, Y, state.masked_A(), state.masked_C(), state.b0,
            radius=bp.ring_radius, ssub=bp.ssub, mesh=mesh)
    if bp.model == "local":
        # the stored weights' prediction, no refit:
        # B = W (Ybg - mean(Ybg) + 1) + b0 (local_background.m:148-150)
        T, H, W = Y.shape
        Ybg = _neuron_free(Y, state)
        Yc = Ybg - comm.frame_mean(Ybg, 0, mesh)[None] + 1.0
        del Ybg
        Hf = H if mesh is None else H * mesh.n_patch
        Hs, Ws, radius_s = _ssub_geometry(Hf, W, bp.ring_radius, bp.ssub)
        if bp.ssub > 1:
            Yc = box_downsample(Yc, ssub=bp.ssub)
        Yest = apply_ring(state.W, Yc, Hs, Ws, radius_s,
                          include_intercept=False, mesh=mesh)
        if bp.ssub > 1:
            Yest = resize_linear(Yest, (H, W), mesh=mesh)
        return Yest + state.b0[None]
    if state.b is None:
        return torch.broadcast_to(state.b0[None], Y.shape)
    rank = state.b.shape[0]
    return (state.f.T @ state.b.reshape(rank, -1)).reshape(Y.shape) \
        + state.b0[None]


def subtract_background(Y: torch.Tensor, state: CNMFEState,
                        params: CNMFEParams, mesh=None) -> torch.Tensor:
    """Ysignal = Y - B, the input to the factor updates."""
    with span("subtract_background"):
        return Y - background_of(Y, state, params, mesh=mesh)


def residual_movie(Y: torch.Tensor, state: CNMFEState,
                   params: CNMFEParams, mesh=None) -> torch.Tensor:
    """Y - B - A C: the input to the residual neuron pick
    (``initComponents_residual_parallel.m:189-199``)."""
    T, H, W = Y.shape
    A = state.masked_A()
    AC = (state.masked_C().T @ A.reshape(A.shape[0], -1)).reshape(T, H, W)
    return subtract_background(Y, state, params, mesh=mesh) - AC
