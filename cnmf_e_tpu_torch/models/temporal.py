"""Temporal (C) update with batched deconvolution (port of
``cnmf_e_tpu/models/temporal.py``; reference
``update_temporal_parallel.m``, ``HALS_temporal.m:58-107`` and, with
``decorrelate``, ``decorrTemporal.m``)."""

from __future__ import annotations

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.hals import hals_temporal
from cnmf_e_tpu_torch.ops.noise import noise_psd
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from cnmf_e_tpu_torch.ops.spikes import decorr_temporal
from cnmf_e_tpu_torch.ops.stats import submedian_mean


def update_temporal(Ysignal: torch.Tensor, state: CNMFEState,
                    params: CNMFEParams) -> CNMFEState:
    """Update traces given footprints. Ysignal: (T, H, W) = Y - B."""
    tp = params.temporal
    T, H, W = Ysignal.shape
    K = state.K_max
    A = state.masked_A()
    Yd = Ysignal.reshape(T, H * W).T
    Ad = A.reshape(K, H * W).T
    C_raw, _ = hals_temporal(Yd, Ad, state.masked_C(), n_iter=tp.n_iter,
                             active=state.active)
    # per-trace baseline: mean of sub-median samples (HALS_temporal.m:79)
    C_raw = C_raw - submedian_mean(C_raw, dim=-1)[:, None]
    sn = noise_psd(C_raw)
    if tp.deconv.enabled:
        res = deconvolve(C_raw, tp.deconv, sn=sn)
        C_raw_new = C_raw - res.b[:, None]
        S_new = res.s
        g_new = res.g[:, :state.g.shape[1]]
        # keep the raw trace where deconvolution collapsed to zero
        dead = res.c.abs().sum(dim=-1) == 0
        C_new = torch.where(dead[:, None], C_raw_new, res.c)
    else:
        C_raw_new = C_raw
        C_new = C_raw - C_raw.amin(dim=-1, keepdim=True)
        S_new = torch.zeros_like(C_raw)
        g_new = state.g
    if tp.decorrelate and tp.deconv.enabled:
        C_new = decorr_temporal(C_new, S_new, A, g_new, sn,
                                gSiz=float(params.init.gSiz))
    act = state.active[:, None]
    return state.replace(
        C=torch.where(act, C_new, 0.0),
        C_raw=torch.where(act, C_raw_new, 0.0),
        S=torch.where(act, S_new, 0.0),
        g=torch.where(act, g_new, state.g),
        neuron_sn=torch.where(state.active, sn, 0.0))
