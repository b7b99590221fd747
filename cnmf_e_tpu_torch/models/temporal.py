"""Temporal (C) update with batched deconvolution (port of
``cnmf_e_tpu/models/temporal.py``; reference
``update_temporal_parallel.m``, ``HALS_temporal.m:58-107`` and, with
``decorrelate``, ``decorrTemporal.m``).

``mesh``: HALS on this rank's frames with A^T A and A^T Y summed over
'patch' (``ops/hals.py``); the baseline, the noise and the deconvolution
run on whole traces, K / n_patch of them a patch rank
(``comm.traces_to_neurons``), as in the step's mesh branch. Every
deconvolution family runs so, and ``decorrelate`` on the same whole
traces with the spikes of all K gathered over 'patch'."""

from __future__ import annotations

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.hals import hals_temporal
from cnmf_e_tpu_torch.ops.noise import noise_psd
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from cnmf_e_tpu_torch.ops.spikes import decorr_temporal
from cnmf_e_tpu_torch.ops.stats import submedian_mean
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import span


def update_temporal(Ysignal: torch.Tensor, state: CNMFEState,
                    params: CNMFEParams, mesh=None) -> CNMFEState:
    """Update traces given footprints. Ysignal: (T, H, W) = Y - B."""
    with span("update_temporal"):
        tp = params.temporal
        T, H, W = Ysignal.shape
        K = state.K_max
        A = state.masked_A()
        Yd = Ysignal.reshape(T, H * W).T
        Ad = A.reshape(K, H * W).T
        C_raw, _ = hals_temporal(Yd, Ad, state.masked_C(), n_iter=tp.n_iter,
                                 active=state.active, mesh=mesh)
        # whole traces from here on: this patch rank's rows under a mesh
        C_raw = comm.traces_to_neurons(C_raw, mesh)
        k0, k1 = (0, K) if mesh is None else mesh.neurons(K)
        active, g_old = state.active[k0:k1], state.g[k0:k1]
        # per-trace baseline: mean of sub-median samples
        # (HALS_temporal.m:79)
        with span("temporal.baseline"):
            C_raw = C_raw - submedian_mean(C_raw, dim=-1)[:, None]
        with span("temporal.noise"):
            sn = noise_psd(C_raw)
        if tp.deconv.enabled:
            with span("oasis.deconvolve"):
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
            g_new = g_old
        if tp.decorrelate and tp.deconv.enabled:
            C_new = decorr_temporal(C_new, S_new, A, g_new, sn,
                                    gSiz=float(params.init.gSiz), mesh=mesh)
        act = active[:, None]
        T_all = C_raw.shape[1]

        def frames(x):
            return comm.traces_to_frames(torch.where(act, x, 0.0), T_all,
                                         mesh)

        def neurons(x):
            return x if mesh is None else comm.all_gather_cat(
                x, 0, mesh.patch_group)
        return state.replace(
            C=frames(C_new), C_raw=frames(C_raw_new), S=frames(S_new),
            g=neurons(torch.where(act, g_new, g_old)),
            neuron_sn=neurons(torch.where(active, sn, 0.0)))
