"""Quality control: per-neuron defect tags and false-positive removal
(port of ``tag_neurons`` / ``remove_false_positives`` /
``delete_neurons`` / ``_apply_keep`` of ``cnmf_e_tpu/models/qc.py``;
reference ``Sources2D.m:1683-1715,744-759``).
The ``classify_components`` criterion (``qc.classify_cl_thr > 0`` with an
active-pixel mask) is not ported."""

from __future__ import annotations

import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.noise import noise_psd

TAG_FEW_PIXELS = 1
TAG_NO_SPIKES = 2
TAG_ZERO_RESIDUAL = 4
TAG_LOW_PNR = 8


def tag_neurons(state: CNMFEState, params: CNMFEParams) -> CNMFEState:
    qc = params.qc
    i32 = torch.int32
    npix = (state.A > 0).sum(dim=(1, 2))
    tags = (npix < qc.min_pixel).to(i32) * TAG_FEW_PIXELS
    if params.temporal.deconv.enabled:
        n_spikes = (state.S[:, 1:] > 0).sum(dim=-1)
        tags = tags + (n_spikes < qc.min_spike_count).to(i32) * TAG_NO_SPIKES
        resid_std = (state.C_raw - state.C).std(dim=-1, unbiased=False)
        raw_sn = noise_psd(state.C_raw)
        tags = tags + (resid_std / torch.clamp(raw_sn, min=1e-12) < 0.1
                       ).to(i32) * TAG_ZERO_RESIDUAL
        pnr = state.C.amax(dim=-1) / torch.clamp(resid_std, min=1e-12)
        tags = tags + (pnr < qc.min_pnr).to(i32) * TAG_LOW_PNR
    return state.replace(tags=torch.where(state.active, tags, 0))


def remove_false_positives(state: CNMFEState, params: CNMFEParams,
                           active_pixels=None) -> CNMFEState:
    """Deactivate neurons carrying any defect tag."""
    if active_pixels is not None and params.qc.classify_cl_thr > 0:
        raise NotImplementedError("classify_components QC is not ported")
    state = tag_neurons(state, params)
    return _apply_keep(state, state.active & (state.tags == 0))


def delete_neurons(state: CNMFEState, indices) -> CNMFEState:
    """Deactivate neurons by slot index (reference ``Sources2D.delete``,
    ``Sources2D.m:762-814``; also the consumer of the HTML report's
    ``decisions.json`` rejected list, ``utils/report.py``)."""
    idx = torch.as_tensor(indices, dtype=torch.long,
                          device=state.active.device).reshape(-1)
    K = state.K_max
    if idx.numel() and not bool(((idx >= 0) & (idx < K)).all()):
        raise ValueError(f"slot indices outside 0..{K - 1}: {indices}")
    drop = torch.zeros_like(state.active)
    drop[idx] = True
    return _apply_keep(state, state.active & ~drop)


def _apply_keep(state: CNMFEState, keep: torch.Tensor) -> CNMFEState:
    """Deactivate the slots where ``keep`` is False and zero their
    footprints and traces."""
    return state.replace(
        active=keep,
        A=state.A * keep[:, None, None],
        C=state.C * keep[:, None],
        C_raw=state.C_raw * keep[:, None],
        S=state.S * keep[:, None])
