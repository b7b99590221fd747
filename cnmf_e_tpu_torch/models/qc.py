"""Quality control: per-neuron defect tags, false-positive removal and
neuron ordering (port of ``cnmf_e_tpu/models/qc.py``; reference
``Sources2D.m:1683-1715`` tags, ``:744-759`` ``remove_false_positives``,
``:573-653`` ``orderROIs``).

``mesh``: :func:`tag_neurons` and :func:`remove_false_positives` on
this rank's blocks: pixel counts summed over 'patch', the trace
statistics on whole traces (K / n_patch a patch rank, the tags gathered
over 'patch'), so every rank holds the same tags and active mask. With
``active_pixels`` (the rank's rows) the footprints and the mask are
gathered over 'patch' and every rank runs the host's float64
``classify_components`` on the whole field of view, as one process
does."""

from __future__ import annotations

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.merge import decay_times
from cnmf_e_tpu_torch.models.pairing import classify_components
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.noise import noise_psd
from cnmf_e_tpu_torch.parallel import comm

TAG_FEW_PIXELS = 1
TAG_NO_SPIKES = 2
TAG_ZERO_RESIDUAL = 4
TAG_LOW_PNR = 8


def row_batches(K: int, rows: int):
    """Near-equal slices of range(K), each at most ``rows`` long."""
    Kb = -(-K // max(-(-K // max(rows, 1)), 1))
    return [slice(k0, min(k0 + Kb, K)) for k0 in range(0, K, Kb)]


def _trace_tags(S, C_raw, C, qc) -> torch.Tensor:
    """The trace defects of whole traces, one tag word a row."""
    i32 = torch.int32
    n_spikes = (S[:, 1:] > 0).sum(dim=-1)
    t = (n_spikes < qc.min_spike_count).to(i32) * TAG_NO_SPIKES
    resid_std = (C_raw - C).std(dim=-1, unbiased=False)
    raw_sn = noise_psd(C_raw)
    t = t + (resid_std / torch.clamp(raw_sn, min=1e-12) < 0.1
             ).to(i32) * TAG_ZERO_RESIDUAL
    pnr = C.amax(dim=-1) / torch.clamp(resid_std, min=1e-12)
    return t + (pnr < qc.min_pnr).to(i32) * TAG_LOW_PNR


def tag_neurons(state: CNMFEState, params: CNMFEParams,
                mesh=None, rows=None) -> CNMFEState:
    """Each neuron's defect tags (0 for an inactive slot). ``rows``: the
    trace statistics run on at most that many whole traces at a time
    (rows are independent; the Welch PSD frames a long C_raw)."""
    qc = params.qc
    npix = comm.psum((state.A > 0).sum(dim=(1, 2)), mesh, "patch")
    tags = (npix < qc.min_pixel).to(torch.int32) * TAG_FEW_PIXELS
    if params.temporal.deconv.enabled:
        S, C_raw, C = (comm.traces_to_neurons(x, mesh)
                       for x in (state.S, state.C_raw, state.C))
        n = S.shape[0]
        t = torch.cat([_trace_tags(S[sl], C_raw[sl], C[sl], qc)
                       for sl in row_batches(n, rows or n)])
        if mesh is not None:
            t = comm.all_gather_cat(t, 0, mesh.patch_group)
        tags = tags + t
    return state.replace(tags=torch.where(state.active, tags, 0))


def remove_false_positives(state: CNMFEState, params: CNMFEParams,
                           active_pixels=None, mesh=None) -> CNMFEState:
    """Deactivate neurons carrying any defect tag.

    ``active_pixels``: optional (H, W) bool mask of signal-bearing pixels;
    with it (and ``qc.classify_cl_thr > 0``) components keeping less than
    ``cl_thr`` of their l2 norm on the mask go too, the
    ``classify_components`` criterion (``classify_components.m:31-38``),
    decided on the host in float64. ``mesh``: ``active_pixels`` is this
    rank's rows of the mask."""
    state = tag_neurons(state, params, mesh)
    keep = state.active & (state.tags == 0)
    if active_pixels is not None and params.qc.classify_cl_thr > 0:
        K = state.K_max
        A, act = state.A, active_pixels
        if mesh is not None:
            A = comm.all_gather_cat(A, 1, mesh.patch_group)
            act = comm.all_gather_cat(torch.as_tensor(
                np.asarray(_host(act), np.uint8), device=A.device), 0,
                mesh.patch_group)
        keep_cl = classify_components(
            _host(A).reshape(K, -1).T, _host(act).reshape(-1),
            cl_thr=params.qc.classify_cl_thr)
        keep = keep & torch.as_tensor(keep_cl, device=keep.device)
    return _apply_keep(state, keep)


def _host(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


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


def _circularity(A: np.ndarray) -> np.ndarray:
    """Per-neuron circularity statistic (``Sources2D.m:611-622``): with
    the row and column profiles of each footprint (the reference's
    rank-1 ``nnmf`` factors are proportional to them for a nonnegative
    footprint), ky and kx count the profile entries above 0.3 of their
    peak; key = |(kx - ky + 0.5) / (kx + ky)^2| (small = round)."""
    w = A.sum(axis=2)                           # (K, H) row profile
    r = A.sum(axis=1)                           # (K, W) column profile
    ky = (w > 0.3 * w.max(axis=1, keepdims=True)).sum(axis=1)
    kx = (r > 0.3 * r.max(axis=1, keepdims=True)).sum(axis=1)
    return np.abs((kx - ky + 0.5) / np.maximum((kx + ky) ** 2, 1))


def _cluster_order(D: np.ndarray, active: np.ndarray) -> np.ndarray:
    """Complete linkage with optimal leaf ordering of a distance matrix
    (``Sources2D.m:623-637``, ``linkage`` / ``optimalleaforder``): a
    permutation placing similar neurons next to each other, inactive
    slots last."""
    from scipy.cluster import hierarchy
    from scipy.spatial.distance import squareform
    idx = np.nonzero(active)[0]
    rest = np.nonzero(~active)[0]
    if idx.size < 3:
        return np.concatenate([idx, rest]).astype(np.int32)
    Ds = np.maximum(D[np.ix_(idx, idx)], 0.0)
    np.fill_diagonal(Ds, 0.0)
    dd = squareform((Ds + Ds.T) / 2.0, checks=False)
    tree = hierarchy.linkage(dd, method="complete")
    leaves = hierarchy.leaves_list(hierarchy.optimal_leaf_ordering(tree, dd))
    return np.concatenate([idx[leaves], rest]).astype(np.int32)


def _cosine_distance(X: np.ndarray) -> np.ndarray:
    X = np.asarray(X, np.float64)
    Xn = X / (np.linalg.norm(X, axis=1) + 1e-12)[:, None]
    return 1.0 - Xn @ Xn.T


_CLUSTER_KEYS = ("temporal_cluster", "spatial_cluster")


def order_key(state: CNMFEState, by: str):
    """(key (K,), descending) of one of ``orderROIs``' sort keys
    (``Sources2D.m:573-653``) other than the two cluster orders."""
    K = state.K_max
    A2 = state.A.reshape(K, -1)
    dev = state.A.device
    if by in ("snr", "pnr"):
        resid = (state.C_raw - state.C).std(dim=-1, correction=0)
        if by == "snr":
            return state.C.var(dim=-1, correction=0) / torch.clamp(
                resid ** 2, min=1e-12), True
        # Sources2D.m:620-622
        return state.C.amax(dim=-1) / torch.clamp(resid, min=1e-12), True
    if by == "energy":
        return (state.A ** 2).sum(dim=(1, 2)) * (state.C ** 2).sum(dim=-1), \
            True
    if by == "mean":                           # Sources2D.m:598-604
        return state.C.mean(dim=-1) * A2.sum(dim=-1), True
    if by == "decay_time":                     # the reference ascends
        return torch.as_tensor(decay_times(state), device=dev), False
    if by == "sparsity_spatial":
        return torch.sqrt((A2 ** 2).sum(dim=-1)) / torch.clamp(
            A2.abs().sum(dim=-1), min=1e-12), False
    if by == "sparsity_temporal":
        return torch.sqrt((state.C_raw ** 2).sum(dim=-1)) / torch.clamp(
            state.C_raw.abs().sum(dim=-1), min=1e-12), True
    if by == "circularity":
        return torch.as_tensor(_circularity(_host(state.A)), device=dev), \
            False
    raise ValueError(f"unknown order key {by!r}")


def order_neurons(state: CNMFEState, by: str = "snr") -> torch.Tensor:
    """Sort permutation of the neuron slots by one of ``orderROIs``' keys
    (``Sources2D.m:573-653``): snr, pnr, energy, mean, decay_time,
    sparsity_spatial, sparsity_temporal, circularity (these by a stable
    sort of :func:`order_key`, inactive slots last), temporal_cluster,
    spatial_cluster (a leaf order of the cosine-distance dendrogram of
    C_raw or A). Returns the permutation on the state's device;
    :func:`apply_order` applies it."""
    if by in _CLUSTER_KEYS:
        X = state.C_raw if by == "temporal_cluster" else \
            state.A.reshape(state.K_max, -1)
        perm = _cluster_order(_cosine_distance(_host(X)), _host(state.active))
        return torch.as_tensor(perm, device=state.A.device)
    key, descend = order_key(state, by)
    key = torch.where(state.active, key, -torch.inf if descend else torch.inf)
    return torch.argsort(-key if descend else key, stable=True)


def apply_order(state: CNMFEState, perm) -> CNMFEState:
    """Permute every per-neuron tensor of the state by ``perm``
    (``orderROIs``' tail, ``Sources2D.m:641-652``)."""
    perm = torch.as_tensor(perm, dtype=torch.long, device=state.A.device)
    return state.replace(
        A=state.A[perm], C=state.C[perm], C_raw=state.C_raw[perm],
        S=state.S[perm], g=state.g[perm], neuron_sn=state.neuron_sn[perm],
        active=state.active[perm],
        tags=None if state.tags is None else state.tags[perm])
