"""Neuron merging (port of ``cnmf_e_tpu/models/merge.py``: the
dist_corr, high_corr and dist_only modes, their candidate graphs on the
host, and the manual ``merge_pairs``; reference
``merge_neurons_dist_corr.m``, ``merge_high_corr.m``,
``merge_close_neighbors.m``).

Pairwise statistics are (K, K) matmuls; a cluster is a connected component
of the candidate graph; each cluster is refit rank-1 (alternating least
squares, batched over clusters as masked matmuls) into the slot of its
highest-energy member, whose trace is then re-deconvolved.
:func:`merge_neurons` finds components on the device (transitive closure
by repeated squaring); :func:`merge_neurons_seq` fetches the adjacency
once and labels its components on the host (:func:`connected_components`).

``mesh``: the state is this rank's blocks. The statistics are sums over
'patch' (centroids, A A^T, norms, the footprint peaks by
``comm.argmax_rows``) and over 'frame' (the trace correlations; the
spikes' difference takes the previous rank's last frame), so every rank
holds the same (K, K) statistics and takes the same clusters. The
rank-1 refit sums C_raw c^T over 'frame' and A a^T over 'patch'; the
re-deconvolution runs on whole traces, K / n_patch a patch rank.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components as _csgraph_cc

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.ops.noise import noise_psd
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from cnmf_e_tpu_torch.parallel import comm

_PLANES = {"dist_corr": 0, "dist_only": 1, "high_corr": 2}


def connected_components(adj: np.ndarray) -> Tuple[np.ndarray, int]:
    """Connected components of a dense symmetric adjacency (n, n), the
    diagonal ignored. Returns (labels (n,) int32, n_components), the labels
    compact and numbered in the order of each component's smallest node,
    as ``cnmf_e_tpu/native/graph_cc.cpp`` numbers them."""
    adj = np.asarray(adj) != 0
    n = adj.shape[0]
    if n == 0:
        return np.empty(0, np.int32), 0
    ncomp, raw = _csgraph_cc(csr_matrix(adj), directed=False)
    # renumber by first appearance: component of node 0 first, and so on
    _, first = np.unique(raw, return_index=True)
    rank = np.empty(ncomp, np.int32)
    rank[np.argsort(first)] = np.arange(ncomp, dtype=np.int32)
    return rank[raw], int(ncomp)


def decay_times(state: CNMFEState) -> np.ndarray:
    """Per-neuron decay time constant (frames), -1 / log(d) of the
    dominant AR root (``Sources2D.m:585-596``)."""
    g = state.g.detach().cpu().numpy()
    if g.shape[1] == 1:
        d = np.clip(g[:, 0], 1e-4, 1 - 1e-6)
    else:
        g1, g2 = g[:, 0], g[:, 1]
        d = np.clip((g1 + np.sqrt(np.maximum(g1 * g1 + 4 * g2, 0.0))) / 2.0,
                    1e-4, 1 - 1e-6)
    return -1.0 / np.log(d)


def _corr_rows(X: torch.Tensor, mesh=None) -> torch.Tensor:
    Xc = X - comm.frame_mean(X, 1, mesh, keepdim=True)
    n = comm.norm(Xc, 1, mesh, "frame") + 1e-12
    return comm.psum(Xc @ Xc.T, mesh, "frame") / torch.outer(n, n)


def _prev_frame(X: torch.Tensor, mesh) -> torch.Tensor:
    """The column before this rank's first frame of (K, T/frame) traces:
    zeros at the first frame, else the previous 'frame' rank's last."""
    zeros = torch.zeros_like(X[:, :1])
    if mesh is None or mesh.n_frame == 1:
        return zeros
    last = comm.all_gather_cat(X[:, -1:], 1, mesh.frame_group)
    return last[:, mesh.f - 1:mesh.f] if mesh.f > 0 else zeros


def _merge_stats(state: CNMFEState, mesh=None) -> torch.Tensor:
    """All pairwise merge statistics, stacked (10, K, K): dist_mean,
    corr_C, cos_A, corr_Craw, corr_S, energy, active, g1, g2, dist_max
    (rows 5-8 broadcast per-neuron vectors)."""
    K = state.K_max
    A3 = state.masked_A()
    Hl, W = A3.shape[1:]
    h0 = 0 if mesh is None else mesh.p * Hl
    dev = A3.device
    mass = comm.psum(A3.sum(dim=(1, 2)), mesh, "patch") + 1e-12
    yy = torch.arange(h0, h0 + Hl, dtype=A3.dtype, device=dev)
    cy = comm.psum((A3 * yy[None, :, None]).sum(dim=(1, 2)), mesh,
                   "patch") / mass
    cx = comm.psum((A3 * torch.arange(W, dtype=A3.dtype, device=dev)[
        None, None, :]).sum(dim=(1, 2)), mesh, "patch") / mass

    def pair_dist(cy, cx):
        dy = cy[:, None] - cy[None, :]
        dx = cx[:, None] - cx[None, :]
        return torch.sqrt(dy * dy + dx * dx)

    pk = comm.argmax_rows(A3, mesh)
    A = A3.reshape(K, -1)
    na = comm.norm(A, 1, mesh, "patch") + 1e-12
    Sdiff = torch.clamp(torch.diff(state.C_raw, dim=1, prepend=_prev_frame(
        state.C_raw, mesh)), min=0.0)
    any_s = comm.pmax((state.S != 0).any().to(torch.int32), mesh, "frame")
    corr_S = torch.where(any_s > 0, _corr_rows(state.S, mesh),
                         _corr_rows(Sdiff, mesh))
    energy = comm.psum((state.A * state.A).sum(dim=(1, 2)), mesh, "patch") \
        * comm.psum((state.C_raw * state.C_raw).sum(dim=1), mesh, "frame")
    g2 = (state.g[:, 1] if state.g.shape[1] > 1
          else torch.zeros(K, dtype=torch.float32, device=dev))

    def row(v):
        return torch.broadcast_to(v.to(torch.float32)[None, :], (K, K))

    cos_A = comm.psum(A @ A.T, mesh, "patch") / torch.outer(na, na)
    return torch.stack([
        pair_dist(cy, cx), _corr_rows(state.C, mesh), cos_A,
        _corr_rows(state.C_raw, mesh), corr_S, row(energy),
        row(state.active), row(state.g[:, 0]), row(g2),
        pair_dist((pk // W).to(A3.dtype), (pk % W).to(A3.dtype))])


def _adjacency(state: CNMFEState, params: CNMFEParams, st: torch.Tensor,
               plane: int) -> torch.Tensor:
    """Candidate graph of one merge mode over active neurons, zero
    diagonal: 0 = dist_corr (with the optional decay gate), 1 = dist_only,
    2 = high_corr."""
    mp = params.merge
    K = state.K_max
    dist = st[9] if mp.method_dist == "max" else st[0]
    if plane == 0:
        adj = (dist <= mp.dmin) & (st[1] >= mp.merge_thr)
        if mp.max_decay_diff is not None:
            g1, g2 = st[7][0], st[8][0]
            d = (g1 + torch.sqrt(torch.clamp(g1 * g1 + 4 * g2, min=0.0))) / 2
            tau = -1.0 / torch.log(torch.clamp(d, 1e-4, 1 - 1e-6))
            adj &= (tau[:, None] - tau[None, :]).abs() <= mp.max_decay_diff
    elif plane == 1:
        adj = dist <= mp.dmin_only
    else:
        a_thr, c_thr, s_thr = mp.merge_thr_spatial
        adj = torch.ones((K, K), dtype=torch.bool, device=st.device)
        if a_thr > 0:
            adj &= st[2] >= a_thr
        if c_thr > 0:
            adj &= st[3] >= c_thr
        if s_thr > 0:
            adj &= st[4] >= s_thr
    off = ~torch.eye(K, dtype=torch.bool, device=st.device)
    return adj & torch.outer(state.active, state.active) & off


def _candidates(state: CNMFEState, params: CNMFEParams, stats,
                plane: int) -> np.ndarray:
    st = (_merge_stats(state) if stats is None
          else torch.as_tensor(stats, device=state.A.device))
    return _adjacency(state, params, st, plane).cpu().numpy()


def merge_candidates_dist_corr(state: CNMFEState, params: CNMFEParams,
                               stats=None) -> np.ndarray:
    """Host adjacency (K, K) bool for distance + correlation merging
    (``merge_neurons_dist_corr.m:54-82``, with the optional decay-time
    gate of ``:74-81``). ``stats``: the (10, K, K) statistics of
    :func:`_merge_stats`, when the caller has them already."""
    return _candidates(state, params, stats, _PLANES["dist_corr"])


def merge_candidates_high_corr(state: CNMFEState, params: CNMFEParams,
                               stats=None) -> np.ndarray:
    """Host adjacency for the (A overlap, C corr, S corr) triple threshold
    (``merge_high_corr.m:50-83``, ``quickMerge.m:34-60``)."""
    return _candidates(state, params, stats, _PLANES["high_corr"])


def merge_candidates_dist_only(state: CNMFEState, params: CNMFEParams,
                               stats=None) -> np.ndarray:
    """Host adjacency of the active neurons whose centres lie within
    ``dmin_only`` (``merge_close_neighbors.m``)."""
    return _candidates(state, params, stats, _PLANES["dist_only"])


def _merge_adjacency(state: CNMFEState, params: CNMFEParams, mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The three candidate graphs (3, K, K) and the energy rank (K,) of
    every neuron (cluster survivor = highest rank)."""
    st = _merge_stats(state, mesh)
    adj = torch.stack([_adjacency(state, params, st, p) for p in range(3)])
    rank = torch.argsort(torch.argsort(st[5][0], stable=True), stable=True)
    return adj, rank


def _cluster_device(state: CNMFEState, params: CNMFEParams, plane: int,
                    mesh=None):
    """Connected components and cluster bookkeeping on the device:
    reachability closes by ceil(log2 K) squarings of (adj | I).

    Returns (members (K//2, K) f32, keep (K//2,) survivor slots,
    valid (K//2,) bool, n_clusters scalar)."""
    K = state.K_max
    dev = state.A.device
    st = _merge_stats(state, mesh)
    adj = _adjacency(state, params, st, plane)
    R = (adj | torch.eye(K, dtype=torch.bool, device=dev)).to(torch.float32)
    for _ in range(max(int(np.ceil(np.log2(max(K, 2)))), 1)):
        R = ((R @ R) > 0).to(torch.float32)
    comp_min = R.argmax(dim=1)                 # first reachable = root id
    valid_node = adj.any(dim=1)
    idx = torch.arange(K, device=dev)
    root = (comp_min == idx) & valid_node
    slot_of = (torch.cumsum(root.long(), 0) - 1)[comp_min]
    Kc = max(K // 2, 1)
    members = ((slot_of[None, :] == torch.arange(Kc, device=dev)[:, None])
               & valid_node[None, :]).to(torch.float32)
    e_m = torch.where(members > 0, st[5][0][None, :], -torch.inf)
    keep = e_m.argmax(dim=1)
    valid = (members > 0).any(dim=1)
    return members, keep, valid, root.sum()


def _merge_apply(state: CNMFEState, members: torch.Tensor,
                 keep: torch.Tensor, valid: torch.Tensor, refit_iters: int,
                 mesh=None) -> Tuple[CNMFEState, torch.Tensor]:
    """Apply all cluster merges: rank-1 refit of each valid cluster
    (``merge_neurons_dist_corr.m:180-187``) into its survivor slot, other
    members deactivated. Returns (state, merged_mask (K,) bool of slots
    holding a freshly merged trace)."""
    K = state.K_max
    dev = state.A.device
    A = state.A.reshape(K, -1)
    C_raw = state.C_raw
    a = members @ A
    c = C_raw[torch.clamp(keep, 0, K - 1)]
    for _ in range(refit_iters):
        Wm = members * comm.psum(C_raw @ c.T, mesh, "frame").T
        a = torch.clamp(Wm @ A, min=0.0) / torch.clamp(comm.psum(
            (c * c).sum(dim=1, keepdim=True), mesh, "frame"), min=1e-12)
        Vm = members * comm.psum(A @ a.T, mesh, "patch").T
        c = torch.clamp(Vm @ C_raw, min=0.0) / torch.clamp(comm.psum(
            (a * a).sum(dim=1, keepdim=True), mesh, "patch"), min=1e-12)
    # invalid clusters scatter into a spare row K that is dropped
    keep_slot = torch.where(valid, keep, K)
    member_of_valid = (valid.to(members.dtype) @ members) > 0

    def put(x, val):
        xp = torch.cat([x, torch.zeros_like(x[:1])])
        xp[keep_slot] = val
        return xp[:K]

    active = put(state.active & ~member_of_valid,
                 torch.ones_like(keep_slot, dtype=torch.bool))
    merged = put(torch.zeros(K, dtype=torch.bool, device=dev),
                 torch.ones_like(keep_slot, dtype=torch.bool))
    zero = ~member_of_valid[:, None]
    state = state.replace(
        A=put(torch.where(zero, A, 0.0), a).reshape(state.A.shape),
        C=put(torch.where(zero, state.C, 0.0), c),
        C_raw=put(torch.where(zero, C_raw, 0.0), c),
        S=state.S * active[:, None], active=active)
    return state, merged


def _deconv_writeback(state: CNMFEState, merged_mask, c, s, b, g
                      ) -> CNMFEState:
    m = merged_mask[:, None]
    return state.replace(
        C=torch.where(m, c, state.C),
        C_raw=torch.where(m, state.C_raw - b[:, None], state.C_raw),
        S=torch.where(m, s, state.S),
        g=torch.where(m, g[:, :state.g.shape[1]], state.g))


def _redeconvolve(state: CNMFEState, params: CNMFEParams,
                  merged_mask: torch.Tensor, mesh=None) -> CNMFEState:
    rows = comm.traces_to_neurons(state.C_raw, mesh)     # whole traces
    sn = noise_psd(rows)
    res = deconvolve(rows, params.temporal.deconv, sn=sn)
    if mesh is None:
        return _deconv_writeback(state, merged_mask, res.c, res.s, res.b,
                                 res.g)
    T = rows.shape[1]
    bg = comm.all_gather_cat(torch.cat([res.b[:, None], res.g], dim=1), 0,
                             mesh.patch_group)
    return _deconv_writeback(state, merged_mask,
                             comm.traces_to_frames(res.c, T, mesh),
                             comm.traces_to_frames(res.s, T, mesh),
                             bg[:, 0].contiguous(),
                             bg[:, 1:].contiguous())


def merge_neurons(state: CNMFEState, params: CNMFEParams,
                  mode: str = "dist_corr", deconv: bool = True, mesh=None
                  ) -> Tuple[CNMFEState, torch.Tensor]:
    """Cluster candidates and merge each cluster by rank-1 refit. Returns
    (state, n_clusters) with n_clusters a device scalar; ``deconv=False``
    defers re-deconvolution of merged traces to a following temporal
    update."""
    members, keep, valid, nm = _cluster_device(state, params, _PLANES[mode],
                                               mesh)
    state, merged_mask = _merge_apply(state, members, keep, valid,
                                      refit_iters=params.merge.refit_iters,
                                      mesh=mesh)
    if deconv and params.temporal.deconv.enabled:
        state = _redeconvolve(state, params, merged_mask, mesh)
    return state, nm


def _merge_with_adjacency(state: CNMFEState, params: CNMFEParams,
                          adj: np.ndarray, rank: np.ndarray,
                          active: np.ndarray, deconv: bool = True,
                          mesh=None) -> Tuple[CNMFEState, int]:
    if not adj.any():
        return state, 0
    labels, ncomp = connected_components(adj)
    K = state.K_max
    Kc = max(K // 2, 1)
    members = np.zeros((Kc, K), np.float32)
    keep = np.zeros((Kc,), np.int64)
    valid = np.zeros((Kc,), bool)
    n_merged = 0
    for comp in range(ncomp):
        ids = np.nonzero((labels == comp) & active)[0]
        if len(ids) < 2 or not adj[np.ix_(ids, ids)].any():
            continue
        members[n_merged, ids] = 1.0
        keep[n_merged] = ids[int(np.argmax(rank[ids]))]
        valid[n_merged] = True
        n_merged += 1
    if n_merged == 0:
        return state, 0
    dev = state.A.device
    state, merged_mask = _merge_apply(
        state, torch.as_tensor(members, device=dev),
        torch.as_tensor(keep, device=dev), torch.as_tensor(valid, device=dev),
        refit_iters=params.merge.refit_iters, mesh=mesh)
    if deconv and params.temporal.deconv.enabled:
        state = _redeconvolve(state, params, merged_mask, mesh)
    return state, n_merged


def merge_pairs(state: CNMFEState, params: CNMFEParams, pairs,
                deconv: bool = True) -> Tuple[CNMFEState, int]:
    """Merge the given (i, j) slot pairs (reference: ``manual_merge`` /
    ``manual_merge_multi_pairs``), the automated replacement for the
    interactive flows. Pairs that chain form one cluster, refit into the
    slot of its highest-energy member."""
    K = state.K_max
    adj = np.zeros((K, K), bool)
    for i, j in pairs:
        if not (0 <= i < K and 0 <= j < K):
            raise ValueError(f"merge pair ({i}, {j}) is outside slots "
                             f"0..{K - 1}")
        adj[i, j] = adj[j, i] = True
    energy = _merge_stats(state)[5][0].cpu().numpy()
    return _merge_with_adjacency(state, params, adj, energy,
                                 state.active.cpu().numpy(), deconv=deconv)


def merge_neurons_seq(state: CNMFEState, params: CNMFEParams, modes,
                      deconv: bool = True, mesh=None
                      ) -> Tuple[CNMFEState, int]:
    """Several merge modes back to back on one adjacency fetch (refetched
    only after a mode actually merged). Returns (state, total clusters).
    Under a mesh every rank fetches the same adjacency, so every rank
    takes the same branches."""
    fetched = None
    total = 0
    for mode in modes:
        if fetched is None:
            adj3, rank = _merge_adjacency(state, params, mesh)
            fetched = (adj3.cpu().numpy(), rank.cpu().numpy(),
                       state.active.cpu().numpy())
        adj3, rank, active = fetched
        state2, nm = _merge_with_adjacency(state, params, adj3[_PLANES[mode]],
                                           rank, active, deconv=deconv,
                                           mesh=mesh)
        if nm:
            state, fetched = state2, None
        total += nm
    return state, total
