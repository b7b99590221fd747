"""Temporal batch mode: recordings longer than device memory (port of
``cnmf_e_tpu/models/batch.py``).

Reference: ``getReady_batch`` / ``initComponents_batch`` /
``update_{spatial,temporal,background}_batch`` / ``concatenate_temporal_batch``
(``Sources2D.m:268-325,708-738``): the movie splits into frame-range
batches; A is shared across batches (synchronized by cc-weighted
averaging, ``update_spatial_batch.m:20-35``), C solves per batch and
concatenates. The reference runs a background update and a residual
neuron pick for every batch and unions the neurons found
(``initComponents_batch.m:71-77``), so neurons that first fire late in a
long recording are found in their own batch.

The first batch runs the full pipeline; later batches inherit the global
A, fit their own background and traces, then pick new neurons from their
residual. If any batch added neurons, every batch's traces are refit
against the union A, and a final spatial-sync pass averages the per-batch
footprints (the frame-axis Gram sums add across batches).

``mesh``: :func:`fit_batches` on a (patch, frame) mesh of
``torch.distributed`` ranks (``parallel/mesh.py``), each rank holding its
(T_b / n_frame, H / n_patch, W) block of every batch, as
``CNMFE(mesh=...).fit`` holds its block of one movie. The projections and
the centroid moments sum over 'patch', the spatial sync's cc = sum_t C^2
over 'frame', and the per-trace median runs on whole traces. The traces
concatenate whole: each batch's traces go to K / n_patch whole traces a
patch rank (``comm.traces_to_neurons``), are joined along time and go
back to one contiguous frame range a rank (``comm.traces_to_frames``),
so the full-session QC and merges, which read neighbouring frames, see
the frames in order. Every rank returns the same full final state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.convert import gather_state, state_blocks
from cnmf_e_tpu_torch.models.background import (subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.initialize import (check_mesh_options,
                                                initialize_greedy)
from cnmf_e_tpu_torch.models.merge import merge_neurons
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models.qc import remove_false_positives, tag_neurons
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.ops.stats import median_mid
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import check_divisible
from cnmf_e_tpu_torch.utils.profiling import timed


def init_traces_given_A(Y: torch.Tensor, state: CNMFEState,
                        params: CNMFEParams, mesh=None) -> CNMFEState:
    """Solve C for a new frame batch with A fixed (reference:
    ``initTemporal.m``): rough C from the footprint projection, then the
    background and the full temporal update (HALS + deconvolution).
    ``mesh``: Y and the state are this rank's blocks; the median that
    sets each rough trace's baseline is taken on whole traces."""
    T = Y.shape[0]
    K = state.K_max
    Ad = state.masked_A().reshape(K, -1)
    aa = comm.psum((Ad * Ad).sum(dim=1), mesh, "patch")
    C0 = comm.psum(Ad @ Y.reshape(T, -1).T, mesh, "patch") \
        / torch.clamp(aa, min=1e-12)[:, None]
    C0 = comm.traces_to_neurons(C0, mesh)
    C0 = torch.clamp(C0 - median_mid(C0, dim=-1)[:, None], min=0.0)
    C0 = comm.traces_to_frames(C0, C0.shape[1], mesh)
    act = state.active[:, None]
    st = state.replace(C=C0 * act, C_raw=C0 * act, S=torch.zeros_like(C0))
    st = update_background(Y, st, params, mesh=mesh)
    return update_temporal(subtract_background(Y, st, params, mesh), st,
                           params, mesh)


def refit_traces_warm(Y: torch.Tensor, st_b: CNMFEState,
                      st_global: CNMFEState,
                      params: CNMFEParams, mesh=None) -> CNMFEState:
    """A-sync refit that keeps the batch's existing traces as the warm
    start (``initComponents_batch.m:87-113`` pads C with zeros for the new
    neurons and reruns the temporal update against the synchronized A)."""
    act = st_global.active[:, None]
    st = st_b.replace(A=st_global.A, g=st_global.g,
                      neuron_sn=st_global.neuron_sn,
                      active=st_global.active,
                      C=st_b.C * act, C_raw=st_b.C_raw * act,
                      S=st_b.S * act)
    st = update_background(Y, st, params, mesh=mesh)
    return update_temporal(subtract_background(Y, st, params, mesh), st,
                           params, mesh)


def _zero_rows(state: CNMFEState, idx: torch.Tensor) -> CNMFEState:
    """Deactivate slots ``idx`` and zero their footprints and traces."""
    def put(x, val):
        x = x.clone()
        x[idx] = val
        return x
    return state.replace(active=put(state.active, False),
                         A=put(state.A, 0.0), C=put(state.C, 0.0),
                         C_raw=put(state.C_raw, 0.0), S=put(state.S, 0.0))


def centroids(A: torch.Tensor, mesh=None) -> Tuple[np.ndarray, np.ndarray]:
    """Each footprint's centre of mass (cy, cx) in float64, rows counted
    over the whole field of view. ``mesh``: A is this rank's (K, H /
    n_patch, W) rows; the mass and the two first moments are summed over
    'patch'."""
    A = A.detach().cpu().numpy()
    _, H, W = A.shape
    y0 = 0 if mesh is None else mesh.p * H
    yy, xx = np.mgrid[y0:y0 + H, 0:W]
    moments = np.stack([A.sum(axis=(1, 2)), (A * yy).sum(axis=(1, 2)),
                        (A * xx).sum(axis=(1, 2))])
    if mesh is not None:
        moments = comm.psum(torch.as_tensor(moments, device=mesh.device),
                            mesh, "patch").cpu().numpy()
    mass = moments[0] + 1e-12
    return moments[1] / mass, moments[2] / mass


def residual_pick_batch(Y: torch.Tensor, state: CNMFEState,
                        params: CNMFEParams,
                        verbose: bool = False, mesh=None) -> CNMFEState:
    """Pick neurons the inherited A misses from this batch's residual
    (``initComponents_residual_parallel`` per batch,
    ``initComponents_batch.m:71-77``) into the state's free slots; their
    traces cover only this batch.

    Picks within ``merge.dmin_only`` of an existing neuron's centroid are
    dropped: a batch-local pick cannot be trace-correlated against neurons
    whose traces live in other batches, so distance is the only gate.
    ``mesh``: Y and the state are this rank's blocks."""
    before = state.active.cpu().numpy().copy()
    K = state.K_max
    resid = subtract_background(Y, state, params, mesh) - (
        state.masked_C().T @ state.masked_A().reshape(K, -1)
    ).reshape(Y.shape)
    state, _ = initialize_greedy(
        resid, params, state=state, min_corr=params.init.min_corr_res,
        min_pnr=params.init.min_pnr_res, verbose=verbose, mesh=mesh)
    del resid

    # the active masks are the same on every rank, so every rank takes
    # this branch (and its collective) alike
    new = state.active.cpu().numpy() & ~before
    if new.any() and before.any():
        cy, cx = centroids(state.A, mesh)
        old_idx = np.nonzero(before)[0]
        drop = [k for k in np.nonzero(new)[0]
                if np.hypot(cy[old_idx] - cy[k],
                            cx[old_idx] - cx[k]).min()
                <= params.merge.dmin_only]
        if drop:
            state = _zero_rows(state, torch.as_tensor(
                np.array(drop), device=Y.device))
    return state


def _union_new_neurons(st_global: CNMFEState, st_b: CNMFEState
                       ) -> Tuple[CNMFEState, np.ndarray]:
    """Copy neurons active in ``st_b`` but not in ``st_global`` (the
    batch's residual picks) into the global footprint set (under a mesh
    the rank's rows of them: the masks are replicated)."""
    new = st_b.active.cpu().numpy() & ~st_global.active.cpu().numpy()
    if not new.any():
        return st_global, new
    idx = torch.as_tensor(np.nonzero(new)[0], device=st_b.A.device)

    def take(x, y):
        x = x.clone()
        x[idx] = y[idx]
        return x
    active = st_global.active.clone()
    active[idx] = True
    return st_global.replace(
        A=take(st_global.A, st_b.A), g=take(st_global.g, st_b.g),
        neuron_sn=take(st_global.neuron_sn, st_b.neuron_sn),
        active=active), new


def sync_footprints(per_batch: Sequence[CNMFEState], movies,
                    params: CNMFEParams, mesh=None) -> torch.Tensor:
    """The cc-weighted average of the per-batch spatial updates
    (``update_spatial_batch.m:20-35``), cc = sum_t C^2 of each batch;
    ``movies``: each batch's movie, in order. ``mesh``: the states and
    movies are this rank's blocks, cc sums over 'frame', and the result
    is this rank's rows."""
    A_acc = w_acc = None
    for st_b, Yb in zip(per_batch, movies):
        st_sp = update_spatial(subtract_background(Yb, st_b, params, mesh),
                               st_b, params, mesh=mesh)
        cc = comm.psum((st_b.C ** 2).sum(dim=-1), mesh, "frame")
        contrib = st_sp.A * cc[:, None, None]
        A_acc = contrib if A_acc is None else A_acc + contrib
        w_acc = cc if w_acc is None else w_acc + cc
    return A_acc / torch.clamp(w_acc, min=1e-12)[:, None, None]


def concat_traces(per_batch: Sequence[CNMFEState], key: str,
                  mesh=None) -> torch.Tensor:
    """The traces ``key`` of every batch joined along time. ``mesh``: each
    batch's (K, T_b / n_frame) block goes whole to the patch ranks (K /
    n_patch whole traces each), the whole traces are joined, and the
    rank keeps its contiguous frames of the session: joining the blocks
    themselves would interleave the batches' frames."""
    whole = torch.cat([comm.traces_to_neurons(getattr(st, key), mesh)
                       for st in per_batch], dim=-1)
    return comm.traces_to_frames(whole, whole.shape[1], mesh)


def _check_batches(batches, params: CNMFEParams, mesh, device,
                   run_log) -> bool:
    """The mesh path's guards, before any stage runs, alike on every
    rank: a ValueError naming the batch and the dimension where the
    ranks' blocks differ (a batch whose frames or rows do not divide over
    the mesh) or do not pool alone, and K_max not divisible over 'patch'.
    Returns whether any rank was given a ``run_log``."""
    shapes = torch.tensor([tuple(Yb.shape) for Yb in batches]
                          + [(run_log is not None,) * 3],
                          dtype=torch.int64, device=device)
    hi = comm.all_reduce_max(shapes.clone(), None)     # the whole mesh
    lo = comm.all_reduce_min(shapes.clone(), None)
    for b in range(len(batches)):
        for i, name in enumerate(("T", "H", "W")):
            if int(hi[b, i]) != int(lo[b, i]):
                raise ValueError(
                    f"batch {b + 1}: the ranks' blocks differ in {name}: "
                    f"{int(lo[b, i])} to {int(hi[b, i])} ({name} does not "
                    f"divide over the mesh)")
    for b, Yb in enumerate(batches):
        try:
            check_mesh_options(params, mesh, tuple(Yb.shape))
        except ValueError as e:
            raise ValueError(f"batch {b + 1}: {e}") from None
    check_divisible(mesh, K=params.init.max_neurons)
    return bool(hi[-1, 0])


def fit_batches(batches: Sequence, params: Optional[CNMFEParams] = None,
                n_outer: int = 1, spatial_sync: bool = True,
                residual_pick: bool = True, verbose: bool = False,
                run_log=None, resume_from: Optional[str] = None,
                device="cuda", mesh=None,
                timer=None) -> Tuple[CNMFEState, List[CNMFEState]]:
    """Run batch-mode CNMF-E on ``device`` (the card unless the caller
    passes ``device="cpu"``).

    ``batches``: sequence of (T_b, H, W) arrays or tensors (or a
    MovieStore's ``iter_blocks()``). ``run_log`` / ``resume_from``: passed
    to the first batch's full fit; with a run_log, every later batch and
    the final state are snapshotted. Returns (state with concatenated
    traces, list of per-batch states). ``timer``: optional
    :class:`cnmf_e_tpu_torch.utils.profiling.StageTimer`; its stages are
    batch1 (the first batch's whole fit), traces, residual_pick, refit,
    spatial_sync, concat, qc_merge (the full-session QC, merges and
    tags) and, under a mesh, gather.

    ``mesh``: a :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh` (the module
    docstring); the device is the mesh's. Every rank calls
    ``fit_batches`` with the same arguments, ``batches`` holding its
    (T_b / n_frame, H / n_patch, W) block of each batch, and gets the
    same full final state; the per-batch states are the rank's blocks.
    ``run_log`` may be given on rank 0 alone: every rank gathers the
    snapshots' states alike, and only rank 0 writes."""
    params = params or CNMFEParams.preset_1p()
    device = torch.device(device) if mesh is None else mesh.device
    batches = list(batches)
    if not batches:
        raise ValueError("no batches")
    snapshots = run_log is not None
    if mesh is not None:
        snapshots = _check_batches(batches, params, mesh, device, run_log)
    lead = mesh is None or mesh.rank == 0
    writer = run_log if lead else None      # rank 0 writes the run log

    def log(m):
        if verbose and lead:
            print(f"[batch] {m}", flush=True)
        if writer is not None:
            writer.log(m)

    def snapshot(stage, st):
        # gather_state is a collective: every rank takes this branch
        if snapshots and mesh is not None:
            st = gather_state(st, mesh)
        if writer is not None:
            writer.snapshot(stage, st)

    def movie(Yb):
        return torch.as_tensor(Yb, dtype=torch.float32, device=device)

    # ---- batch 1: full pipeline -------------------------------------- #
    with timed(timer, "batch1"):
        st0 = CNMFE(params, device=device, mesh=mesh).fit(
            batches[0], n_outer=n_outer, verbose=verbose, run_log=run_log,
            resume_from=resume_from)
    if mesh is not None:
        st0 = state_blocks(st0, mesh)
    per_batch = [st0]
    st_global = st0
    n0 = int(st0.n_active())

    # ---- later batches: inherit A, fit bg + traces, pick residual ---- #
    for b, Yb in enumerate(batches[1:], start=2):
        Yb = movie(Yb)
        with timed(timer, "traces"):
            st_b = init_traces_given_A(Yb, st_global, params, mesh)
        if residual_pick:
            with timed(timer, "residual_pick"):
                st_b = residual_pick_batch(Yb, st_b, params,
                                           verbose=verbose, mesh=mesh)
                st_global, new = _union_new_neurons(st_global, st_b)
            if new.any():
                log(f"batch {b}: +{int(new.sum())} residual neurons "
                    f"(total {int(st_global.n_active())})")
        per_batch.append(st_b)
        snapshot(f"batch{b:02d}", st_b)
        log(f"batch {b}: traces fit ({int(st_b.n_active())} neurons)")

    # ---- A-sync: if any batch added neurons, refit every batch's traces
    # against the union A, warm (initComponents_batch.m:87-113); the
    # active mask is the same on every rank of a mesh ------------------
    if int(st_global.n_active()) > n0 and len(batches) > 1:
        log(f"A-union grew {n0} -> {int(st_global.n_active())}: "
            "refitting all batch traces (warm)")
        with timed(timer, "refit"):
            per_batch = [refit_traces_warm(movie(Yb), st_b, st_global,
                                           params, mesh)
                         for st_b, Yb in zip(per_batch, batches)]

    # ---- spatial sync: cc-weighted average of per-batch A ------------ #
    if spatial_sync and len(per_batch) > 1:
        with timed(timer, "spatial_sync"):
            A_sync = sync_footprints(per_batch, map(movie, batches), params,
                                     mesh)
        per_batch = [st.replace(A=A_sync, active=st_global.active)
                     for st in per_batch]

    # ---- concatenate traces over time -------------------------------- #
    with timed(timer, "concat"):
        final = per_batch[0].replace(
            C=concat_traces(per_batch, "C", mesh),
            C_raw=concat_traces(per_batch, "C_raw", mesh),
            S=concat_traces(per_batch, "S", mesh),
            active=st_global.active)

    # ---- full-session QC + merges over the concatenated traces ------- #
    k_before = int(final.n_active())
    with timed(timer, "qc_merge"):
        final = remove_false_positives(final, params, mesh=mesh)
        final, _ = merge_neurons(final, params, "dist_corr", mesh=mesh)
        final, _ = merge_neurons(final, params, "dist_only", mesh=mesh)
        final = tag_neurons(final, params, mesh)
    if int(final.n_active()) != k_before:
        log(f"full-session QC/merges: {k_before} -> "
            f"{int(final.n_active())} neurons")
    if mesh is not None:
        with timed(timer, "gather"):
            final = gather_state(final, mesh)
    if writer is not None:
        writer.snapshot("batch_final", final)
    return final, per_batch
