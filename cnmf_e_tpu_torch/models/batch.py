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
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.background import (subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models.qc import remove_false_positives, tag_neurons
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.ops.stats import median_mid


def init_traces_given_A(Y: torch.Tensor, state: CNMFEState,
                        params: CNMFEParams) -> CNMFEState:
    """Solve C for a new frame batch with A fixed (reference:
    ``initTemporal.m``): rough C from the footprint projection, then the
    background and the full temporal update (HALS + deconvolution)."""
    T = Y.shape[0]
    K = state.K_max
    Ad = state.masked_A().reshape(K, -1)
    aa = (Ad * Ad).sum(dim=1)
    C0 = (Ad @ Y.reshape(T, -1).T) / torch.clamp(aa, min=1e-12)[:, None]
    C0 = torch.clamp(C0 - median_mid(C0, dim=-1)[:, None], min=0.0)
    act = state.active[:, None]
    st = state.replace(C=C0 * act, C_raw=C0 * act, S=torch.zeros_like(C0))
    st = update_background(Y, st, params)
    return update_temporal(subtract_background(Y, st, params), st, params)


def refit_traces_warm(Y: torch.Tensor, st_b: CNMFEState,
                      st_global: CNMFEState,
                      params: CNMFEParams) -> CNMFEState:
    """A-sync refit that keeps the batch's existing traces as the warm
    start (``initComponents_batch.m:87-113`` pads C with zeros for the new
    neurons and reruns the temporal update against the synchronized A)."""
    act = st_global.active[:, None]
    st = st_b.replace(A=st_global.A, g=st_global.g,
                      neuron_sn=st_global.neuron_sn,
                      active=st_global.active,
                      C=st_b.C * act, C_raw=st_b.C_raw * act,
                      S=st_b.S * act)
    st = update_background(Y, st, params)
    return update_temporal(subtract_background(Y, st, params), st, params)


def _zero_rows(state: CNMFEState, idx: torch.Tensor) -> CNMFEState:
    """Deactivate slots ``idx`` and zero their footprints and traces."""
    def put(x, val):
        x = x.clone()
        x[idx] = val
        return x
    return state.replace(active=put(state.active, False),
                         A=put(state.A, 0.0), C=put(state.C, 0.0),
                         C_raw=put(state.C_raw, 0.0), S=put(state.S, 0.0))


def residual_pick_batch(Y: torch.Tensor, state: CNMFEState,
                        params: CNMFEParams,
                        verbose: bool = False) -> CNMFEState:
    """Pick neurons the inherited A misses from this batch's residual
    (``initComponents_residual_parallel`` per batch,
    ``initComponents_batch.m:71-77``) into the state's free slots; their
    traces cover only this batch.

    Picks within ``merge.dmin_only`` of an existing neuron's centroid are
    dropped: a batch-local pick cannot be trace-correlated against neurons
    whose traces live in other batches, so distance is the only gate."""
    before = state.active.cpu().numpy().copy()
    K = state.K_max
    resid = subtract_background(Y, state, params) - (
        state.masked_C().T @ state.masked_A().reshape(K, -1)
    ).reshape(Y.shape)
    state, _ = initialize_greedy(
        resid, params, state=state, min_corr=params.init.min_corr_res,
        min_pnr=params.init.min_pnr_res, verbose=verbose)
    del resid

    new = state.active.cpu().numpy() & ~before
    if new.any() and before.any():
        A = state.A.cpu().numpy()
        _, H, W = A.shape
        yy, xx = np.mgrid[0:H, 0:W]
        mass = A.sum(axis=(1, 2)) + 1e-12
        cy = (A * yy).sum(axis=(1, 2)) / mass
        cx = (A * xx).sum(axis=(1, 2)) / mass
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
    batch's residual picks) into the global footprint set."""
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


def fit_batches(batches: Sequence, params: Optional[CNMFEParams] = None,
                n_outer: int = 1, spatial_sync: bool = True,
                residual_pick: bool = True, verbose: bool = False,
                run_log=None, resume_from: Optional[str] = None,
                device="cuda",
                mesh=None) -> Tuple[CNMFEState, List[CNMFEState]]:
    """Run batch-mode CNMF-E on ``device`` (the card unless the caller
    passes ``device="cpu"``).

    ``batches``: sequence of (T_b, H, W) arrays or tensors (or a
    MovieStore's ``iter_blocks()``). ``run_log`` / ``resume_from``: passed
    to the first batch's full fit; with a run_log, every later batch and
    the final state are snapshotted. Returns (state with concatenated
    traces, list of per-batch states). ``mesh``: not taken;
    ``CNMFE(mesh=...).fit`` fits one in-memory movie on a mesh."""
    if mesh is not None:
        raise NotImplementedError("fit_batches takes no mesh")
    params = params or CNMFEParams.preset_1p()
    device = torch.device(device)
    batches = list(batches)
    if not batches:
        raise ValueError("no batches")

    def log(m):
        if verbose:
            print(f"[batch] {m}", flush=True)
        if run_log is not None:
            run_log.log(m)

    def movie(Yb):
        return torch.as_tensor(Yb, dtype=torch.float32, device=device)

    # ---- batch 1: full pipeline -------------------------------------- #
    st0 = CNMFE(params, device=device).fit(
        batches[0], n_outer=n_outer, verbose=verbose, run_log=run_log,
        resume_from=resume_from)
    per_batch = [st0]
    st_global = st0
    n0 = int(st0.n_active())

    # ---- later batches: inherit A, fit bg + traces, pick residual ---- #
    for b, Yb in enumerate(batches[1:], start=2):
        Yb = movie(Yb)
        st_b = init_traces_given_A(Yb, st_global, params)
        if residual_pick:
            st_b = residual_pick_batch(Yb, st_b, params, verbose=verbose)
            st_global, new = _union_new_neurons(st_global, st_b)
            if new.any():
                log(f"batch {b}: +{int(new.sum())} residual neurons "
                    f"(total {int(st_global.n_active())})")
        per_batch.append(st_b)
        if run_log is not None:
            run_log.snapshot(f"batch{b:02d}", st_b)
        log(f"batch {b}: traces fit ({int(st_b.n_active())} neurons)")

    # ---- A-sync: if any batch added neurons, refit every batch's traces
    # against the union A, warm (initComponents_batch.m:87-113) ---------
    if int(st_global.n_active()) > n0 and len(batches) > 1:
        log(f"A-union grew {n0} -> {int(st_global.n_active())}: "
            "refitting all batch traces (warm)")
        per_batch = [refit_traces_warm(movie(Yb), st_b, st_global, params)
                     for st_b, Yb in zip(per_batch, batches)]

    # ---- spatial sync: cc-weighted average of per-batch A ------------ #
    if spatial_sync and len(per_batch) > 1:
        A_acc = w_acc = None
        for st_b, Yb in zip(per_batch, batches):
            st_sp = update_spatial(subtract_background(movie(Yb), st_b,
                                                       params), st_b, params)
            cc = (st_b.C ** 2).sum(dim=-1)
            contrib = st_sp.A * cc[:, None, None]
            A_acc = contrib if A_acc is None else A_acc + contrib
            w_acc = cc if w_acc is None else w_acc + cc
        A_sync = A_acc / torch.clamp(w_acc, min=1e-12)[:, None, None]
        per_batch = [st.replace(A=A_sync, active=st_global.active)
                     for st in per_batch]

    # ---- concatenate traces over time -------------------------------- #
    final = per_batch[0].replace(
        C=torch.cat([st.C for st in per_batch], dim=-1),
        C_raw=torch.cat([st.C_raw for st in per_batch], dim=-1),
        S=torch.cat([st.S for st in per_batch], dim=-1),
        active=st_global.active)

    # ---- full-session QC + merges over the concatenated traces ------- #
    k_before = int(final.n_active())
    final = remove_false_positives(final, params)
    final, _ = merge_neurons(final, params, "dist_corr")
    final, _ = merge_neurons(final, params, "dist_only")
    final = tag_neurons(final, params)
    if int(final.n_active()) != k_before:
        log(f"full-session QC/merges: {k_before} -> "
            f"{int(final.n_active())} neurons")
    if run_log is not None:
        run_log.snapshot("batch_final", final)
    return final, per_batch
