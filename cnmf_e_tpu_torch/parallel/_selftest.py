"""Rank bodies for :func:`cnmf_e_tpu_torch.parallel.launch.spawn`: the
mesh cases that ``tests/test_torch_mesh*.py`` hold to the JAX package on
the CPU and ``chip_smoke.py`` phases 10 to 13 run on the card.

Each body takes the rank's :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh`
first and full numpy inputs after it, cuts its own blocks, runs the
port's mesh path, and returns full numpy results gathered over the mesh
(rank 0's value is the one callers read; the others return what is
rank-specific). The spawned children import this module afresh, so it
imports only torch, numpy and the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import os
import re
import time

import numpy as np
import torch
import torch.distributed as dist

from cnmf_e_tpu_torch import cuda_build
from cnmf_e_tpu_torch.checkpoint import RunLog
from cnmf_e_tpu_torch.convert import (gather_state, gather_step_state,
                                      params_from_dict, shard_state,
                                      shard_step_state, state_from_numpy,
                                      state_to_numpy)
from cnmf_e_tpu_torch.io.store import MovieStore
from cnmf_e_tpu_torch.models.background import (background_of,
                                                update_background)
from cnmf_e_tpu_torch.models.batch import (centroids, concat_traces,
                                           fit_batches, init_traces_given_A,
                                           residual_pick_batch,
                                           sync_footprints)
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons, merge_neurons_seq
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models.qc import remove_false_positives
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.models import streaming
from cnmf_e_tpu_torch.models.streaming import fit_streaming
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.ops import hals_kernels, oasis_kernels, ring_kernels
from cnmf_e_tpu_torch.ops.corr import correlation_image
from cnmf_e_tpu_torch.ops.detrend import detrend
from cnmf_e_tpu_torch.ops.filters import (filter_movie, gaussian_psf,
                                          resize_linear)
from cnmf_e_tpu_torch.ops.lowrank import fit_lowrank_model, nmf_hals
from cnmf_e_tpu_torch.ops.morphology import search_locations_ellipse
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.ring import (apply_ring, fit_ring_weights_mesh,
                                       local_background)
from cnmf_e_tpu_torch.ops.spikes import decorr_temporal
from cnmf_e_tpu_torch.ops.stats import (fast_median, fast_median_masked,
                                        submedian_mean)
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import (gather_footprints, gather_image,
                                            gather_movie, gather_traces,
                                            shard_footprints, shard_image,
                                            shard_movie, shard_traces)
from cnmf_e_tpu_torch.parallel.multihost import (frame_range_for_process,
                                                 load_sharded_movie)
from cnmf_e_tpu_torch.parallel.step import make_update_step
from cnmf_e_tpu_torch.utils.profiling import StageTimer

# every plain kernel version; none may run on a card's main path
# (chip_smoke.py's main_path and the card bodies below)
REFERENCES = ((hals_kernels, "hals_sweeps_reference"),
              (oasis_kernels, "oasis_solve_reference"),
              (oasis_kernels, "oasis_chunk_pools_reference"),
              (oasis_kernels, "oasis_pool_merge_reference"),
              (oasis_kernels, "oasis_reconstruct_reference"),
              (ring_kernels, "apply_ring_stencil_reference"),
              (ring_kernels, "apply_ring_mxu_flat_reference"),
              (ring_kernels, "apply_ring_mxu_reference"))


def cases(mesh, jobs):
    """Several bodies in one spawn: ``jobs`` is a list of (name, body
    name in this module, args); their values by name."""
    return {name: globals()[body](mesh, *args) for name, body, args in jobs}


def _sync(mesh) -> None:
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def step_cases(mesh, Y, d, H, W, T, radius, cases):
    """The update step of each ``(name, options)`` in ``cases`` on the
    mesh, from the full movie ``Y`` and state ``d`` (numpy): the full
    result state of each, by name."""
    Yl = shard_movie(np.asarray(Y, np.float32), mesh)
    out = {}
    for name, kw in cases:
        step = make_update_step(mesh, H, W, T, radius=radius, **kw)
        out[name] = gather_step_state(step(Yl, shard_step_state(d, mesh)),
                                      mesh)
    return out


def halo_case(mesh, X, w, w0, H, W, radius):
    """The sharded ring apply of the full (T, H, W) movie ``X`` with
    weights (H W, R) and w0 (H W,): the full result."""
    weights = RingWeights(w=shard_image(w, mesh), w0=shard_image(w0, mesh))
    out = apply_ring(weights, shard_movie(X, mesh), H, W, radius, mesh=mesh)
    return gather_movie(out, mesh).cpu().numpy()


def layout_case(mesh, T, H):
    """This rank's (frames, rows) of a (T, H, W) movie."""
    return mesh.frames(T), mesh.rows(H)


def guard_cases(mesh, H, W, T, K, radius):
    """The ValueError message (or None) of each invalid mesh call: H, T
    and K not divisible over their axes, ``mxu=True`` with a mesh."""
    R = ring_kernels.ring_offsets(radius).shape[0]

    def raised(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    def step_with_K(k):
        z = np.zeros
        d = dict(A=z((k, H, W)), C=z((k, T)), C_raw=z((k, T)), S=z((k, T)),
                 g=np.full(k, 0.9), b0=z((H, W)), ring_w=z((H * W, R)),
                 ring_w0=z(H * W))
        make_update_step(mesh, H, W, T, radius)(
            shard_movie(z((T, H, W), np.float32), mesh),
            shard_step_state(d, mesh))
    return dict(
        H=raised(lambda: make_update_step(mesh, H + 1, W, T, radius)),
        T=raised(lambda: make_update_step(mesh, H, W, T + 1, radius)),
        K=raised(lambda: step_with_K(K + 1)),
        mxu=raised(lambda: make_update_step(mesh, H, W, T, radius,
                                            mxu=True)))


def ingest_case(mesh, root, K, radius):
    """``load_sharded_movie`` of the store at ``root``: this rank's frame
    range and block (numpy), and the C of one mesh step on the ingested
    movie from a seeded state."""
    store = MovieStore(root)
    lo, hi = frame_range_for_process(store.shape[0], mesh)
    Yl = load_sharded_movie(store, mesh)
    T = Yl.shape[0] * mesh.n_frame
    _, H, W = store.shape
    R = ring_kernels.ring_offsets(radius).shape[0]
    rng = np.random.default_rng(0)
    d = dict(A=np.abs(rng.standard_normal((K, H, W))),
             C=np.abs(rng.standard_normal((K, T))),
             C_raw=np.zeros((K, T)), S=np.zeros((K, T)),
             g=np.full(K, 0.9), b0=np.zeros((H, W)),
             ring_w=np.zeros((H * W, R)), ring_w0=np.zeros(H * W))
    out = make_update_step(mesh, H, W, T, radius=radius, n_hals=1)(
        Yl, shard_step_state(d, mesh))
    return dict(range=(lo, hi), block=Yl.cpu().numpy(),
                C=gather_step_state(out, mesh)["C"])


def stream_case(mesh, root, params, kw, chunks=None):
    """``fit_streaming(mesh=...)`` of the store at ``root`` with the
    params dict ``params``: the full result state (numpy) on rank 0, and
    the calls of torch.distributed's object collectives on every rank.
    ``chunks``: values of ``streaming``'s chunk constants (such as
    T_CHUNK, QC_ROWS) for this run alone."""
    chunks = chunks or {}
    saved = {k: getattr(streaming, k) for k in chunks}
    for k, v in chunks.items():
        setattr(streaming, k, v)
    try:
        with count_broadcasts() as calls:
            state = fit_streaming(MovieStore(root), params_from_dict(params),
                                  device=mesh.device, mesh=mesh, **kw)
    finally:
        for k, v in saved.items():
            setattr(streaming, k, v)
    return dict(state=state_to_numpy(state) if mesh.rank == 0 else None,
                broadcasts=calls[0])


def stream_guard_cases(mesh, root, params, cases):
    """The ValueError message (or None) of ``fit_streaming(mesh=...)``
    with each ``(name, params fields, fit keywords)`` in ``cases``."""
    out = {}
    for name, fields, kw in cases:
        try:
            fit_streaming(MovieStore(root), with_fields(
                params_from_dict(params), fields), device=mesh.device,
                mesh=mesh, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# ------------------------------------------------------------------ #
# batch mode on the mesh (tests/test_torch_mesh_batch.py, chip_smoke.py
# phase 13): each rank its block of every batch
# ------------------------------------------------------------------ #
def _batch_blocks(batches, mesh):
    return [shard_movie(np.asarray(Yb, np.float32), mesh) for Yb in batches]


def snapshot_stages(run_dir) -> list:
    """The stage names of a run log's snapshots, in the order written."""
    return [re.sub(r"^snapshot_\d+_(.*)_\d{6}\.npz$", r"\1",
                   os.path.basename(f))
            for f in sorted(glob.glob(os.path.join(run_dir,
                                                   "snapshot_*.npz")))]


def batch_case(mesh, batches, params, workdir):
    """``fit_batches(mesh=...)`` of the full batches, with a run log that
    rank 0 writes under ``workdir``: the full final state on rank 0,
    every rank's digest of it, the per-batch neuron counts, the calls of
    torch.distributed's object collectives and (rank 0) the snapshots'
    stages."""
    log = RunLog(workdir, run_name="batch") if mesh.rank == 0 else None
    with count_broadcasts() as calls:
        final, per = fit_batches(_batch_blocks(batches, mesh),
                                 params_from_dict(params), mesh=mesh,
                                 run_log=log)
    dist.barrier()
    d = state_to_numpy(final)
    return dict(state=d if mesh.rank == 0 else None, digest=digest(d),
                per_batch=[int(st.n_active()) for st in per],
                broadcasts=calls[0],
                snaps=snapshot_stages(log.dir) if log is not None else None)


def batch_stage_cases(mesh, Y, d, Y_late, d_late, batches, states,
                      params):
    """Each stage of ``fit_batches`` alone on the mesh, from full inputs:
    ``init_traces_given_A`` of the movie ``Y`` with the state ``d`` (the
    full traces, g and active mask); ``residual_pick_batch`` of
    ``Y_late`` with ``d_late`` (the full active mask and A, and the
    centroids of the mesh); ``sync_footprints`` of the per-batch full
    states ``states`` over ``batches`` (the full A); ``concat_traces``
    of ``states`` (this rank's own frames of the session)."""
    p = params_from_dict(params)
    st = _full(init_traces_given_A(shard_movie(np.asarray(Y, np.float32),
                                               mesh),
                                   shard_state(d, mesh), p, mesh), mesh)
    out = dict(init={k: st[k] for k in ("C", "C_raw", "S", "g",
                                        "active")})
    st = residual_pick_batch(shard_movie(np.asarray(Y_late, np.float32),
                                         mesh),
                             shard_state(d_late, mesh), p, mesh=mesh)
    full = _full(st, mesh)
    out["pick"] = dict(active=full["active"], A=full["A"],
                       centroids=np.stack(centroids(st.A, mesh)))
    per = [shard_state(x, mesh) for x in states]
    out["sync"] = gather_footprints(sync_footprints(
        per, _batch_blocks(batches, mesh), p, mesh), mesh).cpu().numpy()
    out["concat"] = {k: concat_traces(per, k, mesh).cpu().numpy()
                     for k in ("C", "C_raw", "S")}
    return out


def batch_guard_case(mesh, batches, params):
    """``fit_batches(mesh=...)`` where batch 2's frames do not divide over
    'frame' (the last frame rank's block one frame short): the
    ValueError's message, or None."""
    blocks = _batch_blocks(batches, mesh)
    if mesh.f == mesh.n_frame - 1:
        blocks[1] = blocks[1][:-1]
    try:
        fit_batches(blocks, params_from_dict(params), mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------------ #
# the in-memory fit on the mesh (tests/test_torch_mesh_fit.py and
# tests/test_torch_mesh_stages.py)
# ------------------------------------------------------------------ #
def _full(st, mesh) -> dict:
    """The full state (numpy) of this rank's blocks."""
    return state_to_numpy(gather_state(st, mesh))


def ring_fit_case(mesh, Bf, H, W, radius):
    """The ring weights of the full (T, H, W) residual ``Bf`` fitted on
    the mesh (each rank its frames and rows): the full w and w0."""
    wts = fit_ring_weights_mesh(shard_movie(Bf, mesh), H, W, radius, mesh)
    return dict(w=gather_image(wts.w, mesh).cpu().numpy(),
                w0=gather_image(wts.w0, mesh).cpu().numpy())


def init_case(mesh, Y, params):
    """``initialize_greedy`` of the full movie ``Y`` on the mesh: the full
    state, the seed count and the Cn map."""
    st, info = initialize_greedy(shard_movie(np.asarray(Y, np.float32),
                                             mesh),
                                 params_from_dict(params), mesh=mesh)
    return dict(state=_full(st, mesh), n_found=info["n_found"],
                Cn=info["Cn"].cpu().numpy())


def background_case(mesh, Y, d, params):
    """``update_background`` on the mesh from the full state ``d``: the
    full b0 and ring weights."""
    p = params_from_dict(params)
    st = update_background(shard_movie(np.asarray(Y, np.float32), mesh),
                           shard_state(d, mesh), p, mesh=mesh)
    st = gather_state(st, mesh)
    return dict(b0=st.b0.cpu().numpy(), w=st.W.w.cpu().numpy(),
                w0=st.W.w0.cpu().numpy())


def fit_case(mesh, Y, params, n_outer):
    """``CNMFE(mesh=...).fit`` of the full movie ``Y``: the full state on
    rank 0, and every rank's own active mask (the ranks must agree)."""
    with count_broadcasts() as calls:
        st = CNMFE(params_from_dict(params), mesh=mesh).fit(
            shard_movie(np.asarray(Y, np.float32), mesh), n_outer=n_outer)
    return dict(state=state_to_numpy(st) if mesh.rank == 0 else None,
                active=st.active.cpu().numpy(),
                n_active=int(st.n_active()), broadcasts=calls[0])


def stats_case(mesh, X, M):
    """The medians (fast_median, submedian_mean, fast_median_masked over
    time with mask ``M``) of the full (T, H, W) array ``X`` on the mesh,
    each rank its frames and rows: the full results."""
    Xl, Ml = shard_movie(X, mesh), shard_movie(M, mesh)
    return dict(
        median=gather_image(fast_median(Xl, dim=0, mesh=mesh), mesh),
        submedian=gather_image(submedian_mean(Xl, dim=0, mesh=mesh), mesh),
        masked=gather_image(fast_median_masked(Xl, Ml, dim=0, mesh=mesh),
                            mesh))


def filters_case(mesh, Y, gSig, ssub, noise_cap):
    """Each filter op of the full (T, H, W) movie ``Y`` on the mesh: the
    replicate-padded filter, the bilinear upsample of its ``ssub``-pooled
    frames, the pixel noise over the first ``noise_cap`` frames and over
    all, and the correlation image; full results."""
    Yl = shard_movie(Y, mesh)
    Hl, W = Yl.shape[1:]
    pooled = shard_movie(np.asarray(Y, np.float32)[
        :, :, :].reshape(Y.shape[0], -1, ssub, W // ssub, ssub).mean(
            axis=(2, 4)), mesh)
    return dict(
        filtered=gather_movie(filter_movie(Yl, gaussian_psf(gSig), mesh),
                              mesh).numpy(),
        resized=gather_movie(resize_linear(pooled, (Hl, W), mesh),
                             mesh).numpy(),
        noise_cap=gather_image(noise_psd_frames(Yl, mesh=mesh,
                                                n_frames=noise_cap),
                               mesh).numpy(),
        noise=gather_image(noise_psd_frames(Yl, mesh=mesh), mesh).numpy(),
        corr=gather_image(correlation_image(Yl, mesh=mesh), mesh).numpy())


def merge_qc_case(mesh, d, params):
    """The merges and the QC of the full state ``d`` on the mesh: per mode
    of ``merge_neurons`` (with its re-deconvolution) the clusters and the
    full state; ``merge_neurons_seq``'s and ``remove_false_positives``'
    full states."""
    p = params_from_dict(params)
    st = shard_state(d, mesh)
    out = {}
    for mode in ("dist_corr", "dist_only", "high_corr"):
        res, nm = merge_neurons(st, p, mode, mesh=mesh)
        out[mode] = dict(n=int(nm), state=_full(res, mesh))
    res, nm = merge_neurons_seq(st, p, ("dist_corr", "high_corr"),
                                deconv=False, mesh=mesh)
    out["seq"] = dict(n=int(nm), state=_full(res, mesh))
    out["qc"] = dict(state=_full(remove_false_positives(st, p, mesh=mesh),
                                 mesh))
    return out


def with_fields(p, fields: dict):
    """``p`` with the params fields ``fields`` replaced (dotted names,
    such as "background.model")."""
    for dotted, v in fields.items():
        sec, name = dotted.split(".")
        p = p.replace(**{sec: dataclasses.replace(getattr(p, sec),
                                                  **{name: v})})
    return p


def digest(arrays: dict) -> dict:
    """A hash of each array's bytes: two ranks' values are bit-identical
    where their digests are equal."""
    return {k: hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def fit_guard_cases(mesh, Y, params, variants, workdir):
    """Each option and method of ``CNMFE`` on the mesh, and the exception
    each invalid call raises. ``variants`` maps a name to a dict of params
    fields to replace (dotted names), or to one of "run_log",
    "resume_from" (the run_log case's init snapshot), "fit_batches" (the
    movie's halves as two batches),
    "dff", "background", "reconstruction", "residual", "compute_rss" (on
    a fitted base model), "other_device", "unequal_blocks". By name:
    ("ok", digest, checks) where it runs (the digest of the full state
    and of the method's value on this rank; checks: n_active, whether
    every value is finite, the snapshots written), else the exception's
    type name and message."""
    Yl = shard_movie(np.asarray(Y, np.float32), mesh)
    base = params_from_dict(params)
    fitted = []

    def model():
        if not fitted:
            m = CNMFE(base, mesh=mesh)
            m.fit(Yl, n_outer=1)
            fitted.append(m)
        return fitted[0]

    def run(what):
        """(arrays, checks) of a call that runs; None after one that was
        to raise and did not."""
        if isinstance(what, dict):
            st = CNMFE(with_fields(base, what), mesh=mesh).fit(Yl, n_outer=1)
            return state_to_numpy(st), {}
        if what == "run_log":
            log = (RunLog(workdir, run_name="guards", params=base)
                   if mesh.rank == 0 else None)
            st = CNMFE(base, mesh=mesh).fit(Yl, n_outer=1, run_log=log)
            dist.barrier()
            snaps = [os.path.basename(f).split("_")[2]
                     for f in sorted(glob.glob(os.path.join(
                         workdir, "guards", "snapshot_*.npz")))]
            return state_to_numpy(st), dict(snaps=snaps)
        if what == "resume_from":
            snap, = glob.glob(os.path.join(workdir, "guards",
                                           "snapshot_000_init_*.npz"))
            return state_to_numpy(CNMFE(base, mesh=mesh).fit(
                Yl, n_outer=1, resume_from=snap)), {}
        if what == "fit_batches":
            # the two halves of the movie as batches, this rank's block of
            # each
            T = Y.shape[0]
            st, per = fit_batches([shard_movie(np.asarray(
                Yb, np.float32), mesh) for Yb in (Y[:T // 2], Y[T // 2:])],
                base, mesh=mesh)
            return (dict(state_to_numpy(st), per_batch=np.array(
                [int(x.n_active()) for x in per])), {})
        if what == "other_device":
            CNMFE(base, device="meta", mesh=mesh)
        elif what == "unequal_blocks":
            CNMFE(base, mesh=mesh).fit(Yl[:Yl.shape[0] - mesh.f])
        else:
            m = model()
            out = getattr(m, what)(Yl)
            out = out if isinstance(out, tuple) else (out,)
            out = [np.asarray(x if isinstance(x, float)
                              else x.cpu().numpy()) for x in out]
            arrays = dict(state_to_numpy(m.state),
                          shapes=np.array([x.shape for x in out]))
            if what == "compute_rss":
                arrays["rss"] = out[0]
            return arrays, dict(finite=all(np.isfinite(x).all()
                                           for x in out))
        return None
    out = {}
    for name, what in variants:
        try:
            res = run(what)
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
            continue
        if res is None:
            out[name] = None
            continue
        arrays, checks = res
        checks["n_active"] = int(arrays["active"].sum())
        checks.setdefault("finite", all(
            np.isfinite(v).all() for v in arrays.values()
            if v.dtype.kind == "f"))
        out[name] = ("ok", digest(arrays), checks)
    return out


# ------------------------------------------------------------------ #
# every option and method of CNMFE on the mesh
# (tests/test_torch_mesh_options.py, tests/test_torch_mesh_methods.py)
# ------------------------------------------------------------------ #
def local_bg_case(mesh, Y, radius, ssub, cutoff):
    """``local_background(mesh=...)`` of the full movie ``Y``: the full
    prediction, weights and b0."""
    Yest, wts, b0 = local_background(shard_movie(Y, mesh), radius=radius,
                                     ssub=ssub, neighbor_cutoff=cutoff,
                                     mesh=mesh)
    return dict(Yest=gather_movie(Yest, mesh).cpu().numpy(),
                w=gather_image(wts.w, mesh).cpu().numpy(),
                b0=gather_image(b0, mesh).cpu().numpy())


def bg_model_case(mesh, Y, d, params, sn):
    """``update_background`` then ``background_of`` on the mesh from the
    full state ``d`` (pixel noise ``sn`` or None): the full state's
    background fields and the full background movie."""
    p = params_from_dict(params)
    Yl = shard_movie(np.asarray(Y, np.float32), mesh)
    st = update_background(Yl, shard_state(d, mesh), p,
                           sn_pix=None if sn is None else shard_image(
                               np.asarray(sn, np.float32), mesh),
                           mesh=mesh)
    B = gather_movie(background_of(Yl, st, p, mesh=mesh), mesh)
    full = _full(st, mesh)
    return dict({k: full[k] for k in ("b0", "ring_w", "bg_b", "bg_f")
                 if k in full}, B=B.cpu().numpy())


def lowrank_case(mesh, Y, A, C, rank, mode):
    """``fit_lowrank_model(mesh=...)``: the full b, f and b0."""
    b, f, b0 = fit_lowrank_model(shard_movie(Y, mesh),
                                 shard_footprints(A, mesh),
                                 shard_traces(C, mesh), rank, mode=mode,
                                 mesh=mesh)
    return dict(b=gather_footprints(b, mesh).cpu().numpy(),
                f=gather_traces(f, mesh).cpu().numpy(),
                b0=gather_image(b0, mesh).cpu().numpy())


def nmf_case(mesh, X, rank, n_iter, W0, H0):
    """``nmf_hals(mesh=...)`` of the full (d, T) matrix ``X`` from the
    starting factors (W0, H0): the full W and H."""
    rows = shard_image(X, mesh)
    Xl = shard_traces(rows, mesh)
    Wf, Hf = nmf_hals(Xl, rank, n_iter=n_iter, mesh=mesh,
                      init=(shard_image(W0, mesh), shard_traces(H0, mesh)))
    return dict(W=gather_image(Wf, mesh).cpu().numpy(),
                H=gather_traces(Hf, mesh).cpu().numpy())


def ellipse_case(mesh, A, dist):
    """``search_locations_ellipse(mesh=...)`` of the full footprints: the
    full masks."""
    m = search_locations_ellipse(shard_footprints(A, mesh), dist=dist,
                                 mesh=mesh)
    return gather_footprints(m.to(torch.uint8), mesh).cpu().numpy() > 0


def spatial_case(mesh, Y, d, params, sn):
    """``update_spatial(mesh=...)`` from the full state ``d``: the full
    A."""
    st = update_spatial(shard_movie(np.asarray(Y, np.float32), mesh),
                        shard_state(d, mesh), params_from_dict(params),
                        sn_pix=None if sn is None else shard_image(
                            np.asarray(sn, np.float32), mesh), mesh=mesh)
    return gather_footprints(st.A, mesh).cpu().numpy()


def temporal_case(mesh, Y, d, params):
    """``update_temporal(mesh=...)`` from the full state ``d``: the full
    C, C_raw, S and g."""
    st = update_temporal(shard_movie(np.asarray(Y, np.float32), mesh),
                         shard_state(d, mesh), params_from_dict(params),
                         mesh)
    full = _full(st, mesh)
    return {k: full[k] for k in ("C", "C_raw", "S", "g")}


def decorr_case(mesh, C, S, A, g, sn, gSiz, wd):
    """``decorr_temporal(mesh=...)``: each patch rank decorrelates its
    rows of the whole traces; the full result."""
    k0, k1 = mesh.neurons(C.shape[0])
    dev = mesh.device

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x[k0:k1]), device=dev)
    out = decorr_temporal(t(C), t(S), shard_footprints(A, mesh), t(g),
                          t(sn), gSiz=gSiz, wd=wd, mesh=mesh)
    return comm.all_gather_cat(out, 0, mesh.patch_group).cpu().numpy()


def detrend_case(mesh, X, nk, method):
    """``detrend(mesh=...)`` of the full (d, T) traces, each rank its
    pixels and frames: the full result."""
    Xl = shard_traces(shard_image(X, mesh), mesh)
    return gather_traces(gather_image(detrend(Xl, nk, method, mesh), mesh),
                         mesh).cpu().numpy()


def methods_case(mesh, Y, d, params, windows):
    """Every method of ``CNMFE`` on the mesh with the full state ``d`` as
    its fitted state: ``dff`` at each window of ``windows`` (None: the
    whole session), ``background``, ``reconstruction``, ``residual`` and
    ``compute_rss``, each full."""
    m = CNMFE(params_from_dict(params), mesh=mesh)
    m.state = state_from_numpy(d, device=mesh.device)
    Yl = shard_movie(np.asarray(Y, np.float32), mesh)
    out = {}
    for w in windows:
        C_df, C_raw_df, F0 = m.dff(Yl, window=w)
        out[f"dff_{w}"] = tuple(
            (gather_traces(x, mesh) if x.shape[1] > 1 else x).cpu().numpy()
            for x in (C_df, C_raw_df, F0))
    for what in ("background", "reconstruction", "residual"):
        out[what] = gather_movie(getattr(m, what)(Yl), mesh).cpu().numpy()
    out["rss"] = m.compute_rss(Yl)
    return out


def dff_mode_case(mesh, Y, d, params):
    """``extract_dff(baseline="mode")`` on the mesh: C_df, C_raw_df (full)
    and F0."""
    from cnmf_e_tpu_torch.models.dff import extract_dff
    C_df, C_raw_df, F0 = extract_dff(
        shard_movie(np.asarray(Y, np.float32), mesh),
        shard_state(d, mesh), params_from_dict(params), baseline="mode",
        mesh=mesh)
    return tuple(x.cpu().numpy() for x in (gather_traces(C_df, mesh),
                                           gather_traces(C_raw_df, mesh),
                                           F0))


def log_resume_case(mesh, Y, params, workdir, n_outer):
    """A fit with a run log (rank 0's, in ``workdir``/mesh), then a fit
    resumed from its init snapshot: both full states, the snapshot
    names and the log's lines (rank 0)."""
    p = params_from_dict(params)
    Yl = shard_movie(np.asarray(Y, np.float32), mesh)
    log = RunLog(workdir, run_name="mesh") if mesh.rank == 0 else None
    st = CNMFE(p, mesh=mesh).fit(Yl, n_outer=n_outer, run_log=log)
    dist.barrier()
    snap, = glob.glob(os.path.join(workdir, "mesh",
                                   "snapshot_000_init_*.npz"))
    resumed = CNMFE(p, mesh=mesh).fit(Yl, n_outer=n_outer,
                                      resume_from=snap)
    out = dict(state=state_to_numpy(st), resumed=state_to_numpy(resumed),
               snap=snap)
    if mesh.rank == 0:
        out["snaps"] = sorted(os.path.basename(f) for f in glob.glob(
            os.path.join(workdir, "mesh", "snapshot_*.npz")))
        with open(log.log_path) as f:
            out["log"] = f.read().splitlines()
    return out


def qc_pixels_case(mesh, d, params, active_pixels):
    """``remove_false_positives(active_pixels=...)`` on the mesh, each
    rank its rows of the mask: the full active mask."""
    st = remove_false_positives(
        shard_state(d, mesh), params_from_dict(params),
        active_pixels=shard_image(np.asarray(active_pixels), mesh),
        mesh=mesh)
    return st.active.cpu().numpy()


# ------------------------------------------------------------------ #
# card bodies (chip_smoke.py phases 10 to 12)
# ------------------------------------------------------------------ #
class count_references:
    """Counts the calls of every plain kernel version while active; yields
    the counts by name."""

    def __enter__(self):
        self.calls, self.saved = {}, []
        for mod, name in REFERENCES:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        return self.calls

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# torch.distributed's collectives of picklable objects: the ways a rank
# could send pickled state (no path of the port may call them)
OBJECT_COLLECTIVES = ("broadcast_object_list", "all_gather_object",
                      "gather_object", "scatter_object_list",
                      "send_object_list", "recv_object_list")


class count_broadcasts:
    """Counts the calls of torch.distributed's object collectives (pickled
    state sent between ranks; no mesh path may make one) while active."""

    def __enter__(self):
        self.calls = [0]
        self.saved = [(name, getattr(dist, name))
                      for name in OBJECT_COLLECTIVES if hasattr(dist, name)]
        for name, fn in self.saved:
            def counted(*a, _fn=fn, **kw):
                self.calls[0] += 1
                return _fn(*a, **kw)
            setattr(dist, name, counted)
        return self.calls

    def __exit__(self, *exc):
        for name, fn in self.saved:
            setattr(dist, name, fn)


def _path_run(mesh, fn):
    """``fn()`` with launches, entry calls, plain-version calls, the comm
    counters and the wall (host clock, device synchronised) of this rank
    counted from 0."""
    _sync(mesh)
    dist.barrier()
    cuda_build.reset_launch_counts()
    comm.reset_stats()
    with count_references() as refs:
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh)
        wall = time.perf_counter() - t0
    return out, dict(wall=wall, launches=dict(cuda_build.LAUNCHES),
                     entries=dict(cuda_build.ENTRY_CALLS), references=refs,
                     comm=dict(comm.STATS))


def card_step(mesh, y_path, d_path, H, W, T, radius, chain, cases):
    """The card's mesh step at full size, from a movie and a state saved
    as .npy/.npz (each rank reads its own block): per case a warm-up,
    then one counted and timed run; the full result state on rank 0."""
    Y = np.load(y_path, mmap_mode="r")
    with np.load(d_path) as z:
        d = {k: z[k] for k in z.files}
    Yl = shard_movie(Y, mesh)
    st = shard_step_state(d, mesh)
    out = {}
    for name, kw in cases:
        step = make_update_step(mesh, H, W, T, radius=radius, chain=chain,
                                n_hals=1, **kw)
        step(Yl, st)                                      # warm-up
        res, info = _path_run(mesh, lambda: step(Yl, st))
        full = gather_step_state(res, mesh)
        out[name] = dict(info, state=full if mesh.rank == 0 else None)
    return out


def card_step_identity(mesh, y_path, d_path, H, W, T, radius, chain,
                       cases):
    """The step with ``mesh`` and with ``mesh=None`` on one rank's card,
    on the same tensors: both full results per case."""
    Y = torch.as_tensor(np.load(y_path), device=mesh.device)
    with np.load(d_path) as z:
        d = {k: z[k] for k in z.files}
    st = shard_step_state(d, mesh)
    out = {}
    for name, kw in cases:
        res = {}
        for what, m in (("mesh", mesh), ("none", None)):
            step = make_update_step(m, H, W, T, radius=radius, chain=chain,
                                    n_hals=1, **kw)
            step(Y, st)
            r, info = _path_run(mesh, lambda: step(Y, st))
            res[what] = dict(info, state={k: getattr(r, k).cpu().numpy()
                                          for k in ("A", "C", "C_raw",
                                                    "S")})
        out[name] = res
    return out


def card_ingest(mesh, root):
    """``load_sharded_movie`` of the store at ``root``: the full per-frame
    sums (this rank's rows and frames, summed over 'patch' and gathered
    over 'frame'), the rank's frame range and its read seconds."""
    store = MovieStore(root)
    t0 = time.perf_counter()
    Yl = load_sharded_movie(store, mesh)
    _sync(mesh)
    seconds = time.perf_counter() - t0
    sums = comm.all_reduce_sum(Yl.sum(dim=(1, 2)), mesh.patch_group)
    sums = comm.all_gather_cat(sums, 0, mesh.frame_group)
    return dict(sums=sums.cpu().numpy()[:store.shape[0]],
                range=frame_range_for_process(store.shape[0], mesh),
                seconds=seconds)


def card_stream(mesh, root, warm_root, params, kw):
    """``fit_streaming(mesh=...)`` on the card: a warm-up on the store at
    ``warm_root``, then the counted and timed fit of the store at
    ``root`` with a StageTimer and this rank's peak memory; the calls of
    object collectives; the full state on rank 0."""
    p = params_from_dict(params)
    fit_streaming(MovieStore(warm_root), p, device=mesh.device, mesh=mesh,
                  **kw)
    timer = StageTimer(mesh.device)
    card = mesh.device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with count_broadcasts() as calls:
        state, info = _path_run(mesh, lambda: fit_streaming(
            MovieStore(root), p, device=mesh.device, mesh=mesh, timer=timer,
            **kw))
    info.update(stages=dict(timer.times), broadcasts=calls[0],
                peak=torch.cuda.max_memory_allocated(mesh.device) if card
                else 0,
                state=state_to_numpy(state) if mesh.rank == 0 else None)
    return info



class CommStageTimer(StageTimer):
    """A StageTimer that also sums, per stage, the bytes this rank hands
    to the collectives and the host seconds inside them (``comm.STATS``):
    ``comm[stage] = (bytes, seconds)``."""

    def __init__(self, device):
        super().__init__(device)
        self.comm = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        b0, s0 = comm.STATS["bytes"], comm.STATS["seconds"]
        with super().stage(name):
            yield
        b, sec = self.comm.get(name, (0, 0.0))
        self.comm[name] = (b + comm.STATS["bytes"] - b0,
                           sec + comm.STATS["seconds"] - s0)


def card_fit(mesh, y_path, warm_path, params, n_outer):
    """``CNMFE(mesh=...).fit`` on the card: a warm-up on the movie at
    ``warm_path`` (None: none), then the counted and timed fit of the
    movie at ``y_path`` (.npy, each rank reads only its block) with a
    StageTimer and this rank's peak memory; the full state on rank 0,
    every rank's active mask."""
    p = params_from_dict(params)
    if warm_path is not None:
        CNMFE(p, mesh=mesh).fit(
            shard_movie(np.load(warm_path, mmap_mode="r"), mesh),
            n_outer=n_outer)
    Yl = shard_movie(np.load(y_path, mmap_mode="r"), mesh)
    timer = CommStageTimer(mesh.device)
    card = mesh.device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with count_broadcasts() as calls:
        state, info = _path_run(mesh, lambda: CNMFE(
            p, mesh=mesh).fit(Yl, n_outer=n_outer, timer=timer))
    info.update(stages=dict(timer.times), stage_comm=dict(timer.comm),
                broadcasts=calls[0],
                peak=torch.cuda.max_memory_allocated(mesh.device) if card
                else 0, block=tuple(Yl.shape),
                active=state.active.cpu().numpy(),
                state=state_to_numpy(state) if mesh.rank == 0 else None)
    return info


def card_methods(mesh, y_path, params, n_outer, workdir):
    """On the card: a fit of the movie at ``y_path`` with a run log
    (rank 0 writes it under ``workdir``), a fit resumed from its init
    snapshot, and every method of the fitted model on the rank's block,
    each held to one process's method on the whole movie on the rank's
    card: the largest difference over the mesh relative to the one
    process's scale. The states on rank 0."""
    p = params_from_dict(params)
    Y = np.load(y_path, mmap_mode="r")
    Yl = shard_movie(Y, mesh)
    log = RunLog(workdir, run_name="mesh") if mesh.rank == 0 else None
    m = CNMFE(p, mesh=mesh)
    with count_broadcasts() as calls:
        m.fit(Yl, n_outer=n_outer, run_log=log)
        dist.barrier()
        snap, = glob.glob(os.path.join(workdir, "mesh",
                                       "snapshot_000_init_*.npz"))
        resumed = CNMFE(p, mesh=mesh).fit(Yl, n_outer=n_outer,
                                          resume_from=snap)
    one = CNMFE(p, device=mesh.device)
    one.state = m.state
    Yf = torch.as_tensor(np.array(Y), device=mesh.device)
    T, H = Yf.shape[:2]
    (t0, t1), (h0, h1) = mesh.frames(T), mesh.rows(H)

    def err(got, ref):
        e = torch.tensor([float((got - ref).abs().max())
                          / max(float(ref.abs().max()), 1e-30)],
                         device=mesh.device)
        return float(comm.all_reduce_max(e, None)[0])
    errs = {what: err(getattr(m, what)(Yl),
                      getattr(one, what)(Yf)[t0:t1, h0:h1])
            for what in ("background", "reconstruction", "residual")}
    for w in (None, 101):
        got, ref = m.dff(Yl, window=w), one.dff(Yf, window=w)
        for name, g, r in zip(("C_df", "C_raw_df", "F0"), got, ref):
            errs[f"dff_{w}_{name}"] = err(g, r if r.shape[1] == 1
                                          else r[:, t0:t1])
    rss, rss_one = m.compute_rss(Yl), one.compute_rss(Yf)
    errs["rss"] = abs(rss - rss_one) / rss_one
    lead = mesh.rank == 0
    return dict(errors=errs, rss=rss, snap=snap, broadcasts=calls[0],
                snaps=sorted(os.path.basename(f) for f in glob.glob(
                    os.path.join(workdir, "mesh", "snapshot_*.npz"))),
                active=m.state.active.cpu().numpy(),
                state=state_to_numpy(m.state) if lead else None,
                resumed=state_to_numpy(resumed) if lead else None)


def card_fit_identity(mesh, y_path, warm_path, params, n_outer):
    """The fit with ``mesh`` (a 1 x 1 mesh: the block is the movie) and
    with ``mesh=None`` in one process on the card, after a warm-up of
    each: both full states, walls and counts."""
    p = params_from_dict(params)
    Yw = torch.as_tensor(np.load(warm_path), device=mesh.device)
    Y = torch.as_tensor(np.load(y_path), device=mesh.device)
    out = {}
    for what, m in (("mesh", mesh), ("none", None)):
        CNMFE(p, mesh=m).fit(Yw, n_outer=n_outer)
        st, info = _path_run(mesh, lambda: CNMFE(
            p, mesh=m).fit(Y, n_outer=n_outer))
        out[what] = dict(info, state=state_to_numpy(st))
    return out


def _batch_files(path, n_batches, mesh=None):
    """The ``n_batches`` equal frame batches of the movie saved at
    ``path`` (.npy): memmapped views, or with ``mesh`` this rank's block
    of each on its device (the rank reads only its block)."""
    Y = np.load(path, mmap_mode="r")
    parts = np.split(Y, n_batches)
    return parts if mesh is None else [shard_movie(Yb, mesh)
                                       for Yb in parts]


def card_batch(mesh, y_path, warm_path, params, n_batches):
    """``fit_batches(mesh=...)`` on the card: a warm-up on the movie at
    ``warm_path``, then the counted and timed run of the movie at
    ``y_path`` in ``n_batches`` batches, each rank reading its block of
    each, with a CommStageTimer and this rank's peak memory; the full
    state on rank 0, every rank's active mask, per-batch counts and
    digest of the state."""
    p = params_from_dict(params)
    fit_batches(_batch_files(warm_path, n_batches, mesh), p, mesh=mesh)
    blocks = _batch_files(y_path, n_batches, mesh)
    timer = CommStageTimer(mesh.device)
    card = mesh.device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    with count_broadcasts() as calls:
        (state, per), info = _path_run(mesh, lambda: fit_batches(
            blocks, p, mesh=mesh, timer=timer))
    d = state_to_numpy(state)
    info.update(stages=dict(timer.times), stage_comm=dict(timer.comm),
                broadcasts=calls[0],
                peak=torch.cuda.max_memory_allocated(mesh.device) if card
                else 0, block=tuple(blocks[0].shape),
                active=state.active.cpu().numpy(),
                per_batch=[int(st.n_active()) for st in per],
                digest=digest(d), state=d if mesh.rank == 0 else None)
    return info


def card_batch_identity(mesh, y_path, warm_path, params, n_batches):
    """``fit_batches`` with ``mesh`` (a 1 x 1 mesh: the blocks are the
    batches) and with ``mesh=None`` in one process on the card, on the
    same tensors, after a warm-up of each: both full states, walls,
    counts and per-batch neuron counts."""
    p = params_from_dict(params)
    dev = mesh.device

    def upload(path):
        return [torch.as_tensor(np.array(Yb), device=dev)
                for Yb in _batch_files(path, n_batches)]
    warm, movie = upload(warm_path), upload(y_path)
    out = {}
    for what, m in (("mesh", mesh), ("none", None)):
        fit_batches(warm, p, mesh=m, device=dev)
        (st, per), info = _path_run(mesh, lambda: fit_batches(
            movie, p, mesh=m, device=dev))
        out[what] = dict(info, state=state_to_numpy(st),
                         per_batch=[int(x.n_active()) for x in per])
    return out
