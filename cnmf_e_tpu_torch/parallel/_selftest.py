"""Rank bodies for :func:`cnmf_e_tpu_torch.parallel.launch.spawn`: the
mesh cases that ``tests/test_torch_mesh*.py`` hold to the JAX package on
the CPU and ``chip_smoke.py`` phases 10 and 11 run on the card.

Each body takes the rank's :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh`
first and full numpy inputs after it, cuts its own blocks, runs the
port's mesh path, and returns full numpy results gathered over the mesh
(rank 0's value is the one callers read; the others return what is
rank-specific). The spawned children import this module afresh, so it
imports only torch, numpy and the port.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
import torch.distributed as dist

from cnmf_e_tpu_torch import cuda_build
from cnmf_e_tpu_torch.convert import (gather_state, gather_step_state,
                                      params_from_dict, shard_state,
                                      shard_step_state, state_to_numpy)
from cnmf_e_tpu_torch.io.store import MovieStore
from cnmf_e_tpu_torch.models.background import update_background
from cnmf_e_tpu_torch.models.batch import fit_batches
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons, merge_neurons_seq
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.models.qc import remove_false_positives
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.models.streaming import fit_streaming
from cnmf_e_tpu_torch.ops import hals_kernels, oasis_kernels, ring_kernels
from cnmf_e_tpu_torch.ops.corr import correlation_image
from cnmf_e_tpu_torch.ops.filters import (filter_movie, gaussian_psf,
                                          resize_linear)
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.ring import apply_ring, fit_ring_weights_mesh
from cnmf_e_tpu_torch.ops.stats import (fast_median, fast_median_masked,
                                        submedian_mean)
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import (gather_image, gather_movie,
                                            shard_image, shard_movie)
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


def stream_case(mesh, root, params, kw):
    """``fit_streaming(mesh=...)`` of the store at ``root`` with the
    params dict ``params``: the full result state (numpy) on rank 0."""
    state = fit_streaming(MovieStore(root), params_from_dict(params),
                          device=mesh.device, mesh=mesh, **kw)
    return state_to_numpy(state) if mesh.rank == 0 else None


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


def fit_guard_cases(mesh, Y, params, variants):
    """The exception each invalid mesh call raises: ``variants`` maps a
    name to a dict of params fields to replace (dotted names) or to one
    of the calls "resume_from", "run_log", "fit_batches", "dff",
    "background", "reconstruction", "residual", "compute_rss",
    "other_device", "unequal_blocks"; the exception's type name and message by name."""
    import dataclasses
    Yl = shard_movie(np.asarray(Y, np.float32), mesh)
    base = params_from_dict(params)

    def with_fields(p, fields):
        for dotted, v in fields.items():
            sec, name = dotted.split(".")
            p = p.replace(**{sec: dataclasses.replace(getattr(p, sec),
                                                      **{name: v})})
        return p

    def run(what):
        model = CNMFE(base, mesh=mesh)
        if isinstance(what, dict):
            CNMFE(with_fields(base, what), mesh=mesh).fit(Yl, n_outer=1)
        elif what in ("resume_from", "run_log"):
            model.fit(Yl, **{what: "x"})
        elif what == "fit_batches":
            fit_batches([Yl], base, mesh=mesh)
        elif what == "other_device":
            CNMFE(base, device="meta", mesh=mesh)
        elif what == "unequal_blocks":
            model.fit(Yl[:Yl.shape[0] - mesh.f])
        else:
            getattr(model, what)(Yl)
    out = {}
    for name, what in variants:
        try:
            run(what)
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


# ------------------------------------------------------------------ #
# card bodies (chip_smoke.py phases 10 and 11)
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


class count_broadcasts:
    """Counts the calls of ``comm.broadcast_object`` (the pickled state
    that ``fit_streaming(mesh=...)`` sends around; the in-memory fit on a
    mesh must make none) while active."""

    def __enter__(self):
        self.calls = [0]
        self.saved = comm.broadcast_object

        def counted(*a, **kw):
            self.calls[0] += 1
            return self.saved(*a, **kw)
        comm.broadcast_object = counted
        return self.calls

    def __exit__(self, *exc):
        comm.broadcast_object = self.saved


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
    ``root`` with a StageTimer and this rank's peak memory; the full
    state on rank 0."""
    p = params_from_dict(params)
    fit_streaming(MovieStore(warm_root), p, device=mesh.device, mesh=mesh,
                  **kw)
    timer = StageTimer(mesh.device)
    card = mesh.device.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    state, info = _path_run(mesh, lambda: fit_streaming(
        MovieStore(root), p, device=mesh.device, mesh=mesh, timer=timer,
        **kw))
    info.update(stages=dict(timer.times),
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
    ``warm_path``, then the counted and timed fit of the movie at
    ``y_path`` (.npy, each rank reads only its block) with a StageTimer
    and this rank's peak memory; the full state on rank 0, every rank's
    active mask."""
    p = params_from_dict(params)
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
            p, mesh=mesh).fit(Yl, n_outer=n_outer,
                                                  timer=timer))
    info.update(stages=dict(timer.times), stage_comm=dict(timer.comm),
                broadcasts=calls[0],
                peak=torch.cuda.max_memory_allocated(mesh.device) if card
                else 0, block=tuple(Yl.shape),
                active=state.active.cpu().numpy(),
                state=state_to_numpy(state) if mesh.rank == 0 else None)
    return info


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
