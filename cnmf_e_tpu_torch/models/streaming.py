"""Out-of-core pipeline for movies larger than device memory (port of
``cnmf_e_tpu/models/streaming.py``).

The factor updates stay EXACT under streaming by accumulating the
frame-axis Gram sums over blocks of a :class:`MovieStore`:

  spatial:   U = sum_b C_b Ysig_b,  V = C C^T  -> HALS on (U, V)
  ring fit:  the per-pixel Gram accumulation is already frame-blocked
  temporal:  per-block projections A Ysig_b are independent given A and
             the background; the sweeps and the deconvolution run on the
             concatenated (K, T) traces

Initialization runs on a temporally decimated in-memory proxy movie (tsub
chosen so it fits the budget) and is refined at full rate by the streamed
updates. The footprints stay in the row-major (K, d) layout of the state
throughout, so the spatial solve runs the HALS kernel (K1) with no
transpose; each block's ring subtraction runs the ring stencil (K6) at
full resolution and ``background.ring_radius`` (``background.ssub`` is
not read here, as in the JAX package), and the deconvolution the OASIS
solve (K2 -> K3 -> K4). As in the JAX package, the streamed fit always
fits its own ring background and uses no search locations: it reads
neither ``background.model`` nor ``spatial.search_method``.

Blocks reach the card through :func:`_prefetch_blocks`: a worker thread
reads the next chunk from the memmap into a pinned host buffer while the
current one is computed on, the copy runs on its own CUDA stream, and the
compute stream waits on the copy's event. Blocks upload in their stored
dtype (float16 for the simulated scale store) and are cast on the card.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.convert import gather_state, state_blocks
from cnmf_e_tpu_torch.io.store import MovieStore
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons
from cnmf_e_tpu_torch.models.qc import _apply_keep, row_batches, tag_neurons
from cnmf_e_tpu_torch.models.state import (CNMFEState, RingWeights, compact,
                                           empty_state)
from cnmf_e_tpu_torch.ops.filters import resize_linear
from cnmf_e_tpu_torch.ops.hals import (hals_spatial_sweeps_rows,
                                       hals_temporal_sweeps)
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from cnmf_e_tpu_torch.ops.ring import (apply_ring, fit_ring_weights_mesh,
                                       stride_grid)
from cnmf_e_tpu_torch.ops.ring_kernels import ring_offsets
from cnmf_e_tpu_torch.ops.stats import submedian_mean
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import (check_divisible,
                                            gather_footprints, gather_image)
from cnmf_e_tpu_torch.utils.profiling import timed

# Chunked branches. Each is exact by construction (columns, pixels and
# neurons are independent given the Grams) and bounds the live (K, T) or
# (K, d) buffers of a long or wide recording; tests lower them to compare
# the chunked result with the unchunked one.
T_CHUNK = 25_000       # frames per temporal solve; past it deconvolution
#                        and QC batch neurons and a post-spatial snapshot
#                        is written
D_CHUNK = 1 << 16      # pixels per spatial solve, past 2 * D_CHUNK pixels
QC_ROWS = 640          # neurons per QC batch past T_CHUNK
DECONV_BYTES = 256 << 20   # f32 trace bytes per deconvolution batch ...
DECONV_ALIGN = 64          # ... in multiples of this many neurons
CHUNK_BYTES = 256 << 20    # f32 frame bytes per streamed chunk


# ------------------------------------------------------------------ #
# block programs: plain functions on tensors, footprints (K, d)
# ------------------------------------------------------------------ #
def _ring_subtract(Yb, A_kd, C_b, b0, weights, radius, H, W, mesh=None):
    """The block's signal Y - B, B = W (Y - b0 - A C) + w0 + b0 by the
    ring stencil at full resolution (``streaming.py:40-59``); under a
    mesh on this rank's rows, with the ring's halo from its patch
    neighbours."""
    X = Yb - b0[None] - (C_b.T @ A_kd).reshape(Yb.shape)
    return Yb - (apply_ring(weights, X, H, W, radius, mesh=mesh) + b0[None])


def _block_temporal_U_raw(Yb, A_kd):
    """First-pass accumulators: the raw projection rows A Y_b (K, t) and
    the block's pixel sum. The mean-subtracted projection is separable,
    U[:, t] = A (Y_t - Ymean) = A Y_t - A Ymean, so the caller applies the
    rank-1 correction once the mean image is known."""
    Yb = Yb.to(torch.float32)
    return A_kd @ Yb.reshape(Yb.shape[0], -1).T, Yb.sum(dim=0)


def _block_temporal_U_ring(Yb, A_kd, C_blk, b0, weights, radius, H, W,
                           mesh=None):
    Yb = Yb.to(torch.float32)
    Ysig = _ring_subtract(Yb, A_kd, C_blk, b0, weights, radius, H, W, mesh)
    return A_kd @ Ysig.reshape(Yb.shape[0], -1).T


def _block_Bf(Yb_s, A_kd, Cc_s, Ymean, j0: int):
    """Ring-fit residual rows of an already strided frame subset; ``Cc_s``
    holds the centred traces on the same global stride grid and ``j0`` is
    this block's first column in it."""
    Yb_s = Yb_s.to(torch.float32)
    nb, H, W = Yb_s.shape
    recon = (Cc_s[:, j0:j0 + nb].T @ A_kd).reshape(nb, H, W)
    return Yb_s - Ymean[None] - recon


def _interp_grid_traces(Cg, t0: int, n: int, stride: int):
    """Linearly interpolate stride-grid traces (columns at frames 0,
    stride, 2 stride, ...) onto the ``n`` frames from ``t0``: the
    bootstrap iteration's C_prev for the streamed ring subtraction
    (``update_background_parallel.m:311-317`` freezes C_prev at the
    background stage, and iteration 0 has no full-T C yet)."""
    j = t0 + torch.arange(n, device=Cg.device)
    m = j // stride
    frac = (j % stride).to(torch.float32) / float(max(stride, 1))
    ng = Cg.shape[1]
    m0 = torch.clamp(m, 0, ng - 1)
    m1 = torch.clamp(m + 1, 0, ng - 1)
    return Cg[:, m0] * (1.0 - frac)[None] + Cg[:, m1] * frac[None]


def _block_spatial_U(U, Yb, A_kd, C_blk, b0, weights, radius, H, W,
                     mesh=None):
    """U += C_b Ysig_b, in place on the (K, d) accumulator."""
    Yb = Yb.to(torch.float32)
    Ysig = _ring_subtract(Yb, A_kd, C_blk, b0, weights, radius, H, W, mesh)
    return U.addmm_(C_blk, Ysig.reshape(Yb.shape[0], -1))


# ------------------------------------------------------------------ #
# block upload
# ------------------------------------------------------------------ #
def _prefetch_blocks(store: MovieStore, device, slicer=None,
                     sub_blocks: int = 1, spans: Optional[list] = None,
                     frames: Optional[Tuple[int, int]] = None,
                     rows: Optional[Tuple[int, int]] = None):
    """Iterate frame chunks as tensors on ``device``, in order: yields
    ``(t0, chunk)`` with t0 the chunk's global start frame, in the store's
    dtype. ``slicer(t0, memmap) -> ndarray`` reads only the frames a pass
    needs (the strided ring fit); ``sub_blocks`` splits each stored block
    (or its part in ``frames``) into that many chunks. ``frames`` and
    ``rows``: read only frames [t0, t1) and rows [h0, h1) (a mesh rank's
    block; default all).

    On a CUDA device a worker thread reads chunk i+1 into one of two
    pinned host buffers while chunk i is computed on; each copy runs on a
    copy stream, the compute stream waits on its event, and a buffer is
    refilled only after its last copy's event has completed. The chunk is
    marked used on the compute stream (``record_stream``), so its memory
    is not reused before the work queued on it has run. With ``spans``
    given, each copy appends (start event, end event, bytes)."""
    device = torch.device(device)
    fpb = store.frames_per_block
    T, H = store.shape[:2]
    f0, f1 = (0, T) if frames is None else frames
    h0, h1 = (0, H) if rows is None else rows
    jobs = []
    for i in range(store.n_blocks()):
        a, b = max(i * fpb, f0) - i * fpb, min((i + 1) * fpb, f1, T) - i * fpb
        if b <= a:
            continue
        step = -(-(b - a) // max(sub_blocks, 1))
        for s0 in range(a, b, step):
            jobs.append((i, s0, min(step, b - s0)))

    def chunk_of(job):
        i, s0, n = job
        blk = store.read_block(i)[s0:s0 + n, h0:h1]
        return slicer(i * fpb + s0, blk) if slicer is not None else blk

    if device.type != "cuda":
        for job in jobs:
            yield job[0] * fpb + job[1], torch.from_numpy(np.array(
                chunk_of(job)))
        return

    copy_stream = torch.cuda.Stream(device)
    compute = torch.cuda.current_stream(device)
    bufs = [None, None]       # pinned host buffers, alternating
    done = [None, None]       # each buffer's last copy-done event

    def read(j):
        chunk = chunk_of(jobs[j])
        slot = j % 2
        if done[slot] is not None:
            done[slot].synchronize()
        if bufs[slot] is None or bufs[slot].numel() < chunk.nbytes:
            bufs[slot] = torch.empty(chunk.nbytes, dtype=torch.uint8,
                                     pin_memory=True)
        host = bufs[slot][:chunk.nbytes].view(
            torch.from_numpy(np.empty(0, chunk.dtype)).dtype
        ).reshape(chunk.shape)
        np.copyto(host.numpy(), chunk)
        return host

    with cf.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(read, 0)
        for j, job in enumerate(jobs):
            host = fut.result()
            with torch.cuda.stream(copy_stream):
                if spans is not None:
                    start = torch.cuda.Event(enable_timing=True)
                    start.record(copy_stream)
                dev = host.to(device, non_blocking=True)
                end = torch.cuda.Event(enable_timing=spans is not None)
                end.record(copy_stream)
            if spans is not None:
                spans.append((start, end, host.numel() * host.element_size()))
            done[j % 2] = end
            if j + 1 < len(jobs):
                fut = ex.submit(read, j + 1)
            compute.wait_event(end)
            dev.record_stream(compute)
            yield job[0] * fpb + job[1], dev


# ------------------------------------------------------------------ #
# snapshots (the JAX package's npz format: A and traces as float16)
# ------------------------------------------------------------------ #
def _np(x, dtype=None) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def _save_snapshot(path: str, stage: str, state: CNMFEState, A=None,
                   traces: bool = True, **extra) -> None:
    out = dict(stage=stage,
               A=_np(state.A, np.float16) if A is None else A,
               active=_np(state.active),
               g=_np(state.g, np.float32),
               neuron_sn=_np(state.neuron_sn, np.float32))
    if traces:
        out.update(C=_np(state.C, np.float16),
                   C_raw=_np(state.C_raw, np.float16))
    np.savez(path, **out, **extra)


def fit_streaming(store: MovieStore, params: Optional[CNMFEParams] = None,
                  n_outer: int = 2, init_budget_frames: int = 4000,
                  verbose: bool = False,
                  snapshot_path: Optional[str] = None,
                  device="cuda", mesh=None, timer=None) -> CNMFEState:
    """Run CNMF-E streaming frame blocks from a :class:`MovieStore`, on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    ``snapshot_path``: optional .npz path; after the init, the temporal
    pass and every outer iteration the footprints (float16), active mask,
    g, neuron_sn and traces are saved there, and an existing file resumes
    the fit (the JAX package's format: a snapshot of either package
    resumes in the other). ``timer``: optional
    :class:`cnmf_e_tpu_torch.utils.profiling.StageTimer`; each stage ends
    with a device synchronisation, and the uploads' copy-stream time and
    bytes are added as stage ``upload``.

    ``mesh``: a :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh` (BASELINE
    config 5's "patch-sharded across N >= 2 hosts",
    ``cnmf_e_tpu/models/streaming.py:226-237``). Every rank calls
    ``fit_streaming`` with the same arguments and ``device=mesh.device``,
    streams its own frames and rows, and returns the same full state. The
    Grams are summed over 'frame' (spatial) and 'patch' (temporal), the
    block ring subtraction and the ring fit take the ring's halo rows from
    the patch neighbours, the ring fit gathers its strided rows over
    'frame', and the baseline and deconvolution run on whole traces, K /
    n_patch of them a patch rank. The init runs on the mesh on the
    proxy's blocks: each rank reads its rows and its even share of the
    proxy's frames (the same stride-tsub frames as one process) from the
    store, which every rank can read. The QC, the merges and the tags run
    on the mesh on the rank's blocks, as ``CNMFE(mesh=...).fit`` runs
    them, and the state is gathered at the end; no state is pickled.
    Rank 0 writes the snapshots (from gathered states) and computes the
    pixel noise. H, T and K_max must divide over their axes, the proxy's
    frames over 'frame' (``init_budget_frames`` sets them) and H /
    n_patch by ``init.ssub``; a ValueError names the one that does not,
    before any work."""
    params = params or CNMFEParams.preset_1p()
    device = torch.device(device)
    T, H, W = store.shape
    radius = params.background.ring_radius
    lead = mesh is None or mesh.rank == 0
    check_divisible(mesh, H=H, T=T)
    h0, h1 = (0, H) if mesh is None else mesh.rows(H)
    f0, f1 = (0, T) if mesh is None else mesh.frames(T)
    Hl = h1 - h0
    dl = Hl * W
    log = (lambda m: print(f"[stream] {m() if callable(m) else m}",
                           flush=True)) if verbose and lead \
        else (lambda m: None)
    spans = [] if timer is not None else None

    def blocks(slicer=None, sub_blocks=1):
        return _prefetch_blocks(store, device, slicer=slicer,
                                sub_blocks=sub_blocks, spans=spans,
                                frames=(f0, f1), rows=(h0, h1))

    def strided(stride):
        def slicer(t0, blk):
            return np.ascontiguousarray(blk[(-t0) % stride::stride])
        return slicer

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    def blocks_of(st: CNMFEState) -> CNMFEState:
        return st if mesh is None else state_blocks(st, mesh)

    def gathered(st: CNMFEState) -> CNMFEState:
        return st if mesh is None else gather_state(st, mesh)

    # ---- init on a decimated proxy movie, or resume ------------------
    state = None
    resume_mid = resume_post_spatial = False
    if snapshot_path is not None and os.path.exists(snapshot_path):
        with np.load(snapshot_path) as z:
            A_r = np.asarray(z["A"], np.float32)
            # the AR order from the saved g, else from the deconv model
            p_ar = (int(z["g"].shape[1]) if "g" in z.files
                    else 2 if params.temporal.deconv.model in ("ar2", "exp2")
                    else 1)
            state = empty_state(A_r.shape[0], H, W, 1, p=p_ar,
                                device=device).replace(
                A=tensor(A_r), active=tensor(z["active"], torch.bool))
            if "g" in z.files:
                state = state.replace(g=tensor(z["g"]),
                                      neuron_sn=tensor(z["neuron_sn"]))
            # a traces snapshot carries the full-T deconvolved C:
            # continue at the ring fit; a post-spatial one also carries
            # the new A and the ring weights: continue at QC / merge
            stage_str = str(z["stage"]) if "stage" in z.files else ""
            full_T = "C" in z.files and z["C"].shape[1] == T
            resume_post_spatial = stage_str.endswith("_spatial") and full_T
            resume_mid = resume_post_spatial or (
                stage_str.endswith("_traces") and full_T)
            if resume_post_spatial:
                resume_weights = _pixel_rows(RingWeights(
                    w=tensor(z["ring_w"]), w0=tensor(z["ring_w0"])),
                    h0 * W, h1 * W)
                resume_b0 = tensor(z["b0"])[h0:h1]
                resume_Ymean = tensor(z["Ymean"])[h0:h1]
            if resume_mid:
                Cj = tensor(z["C"])
                # S was not saved: the inverse AR recurrence of the
                # deconvolved C (zeros would trip the QC no-spikes tag)
                s_rec = Cj - state.g[:, :1] * torch.nn.functional.pad(
                    Cj[:, :-1], (1, 0))
                if p_ar == 2:
                    s_rec = s_rec - state.g[:, 1:2] * \
                        torch.nn.functional.pad(Cj[:, :-2], (2, 0))
                state = state.replace(C=Cj, C_raw=tensor(z["C_raw"]),
                                      S=torch.clamp(s_rec, min=0.0))
            state = blocks_of(state)
        log(lambda state=state: f"resumed {int(state.n_active())} neurons "
            f"from {snapshot_path} (stage {stage_str or '?'}"
            f"{', mid-iteration' if resume_mid else ''})")
    if state is None:
        tsub = max(-(-T // init_budget_frames), 1)
        ssub = max(int(params.init.ssub), 1)
        _check_proxy(mesh, T, H, tsub, ssub, init_budget_frames,
                     params.init.max_neurons)
        with timed(timer, "init"):
            state = _init_proxy(store, params, tsub, ssub, device, verbose,
                                mesh)
        log(lambda state=state: f"init (tsub={tsub}, ssub={ssub}): "
            f"{int(state.n_active())} neurons")
        if snapshot_path is not None:
            A_init = state.A if mesh is None else gather_footprints(state.A,
                                                                    mesh)
            if lead:
                _save_snapshot(snapshot_path, "init", state,
                               A=_np(A_init, np.float16), traces=False)
            log(f"init snapshot -> {snapshot_path}")

    # traces expand to full T at the first temporal solve; until then
    # they are T = 1 placeholders
    K_cap = state.K_max
    check_divisible(mesh, K=K_cap)
    if not resume_mid:
        z1 = torch.zeros((K_cap, 1), device=device)
        state = state.replace(C=z1, C_raw=z1, S=z1)
    k0, k1 = (0, K_cap) if mesh is None else mesh.neurons(K_cap)

    # ---- pixel noise, cached in the store (the first noise_frame_cap
    # frames, in row bands) ---------------------------------------------
    with timed(timer, "noise"):
        if lead and store.load_noise() is None:
            cap = min(params.noise_frame_cap, T)
            Yn = store.read_frames(0, cap)
            rows = max(1, min(H, int((512 << 20) // max(cap * W * 4, 1))))
            store.save_noise(np.concatenate([
                _np(noise_psd_frames(tensor(Yn[:, r0:r0 + rows])))
                for r0 in range(0, H, rows)], axis=0))
            del Yn

    fpb = store.frames_per_block
    sub_blocks = max(1, -(-fpb * dl * 4 // CHUNK_BYTES))
    R = ring_offsets(radius).shape[0]
    stride = max(int(np.ceil(T / (params.background.frame_cap_factor * R))),
                 1)

    n_grid = len(range(0, T, stride))
    g_lo = -(-f0 // stride)          # this rank's first grid column
    Tl = f1 - f0
    _, grid_sizes = stride_grid(T, stride, mesh)

    def fit_ring(Bf):
        """The ring weights of this rank's pixels from its strided
        residual rows Bf (its frames and rows): under a mesh the rows take
        the ring's halo from the patch neighbours and the frames of the
        other frame ranks."""
        return fit_ring_weights_mesh(Bf, H, W, radius, mesh, grid_sizes,
                                     ridge_eps=params.background.ridge_eps)

    weights = None
    Ymean = None

    for it in range(n_outer):
        skip_temporal = resume_mid and it == 0
        skip_ring_spatial = resume_post_spatial and it == 0
        # the (K, d) view of the footprints the block programs read
        A_kd = state.A.reshape(K_cap, dl)
        if skip_ring_spatial:
            state = state.replace(b0=resume_b0, W=resume_weights)
            weights = resume_weights
            Ymean = resume_Ymean
            log(f"iter {it}: resumed at QC/merge")
        elif skip_temporal:
            # Ymean died with the interrupted process: re-estimate it on
            # the host from the ring-fit stride grid
            acc_h = np.zeros((H, W), np.float64)
            n_h = 0
            for bi in range(store.n_blocks()):
                sub = np.asarray(store.read_block(bi)[
                    (-(bi * fpb)) % stride::stride], np.float32)
                acc_h += sub.sum(axis=0)
                n_h += sub.shape[0]
            Ymean = tensor((acc_h / max(n_h, 1)).astype(np.float32))[h0:h1]
            log(f"iter {it}: resumed at ring fit (strided Ymean over {n_h} "
                f"frames)")
        C_boot = None
        if (not skip_temporal and weights is None
                and params.background.ring_bootstrap):
            # ---- strided ring bootstrap: fit the ring model from one
            # 1/stride upload first (grid traces solved from the same
            # frames), so iteration 0's temporal pass already subtracts
            # the ring background (demo_large_data_1p.m:199-209) -------
            with timed(timer, "bootstrap"):
                Yg = torch.cat([b for _, b in blocks(strided(stride))])
                n_loc = Yg.shape[0]
                gb = max(fpb // stride, 1)
                Ug = torch.empty((K_cap, n_loc), device=device)
                acc_g = torch.zeros((Hl, W), device=device)
                for g0 in range(0, n_loc, gb):
                    Ub, s = _block_temporal_U_raw(Yg[g0:g0 + gb], A_kd)
                    Ug[:, g0:g0 + gb] = Ub
                    acc_g += s
                Ymean = comm.psum(acc_g, mesh, "frame") / n_grid
                Vg = comm.psum(A_kd @ A_kd.T, mesh, "patch")
                Ug -= (A_kd @ Ymean.reshape(-1))[:, None]
                Ug = comm.psum(Ug, mesh, "patch")
                C0g = torch.clamp(Ug / torch.clamp(torch.diagonal(Vg),
                                                   min=1e-12)[:, None],
                                  min=0.0)
                Cg = hals_temporal_sweeps(Ug, Vg, C0g,
                                          n_iter=params.temporal.n_iter,
                                          active=state.active)
                del Ug, C0g
                Cg_mean = comm.frame_mean(Cg, -1, mesh, n=n_grid)
                state = state.replace(
                    b0=Ymean - (Cg_mean @ A_kd).reshape(Hl, W))
                Ccg = (Cg - Cg_mean[:, None]).contiguous()
                Bf = torch.cat([_block_Bf(Yg[g0:g0 + gb], A_kd, Ccg, Ymean,
                                          g0)
                                for g0 in range(0, n_loc, gb)])
                del Yg, Ccg
                weights = fit_ring(Bf)
                del Bf
                state = state.replace(W=weights)
                C_boot = (Cg if mesh is None else comm.all_gather_cat(
                    Cg, 1, mesh.frame_group, grid_sizes))
            log(f"iter {it}: ring bootstrap fit ({n_grid} strided frames)")
        if not skip_temporal:
            # ---- temporal pass: the projection U = A Ysig accumulates
            # over blocks and V = A A^T is frame-independent, so the full
            # cross-term coordinate descent (HALS_temporal.m:58-107) runs
            # exactly as in memory ----------------------------------------
            with timed(timer, "temporal"):
                V = comm.psum(A_kd @ A_kd.T, mesh, "patch")
                aa = torch.diagonal(V)
                U = torch.empty((K_cap, Tl), device=device)
                if weights is None:
                    # the first pass doubles as the mean-image
                    # accumulation
                    acc = torch.zeros((Hl, W), device=device)
                    for t0, Yb in blocks(sub_blocks=sub_blocks):
                        Ub, s = _block_temporal_U_raw(Yb, A_kd)
                        U[:, t0 - f0:t0 - f0 + Yb.shape[0]] = Ub
                        acc += s
                    Ymean = comm.psum(acc, mesh, "frame") / T
                    U -= (A_kd @ Ymean.reshape(-1))[:, None]
                else:
                    for t0, Yb in blocks(sub_blocks=sub_blocks):
                        n = Yb.shape[0]
                        C_blk = (_interp_grid_traces(C_boot, t0, n, stride)
                                 if C_boot is not None
                                 else state.C[:, t0 - f0:t0 - f0 + n])
                        U[:, t0 - f0:t0 - f0 + n] = _block_temporal_U_ring(
                            Yb, A_kd, C_blk, state.b0, weights, radius, H, W,
                            mesh)
                U = comm.psum(U, mesh, "patch")
                # frame-chunked sweeps: columns are independent given V
                parts = []
                for t0 in range(0, Tl, T_CHUNK):
                    Ub = U[:, t0:t0 + T_CHUNK].contiguous()
                    C0 = torch.clamp(Ub / torch.clamp(aa, min=1e-12)[:, None],
                                     min=0.0)
                    parts.append(hals_temporal_sweeps(
                        Ub, V, C0, n_iter=params.temporal.n_iter,
                        active=state.active))
                del U
                C_raw = parts[0] if len(parts) == 1 else torch.cat(parts, 1)
                del parts
                # neuron-batched baseline + deconvolution on whole traces
                # (this patch rank's neurons under a mesh): rows are
                # independent, so batching is exact
                C_raw = comm.traces_to_neurons(C_raw, mesh)
                act = state.active[k0:k1, None]
                rows = (max(DECONV_ALIGN, DECONV_BYTES // max(T * 4, 1)
                            // DECONV_ALIGN * DECONV_ALIGN)
                        if T > T_CHUNK else k1 - k0)
                C_new = torch.empty_like(C_raw)
                Cr_new = torch.empty_like(C_raw)
                S_new = torch.empty_like(C_raw)
                for sl in row_batches(k1 - k0, rows):
                    Cb = C_raw[sl]
                    Cb = Cb - submedian_mean(Cb, dim=-1)[:, None]
                    res = deconvolve(Cb, params.temporal.deconv)
                    C_new[sl] = torch.where(act[sl], res.c, 0.0)
                    Cr_new[sl] = torch.where(act[sl], Cb - res.b[:, None],
                                             0.0)
                    S_new[sl] = torch.where(act[sl], res.s, 0.0)
                del C_raw
                state = state.replace(
                    C=comm.traces_to_frames(C_new, T, mesh),
                    C_raw=comm.traces_to_frames(Cr_new, T, mesh),
                    S=comm.traces_to_frames(S_new, T, mesh))
            log(lambda state=state:
                f"iter {it}: traces ({int(state.n_active())} neurons)")
            if snapshot_path is not None:
                # A is unchanged by the temporal stage: reuse the previous
                # snapshot's copy
                full = gathered(state)
                if lead:
                    A_prev = None
                    if os.path.exists(snapshot_path):
                        with np.load(snapshot_path) as z:
                            A_prev = z["A"]
                    _save_snapshot(snapshot_path, f"iter{it}_traces", full,
                                   A=A_prev)
                log(f"iter {it}: traces snapshot -> {snapshot_path}")

        if not skip_ring_spatial:
            # ---- ring background fit on strided residual rows ----------
            with timed(timer, "ring_fit"):
                Cmean = comm.frame_mean(state.C, -1, mesh)
                state = state.replace(
                    b0=Ymean - (Cmean @ A_kd).reshape(Hl, W))
                Cc_s = (state.C - Cmean[:, None])[
                    :, (-f0) % stride::stride].contiguous()
                Bf = torch.cat([
                    _block_Bf(Yb_s, A_kd, Cc_s, Ymean,
                              -(-t0 // stride) - g_lo)
                    for t0, Yb_s in blocks(strided(stride))])
                del Cc_s
                weights = fit_ring(Bf)
                del Bf
                state = state.replace(W=weights)
            log(f"iter {it}: ring background fit")

            # ---- spatial: streamed Gram accumulation, then HALS on the
            # row-major (K, d) factor -----------------------------------
            with timed(timer, "spatial"):
                C = state.C
                U = torch.zeros((K_cap, dl), device=device)
                for t0, Yb in blocks(sub_blocks=sub_blocks):
                    _block_spatial_U(U, Yb, A_kd,
                                     C[:, t0 - f0:t0 - f0 + Yb.shape[0]],
                                     state.b0, weights, radius, H, W, mesh)
                U = comm.psum(U, mesh, "frame")
                V = comm.psum(C @ C.T, mesh, "frame")
                if dl > 2 * D_CHUNK:
                    # pixel-chunked sweeps: pixels are independent given V
                    A_new = torch.cat([hals_spatial_sweeps_rows(
                        U[:, p0:p0 + D_CHUNK].contiguous(), V,
                        A_kd[:, p0:p0 + D_CHUNK].contiguous(),
                        n_iter=params.spatial.n_iter)
                        for p0 in range(0, dl, D_CHUNK)], dim=1)
                else:
                    A_new = hals_spatial_sweeps_rows(
                        U, V, A_kd, n_iter=params.spatial.n_iter)
                del U, A_kd
                state = state.replace(A=A_new.reshape(K_cap, Hl, W)
                                      * state.active[:, None, None])
            log(f"iter {it}: spatial")
            if snapshot_path is not None and T > T_CHUNK:
                # post-spatial snapshot: a resume point past the two
                # full-movie passes
                full = gathered(state)
                Ym = Ymean if mesh is None else gather_image(Ymean, mesh)
                if lead:
                    _save_snapshot(snapshot_path, f"iter{it}_spatial", full,
                                   ring_w=_np(full.W.w, np.float16),
                                   ring_w0=_np(full.W.w0, np.float32),
                                   b0=_np(full.b0, np.float32),
                                   Ymean=_np(Ym, np.float32))
                log(f"iter {it}: spatial snapshot -> {snapshot_path}")

        with timed(timer, "qc_merge"):
            state = _quality_control(state, params, T, deactivate=True,
                                     mesh=mesh)
            # deconv=False: non-final iterations are re-deconvolved by the
            # next temporal pass; on the final one the merged clusters
            # keep their rank-1 refit traces
            state, nm = merge_neurons(state, params, "dist_corr",
                                      deconv=False, mesh=mesh)
            state, nm2 = merge_neurons(state, params, "dist_only",
                                       deconv=False, mesh=mesh)
            nm, nm2 = int(nm), int(nm2)
        if snapshot_path is not None:
            full = gathered(state)
            if lead:
                _save_snapshot(snapshot_path, f"iter{it}", full)
        log(lambda nm=nm, nm2=nm2, state=state:
            f"iter {it}: QC + merges ({nm}+{nm2}), "
            f"{int(state.n_active())} neurons")
        if snapshot_path is not None:
            log(f"iter {it}: snapshot -> {snapshot_path}")

    with timed(timer, "tags"):
        state = compact(_quality_control(state, params, T, deactivate=False,
                                         mesh=mesh))
    if mesh is not None:
        with timed(timer, "gather"):
            state = gather_state(state, mesh)
    if timer is not None and spans:
        torch.cuda.synchronize(device)
        timer.add("upload", sum(a.elapsed_time(b) for a, b, _ in spans)
                  / 1e3, count=len(spans),
                  nbytes=sum(n for _, _, n in spans))
    return state


def _pixel_rows(w: RingWeights, p0: int, p1: int) -> RingWeights:
    return RingWeights(w=w.w[p0:p1].contiguous(), w0=w.w0[p0:p1].contiguous())


def _check_proxy(mesh, T: int, H: int, tsub: int, ssub: int,
                 budget: int, K_max: int) -> None:
    """The mesh init's guards, alike on every rank and before any work: a
    ValueError where the proxy's frames do not divide over 'frame', where
    a rank's rows do not pool alone (H / n_patch not a multiple of
    ``init.ssub``), or where K_max does not divide over 'patch'."""
    if mesh is None:
        return
    P = len(range(0, T, tsub))
    if P % mesh.n_frame:
        raise ValueError(
            f"the init proxy's {P} frames (T = {T} at tsub = {tsub}, set "
            f"by init_budget_frames = {budget}) are not divisible by the "
            f"{mesh.n_frame} ranks of the 'frame' axis")
    Hl = H // mesh.n_patch
    if Hl % ssub:
        raise ValueError(f"H / n_patch = {Hl} is not a multiple of "
                         f"init.ssub = {ssub}")
    check_divisible(mesh, K=K_max)


def _init_proxy(store: MovieStore, params: CNMFEParams, tsub: int,
                ssub: int, device, verbose: bool, mesh=None) -> CNMFEState:
    """The greedy init on a proxy movie decimated tsub-fold in time (the
    stride-tsub frames 0, tsub, 2 tsub, ...) and pooled ssub-fold in
    space, built block by block on the host (bounded RAM; the pool cuts
    the upload by ssub^2); footprints back at full resolution, T = 1
    traces (they are rebuilt at full T).

    ``mesh``: each rank reads from the store only its block of the
    proxy, its pooled rows and its even share of the proxy's frames, runs
    ``initialize_greedy(mesh=...)`` on it and resizes its footprints back
    on its own rows; the state returned is its blocks."""
    T, H, W = store.shape
    Hs, Ws = H // ssub, W // ssub
    P = len(range(0, T, tsub))
    j0, j1 = (0, P) if mesh is None else mesh.frames(P)
    c0, c1 = (0, Hs) if mesh is None else mesh.rows(Hs)
    fpb = store.frames_per_block
    parts = []
    for i in range(store.n_blocks()):
        b0, b1 = i * fpb, min((i + 1) * fpb, T)
        # this block's grid frames j tsub, j in [j0, j1)
        lo = max(-(-b0 // tsub), j0) * tsub
        hi = min(b1, (j1 - 1) * tsub + 1)
        if hi <= lo:
            continue
        sl = np.asarray(store.read_block(i)[
            lo - b0:hi - b0:tsub, c0 * ssub:c1 * ssub, :Ws * ssub]
        ).astype(np.float32)
        if ssub > 1:
            sl = sl.reshape(sl.shape[0], c1 - c0, ssub, Ws, ssub).mean(
                axis=(2, 4))
        parts.append(sl)
    Y_proxy = torch.as_tensor(np.concatenate(parts, axis=0), device=device)
    del parts
    ip_init = dataclasses.replace(
        params.init, tsub=1, ssub=1, gSig=max(params.init.gSig / ssub, 0.0),
        gSiz=max(int(params.init.gSiz // ssub), 3))
    state, _ = initialize_greedy(Y_proxy, params.replace(init=ip_init),
                                 verbose=verbose, mesh=mesh)
    del Y_proxy
    if ssub > 1:
        # footprints back to full resolution (under a mesh the rank's
        # rows, with the resize's halo row from its neighbours); traces
        # are rebuilt at full T, so only A, active, g and sn carry
        Hl = H if mesh is None else (c1 - c0) * ssub
        state = empty_state(state.K_max, Hl, W, 1, p=state.g.shape[1],
                            device=device).replace(
            A=resize_linear(state.A, (Hl, W), mesh)
            * state.active[:, None, None],
            active=state.active, g=state.g, neuron_sn=state.neuron_sn)
    return state


def _quality_control(state: CNMFEState, params: CNMFEParams, T: int,
                     deactivate: bool, mesh=None) -> CNMFEState:
    """Tag the neurons (and, with ``deactivate``, drop the tagged ones),
    in batches of at most QC_ROWS whole traces past T_CHUNK frames: the
    tags' Welch PSD frames the whole (K, T) C_raw, and rows are
    independent. ``mesh``: the state is this rank's blocks, and the
    batches split the rank's K / n_patch whole traces."""
    state = tag_neurons(state, params, mesh,
                        rows=QC_ROWS if T > T_CHUNK else None)
    if not deactivate:
        return state
    return _apply_keep(state, state.active & (state.tags == 0))
