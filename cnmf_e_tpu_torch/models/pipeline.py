"""End-to-end CNMF-E pipeline (port of ``cnmf_e_tpu/models/pipeline.py``).

Stage order mirrors the reference demo (``demo_large_data_1p.m:122-232``):

  init -> merge -> background -> residual pick -> spatial -> merge ->
  [temporal -> QC -> merge -> spatial] x n_outer -> merge ->
  background -> spatial -> temporal -> QC -> merges -> [refit] -> tags

``CNMFE(..., mesh=mesh).fit(block)`` runs the same stages on a (patch,
frame) mesh of ``torch.distributed`` ranks (``parallel/mesh.py``): every
rank passes its (T/frame, H/patch, W) block of the movie
(``mesh.shard_movie``), the movie and the footprints stay sharded through
every stage, each stage sums over the mesh what it needs (the modules'
docstrings), and every rank returns the same full state, gathered at the
end. Every option of :class:`~cnmf_e_tpu_torch.config.CNMFEParams` runs
so, and every method of :class:`CNMFE` takes the rank's block of a movie
and returns the rank's block (``compute_rss`` the whole mesh's sum).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from cnmf_e_tpu_torch.checkpoint import restore_state
from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.convert import gather_state, state_blocks
from cnmf_e_tpu_torch.models.background import (background_of,
                                                residual_movie,
                                                subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models import initialize
from cnmf_e_tpu_torch.models.dff import extract_dff
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons, merge_neurons_seq
from cnmf_e_tpu_torch.models.qc import remove_false_positives, tag_neurons
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState, compact
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import check_divisible
from cnmf_e_tpu_torch.utils.profiling import timed


def _check_mesh(params: CNMFEParams, Y: torch.Tensor, mesh,
                run_log) -> bool:
    """The mesh path's guards, before any stage runs: a ValueError naming
    a dimension that does not divide (or in which the ranks' blocks
    differ). Returns whether any rank was given a ``run_log``, so that
    every rank gathers the snapshots alike."""
    shape = torch.tensor(tuple(Y.shape) + (run_log is not None,),
                         dtype=torch.int64, device=Y.device)
    hi = comm.all_reduce_max(shape.clone(), None)      # the whole mesh
    lo = comm.all_reduce_min(shape.clone(), None)
    for i, name in enumerate(("T", "H", "W")):
        if int(hi[i]) != int(lo[i]):
            raise ValueError(f"the ranks' blocks differ in {name}: "
                             f"{int(lo[i])} to {int(hi[i])}")
    # after the shapes: every rank raises alike from here on
    initialize.check_mesh_options(params, mesh, Y.shape)
    check_divisible(mesh, K=params.init.max_neurons)
    ssub = params.background.ssub
    if ssub > 1 and Y.shape[1] % ssub:
        raise ValueError(f"H / n_patch = {Y.shape[1]} is not a multiple "
                         f"of background.ssub = {ssub}")
    return bool(hi[3])


class CNMFE:
    """High-level pipeline object. Every tensor it builds lives on
    ``device``: the card by default, where the CUDA kernels run;
    ``device="cpu"`` runs their plain PyTorch versions. ``mesh``: a
    :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh`; :meth:`fit` then takes
    this rank's block of the movie (the module docstring), and the
    device is the mesh's (another ``device`` raises)."""

    def __init__(self, params: Optional[CNMFEParams] = None,
                 device=None, mesh=None):
        self.params = params or CNMFEParams.preset_1p()
        if mesh is not None:
            d = mesh.device if device is None else torch.device(device)
            if d.type != mesh.device.type or d.index not in (
                    None, mesh.device.index):
                raise ValueError(f"device {d} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = torch.device("cuda" if device is None else device)
        self.mesh = mesh
        self.state: Optional[CNMFEState] = None
        self.info: dict = {}

    def _movie(self, Y) -> torch.Tensor:
        return torch.as_tensor(Y, device=self.device).to(torch.float32)

    def _fitted(self) -> CNMFEState:
        """The fitted state, under a mesh this rank's blocks of it."""
        if self.state is None:
            raise RuntimeError("run fit() first")
        if self.mesh is None:
            return self.state
        return state_blocks(self.state, self.mesh)

    def estimate_pixel_noise(self, Y: torch.Tensor) -> torch.Tensor:
        """Per-pixel noise sigma over the first ``noise_frame_cap`` frames
        (``Sources2D.m:328-379``); under a mesh Y is this rank's block and
        the sigma its rows'."""
        return noise_psd_frames(Y, mesh=self.mesh,
                                n_frames=self.params.noise_frame_cap)

    def fit(self, Y, n_outer: int = 2, verbose: bool = False,
            run_log=None, resume_from: Optional[str] = None,
            timer=None) -> CNMFEState:
        """Run the full pipeline on an in-memory movie Y (T, H, W), numpy
        or tensor.

        ``run_log``: optional :class:`cnmf_e_tpu_torch.checkpoint.RunLog`
        (stage snapshots and a timestamped log). ``resume_from``: a
        snapshot .npz of either package; initialization is skipped and
        the state restored from it. ``timer``: optional
        :class:`cnmf_e_tpu_torch.utils.profiling.StageTimer`, which sums
        wall time per stage (the JAX package's stage names), each stage
        closed by a device synchronisation.

        Under a mesh every rank calls ``fit`` with its block of Y and the
        same arguments, and gets the same full state. ``run_log`` may be
        given on rank 0 alone: every rank gathers the snapshots' states
        alike, and only rank 0 writes. ``resume_from``: every rank
        restores the whole snapshot and keeps its blocks."""
        p = self.params
        mesh = self.mesh
        with timed(timer, "scrub"):
            Y = self._movie(Y)
            # rank-local under a mesh: no collective depends on it
            if not bool(torch.isfinite(Y.sum())):
                Y = torch.nan_to_num(Y)
        snapshots = run_log is not None
        if mesh is not None:
            snapshots = _check_mesh(p, Y, mesh, run_log)
            if mesh.rank != 0:
                run_log = None
        t0 = time.time()

        def log(msg):
            if not verbose and run_log is None:
                return
            msg = f"{msg() if callable(msg) else msg} " \
                f"({time.time() - t0:.1f}s)"
            if verbose:
                print(f"[cnmfe] {msg}", flush=True)
            if run_log is not None:
                run_log.log(msg)

        def snapshot(stage, state):
            # gather_state is a collective: every rank takes this branch
            if snapshots and mesh is not None:
                state = gather_state(state, mesh)
            if run_log is not None:
                run_log.snapshot(stage, state)

        with timed(timer, "noise"):
            sn_pix = self.estimate_pixel_noise(Y)
        log("pixel noise estimated")

        if resume_from is not None:
            T, H, W = Y.shape
            if mesh is not None:
                T, H = T * mesh.n_frame, H * mesh.n_patch
            state = restore_state(resume_from, p.init.max_neurons, H, W, T,
                                  device=self.device)
            if mesh is not None:
                state = state_blocks(state, mesh)
            log(lambda: f"resumed {int(state.n_active())} neurons from "
                f"{resume_from}")
        else:
            with timed(timer, "init"):
                state, info = initialize_greedy(Y, p, verbose=verbose,
                                                mesh=mesh)
            self.info.update(Cn=info["Cn"], PNR=info["PNR"])
            log(lambda: f"init: {int(state.n_active())} neurons")
            with timed(timer, "merge"):
                state, _ = merge_neurons(state, p, "dist_corr", mesh=mesh)
            snapshot("init", state)
            with timed(timer, "background"):
                state = update_background(Y, state, p, sn_pix=sn_pix,
                                          mesh=mesh)
            with timed(timer, "residual_pick"):
                state = compact(state)
                state, _ = initialize_greedy(
                    residual_movie(Y, state, p, mesh), p, state=state,
                    min_corr=p.init.min_corr_res,
                    min_pnr=p.init.min_pnr_res, verbose=verbose, mesh=mesh)
            log(lambda: f"residual pick: {int(state.n_active())} neurons")

        # spatial first so residual duplicates refit onto the data; the
        # temporal update that follows re-deconvolves merged traces
        with timed(timer, "spatial"):
            Ysig = subtract_background(Y, state, p, mesh)
            state = update_spatial(Ysig, state, p, sn_pix=sn_pix, mesh=mesh)
        with timed(timer, "merge"):
            state, _ = merge_neurons(state, p, "high_corr", deconv=False,
                                     mesh=mesh)

        for it in range(max(n_outer, 1)):
            re_bg = p.background.refresh_every
            if re_bg > 0 and it > 0 and it % re_bg == 0:
                with timed(timer, "background"):
                    state = update_background(Y, state, p, sn_pix=sn_pix,
                                              mesh=mesh)
                    Ysig = subtract_background(Y, state, p, mesh)
            with timed(timer, "temporal"):
                state = update_temporal(Ysig, state, p, mesh)
            with timed(timer, "qc"):
                state = remove_false_positives(state, p, mesh=mesh)
            with timed(timer, "merge"):
                state, _ = merge_neurons(state, p, "dist_corr", deconv=False,
                                         mesh=mesh)
            with timed(timer, "spatial"):
                state = update_spatial(Ysig, state, p, sn_pix=sn_pix,
                                       mesh=mesh)
            log(lambda it=it: f"iter {it}: {int(state.n_active())} neurons")

        # fold co-located duplicates into their originals
        with timed(timer, "merge"):
            state, _ = merge_neurons(state, p, "dist_only", deconv=False,
                                     mesh=mesh)

        # final full pass on a refreshed background
        with timed(timer, "background"):
            state = update_background(Y, state, p, sn_pix=sn_pix, mesh=mesh)
        with timed(timer, "spatial"):
            Ysig = subtract_background(Y, state, p, mesh)
            state = update_spatial(Ysig, state, p, sn_pix=sn_pix, mesh=mesh)
        with timed(timer, "temporal"):
            state = update_temporal(Ysig, state, p, mesh)
        # the active mask is the same on every rank of a mesh, so every
        # rank takes the refit branch below alike
        k_before = int(state.n_active())
        with timed(timer, "qc"):
            state = remove_false_positives(state, p, mesh=mesh)
        # if a merge fires the count drops below k_before and the refit
        # below re-deconvolves
        with timed(timer, "merge"):
            state, _ = merge_neurons_seq(state, p,
                                         ("dist_corr", "high_corr"),
                                         deconv=False, mesh=mesh)
        if int(state.n_active()) != k_before:
            with timed(timer, "spatial"):
                Ysig = subtract_background(Y, state, p, mesh)
                state = update_spatial(Ysig, state, p, sn_pix=sn_pix,
                                       mesh=mesh)
            with timed(timer, "temporal"):
                state = update_temporal(Ysig, state, p, mesh)
            with timed(timer, "qc"):
                state = remove_false_positives(state, p, mesh=mesh)
        state = compact(tag_neurons(state, p, mesh))
        if mesh is not None:
            with timed(timer, "gather"):
                state = gather_state(state, mesh)
        log(lambda: f"done: {int(state.n_active())} neurons")
        if run_log is not None:
            run_log.snapshot("final", state)     # gathered above
        self.state = state
        return state

    def dff(self, Y, window: Optional[int] = None, prctile: float = 50.0):
        """(C_df, C_raw_df, F0) of the fitted state on the movie Y
        (:func:`cnmf_e_tpu_torch.models.dff.extract_dff`); under a mesh Y
        is this rank's block, and the traces returned are its frames."""
        return extract_dff(self._movie(Y), self._fitted(), self.params,
                           window=window, prctile=prctile, mesh=self.mesh)

    def background(self, Y) -> torch.Tensor:
        """The background B of the movie Y (this rank's block of both
        under a mesh)."""
        return background_of(self._movie(Y), self._fitted(), self.params,
                             mesh=self.mesh)

    def reconstruction(self, Y) -> torch.Tensor:
        """Denoised movie A C + B (this rank's block under a mesh)."""
        st = self._fitted()
        B = self.background(Y)
        A = st.masked_A()
        AC = st.masked_C().T @ A.reshape(A.shape[0], -1)
        return AC.reshape(B.shape) + B

    def residual(self, Y) -> torch.Tensor:
        return self._movie(Y) - self.reconstruction(Y)

    def compute_rss(self, Y) -> float:
        """||Y - AC - B||_F^2 (``Sources2D.m:1358-1510``); under a mesh
        the sum over every rank's block."""
        r = self.residual(Y)
        rss = (r * r).sum()
        if self.mesh is not None:
            rss = comm.all_reduce_sum(rss.reshape(1), None)[0]
        return float(rss)
