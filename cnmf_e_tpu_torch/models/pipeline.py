"""End-to-end CNMF-E pipeline (port of ``cnmf_e_tpu/models/pipeline.py``).

Stage order mirrors the reference demo (``demo_large_data_1p.m:122-232``):

  init -> merge -> background -> residual pick -> spatial -> merge ->
  [temporal -> QC -> merge -> spatial] x n_outer -> merge ->
  background -> spatial -> temporal -> QC -> merges -> [refit] -> tags
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from cnmf_e_tpu_torch.checkpoint import restore_state
from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.background import (background_of,
                                                residual_movie,
                                                subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.dff import extract_dff
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.merge import merge_neurons, merge_neurons_seq
from cnmf_e_tpu_torch.models.qc import remove_false_positives, tag_neurons
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState, compact
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.ops.noise import noise_psd_frames
from cnmf_e_tpu_torch.utils.profiling import timed


class CNMFE:
    """High-level pipeline object. Every tensor it builds lives on
    ``device``: the card by default, where the CUDA kernels run;
    ``device="cpu"`` runs their plain PyTorch versions."""

    def __init__(self, params: Optional[CNMFEParams] = None,
                 device="cuda"):
        self.params = params or CNMFEParams.preset_1p()
        self.device = torch.device(device)
        self.state: Optional[CNMFEState] = None
        self.info: dict = {}

    def _movie(self, Y) -> torch.Tensor:
        return torch.as_tensor(Y, device=self.device).to(torch.float32)

    def estimate_pixel_noise(self, Y: torch.Tensor) -> torch.Tensor:
        """Per-pixel noise sigma over the first ``noise_frame_cap`` frames
        (``Sources2D.m:328-379``)."""
        return noise_psd_frames(Y[:min(self.params.noise_frame_cap,
                                       Y.shape[0])])

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
        closed by a device synchronisation."""
        p = self.params
        with timed(timer, "scrub"):
            Y = self._movie(Y)
            if not bool(torch.isfinite(Y.sum())):
                Y = torch.nan_to_num(Y)
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

        with timed(timer, "noise"):
            sn_pix = self.estimate_pixel_noise(Y)
        log("pixel noise estimated")

        if resume_from is not None:
            T, H, W = Y.shape
            state = restore_state(resume_from, p.init.max_neurons, H, W, T,
                                  device=self.device)
            log(lambda: f"resumed {int(state.n_active())} neurons from "
                f"{resume_from}")
        else:
            with timed(timer, "init"):
                state, info = initialize_greedy(Y, p, verbose=verbose)
            self.info.update(Cn=info["Cn"], PNR=info["PNR"])
            log(lambda: f"init: {int(state.n_active())} neurons")
            with timed(timer, "merge"):
                state, _ = merge_neurons(state, p, "dist_corr")
            if run_log is not None:
                run_log.snapshot("init", state)
            with timed(timer, "background"):
                state = update_background(Y, state, p, sn_pix=sn_pix)
            with timed(timer, "residual_pick"):
                state = compact(state)
                state, _ = initialize_greedy(
                    residual_movie(Y, state, p), p, state=state,
                    min_corr=p.init.min_corr_res,
                    min_pnr=p.init.min_pnr_res, verbose=verbose)
            log(lambda: f"residual pick: {int(state.n_active())} neurons")

        # spatial first so residual duplicates refit onto the data; the
        # temporal update that follows re-deconvolves merged traces
        with timed(timer, "spatial"):
            Ysig = subtract_background(Y, state, p)
            state = update_spatial(Ysig, state, p, sn_pix=sn_pix)
        with timed(timer, "merge"):
            state, _ = merge_neurons(state, p, "high_corr", deconv=False)

        for it in range(max(n_outer, 1)):
            re_bg = p.background.refresh_every
            if re_bg > 0 and it > 0 and it % re_bg == 0:
                with timed(timer, "background"):
                    state = update_background(Y, state, p, sn_pix=sn_pix)
                    Ysig = subtract_background(Y, state, p)
            with timed(timer, "temporal"):
                state = update_temporal(Ysig, state, p)
            with timed(timer, "qc"):
                state = remove_false_positives(state, p)
            with timed(timer, "merge"):
                state, _ = merge_neurons(state, p, "dist_corr", deconv=False)
            with timed(timer, "spatial"):
                state = update_spatial(Ysig, state, p, sn_pix=sn_pix)
            log(lambda it=it: f"iter {it}: {int(state.n_active())} neurons")

        # fold co-located duplicates into their originals
        with timed(timer, "merge"):
            state, _ = merge_neurons(state, p, "dist_only", deconv=False)

        # final full pass on a refreshed background
        with timed(timer, "background"):
            state = update_background(Y, state, p, sn_pix=sn_pix)
        with timed(timer, "spatial"):
            Ysig = subtract_background(Y, state, p)
            state = update_spatial(Ysig, state, p, sn_pix=sn_pix)
        with timed(timer, "temporal"):
            state = update_temporal(Ysig, state, p)
        k_before = int(state.n_active())
        with timed(timer, "qc"):
            state = remove_false_positives(state, p)
        # if a merge fires the count drops below k_before and the refit
        # below re-deconvolves
        with timed(timer, "merge"):
            state, _ = merge_neurons_seq(state, p,
                                         ("dist_corr", "high_corr"),
                                         deconv=False)
        if int(state.n_active()) != k_before:
            with timed(timer, "spatial"):
                Ysig = subtract_background(Y, state, p)
                state = update_spatial(Ysig, state, p, sn_pix=sn_pix)
            with timed(timer, "temporal"):
                state = update_temporal(Ysig, state, p)
            with timed(timer, "qc"):
                state = remove_false_positives(state, p)
        state = compact(tag_neurons(state, p))
        log(lambda: f"done: {int(state.n_active())} neurons")
        if run_log is not None:
            run_log.snapshot("final", state)
        self.state = state
        return state

    def dff(self, Y, window: Optional[int] = None, prctile: float = 50.0):
        """(C_df, C_raw_df, F0) of the fitted state on the movie Y
        (:func:`cnmf_e_tpu_torch.models.dff.extract_dff`)."""
        if self.state is None:
            raise RuntimeError("run fit() first")
        return extract_dff(self._movie(Y), self.state, self.params,
                           window=window, prctile=prctile)

    def background(self, Y) -> torch.Tensor:
        if self.state is None:
            raise RuntimeError("run fit() first")
        return background_of(self._movie(Y), self.state, self.params)

    def reconstruction(self, Y) -> torch.Tensor:
        """Denoised movie A C + B."""
        st = self.state
        B = self.background(Y)
        A = st.masked_A()
        AC = st.masked_C().T @ A.reshape(A.shape[0], -1)
        return AC.reshape(B.shape) + B

    def residual(self, Y) -> torch.Tensor:
        return self._movie(Y) - self.reconstruction(Y)

    def compute_rss(self, Y) -> float:
        """||Y - AC - B||_F^2 (``Sources2D.m:1358-1510``)."""
        r = self.residual(Y)
        return float((r * r).sum())
