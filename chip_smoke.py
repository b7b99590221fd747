"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each fails the script when its check fails):
  0. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit of card 0 on a line of their own;
  1. build: compiles the CUDA kernels from cnmf_e_tpu_torch/csrc;
  2. kernels vs plain: every kernel against its plain PyTorch version on
     the card, at the shapes CNMFE.fit and the update step give it on a
     256x256x2000 movie with 192 neuron slots and ring radius 13, with
     median CUDA-event times of both and each kernel's bound; K1 also at
     edge shapes (K from 1 to 4000, mixed schedules, gate zeros, masks),
     and its compacted body (masked calls, held to the dense body to the
     bit) at the k2000 and 2p benchmark cells' spatial calls, timed beside
     its bytes bound, and at edge cases
     (ragged d, a tile at capacity and one over, an all-ones mask on the
     dense fallback, gate zeros, free steps of overlapping rows, the
     unmasked temporal call), each with its compact_stats;
     the ring stencil K6 (both its bodies) and the banded bf16 ring
     products K5 and K7 at the step's shapes and at edge shapes (widths
     and heights off the tiles, T = 1, 7, 2001, a field of view narrower
     than the ring, radii 1 to 16 and 6.5), the banded products also
     against K6; K6 also at the fit's own shapes (the 128x128 coarse
     grid, radius 9, with and without the intercept, and with the local
     background's uniform annulus weights); torch.sparse.mm of
     the ring matrix timed beside the ring kernels as the library
     yardstick, each kernel's ratio to it and to its bound printed; the OASIS
     kernels K2 -> K3 -> K4 at both launch shapes of the fit (K = 64 and
     192) with their device times, and at edge cases (chunks of 18, 32,
     64 and 256, and of 1024 and 2048 in pass 1's global-stack body; one
     trace; 70,000 traces, past the old grid limit; T = 2500, monotone
     traces, smin = 0, lam > 0), pool starts, lengths and counts equal to
     the plain versions'; in every case the one-call solve entry against
     the three-wrapper chain, c and s bit-identical, both timed; K6 also
     on one streamed block of phase 6's store (256x256x1000) at radii 15
     and 18 (its shared-memory body) and 9, bit-identical to its plain
     version, timed beside torch.sparse.mm;
  3. end-to-end consistency: CNMFE.fit on a small simulated movie on the
     card and on the CPU must agree;
  4. the fit at full size: CNMFE.fit with the 1p preset on a simulated
     256x256x2000 movie (warm-up fit, then a timed fit); every kernel of
     the fit must have launched and the detection F1 against ground truth
     must reach 0.8;
  5. the chained update step at full size (bench.py's hals_iter_throughput
     problem: 256x256x2000, K = 192, radius 13, chain 10) in three
     variants, each timed after a warm-up; every kernel of its path must
     have launched and every output must be finite;
  5b. step consistency: the coloured step on the card and on the CPU, on
     a well-conditioned problem (C max-rel drift <= 1e-3) and on an
     ill-conditioned one (A, C and C_raw within 8x the larger of the
     card's and the CPU's own drift under a one-ulp change of Y);
  6. out of core: fit_streaming on a 256x256x20,000 float16 store with
     500 planted neurons (scripts_dev/scale_demo.py --small), written to a
     temporary directory and deleted at the end; detection F1 >= 0.9;
     wall, stage seconds, peak memory and the upload's bytes and share of
     the wall printed;
  6b. fit_batches on phase 4's movie at 6000 frames in three batches of
     2000 with phase 4's parameters (its stage seconds printed); F1 >=
     0.8; its state is phase 13's reference;
  6c. fit_streaming of a 48x48x600 store on the card and on the CPU must
     agree;
  7. the command line (cnmf_e_tpu_torch/run.py, --device cuda by default)
     on a temporary directory: 7a phase 4's movie as a float32 TIFF with
     the 1p preset, --max-neurons 192 --dff --save-mat (and --report
     --neuron-panels where matplotlib and PIL are installed; otherwise a
     line says that the figures were not written and why), F1 >= 0.8 and
     finite DF/F, then --resume from its final snapshot with a
     decisions.json of two rejects and one merge pair, whose summary
     counts the resumed fit's neurons less the merged and dropped ones;
     7b the same TIFF with --batch-frames 1000 --dff, F1 >= 0.8; 7c a
     64x64x600 svd fit and its DF/F on the card and on the CPU must agree
     (n_active, correlations >= 0.99, F0 within 1e-4 relative), then the
     2p preset (svd background) on a simulated 256x256x2000 2p movie,
     recall >= 0.75 and no ring kernel launched, and once with --bg-model
     nmf (recall >= 0.75); each run's wall split into fit, DF/F and
     figures, with peak memory;
  8. the 2p pipelines of BASELINE configs 1 and 4: 8a the vanilla CNMF
     class (lasso, then nnls) on phase 7c's 256x256x2000 2p movie, K1 to
     K4 launched and no ring kernel, recall >= 0.75 and median matched
     trace correlation >= 0.85; 8b CNMFE with preset_2p("ar2_constrained")
     and ("ar2_thresholded") on a simulated 256x256x1000 AR(2) movie (cut
     from 2000 frames to make room for phase 13), K1
     launched and no ring kernel, g of width 2, recall >= 0.75, the
     constrained fit within the RSS budget, the AR(2) deconvolution's
     seconds printed; 8c every deconvolution family on 192 traces (T =
     1000) of 8b's fit, on the card and on the CPU (c and s within 1e-4 of each
     trace's scale; MCEM and MCMC on the card, held to the planted
     traces), each family's median wall; 8d at 64x64x600 the spatial
     algorithms hals_thresh, nnls and lars and temporal.decorrelate on
     the card and on the CPU (correlations >= 0.99), and mcmc_spikes on
     planted spikes on the card;
  9. the local background and the ellipse search: 9a phase 4's movie
     and parameters with background.model="local" and
     spatial.search_method="ellipse" (warm-up fit, then a timed fit with
     stage seconds, local_background's own seconds and peak memory), K1,
     the OASIS solve entry and K6 launched, F1 >= 0.8; 9b the same
     options on phase 3's movie on the card and on the CPU must agree;
     9c on 9a's state, card against CPU, each timed: order_neurons for
     every key (equal permutations wherever the keys are distinct),
     apply_order, remove_false_positives with an active-pixel mask and
     classify_cl_thr = 0.8, the three merge candidate graphs, the ellipse
     masks and threshold_components, local_correlation_projected (also
     against the full correlation image), hals_nmf (K1 launched),
     kmeans_pp and sparse_nmf_init from the same generator, and
     pair_neurons against the planted neurons;
 10. the (patch, frame) mesh on torch.distributed, one card shared by
     the ranks: 10a the update step of phase 5 (deconv_every_5 and
     colored_every_5) on a 2 x 2 mesh of gloo ranks, each a process of
     its own on the card, gathered and held to phase 5's single-process
     step (C max-rel drift <= 1e-3, A within 2e-4 of its scale, or 8x
     the one-process step's own drift under a one-ulp change of Y where
     that is larger: the uncoloured chain is ill-conditioned there), K1,
     the OASIS solve entry and K6 launched on every rank and no plain
     version; its ms per iteration beside phase 5's, with the bytes
     each rank hands to the collectives and the host seconds inside
     them; 10a' the same step on a 1 x 1 NCCL mesh against
     mesh=None in one process (bit-identical, or within 1e-6 of scale
     with the difference printed); 10c the four ranks read their blocks
     of phase 6's store with load_sharded_movie, whose per-frame sums,
     all-reduced, equal a direct read (rtol 1e-4, atol 1e-3); 10b
     fit_streaming on phase 6's store on the 2 x 2 gloo mesh (a warm-up
     on its 64x64 store first): F1 >= 0.9, n_active equal to phase 6's,
     every footprint and trace at correlation >= 0.999 with phase 6's,
     A within 5e-4 and C within 5e-3 of their scale of phase 6's state,
     or 8x the drift of phase 6's fit rerun with smaller chunks (its sums
     in another order) where that is larger; the init, QC, merges and
     tags on the mesh, no pickled state sent; the wall, stage seconds
     (the init and QC stages beside the figures of the rank-0 QC that
     pickled the state, PERF.md section 5) and peak memory of each rank
     printed.
 11. the in-memory fit on the mesh: phase 4's movie and parameters through
     CNMFE(mesh=...).fit on a 2 x 2 mesh of gloo ranks sharing the card
     (a warm-up on a 64x64 movie first; each rank reads only its block):
     F1 >= 0.8, n_active equal to phase 4's, every rank's active mask the
     same, no pickled state sent, every matched footprint and trace at
     correlation >= 0.999 with phase 4's state (or 8x phase 4's own drift
     under a one-ulp change of Y where that is larger, both printed), each
     rank's peak memory at most half of phase 4's; K1, the OASIS solve
     entry and K6 launched on every rank, no plain version; the wall,
     stage seconds, collective bytes and seconds, and peak memory of each
     rank printed; 11' the same fit on a 1 x 1 NCCL mesh against
     mesh=None in one process (bit-identical, or within 1e-6 of scale
     with the difference printed).
 12. every option and method of CNMFE on the mesh, in one spawn of a
     2 x 2 gloo mesh sharing the card (each rank's wall, peak memory,
     collective bytes and seconds by stage and launches printed): 12a
     phase 9a's local + ellipse fit, held to phase 9a's state (the same
     n_active, F1 >= 0.8, matched footprints and traces at correlation
     >= min(0.999, 1 - 8x phase 9a's own one-ulp drift)), K1, the solve
     entry and K6 on every rank, and the local fit's bytes by both
     exchanges printed; 12b preset_2p (svd background of rank 3,
     hals_thresh, decorrelate) on phase 7c's 256x256x2000 2p movie, held
     to the same fit in one process (n_active, recall >= 0.75, the same
     correlation bars, the background f^T b + b0 within its own drift),
     K1 and the solve entry on every rank; 12c on a 128x128x1000 movie
     the nmf background with nnls on the decimated (ssub 2, tsub 2) and
     detrended (nk 3) init, and lars, each held to one process, then a
     fit with a run log written by rank 0, one resumed from its init
     snapshot (held to one process resumed from it) and every method
     (dff at the whole session and a 101-frame window, background,
     reconstruction, residual, compute_rss) on each rank's block against
     one process on the whole movie; no pickled state sent; 12' 12a and
     12b on a 1 x 1 NCCL mesh against mesh=None (bit-identical, or
     within 1e-6 of scale with the difference printed).
 13. batch mode on the mesh: phase 6b's problem (256x256x6000 in three
     batches of 2000, preset_1p, K_max 192) through fit_batches(mesh=...)
     on a 2 x 2 gloo mesh sharing the card (a warm-up on a 64x64 movie
     first; each rank reads only its 1000 x 128 x 256 block of each
     batch): F1 >= 0.8, n_active and the per-batch counts equal to 6b's,
     every matched footprint and trace at correlation >= 0.999 with 6b's
     state (or 8x 6b's own drift under a one-ulp change of Y where that
     is larger, both printed), every rank's active mask and state the
     same, no pickled state sent; K1, the OASIS solve entry and K6 on
     every rank, no plain version; each rank's wall, stage seconds,
     collective bytes and seconds and peak memory printed beside 6b's;
     13' the same on a 1 x 1 NCCL mesh against mesh=None (bit-identical,
     or within 1e-6 of scale with the difference printed).
No plain kernel version may run on the paths of phases 4 to 13, and
their OASIS kernels must launch through the solve entry.
The line before the last holds one JSON object with the per-kernel
results; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device", file=sys.stderr)
    sys.exit(1)

from cnmf_e_tpu_torch.config import (  # noqa: E402
    BackgroundParams, CNMFEParams, DeconvParams, InitParams, MergeParams)
from cnmf_e_tpu_torch.utils.metrics import detection_f1, trace_corr  # noqa: E402
from cnmf_e_tpu_torch.utils.profiling import StageTimer  # noqa: E402
from cnmf_e_tpu_torch.utils.simulate import (  # noqa: E402
    gaussian_footprints, simulate_movie, simulate_movie_store, smooth_field)
from cnmf_e_tpu_torch import cuda_build  # noqa: E402
from cnmf_e_tpu_torch import run as cli  # noqa: E402
from cnmf_e_tpu_torch.convert import (  # noqa: E402
    state_from_numpy, state_to_numpy, step_state_from_numpy)
from cnmf_e_tpu_torch.io.tiff import write_tiff  # noqa: E402
from cnmf_e_tpu_torch.models import cnmf2p  # noqa: E402
from cnmf_e_tpu_torch.models.batch import fit_batches  # noqa: E402
from cnmf_e_tpu_torch.models import background, merge, qc  # noqa: E402
from cnmf_e_tpu_torch.models.dff import extract_dff  # noqa: E402
from cnmf_e_tpu_torch.models.pairing import pair_neurons  # noqa: E402
from cnmf_e_tpu_torch.models.pipeline import CNMFE  # noqa: E402
from cnmf_e_tpu_torch.models import streaming  # noqa: E402
from cnmf_e_tpu_torch.models.streaming import fit_streaming  # noqa: E402
from cnmf_e_tpu_torch.models.state import RingWeights  # noqa: E402
from cnmf_e_tpu_torch.ops import (hals_kernels, oasis,  # noqa: E402
                                  oasis_kernels, ring_kernels)
from cnmf_e_tpu_torch.ops.ar import (ar_kernel,  # noqa: E402
                                     estimate_time_constant)
from cnmf_e_tpu_torch.ops.coloring import (  # noqa: E402
    class_step_schedule, greedy_color, overlap_adjacency)
from cnmf_e_tpu_torch.ops.corr import (  # noqa: E402
    correlation_image, local_correlation_projected)
from cnmf_e_tpu_torch.ops.hals import hals_nmf  # noqa: E402
from cnmf_e_tpu_torch.ops.lowrank import (  # noqa: E402
    kmeans_pp, sparse_nmf_init)
from cnmf_e_tpu_torch.ops.morphology import (  # noqa: E402
    search_locations_dilate, search_locations_ellipse, threshold_components)
from cnmf_e_tpu_torch.ops.mcmc import mcmc_spikes  # noqa: E402
from cnmf_e_tpu_torch.ops.noise import noise_psd  # noqa: E402
from cnmf_e_tpu_torch.ops.oasis import deconvolve  # noqa: E402
from cnmf_e_tpu_torch.ops.oasis_kernels import pass1_input  # noqa: E402
from cnmf_e_tpu_torch.ops.ring import (  # noqa: E402
    _neighbor_index as ring_neighbor_index, apply_ring)
from cnmf_e_tpu_torch.io.store import MovieStore  # noqa: E402
from cnmf_e_tpu_torch.parallel import _selftest, launch  # noqa: E402
from cnmf_e_tpu_torch.parallel.step import (  # noqa: E402
    make_bg_projection, make_update_step)

DEV = torch.device("cuda:0")
KERNEL_META = {
    "hals_sweeps": ("cnmf_e_tpu_torch/csrc/hals_sweeps.cu",
                    "cnmf_e_tpu/ops/pallas_hals.py:243"),
    "oasis_chunk_pools": ("cnmf_e_tpu_torch/csrc/oasis.cu",
                          "cnmf_e_tpu/ops/pallas_oasis.py:156"),
    "oasis_pool_merge": ("cnmf_e_tpu_torch/csrc/oasis.cu",
                         "cnmf_e_tpu/ops/pallas_oasis.py:340"),
    "oasis_reconstruct": ("cnmf_e_tpu_torch/csrc/oasis.cu",
                          "cnmf_e_tpu/ops/pallas_oasis.py:448"),
    "ring_stencil": ("cnmf_e_tpu_torch/csrc/ring_stencil.cu",
                     "cnmf_e_tpu/ops/pallas_ring.py:93"),
    "ring_banded_flat": ("cnmf_e_tpu_torch/csrc/ring_banded.cu",
                         "cnmf_e_tpu/ops/pallas_ring_mxu.py:182"),
    "ring_banded_htw": ("cnmf_e_tpu_torch/csrc/ring_banded.cu",
                        "cnmf_e_tpu/ops/pallas_ring_mxu.py:236"),
}
# the kernels each path must launch
PATH_EXACT = {"hals_sweeps", "oasis_chunk_pools", "oasis_pool_merge",
              "oasis_reconstruct", "ring_stencil"}
PATH_MXU = PATH_EXACT - {"ring_stencil"} | {"ring_banded_flat"}
PATH_2P = PATH_EXACT - {"ring_stencil"}      # a low-rank background
OASIS_NAMES = oasis_kernels.OASIS_KERNELS  # launched by the solve entry
RADIUS = 13                 # bench.py's ring radius at 256 x 256
# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): FP32 on the
# CUDA cores, dense bf16 on the tensor cores, HBM3
FP32_FLOPS, BF16_FLOPS, HBM_BYTES = 67e12, 989e12, 3.35e12
HALS_TOL = 2e-5             # K1 against its plain version, times 1 + |x|
SM_COUNT = torch.cuda.get_device_properties(DEV).multi_processor_count


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = FP32_FLOPS):
    """The least time the card could take, in ms, and what sets it: the
    larger of the operations over the peak rate and the bytes (each input
    read once, each output written once) over the HBM rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {what}")


@contextlib.contextmanager
def main_path():
    """Count the kernel launches of one main-path run, from 0, and fail if
    it calls a plain kernel version or launches an OASIS kernel other than
    through the solve entry. Yields the launch counts, filled in when the
    block ends."""
    launches = {}
    with _selftest.count_references() as ref_calls:
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        yield launches
        torch.cuda.synchronize()
    launches.update(cuda_build.LAUNCHES)
    require(not ref_calls, f"the main path called plain versions: "
            f"{ref_calls}")
    solves = cuda_build.ENTRY_CALLS.get("oasis_solve_launch", 0)
    require(all(launches[k] == solves for k in OASIS_NAMES),
            f"the main path launched OASIS kernels outside the solve entry "
            f"({solves} solves): {launches}")


def check_path(launches: dict, path: set, what: str) -> None:
    require(all(launches[k] > 0 for k in path),
            f"a kernel of the {what} path never launched: {launches}")


def drift(x: np.ndarray, ref: np.ndarray) -> float:
    """Max relative drift (scripts_dev/chain_drift.py:70-73)."""
    scale = np.maximum(np.abs(ref), 0.05 * np.abs(ref).max())
    return float((np.abs(x - ref) / scale).max())


# ------------------------------------------------------------------ #
# phase 2 inputs: the shapes CNMFE.fit gives each kernel at 256x256x2000
# ------------------------------------------------------------------ #
def slice_problem(K=192, H=256, W=256, T=2000, seed=0):
    g = torch.Generator(device=DEV).manual_seed(seed)
    cy = torch.rand(K, generator=g, device=DEV) * H
    cx = torch.rand(K, generator=g, device=DEV) * W
    yy = torch.arange(H, device=DEV, dtype=torch.float32)[None, :, None]
    xx = torch.arange(W, device=DEV, dtype=torch.float32)[None, None, :]
    A = torch.exp(-((yy - cy[:, None, None]) ** 2
                    + (xx - cx[:, None, None]) ** 2) / (2 * 3.0 ** 2))
    A = torch.where(A > 0.05, A, 0.0)
    spikes = (torch.rand((K, T), generator=g, device=DEV) < 0.02).float() \
        * (0.5 + torch.rand((K, T), generator=g, device=DEV))
    C = torch.zeros((K, T), device=DEV)
    for t in range(1, T):
        C[:, t] = 0.95 * C[:, t - 1] + spikes[:, t]
    noise = 0.1 * torch.randn((H * W, T), generator=g, device=DEV)
    Y = A.reshape(K, -1).T @ C + noise                      # (d, T)
    return A, C, Y, g


def compact_counts(M: torch.Tensor, TD: int) -> torch.Tensor:
    """Active rows of each TD-column tile of the mask M (K, d): the rows
    the compacted body runs there."""
    K, d = M.shape
    pad = torch.zeros((K, -(-d // TD) * TD - d), dtype=torch.bool,
                      device=M.device)
    return torch.cat([M.bool(), pad], dim=1).view(K, -1, TD).any(
        dim=2).sum(dim=0)


def compact_work(M: torch.Tensor, TD: int, n_iter: int):
    """(operations, bytes) a masked call needs: 2 k_t^2 TD multiply-adds
    a sweep on the k_t active rows of each tile; one read of the mask,
    one write of the (K, d) output, the active rows of X and U, the
    sub-Grams, V's diagonal and the gate."""
    K, d = M.shape
    k = compact_counts(M, TD).double()
    flops = float(2.0 * n_iter * TD * (k * k).sum())
    nbytes_ = float(K * d * (M.element_size() + 4) + 8 * TD * k.sum()
                    + 4 * (k * k).sum() + 8 * K)
    return flops, nbytes_


def dense_body(U, V, X, gate, sched, M, n_iter, block):
    """K1's dense body on every tile of a masked call (the unmasked entry
    point given the mask, as the compacted body's fallback runs a tile)."""
    K, d = X.shape
    TD, KC = hals_kernels._tiling(K, d, SM_COUNT)
    f32 = lambda t: t.to(torch.float32).contiguous()
    M8 = (M if M.dtype in (torch.bool, torch.uint8) else M > 0)
    starts, ends, free, n_steps = (t.to(torch.int32).contiguous()
                                   for t in sched)
    out = torch.empty((K, d), device=DEV)
    cuda_build.launch("hals_sweeps", DEV, f32(U), f32(V), f32(X), out,
                      M8.contiguous().view(torch.uint8), f32(gate), starts,
                      ends, free, n_steps, K, d, n_iter, 1,
                      hals_kernels._rows_per_step(K, block), TD, KC)
    return out


def hals_case(what, U, V, X, gate, sched, M, n_iter, block, relu,
              plain_reps=0, expect=None):
    """K1 on one call against its plain version (within HALS_TOL times
    1 + |x|); with plain_reps > 0 also timed: the kernel, the plain version,
    and n_iter f32 torch.mm(V, X) (the same multiply-adds as a dense Jacobi
    sweep, a yardstick of cuBLAS's FP32 rate here that the port never
    calls). A masked call launches the compacted body and the dense
    fallback (two launches, its compact_stats printed, held to ``expect``:
    "compact" every tile on the compacted body, "fallback" every tile on
    the dense body, or a number of fallback tiles); an unmasked call the
    dense body alone and no compacted tile. The bound of a masked call is
    what its active rows need (compact_work), of an unmasked one the dense
    2 K^2 d n_iter operations. A masked call's result must equal the dense
    body's (dense_body) to the bit."""
    K, d = X.shape

    def kernel():
        return hals_kernels.hals_sweeps(U, V, X, gate, sched, M, n_iter,
                                        block, relu)

    def plain():
        return hals_kernels.hals_sweeps_reference(U, V, X, gate, sched, M,
                                                  n_iter, block, relu)

    TD, KC = hals_kernels._tiling(K, d, hals_kernels._sm_count(DEV.index))
    n_tiles = -(-d // TD)
    before = hals_kernels.compact_stats(DEV)
    launches = cuda_build.LAUNCHES["hals_sweeps"]
    out_k = kernel()
    after = hals_kernels.compact_stats(DEV)
    stats = {k: after[k] - before[k] for k in after}
    launches = cuda_build.LAUNCHES["hals_sweeps"] - launches
    out_p = plain()
    torch.cuda.synchronize()
    err = (out_k - out_p).abs()
    ok = bool((err <= HALS_TOL * (1 + out_p.abs())).all()
              and torch.isfinite(out_k).all())
    steps = int(sched[3])
    res = dict(case=what, K=K, d=d, n_iter=n_iter, steps=steps,
               mask=M is not None, max_abs_err=float(err.max()), TD=TD,
               launches=launches, compact_stats=stats)
    # the kernel's tiling: columns per CTA and Gram columns per V slice
    line = (f"phase 2: hals_sweeps {what} K={K} d={d} n_iter={n_iter} "
            f"block={block} steps={steps} mask={M is not None} TD={TD} "
            f"KC={KC}: max_abs_err "
            f"{res['max_abs_err']:.3e} (tol {HALS_TOL:g}*(1+|x|)); "
            f"launches {launches}")
    if M is not None:
        k = compact_counts(M, TD)
        dense = dense_body(U, V, X, gate, sched, M, n_iter, block)
        same = bool(torch.equal(out_k, dense))
        res.update(active_mean=float(k.double().mean()),
                   active_max=int(k.max()), bit_identical_to_dense=same)
        line += (f"; bit-identical to the dense body {same}"
                 + ("" if same else
                    f" ({int((out_k != dense).sum())} entries differ, by up "
                    f"to {float((out_k - dense).abs().max()):.3e})"))
        del dense
        line += (f"; compact_stats {json.dumps(stats)} of {n_tiles} tiles "
                 f"(active rows a tile: mean {res['active_mean']:.3f}, max "
                 f"{res['active_max']}, capacity "
                 f"{hals_kernels.COMPACT_ROWS})")
    if plain_reps:
        if M is None:
            flops, nb = (n_iter * 2.0 * K * K * d,
                         nbytes(U, V, X, X))
        else:
            flops, nb = compact_work(M, TD, n_iter)
        bms, by = bound(flops, nb)
        res.update(ms=cuda_ms(kernel, 5), plain_ms=cuda_ms(plain, plain_reps),
                   library_ms=cuda_ms(lambda: [torch.mm(V, X)
                                               for _ in range(n_iter)], 5),
                   bound_ms=bms, bound_by=by)
        line += (f" kernel {res['ms']:.3f} ms, bound {bms:.3f} ms ({by}), "
                 f"plain {res['plain_ms']:.3f} ms, {n_iter} x torch.mm(V, X) "
                 f"{res['library_ms']:.3f} ms")
    print(line, flush=True)
    require(ok, f"hals_sweeps ({what}, K={K}, d={d}) disagrees with its "
            f"plain version")
    if M is None:
        require(launches == 1 and not any(stats.values()),
                f"hals_sweeps ({what}): an unmasked call launched {launches} "
                f"kernels, compact_stats {stats}")
        return res
    require(res["bit_identical_to_dense"],
            f"hals_sweeps ({what}): the compacted body differs from the "
            f"dense body")
    require(launches == 2 and stats["compact_tiles"]
            + stats["fallback_tiles"] == n_tiles,
            f"hals_sweeps ({what}): {launches} launches, compact_stats "
            f"{stats} over {n_tiles} tiles")
    want_fb = {"compact": 0, "fallback": n_tiles}.get(expect, expect)
    require(want_fb is None or stats["fallback_tiles"] == want_fb,
            f"hals_sweeps ({what}): {stats['fallback_tiles']} fallback "
            f"tiles, expected {want_fb}")
    # a tile falls back past COMPACT_ROWS active rows (or, on a schedule
    # of overlapping steps, past COMPACT_ROWS non-empty steps)
    over = int((k > hals_kernels.COMPACT_ROWS).sum())
    require(stats["fallback_tiles"] > over
            or (stats["fallback_tiles"] == over and stats["active_rows"]
                == int(k[k <= hals_kernels.COMPACT_ROWS].sum())),
            f"hals_sweeps ({what}): compact_stats {stats}, but {over} tiles "
            f"hold more than {hals_kernels.COMPACT_ROWS} active rows")
    return res


def phase2_hals_edges():
    """K1 at edge shapes: K from 1 to 4000 (V streams through shared memory
    past K ~ 600; past K ~ 3250 the tile narrows to 8 columns), d from 300
    to 65,536, class schedules of free steps, the in-order block grid, and
    the overflow fallback that mixes free and in-order steps; gates with
    zeros; with and without a mask."""
    cases = []
    for K, d, kind, masked, gate_zeros in (
            (1, 2000, "coloured", True, False),
            (5, 3050, "block grid", False, True),
            (5, 65536, "coloured", False, False),
            (37, 65536, "mixed", True, True),
            (37, 3050, "mixed", False, False),
            (700, 3050, "coloured", True, True),
            (700, 65536, "block grid", True, False),
            (2304, 2000, "block grid", False, True),
            (2304, 3050, "coloured", True, True),
            (4000, 300, "coloured", True, True)):
        g = torch.Generator(device=DEV).manual_seed(K * 7 + d)
        X = torch.clamp(torch.randn((K, d), generator=g, device=DEV), min=0)
        X = X * (torch.rand((K, d), generator=g, device=DEV) < 0.1)
        M = (((torch.rand((K, d), generator=g, device=DEV) < 0.1) | (X > 0))
             if masked else None)
        F = torch.randn((K, 64), generator=g, device=DEV)
        V = F @ F.T / 64 + torch.eye(K, device=DEV)
        U = torch.randn((K, d), generator=g, device=DEV)
        gate = torch.ones(K, device=DEV)
        if gate_zeros:
            gate[::3] = 0.0
        if kind == "block grid":
            block = 16
            sched = hals_kernels.block_grid_schedule(K, block, DEV)
        else:
            # "coloured": up to 7 classes (ids below K, as a colouring
            # gives); "mixed": 12-row classes on 8-row steps overflow a
            # 4-step capacity, and the fallback grid is free only where a
            # step stays inside one class
            block = 64 if kind == "coloured" else 8
            classes = (torch.arange(K, device=DEV) * min(K, 7) // K
                       if kind == "coloured"
                       else torch.arange(K, device=DEV) // 12)
            sched = class_step_schedule(classes.to(torch.int32), block=block,
                                        n_cap=4 if kind == "mixed" else None)
        cases.append(hals_case(f"edge {kind}", U, V, X, gate, sched, M, 2,
                               block, masked or K % 2 == 1))
    return cases


def lattice_problem(K, gSig, H=512, W=512, T=200, seed=0):
    """K1's masked spatial call at a benchmark cell's geometry
    (benchmark/harness/inputs.py): centres on a pitch-10 lattice with
    jitter 2 and margin 6, Gaussian footprints of sigma gSig (1 +- 0.2)
    cut at two sigma, search masks dilated by 2 pixels; rows in the order
    of a greedy colouring of the mask overlaps with its class schedule
    (ops/hals.py). V = Cc Cc^T of T-frame traces, U = V A + noise."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    pitch, jitter, margin = 10, 2.0, 6
    nx = (W - 2 * margin) // pitch
    ny = (H - 2 * margin) // pitch
    cell = torch.randperm(ny * nx, generator=g, device=DEV)[:K]
    j = jitter * (2 * torch.rand((2, K), generator=g, device=DEV) - 1)
    cy = margin + ((cell // nx).float() + 0.5) * pitch + j[0]
    cx = margin + ((cell % nx).float() + 0.5) * pitch + j[1]
    sig = gSig * (1 + 0.2 * (2 * torch.rand(K, generator=g, device=DEV)
                             - 1))
    yy = torch.arange(H, dtype=torch.float32, device=DEV)[None, :]
    xx = torch.arange(W, dtype=torch.float32, device=DEV)[None, :]
    A = (torch.exp(-(yy - cy[:, None]) ** 2 / (2 * sig[:, None] ** 2))
         [:, :, None]
         * torch.exp(-(xx - cx[:, None]) ** 2 / (2 * sig[:, None] ** 2))
         [:, None, :])
    A = A.masked_fill_(A < np.exp(-2.0), 0.0)
    M = search_locations_dilate(A, radius=2).reshape(K, H * W)
    A = A.reshape(K, H * W)
    colors = greedy_color(overlap_adjacency(M))
    order = torch.argsort(colors, stable=True)
    sched = class_step_schedule(colors[order], block=64)
    C = torch.clamp(torch.randn((K, T), generator=g, device=DEV), min=0)
    Cc = C - C.mean(dim=1, keepdim=True)
    V = (Cc @ Cc.T)[order][:, order].contiguous()
    A, M = A[order].contiguous(), M[order].contiguous()
    U = V @ A + 0.1 * torch.randn(A.shape, generator=g, device=DEV)
    X = torch.clamp(A * (1 + 0.2 * torch.randn(A.shape, generator=g,
                                               device=DEV)), min=0)
    del A
    return U, V, X, M, sched


def window_masks(K, d, g, width=(12, 29), extra=2):
    """Each row's support: a window of 12-28 columns at a random start and
    a few random pixels, so a tile meets a handful of rows."""
    a = torch.randint(0, d - width[0], (K,), generator=g, device=DEV)
    w = torch.randint(*width, (K,), generator=g, device=DEV)
    cols = torch.arange(d, device=DEV)
    M = (cols >= a[:, None]) & (cols < (a + w)[:, None])
    M[torch.arange(K, device=DEV)[:, None],
      torch.randint(0, d, (K, extra), generator=g, device=DEV)] = True
    return M


def dense_problem(K, d, g, M):
    X = torch.clamp(torch.randn((K, d), generator=g, device=DEV), min=0) * M
    F = torch.randn((K, 32), generator=g, device=DEV)
    V = F @ F.T / 32 + torch.eye(K, device=DEV)
    U = torch.randn((K, d), generator=g, device=DEV) + 0.5
    return U, V, X


def phase2_hals_compact():
    """K1's compacted body (masked calls) against the plain version:
    (a) the k2000 cell's spatial call (K 2000, 512 x 512, lattice masks,
    gSig 3, coloured, n_iter 10), timed beside its bytes bound; (b) the 2p
    cell's (K 1000, gSig 2, TD 32); (c) a ragged d (3050) with K = 203;
    (d) one tile at exactly COMPACT_ROWS active rows and one over it;
    (e) an all-ones mask, every tile on the dense fallback; (f) gate zeros
    and a row with V_kk = 0; (g) free steps whose rows share mask pixels
    (the snapshot rule); (h) the unmasked temporal call, dense alone."""
    cases = []
    cap = hals_kernels.COMPACT_ROWS
    for what, K, gSig in (("(a) k2000 cell", 2000, 3.0),
                          ("(b) 2p cell", 1000, 2.0)):
        U, V, X, M, sched = lattice_problem(K, gSig, seed=K)
        ones = torch.ones(K, device=DEV)
        cases.append(hals_case(f"compact {what}", U, V, X, ones, sched, M,
                               10, 64, True, plain_reps=1,
                               expect="compact"))
        if K == 2000:
            # (h): the same cell's temporal call, V = A^T A of these
            # footprints, U = V C + noise over 8000 frames, unmasked
            T = 8000
            Vt = X @ X.T
            colors = greedy_color((Vt != 0) & ~torch.eye(
                K, dtype=torch.bool, device=DEV))
            order = torch.argsort(colors, stable=True)
            sched_t = class_step_schedule(colors[order], block=64)
            Vt = Vt[order][:, order].contiguous()
            Ct = torch.clamp(torch.randn((K, T), generator=torch.Generator(
                device=DEV).manual_seed(8), device=DEV), min=0)
            Ut = Vt @ Ct + 0.1 * torch.randn_like(Ct)
            C0 = torch.clamp(Ct + 0.1 * torch.randn_like(Ct), min=0)
            temporal = (Ut, Vt, C0, ones, sched_t)
        del U, V, X, M
        torch.cuda.empty_cache()

    # (c) + (f): ragged d, K not a multiple of 8, gate zeros, V_kk = 0
    g = torch.Generator(device=DEV).manual_seed(21)
    K, d = 203, 3050
    M = window_masks(K, d, g)
    U, V, X = dense_problem(K, d, g, M)
    V[5, :] = 0.0
    V[:, 5] = 0.0
    gate = torch.ones(K, device=DEV)
    gate[::3] = 0.0
    colors = greedy_color(overlap_adjacency(M))
    order = torch.argsort(colors, stable=True)
    sched = class_step_schedule(colors[order], block=64)
    cases.append(hals_case(
        "compact (c, f) ragged, gate zeros, V_kk = 0", U[order],
        V[order][:, order].contiguous(), X[order], gate[order], sched,
        M[order].contiguous(), 10, 64, True, expect="compact"))

    # (d): tile 0 at exactly capacity, tile 1 one over, on the in-order
    # block grid (non-free steps of 16 rows)
    K, d = 200, 65536
    TD, _ = hals_kernels._tiling(K, d, SM_COUNT)
    M = window_masks(K, d, g)
    M[:, :2 * TD] = False
    M[:cap, 0] = True
    M[:cap + 1, TD] = True
    U, V, X = dense_problem(K, d, g, M)
    ones = torch.ones(K, device=DEV)
    grid16 = hals_kernels.block_grid_schedule(K, 16, DEV)
    cases.append(hals_case("compact (d) a tile at capacity, one over", U, V,
                           X, ones, grid16, M, 4, 16, True, expect=1))
    # (e): an all-ones mask, K above capacity: every tile falls back
    cases.append(hals_case("compact (e) all-ones mask", U, V, X, ones,
                           grid16, torch.ones_like(M), 4, 16, True,
                           expect="fallback"))
    # (g): three classes of contiguous rows that ignore the overlaps, so
    # free steps hold rows sharing mask pixels
    K, d = 120, 3000
    M = window_masks(K, d, g, width=(40, 81))
    U, V, X = dense_problem(K, d, g, M)
    classes = (torch.arange(K, device=DEV) * 3 // K).to(torch.int32)
    sched = class_step_schedule(classes, block=64)
    require(any(fr and bool((M[lo:hi].sum(dim=0) > 1).any())
                for lo, hi, fr in hals_kernels._step_rows(
                    sched, K, hals_kernels._rows_per_step(K, 64))),
            "case (g) has no free step of overlapping rows")
    ones = torch.ones(K, device=DEV)
    cases.append(hals_case("compact (g) free steps of overlapping rows", U,
                           V, X, ones, sched, M, 10, 64, True))
    cases.append(hals_case("compact (h) unmasked temporal", *temporal,
                           None, 4, 64,
                           False))
    return cases


def phase2_kernels(K=192, H=256, W=256, T=2000):
    A, C, Y, gen = slice_problem(K=K, H=H, W=W, T=T)
    d = A.shape[1] * A.shape[2]
    results = {}

    # K1 spatial: masked, relu, colored (models/spatial.py; the step's
    # spatial update on the same masks)
    A0 = torch.clamp(A * (1 + 0.2 * torch.randn(A.shape, generator=gen,
                                                 device=DEV)), min=0.0)
    mask = search_locations_dilate(A0, radius=2).reshape(K, d)
    adj = overlap_adjacency(mask)
    colors = greedy_color(adj)
    # the colouring runs on the host: its (K, K) copy and loop, per HALS call
    color_s = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_color(adj)
        color_s.append(time.perf_counter() - t0)
    print(f"phase 2: greedy_color on the host K={K}: median "
          f"{statistics.median(color_s) * 1e3:.3f} ms per HALS call",
          flush=True)
    order = torch.argsort(colors, stable=True)
    sched = class_step_schedule(colors[order], block=64)
    Cc = C - C.mean(dim=1, keepdim=True)
    U = (Y @ Cc.T).T[order].contiguous()                    # (K, d)
    V = (Cc @ Cc.T)[order][:, order].contiguous()
    X = A0.reshape(K, d)[order].contiguous()
    M = mask[order].contiguous()
    ones = torch.ones(K, device=DEV)

    # K1 temporal: no relu, colored (models/temporal.py, the step's
    # temporal update)
    Af = A.reshape(K, d)
    Vt = Af @ Af.T
    adj = (Vt != 0) & ~torch.eye(K, dtype=torch.bool, device=DEV)
    colors_t = greedy_color(adj)
    order_t = torch.argsort(colors_t, stable=True)
    sched_t = class_step_schedule(colors_t[order_t], block=64)
    Ut = (Af @ Y)[order_t].contiguous()
    Vt = Vt[order_t][:, order_t].contiguous()
    C0 = (C + 0.1 * torch.randn(C.shape, generator=gen, device=DEV)
          )[order_t].contiguous()
    gate = (torch.rand(K, generator=gen, device=DEV) > 0.1).float()

    # the fit's calls (10 spatial, 4 temporal sweeps), the step's
    # (n_hals = 1), and the uncoloured step's in-order block grid, 16 rows
    # a step
    sched_bg = hals_kernels.block_grid_schedule(K, 16, DEV)
    cases = [hals_case(*c) for c in (
        ("spatial coloured, fit", U, V, X, ones, sched, M, 10, 64, True, 3),
        ("temporal coloured, fit", Ut, Vt, C0, gate, sched_t, None, 4, 64,
         False, 3),
        ("spatial coloured, step", U, V, X, ones, sched, M, 1, 64, True, 3),
        ("temporal coloured, step", Ut, Vt, C0, ones, sched_t, None, 1, 64,
         False, 3),
        ("spatial block grid", U, V, X, ones, sched_bg, M, 10, 16, True, 1),
        ("temporal block grid", Ut, Vt, C0, gate, sched_bg, None, 4, 16,
         False, 1))]
    cases += phase2_hals_edges()
    cases += phase2_hals_compact()
    fit = cases[0]
    results["hals_sweeps"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), ms=fit["ms"],
        plain_ms=fit["plain_ms"], bound_ms=fit["bound_ms"],
        bound_by=fit["bound_by"], library_ms=fit["library_ms"],
        cases=cases)

    results.update(phase2_oasis(C, gen))
    return results


# ------------------------------------------------------------------ #
# phase 2, K2 -> K3 -> K4: the foopsi deconvolution
# ------------------------------------------------------------------ #
def device_ms(fns: dict, reps: int, spin: int = 50_000_000) -> dict:
    """Device time, in ms, of one call of each ``fns[name]``, every kernel
    it launches included (the OASIS wrappers launch their kernel alone):
    ``reps`` calls queued behind a spin kernel of ``spin`` cycles, which
    holds the stream until the host has queued them all, and timed by CUDA
    events around the calls alone. The wrappers' host work is then not in
    the time; the gaps between back-to-back launches are. torch.profiler
    would give the kernels' own times, but now and then it returns a
    session with no device events, which would fail the run."""
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        while True:
            s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
            s.record()
            torch.cuda._sleep(spin)
            a.record()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            torch.cuda.synchronize()
            if host_ms < s.elapsed_time(a):
                break
            spin *= 2       # the host was still queueing when the spin ended
            require(spin < 2 ** 36, f"{name}: the host waits for the card "
                    f"inside a call, so its calls cannot be queued")
        out[name] = a.elapsed_time(b) / reps
    return out


def pools_err(a, b, what: str) -> float:
    """Pool starts, lengths and counts equal; values within 1e-4 (1+|x|)."""
    for x, z in zip(a[2:], b[2:]):
        require(torch.equal(x, z), f"{what}: OASIS pool starts/lengths/"
                f"counts differ from the plain version")
    errs = [(x - z).abs() for x, z in zip(a[:2], b[:2])]
    require(all(bool((e <= 1e-4 * (1 + z.abs())).all())
                for e, z in zip(errs, b[:2])),
            f"{what}: OASIS pool values differ from the plain version")
    return max(float(e.max()) for e in errs)


def live_pool_bytes(pools, per_pool: int = 16) -> int:
    """The bytes of the live pools of ``pools`` (``per_pool`` bytes each)
    and of their counts."""
    n = pools[4]
    return int(n.sum()) * per_pool + nbytes(n)


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def oasis_case(what, y, g, lam, smin, L, timed=False):
    """K2 -> K3 -> K4 on one problem, each against its plain version on the
    same input (K2 on pass1_input's output, K3 and K4 on the kernels' own
    output, K4 writing the T samples of y); then the solve entry on y
    against that three-wrapper chain, c and s bit-identical. Returns each
    kernel's error, whether K4 is bit-identical to its plain version, its
    device time per launch (``ms``, by :func:`device_ms`) and the
    CUDA-event time of one wrapper call (``call_ms``), and the solve's and
    the chain's the same two ways; with ``timed`` also the plain version's
    time and the kernel's bound (the bytes it must move; the pool
    arithmetic is a few operations a sample)."""
    K, T = y.shape
    vinit = pass1_input(y, g, lam, L)

    def k2():
        return oasis_kernels.oasis_chunk_pools(vinit, g, smin, L)

    def k2_plain():
        return oasis_kernels.oasis_chunk_pools_reference(vinit, g, smin, L)

    p1k = k2()
    errs = [pools_err(p1k, k2_plain(), f"oasis_chunk_pools {what}")]

    def k3():
        return oasis_kernels.oasis_pool_merge(*p1k, g, smin)

    def k3_plain():
        return oasis_kernels.oasis_pool_merge_reference(*p1k, g, smin)

    p2k = k3()
    errs.append(pools_err(p2k, k3_plain(), f"oasis_pool_merge {what}"))

    def k4():
        return oasis_kernels.oasis_reconstruct(*p2k, g, T)

    def k4_plain():
        return oasis_kernels.oasis_reconstruct_reference(*p2k, g, T)

    (ck, sk), (cp, sp) = k4(), k4_plain()
    errs.append(max(float((ck - cp).abs().max()),
                    float((sk - sp).abs().max())))
    require(errs[2] <= 1e-4, f"oasis_reconstruct {what} disagrees with its "
            f"plain version")
    k4_bits = bool(torch.equal(bits(ck), bits(cp))
                   and torch.equal(bits(sk), bits(sp)))

    def solve():
        return oasis_kernels.oasis_solve(y, g, lam, smin, L)

    def chain():
        p1 = oasis_kernels.oasis_chunk_pools(pass1_input(y, g, lam, L), g,
                                             smin, L)
        return oasis_kernels.oasis_reconstruct(
            *oasis_kernels.oasis_pool_merge(*p1, g, smin), g, T)

    cs, ss = solve()
    require(torch.equal(bits(cs), bits(ck)) and torch.equal(bits(ss),
                                                             bits(sk)),
            f"oasis_solve {what}: c, s differ from the three-wrapper chain")
    calls = dict(zip(OASIS_NAMES, ((k2, k2_plain), (k3, k3_plain),
                                   (k4, k4_plain))))
    # bytes each function must move: K2 reads the traces; K3 reads the live
    # pools (v, w, t0, len: 16 bytes each) and the counts, K4 their v, w
    # and t0 (12 bytes); K2 and K3 write every slot of their pool arrays, K4
    # writes c and s
    nbs = (nbytes(vinit, g, smin, *p1k),
           live_pool_bytes(p1k) + nbytes(g, smin, *p2k),
           live_pool_bytes(p2k, 12) + nbytes(g, ck, sk))
    reps = 20 if timed else 5
    dev = device_ms(dict({name: c[0] for name, c in calls.items()},
                         solve=solve, chain=chain), reps)
    out = {}
    line = f"phase 2: OASIS {what} K={K} T={T} L={L}:"
    for (name, (kernel, plain)), e, nb in zip(calls.items(), errs, nbs):
        res = dict(max_abs_err=e, ms=dev[name], call_ms=cuda_ms(kernel, 5))
        line += (f" {name} err {e:.2e} kernel {res['ms']:.4f} ms (call "
                 f"{res['call_ms']:.4f})")
        if timed:
            bms, by = bound(0.0, nb)
            res.update(plain_ms=cuda_ms(plain, 3), bound_ms=bms, bound_by=by,
                       library_ms=None)
            line += (f", bound {bms:.4f} ({by}), plain "
                     f"{res['plain_ms']:.3f}")
        line += ";"
        out[name] = res
    out["oasis_reconstruct"]["bit_identical"] = k4_bits
    out["oasis_pool_merge"]["pools"] = int(p2k[4].sum())
    out["solve"] = dict(ms=dev["solve"], call_ms=cuda_ms(solve, 5),
                        chain_ms=dev["chain"], chain_call_ms=cuda_ms(chain, 5))
    sv = out["solve"]
    print(line + f" K4 bit-identical {k4_bits}; solve entry {sv['ms']:.4f} "
          f"ms (call {sv['call_ms']:.4f}) against the chain {sv['chain_ms']:.4f}"
          f" (call {sv['chain_call_ms']:.4f}), c and s bit-identical (kernel: "
          f"device time of back-to-back launches; call: CUDA events around "
          f"one wrapper call)", flush=True)
    return out


def phase2_oasis(C, gen, L=128):
    """K2 -> K3 -> K4 at both launch shapes of the fit (K = 64 seeds in the
    init rounds, K = 192 slots in the temporal updates, merges and the
    step; T = 2000, L = 128, smin = 5 sn), then at edge cases, each held to
    the plain versions: chunks of 18, 32, 64 and 256, and of 1024 and 2048
    (pass 1's global-stack body; 2048 is one chunk a trace); one trace;
    70,000 traces of 256 samples (past the 65,535 of the old grid's y
    axis); T = 2500, not a multiple of L; strictly increasing traces (no
    pool merges, pass 2 is all appends) and strictly decreasing ones (one
    pool per trace, every seam cascades); smin = 0; lam > 0. Every case
    also holds the solve entry to the three-wrapper chain."""
    K, T = C.shape
    y = C + 0.1 * torch.randn(C.shape, generator=gen, device=DEV)
    sn = noise_psd(y)
    g = estimate_time_constant(y, p=1, sn=sn)[:, 0].contiguous()
    smin = (5.0 * sn).contiguous()
    yb = (y - torch.quantile(y, 0.15, dim=-1)[:, None]).contiguous()
    zero = torch.zeros(K, device=DEV)
    cases = {}
    for k in (64, K):
        cases[f"K={k}"] = oasis_case(
            "fit shape", yb[:k].contiguous(), g[:k].contiguous(), zero[:k],
            smin[:k].contiguous(), L, timed=True)
    # 18: below a warp, and not a multiple of the 4-sample vector loads
    for Le in (18, 32, 64, 256, 1024, 2048):
        cases[f"L={Le}"] = oasis_case(f"L={Le}", yb, g, zero, smin, Le)
    cases["K=1"] = oasis_case("K=1", yb[:1].contiguous(), g[:1].contiguous(),
                              zero[:1], smin[:1].contiguous(), L)
    # 70,000 traces: 7 pieces of 256 samples from each of the 192, repeated,
    # each copy with its own noise
    Kb, Tb = 70_000, 256
    pieces = yb[:, :7 * Tb].reshape(-1, Tb)
    reps = -(-Kb // len(pieces))
    yk = (pieces.repeat(reps, 1)[:Kb] + 0.05 * torch.randn(
        (Kb, Tb), generator=gen, device=DEV)).contiguous()
    gk = g.repeat_interleave(7).repeat(reps)[:Kb].contiguous()
    sk = smin.repeat_interleave(7).repeat(reps)[:Kb].contiguous()
    cases[f"K={Kb}"] = oasis_case(f"K={Kb}", yk, gk, torch.zeros_like(gk), sk,
                                  L)
    del yk, gk, sk
    y25 = torch.cat([yb, yb[:, :500]], 1)
    cases["T=2500"] = oasis_case("T=2500", y25, g, zero, smin, L)
    t = torch.arange(T, device=DEV, dtype=torch.float32)
    rows = torch.arange(8, device=DEV, dtype=torch.float32)[:, None]
    g8 = torch.full((8,), 0.998, device=DEV)
    zero8 = torch.zeros(8, device=DEV)
    up = 1.0 + rows + t / 64.0
    down = (10.0 + rows) * 0.995 ** t
    for what, tr, sm in (("increasing, smin=0", up, zero8),
                         ("decreasing, smin=0", down, zero8),
                         ("decreasing, smin>0", down, zero8 + 0.05)):
        cases[what] = oasis_case(what, tr, g8, zero8, sm, L)
    cases["smin=0"] = oasis_case("smin=0", yb, g, zero, torch.zeros_like(smin),
                                 L)
    cases["lam>0"] = oasis_case("lam=0.5", yb, g, zero + 0.5, smin, L)
    Tp = -(-T // L) * L
    require(cases["increasing, smin=0"]["oasis_pool_merge"]["pools"]
            == 8 * Tp, "an increasing trace merged pools")
    require(cases["decreasing, smin=0"]["oasis_pool_merge"]["pools"]
            == 8 * (1 + Tp - T), "a decreasing trace did not end as one "
            "pool (beside its never-merging padding)")
    for what in ("K=64", f"K={K}", "decreasing, smin=0", "decreasing, smin>0"):
        k4 = cases[what]["oasis_reconstruct"]
        print(f"phase 2: oasis_reconstruct {what}: {k4['ms']:.4f} ms "
              f"(aim 0.008)" + (f", bound {k4['bound_ms']:.4f}"
                                if "bound_ms" in k4 else ""), flush=True)
    results = {}
    for name in OASIS_NAMES:
        main = cases[f"K={K}"][name]
        results[name] = dict(
            main, max_abs_err=max(c[name]["max_abs_err"]
                                  for c in cases.values()),
            cases={what: c[name] for what, c in cases.items()})
    results["oasis_reconstruct"]["bit_identical"] = all(
        c["oasis_reconstruct"]["bit_identical"] for c in cases.values())
    # the solve entry launches all three: its times at K = 192 on each
    for name in OASIS_NAMES:
        results[name]["solve"] = cases[f"K={K}"]["solve"]
    return results


def ring_csr(w, H: int, W: int, radius: int):
    """The ring apply's (d, d) matrix as a CSR tensor: row p holds w[p, r]
    at column p + offset_r for each tap inside the field of view."""
    offsets = ring_kernels.ring_offsets(radius)
    R, d = offsets.shape[0], H * W
    dy, dx = (torch.as_tensor(offsets[:, i], device=DEV) for i in (0, 1))
    hh = (torch.arange(H, device=DEV)[:, None, None] + dy).expand(H, W, R)
    ww = (torch.arange(W, device=DEV)[None, :, None] + dx).expand(H, W, R)
    valid = ((hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)).reshape(d, R)
    rows = torch.arange(d, device=DEV)[:, None].expand(d, R)
    cols = (hh * W + ww).reshape(d, R)
    return torch.sparse_coo_tensor(
        torch.stack([rows[valid], cols[valid]]), w[valid], (d, d)
    ).coalesce().to_sparse_csr()


def ring_library(w, w0, X, H: int, W: int, radius: int):
    """One torch.sparse.mm (cuSPARSE) of the ring matrix as a CSR (d, d)
    tensor with the (d, T) movie: the ring apply without its w0 add, a
    yardstick the port never calls. Builds the matrix and the transposed
    movie, checks the product against K6's output less w0, and returns the
    product as a callable to time."""
    T = X.shape[0]
    Wcsr = ring_csr(w, H, W, radius)
    Xd = X.reshape(T, H * W).T.contiguous()
    ref = (ring_kernels.apply_ring_stencil(w, w0, X, H, W, radius)
           - w0.reshape(1, H, W)).reshape(T, H * W).T
    e = (torch.sparse.mm(Wcsr, Xd) - ref).abs()
    require(bool((e <= 1e-4 * (1 + ref.abs())).all()),
            "torch.sparse.mm of the ring matrix disagrees with K6")
    print(f"phase 2: library torch.sparse.mm (CSR, {Wcsr.values().numel()} "
          f"nonzeros) of the ring matrix with the movie {H}x{W}x{T} "
          f"radius={radius}, w0 add left out: max_abs_err "
          f"{float(e.max()):.3e} against K6 less w0", flush=True)
    return lambda: torch.sparse.mm(Wcsr, Xd)


def ring_times(kernels: dict, library, reps=10) -> dict:
    """Each ring kernel's device time (``ms``, by :func:`device_ms`: its
    wrapper's launches back to back, the wrapper's device work such as K6's
    weight transpose or K5's bf16 cast included, its host work not) and
    the CUDA-event time of one wrapper call (``call_ms``, host work
    included), and the library product's the same two ways."""
    dev = device_ms(dict(kernels, library=library), reps)
    return {name: dict(ms=dev[name], call_ms=cuda_ms(fn, reps),
                       library_ms=dev["library"])
            for name, fn in dict(kernels, library=library).items()}


def ring_problem(T, H, W, radius, seed, uniform=False, intercept=True):
    """A (T, H, W) movie and ring weights on the card: bench.py's uniform
    weights 1/R without an intercept, or random weights about 1/R with a
    random intercept (or none)."""
    R = ring_kernels.ring_offsets(radius).shape[0]
    gen = torch.Generator(device=DEV).manual_seed(seed)
    X = torch.randn((T, H, W), generator=gen, device=DEV)
    if uniform:
        w = torch.full((H * W, R), 1.0 / R, device=DEV)
    else:
        w = 0.01 * torch.randn((H * W, R), generator=gen, device=DEV) + 1.0 / R
    w0 = (torch.randn(H * W, generator=gen, device=DEV) if intercept
          else torch.zeros(H * W, device=DEV))
    return X, RingWeights(w=w, w0=w0)


def stencil_case(what, X, wts, H, W, radius, apply=None):
    """K6 (through ``apply``, by default its wrapper) against its plain
    version, within 1e-5 (1 + |x|). Returns the error, whether the two agree
    bit for bit, and the body the wrapper's picker took."""
    T = X.shape[0]
    plan = ring_kernels._stencil_plan(T, H, W, radius, SM_COUNT)
    ref = ring_kernels.apply_ring_stencil_reference(wts.w, wts.w0, X, H, W,
                                                    radius)
    out = (apply or (lambda: ring_kernels.apply_ring_stencil(
        wts.w, wts.w0, X, H, W, radius)))()
    e = (out - ref).abs()
    ok = bool((e <= 1e-5 * (1 + ref.abs())).all()
              and torch.isfinite(out).all())
    res = dict(case=what, body=plan.body, max_abs_err=float(e.max()),
               bit_identical=bool(torch.equal(out, ref)))
    print(f"phase 2: ring_stencil {what} {H}x{W}x{T} radius={radius} "
          f"R={wts.w.shape[1]} body={plan.body} frames/thread="
          f"{plan.frames_per_thread} TT={plan.TT} smem="
          f"{plan.smem_bytes}: max_abs_err {res['max_abs_err']:.3e} (tol "
          f"1e-5*(1+|x|)), bit-identical {res['bit_identical']}", flush=True)
    require(ok, f"ring_stencil ({what}) disagrees with its plain version")
    return res


BANDED = (("ring_banded_flat", ring_kernels.apply_ring_mxu_flat,
           "apply_ring_mxu_flat_reference"),
          ("ring_banded_htw", ring_kernels.apply_ring_mxu,
           "apply_ring_mxu_reference"))


def banded_cases(what, X, wts, H, W, radius):
    """K5 and K7 on one problem, each within 1e-5 of the output's scale of
    its plain version and within 2e-2 of it of K6 (bf16 operands). Returns
    each kernel's error against its plain version."""
    ref6 = ring_kernels.apply_ring_stencil(wts.w, wts.w0, X, H, W, radius)
    scale = float(ref6.abs().max())
    bands = ring_kernels.ring_dense_bands(wts, H, W, radius)
    errs = {}
    for name, kernel, plain in BANDED:
        out = kernel(bands, wts.w0, X, H, W, radius)
        ref = getattr(ring_kernels, plain)(bands, wts.w0, X, H, W, radius)
        e = float((out - ref).abs().max())
        e32 = float((out - ref6).abs().max())
        errs[name] = e
        print(f"phase 2: {name} {what} {H}x{W}x{X.shape[0]} radius={radius}:"
              f" max_abs_err {e:.3e} against its plain version (tol "
              f"1e-5*scale = {1e-5 * scale:.3e}), {e32:.3e} against K6 (tol "
              f"2e-2*scale = {2e-2 * scale:.3e})", flush=True)
        require(e <= 1e-5 * scale and bool(torch.isfinite(out).all()),
                f"{name} ({what}) disagrees with its plain version")
        require(e32 <= 2e-2 * scale, f"{name} ({what}) is off K6 by more "
                f"than bf16 rounding")
    return errs


def ring_bounds(X, w, w0, R):
    """The least times of the ring apply. K6 does a multiply and an add per
    tap and an add of w0 in FP32, and moves X, w, w0 and the output. K5/K7
    compute the same function: they count the same operations at the bf16
    rate, and move the band entries that hold a tap (H*W*R bf16: the only
    nonzeros of the bands, whatever blocks a kernel reads), w0, the bf16
    movie and the f32 output."""
    T, H, W = X.shape
    flops = (2.0 * R + 1) * T * H * W
    return {"ring_stencil": bound(flops, nbytes(X, X, w, w0)),
            "banded": bound(flops, H * W * R * 2 + nbytes(w0) + X.numel() * 2
                            + X.numel() * 4, BF16_FLOPS)}


def ratios(res: dict) -> str:
    return (f"{res['ms'] / res['library_ms']:.3f}x the library, "
            f"{res['ms'] / res['bound_ms']:.2f}x the bound")


def phase2_ring(H=256, W=256, T=2000):
    """K6, K5 and K7 at the step's shapes, on bench.py's uniform ring
    weights (1/R, no intercept) and on random weights and intercepts, timed
    beside torch.sparse.mm of the ring matrix; then at edge shapes, each
    held to its plain version: K6's shared-memory body (a radius past the
    register cap, a non-integer radius, W % 4 != 0), widths and heights
    that are not multiples of the tile, T = 1, 7 and 2001, a field of view
    narrower than the ring (W <= 2 mr); K5 and K7 at W = 200, H = 3, T not a
    multiple of the frame tile, radii 9 and 13."""
    R = ring_kernels.ring_offsets(RADIUS).shape[0]
    cases, errs = [], {"ring_banded_flat": 0.0, "ring_banded_htw": 0.0}
    for uniform in (True, False):
        X, wts = ring_problem(T, H, W, RADIUS, seed=1, uniform=uniform,
                              intercept=not uniform)
        what = "uniform weights" if uniform else "random weights"
        cases.append(stencil_case(what, X, wts, H, W, RADIUS))
        for k, e in banded_cases(what, X, wts, H, W, RADIUS).items():
            errs[k] = max(errs[k], e)

    # times on the random weights
    w, w0 = wts.w, wts.w0
    bands = ring_kernels.ring_dense_bands(wts, H, W, RADIUS)
    Xb = X.reshape(T, H * W).to(torch.bfloat16).contiguous()
    timed = [("ring_stencil",
              lambda: ring_kernels.apply_ring_stencil(w, w0, X, H, W, RADIUS),
              lambda: ring_kernels.apply_ring_stencil_reference(
                  w, w0, X, H, W, RADIUS))]
    for name, kernel, plain in BANDED:
        timed.append((name,
                      lambda k=kernel: k(bands, w0, X, H, W, RADIUS),
                      lambda p=plain: getattr(ring_kernels, p)(
                          bands, w0, X, H, W, RADIUS)))
    bounds = ring_bounds(X, w, w0, R)
    times = ring_times(
        dict({name: kernel for name, kernel, _ in timed},
             # K5's launch alone, on the bf16 movie made beforehand
             ring_banded_flat_launch=lambda: ring_kernels._banded(
                 "ring_banded_flat", Xb, bands, w0, T, H, W, RADIUS)),
        ring_library(w, w0, X, H, W, RADIUS))
    lib = times["library"]
    print(f"phase 2: library torch.sparse.mm {H}x{W}x{T} radius={RADIUS}: "
          f"{lib['ms']:.3f} ms (call {lib['call_ms']:.3f})", flush=True)
    results = {}
    for name, kernel, plain in timed:
        bms, by = bounds["ring_stencil" if name == "ring_stencil"
                         else "banded"]
        results[name] = dict(times[name], plain_ms=cuda_ms(plain, 2),
                             bound_ms=bms, bound_by=by)
        res = results[name]
        print(f"phase 2: {name} {H}x{W}x{T} radius={RADIUS}: kernel "
              f"{res['ms']:.3f} ms (call {res['call_ms']:.3f}), bound "
              f"{bms:.3f} ms ({by}), plain {res['plain_ms']:.3f} ms, library "
              f"{res['library_ms']:.3f} ms: {ratios(res)}", flush=True)
    launch = times["ring_banded_flat_launch"]
    results["ring_banded_flat"]["launch_ms"] = launch["ms"]
    print(f"phase 2: ring_banded_flat launch alone (the bf16 movie made "
          f"beforehand): {launch['ms']:.3f} ms (call {launch['call_ms']:.3f})",
          flush=True)
    ms_bands = cuda_ms(lambda: ring_kernels.ring_dense_bands(
        wts, H, W, RADIUS), 3)
    print(f"phase 2: ring_dense_bands (plain PyTorch scatter, "
          f"{bands.numel() * 2 / 1e6:.0f} MB of bf16): {ms_bands:.3f} ms",
          flush=True)
    del X, Xb, bands, wts, w, w0

    # K6's shared-memory body at the step's shape, radius 15 (R = 96, past
    # the register cap)
    X, wts = ring_problem(T, H, W, 15, seed=3)
    cases.append(stencil_case("past the register cap", X, wts, H, W, 15))
    ms = device_ms({"shared": lambda: ring_kernels.apply_ring_stencil(
        wts.w, wts.w0, X, H, W, 15)}, 5)["shared"]
    bms, by = ring_bounds(X, wts.w, wts.w0, wts.w.shape[1])["ring_stencil"]
    shared_body = dict(shape=f"T={T} H={H} W={W} radius=15", ms=ms,
                       bound_ms=bms, bound_by=by)
    print(f"phase 2: ring_stencil shared-memory body {H}x{W}x{T} radius=15: "
          f"kernel {ms:.3f} ms, bound {bms:.3f} ms ({by})", flush=True)
    del X, wts

    for i, (t, h, w_, rad, kinds) in enumerate((
            (300, 100, 200, 13, "tile"),       # W, H not multiples of 8 x 32
            (60, 37, 131, 9, "tile"),          # W % 4 != 0: shared body
            (1, 64, 96, 13, "T"), (7, 64, 96, 13, "T"),
            (2001, 64, 96, 13, "T"),
            (20, 24, 24, 13, "fov"),           # W <= 2 mr
            (20, 20, 18, 13, "fov"),           # and W % 4 != 0
            (9, 16, 32, 1, "radius"), (30, 40, 64, 6.5, "radius"),
            (30, 40, 64, 16, "radius"))):
        for uniform, intercept in ((True, False), (False, True),
                                   (False, False)):
            X, wts = ring_problem(t, h, w_, rad, seed=10 + i,
                                  uniform=uniform, intercept=intercept)
            cases.append(stencil_case(
                f"edge ({kinds}; {'uniform' if uniform else 'random'}, "
                f"w0 {intercept})", X, wts, h, w_, rad))
    for i, (t, h, w_, rad) in enumerate(((300, 40, 200, 13),
                                         (300, 40, 200, 9),
                                         (257, 3, 64, 9), (257, 3, 64, 13),
                                         (100, 20, 8, 13))):
        X, wts = ring_problem(t, h, w_, rad, seed=30 + i)
        for k, e in banded_cases("edge", X, wts, h, w_, rad).items():
            errs[k] = max(errs[k], e)
    require({c["body"] for c in cases} == {"registers", "shared"},
            "the edge cases did not run both bodies of ring_stencil")
    results["ring_stencil"].update(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        bit_identical=all(c["bit_identical"] for c in cases),
        shared_body=shared_body, cases=len(cases))
    for name in errs:
        results[name]["max_abs_err"] = errs[name]
    return results


def phase2_ring_fit_grid(H=128, W=128, T=2000, radius=9):
    """K6 at the shapes CNMFE.fit gives it on the 256x256x2000 movie:
    preset_1p's ssub=2 coarse grid (radius 18 / 2), through the dispatching
    apply_ring with the intercept (reconstruct_ring_background), without
    it (the outlier clamp of fit_ring_model) and with the local
    background's uniform annulus weights, timed beside torch.sparse.mm of
    the ring matrix."""
    X, wts = ring_problem(T, H, W, radius, seed=2)
    R = wts.w.shape[1]
    cases = []
    for intercept in (True, False):
        w = RingWeights(w=wts.w, w0=wts.w0 if intercept
                        else torch.zeros_like(wts.w0))
        cases.append(stencil_case(
            f"fit grid, intercept={intercept}", X, w, H, W, radius,
            apply=lambda: apply_ring(wts, X, H, W, radius,
                                     include_intercept=intercept)))
    # the local background's annulus average: valid / n_valid, no intercept
    _, valid = ring_neighbor_index(H, W, ring_kernels.ring_offsets(radius))
    unif = torch.as_tensor(valid / np.maximum(valid.sum(1, keepdims=True), 1),
                           dtype=torch.float32, device=DEV)
    w = RingWeights(w=unif, w0=torch.zeros(H * W, device=DEV))
    cases.append(stencil_case(
        "fit grid, local background's uniform weights", X, w, H, W, radius,
        apply=lambda: apply_ring(w, X, H, W, radius,
                                 include_intercept=False)))
    require(cases[-1]["bit_identical"], "ring_stencil with the local "
            "background's uniform weights is not bit-identical to its "
            "plain version")
    times = ring_times(
        {"ring_stencil": lambda: ring_kernels.apply_ring_stencil(
            wts.w, wts.w0, X, H, W, radius)},
        ring_library(wts.w, wts.w0, X, H, W, radius), reps=20)
    pms = cuda_ms(lambda: ring_kernels.apply_ring_stencil_reference(
        wts.w, wts.w0, X, H, W, radius), 2)
    bms, by = ring_bounds(X, wts.w, wts.w0, R)["ring_stencil"]
    res = dict(times["ring_stencil"],
               shape=f"T={T} H={H} W={W} radius={radius}",
               max_abs_err=max(c["max_abs_err"] for c in cases),
               bit_identical=all(c["bit_identical"] for c in cases),
               plain_ms=pms, bound_ms=bms, bound_by=by)
    print(f"phase 2: ring_stencil fit grid {H}x{W}x{T} radius={radius}: "
          f"kernel {res['ms']:.3f} ms (call {res['call_ms']:.3f}), bound "
          f"{bms:.3f} ms ({by}), plain {pms:.3f} ms, library "
          f"{res['library_ms']:.3f} ms (call "
          f"{times['library']['call_ms']:.3f}): {ratios(res)}", flush=True)
    return res


def phase2_ring_stream_block(H=256, W=256, T=1000):
    """K6 on one streamed block of fit_streaming's shakeout store (1000
    frames of 256x256; the streamed ring subtraction runs at full
    resolution and background.ring_radius, whatever background.ssub says):
    at radius 15 and 18, which take the shared-memory body (preset_1p's
    radius is 18), and at radius 9, phase 6's own (the register body). Each
    bit-identical to its plain version and timed by device_ms beside
    torch.sparse.mm of the same ring matrix."""
    out = {}
    for radius in (15, 18, 9):
        X, wts = ring_problem(T, H, W, radius, seed=40 + radius)
        case = stencil_case(f"streamed block, radius {radius}", X, wts, H, W,
                            radius)
        require(case["bit_identical"], f"ring_stencil on the streamed block "
                f"(radius {radius}) is not bit-identical to its plain version")
        times = ring_times(
            {"ring_stencil": lambda: ring_kernels.apply_ring_stencil(
                wts.w, wts.w0, X, H, W, radius)},
            ring_library(wts.w, wts.w0, X, H, W, radius))
        bms, by = ring_bounds(X, wts.w, wts.w0, wts.w.shape[1])["ring_stencil"]
        res = dict(times["ring_stencil"], body=case["body"], R=wts.w.shape[1],
                   bound_ms=bms, bound_by=by)
        print(f"phase 2: ring_stencil streamed block {H}x{W}x{T} radius="
              f"{radius} R={res['R']} body={res['body']}: kernel "
              f"{res['ms']:.3f} ms (call {res['call_ms']:.3f}), bound "
              f"{bms:.3f} ms ({by}), library torch.sparse.mm "
              f"{res['library_ms']:.3f} ms: {ratios(res)}", flush=True)
        out[f"radius={radius}"] = res
        del X, wts
    return out


# ------------------------------------------------------------------ #
# phases 3 and 4
# ------------------------------------------------------------------ #
def match_by_footprint(A1, A2):
    """Greedy one-to-one matching of two footprint sets by correlation."""
    a1 = A1.reshape(len(A1), -1)
    a2 = A2.reshape(len(A2), -1)
    corr = np.corrcoef(np.concatenate([a1, a2]))[:len(a1), len(a1):]
    pairs, used1, used2 = [], set(), set()
    for flat in np.argsort(-corr, axis=None):
        i, j = np.unravel_index(flat, corr.shape)
        if i not in used1 and j not in used2:
            pairs.append((int(i), int(j), float(corr[i, j])))
            used1.add(i)
            used2.add(j)
    return pairs


def phase3_consistency():
    gt = simulate_movie(seed=11, H=64, W=64, T=600, K=10, gSig=2.5,
                        sn=0.08, bg_strength=0.8, min_dist=12.0,
                        spike_rate=0.04)
    params = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=40, seeds_per_round=16, max_rounds=6),
        background=BackgroundParams(model="ring", ring_radius=9),
        merge=MergeParams(dmin=4.0))
    out = {}
    for dev in ("cuda", "cpu"):
        cuda_build.reset_launch_counts()
        st = CNMFE(params, device=dev).fit(gt.Y, n_outer=2)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(cuda_build.LAUNCHES)
        n = int(st.n_active())
        out[dev] = (n, st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy())
    (n_g, A_g, C_g), (n_c, A_c, C_c) = out["cuda"], out["cpu"]
    require(n_g == n_c, f"n_active differs: cuda {n_g}, cpu {n_c}")
    pairs = match_by_footprint(A_g, A_c)
    a_corr = min(p[2] for p in pairs)
    c_corr = min(float(np.corrcoef(C_g[i], C_c[j])[0, 1])
                 for i, j, _ in pairs)
    print(f"phase 3: cuda vs cpu fit on 64x64x600 (ssub=1): n_active {n_g} "
          f"== {n_c}; min footprint corr {a_corr:.5f}, min trace corr "
          f"{c_corr:.5f} (>= 0.99); cuda launches {json.dumps(launches)}",
          flush=True)
    require(a_corr >= 0.99 and c_corr >= 0.99,
            "cuda and cpu fits disagree")
    check_path(launches, PATH_EXACT, "ssub=1 fit")


def fit_problem(T=2000):
    """bench.py:199-236's 1p recording: the simulated 256x256x2000 movie (T
    frames of it) and the 1p preset with 192 neuron slots."""
    gt = simulate_movie(seed=7, H=256, W=256, T=T, K=120, gSig=3.0,
                        sn=0.1, bg_strength=1.0, min_dist=9.0,
                        spike_rate=0.02)
    params = CNMFEParams.preset_1p()
    params = params.replace(init=dataclasses.replace(
        params.init, max_neurons=192, seeds_per_round=64, max_rounds=10))
    return gt, params


def phase4_full():
    gt, params = fit_problem()
    Y = torch.as_tensor(gt.Y, device=DEV)
    CNMFE(params, device=DEV).fit(Y, n_outer=2)             # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats(DEV)
    with main_path() as launches:
        t0 = time.perf_counter()
        state = CNMFE(params, device=DEV).fit(Y, n_outer=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    n = int(state.n_active())
    A = state.A[:n].cpu().numpy()
    C = state.C[:n].cpu().numpy()
    require(bool(np.isfinite(A).all() and np.isfinite(C).all()),
            "non-finite footprints or traces")
    f1 = detection_f1(A, gt.A)
    corr = trace_corr(C, gt.C, f1["matches"])
    med = float(np.median(corr)) if len(corr) else 0.0
    print(f"phase 4: CNMFE.fit preset_1p 256x256x2000 K_max=192 n_outer=2: "
          f"wall {wall:.3f} s, n_active {n}, F1 {f1['f1']:.4f} "
          f"(precision {f1['precision']:.4f}, recall {f1['recall']:.4f}), "
          f"median matched trace corr {med:.4f}, peak memory "
          f"{peak / 2**30:.3f} GiB, launches {json.dumps(launches)}",
          flush=True)
    check_path(launches, PATH_EXACT, "fit")
    require(f1["f1"] >= 0.8, f"F1 {f1['f1']:.4f} < 0.8")
    # phase 11's reference: the fitted neurons, the wall and the peak
    return launches, dict(A=A, C=C, wall=wall, peak=peak)


# ------------------------------------------------------------------ #
# phases 5 and 5b: the chained update step
# ------------------------------------------------------------------ #
def step_problem(H, W, T, K, radius, seed=0):
    """bench.py:100-125's synthetic state, built in numpy: random
    footprints with compact support, |N(0, 1)| traces, uniform ring
    weights 1/R."""
    R = ring_kernels.ring_offsets(radius).shape[0]
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((T, H, W)) * 0.1 + 1.0).astype(np.float32)
    A = np.zeros((K, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for k in range(K):
        cy, cx = rng.uniform(10, H - 10), rng.uniform(10, W - 10)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    A[A < 1e-3] = 0.0
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    d = dict(A=A, C=C, C_raw=np.zeros((K, T), np.float32),
             S=np.zeros((K, T), np.float32),
             g=np.full((K,), 0.92, np.float32),
             b0=np.ones((H, W), np.float32),
             ring_w=np.full((H * W, R), 1.0 / R, np.float32),
             ring_w0=np.zeros((H * W,), np.float32))
    return Y, d


STEP_VARIANTS = (
    ("colored_every_5", dict(colored=True, deconv_every=5), PATH_EXACT),
    ("deconv_every_5", dict(deconv_every=5), PATH_EXACT),
    ("colored_every_5_mxu", dict(colored=True, deconv_every=5, mxu=True),
     PATH_MXU),
)


def phase5_step(H=256, W=256, T=2000, K=192, chain=10):
    """The step in each variant of STEP_VARIANTS; returns the launches,
    the (A, C) and the ms per iteration of each, by variant (phase 10a
    holds the mesh step to them)."""
    Y_np, d = step_problem(H, W, T, K, RADIUS)
    Y = torch.as_tensor(Y_np, device=DEV)
    del Y_np
    st0 = step_state_from_numpy(d, DEV)
    outs, per_path, ms = {}, {}, {}
    for name, kw, path in STEP_VARIANTS:
        step = make_update_step(None, H, W, T, radius=RADIUS, n_hals=1,
                                chain=chain, **kw)
        step(Y, st0)                                        # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with main_path() as launches:
            t0 = time.perf_counter()
            a.record()
            out = step(Y, st0)
            b.record()
        wall = time.perf_counter() - t0
        ms_iter = a.elapsed_time(b) / chain
        finite = all(bool(torch.isfinite(getattr(out, k)).all())
                     for k in ("A", "C", "C_raw", "S"))
        proj = make_bg_projection(None, H, W, T, RADIUS, mxu=kw.get("mxu"))
        ms_proj = cuda_ms(lambda: proj(Y, st0), 1)
        print(f"phase 5: step {name} {H}x{W}x{T} K={K} radius={RADIUS} "
              f"n_hals=1 chain={chain}: {ms_iter:.3f} ms per iteration "
              f"(CUDA events over the whole step, projection included; "
              f"host {wall * 1e3 / chain:.3f} ms; the projection alone "
              f"{ms_proj:.3f} ms), "
              f"{H * W * T / ms_iter / 1e3:.1f} Mpixel-frames/s, finite "
              f"{finite}, launches {json.dumps(launches)}", flush=True)
        check_path(launches, path, name)
        require(finite, f"step {name} gave non-finite values")
        outs[name] = (out.A.cpu().numpy(), out.C.cpu().numpy())
        per_path[name] = launches
        ms[name] = ms_iter
    (a_mxu, c_mxu), (a_ex, c_ex) = (outs["colored_every_5_mxu"],
                                    outs["colored_every_5"])
    print(f"phase 5: chain drift of colored_every_5_mxu against "
          f"colored_every_5 (reported, not gated): A max-rel "
          f"{drift(a_mxu, a_ex):.3e}, C max-rel {drift(c_mxu, c_ex):.3e}",
          flush=True)
    return per_path, outs, ms


STEP_5B = (
    # (H, W, T, K, radius, seed), step options; C grows to ~3e5 on the
    # second, where a footprint collapses
    ("well-conditioned", (64, 64, 600, 16, 6, 3),
     dict(n_hals=1, chain=3, deconv_every=1, colored=True)),
    ("ill-conditioned", (100, 72, 333, 37, 6, 5),
     dict(n_hals=2, chain=3, deconv_every=2, colored=True)))
STEP_KEYS = ("A", "C", "C_raw")


def phase5b_consistency():
    """The coloured step on the card against the step on the CPU, beside
    each device's own drift when Y moves by one ulp up and down
    (np.nextafter). The well-conditioned problem is held to the chain-drift
    bar (C max-rel <= 1e-3); the ill-conditioned one, where one ulp moves
    C by more than 0.1, to 8x the larger self-drift in A, C and C_raw
    (tests/test_torch_step.py::test_step_drift_within_reference_rounding's
    bar)."""
    for what, (H, W, T, K, radius, seed), kw in STEP_5B:
        Y, d = step_problem(H, W, T, K, radius, seed=seed)
        step = make_update_step(None, H, W, T, radius=radius, **kw)

        def run(Y_, dev):
            out = step(torch.as_tensor(Y_, device=dev),
                       step_state_from_numpy(d, dev))
            return {k: getattr(out, k).cpu().numpy() for k in STEP_KEYS}
        base = {dev: run(Y, dev) for dev in (DEV, "cpu")}
        self_drift = dict.fromkeys(STEP_KEYS, 0.0)
        for dev in (DEV, "cpu"):
            for to in (np.inf, -np.inf):
                moved = run(np.nextafter(Y, np.float32(to)), dev)
                for k in STEP_KEYS:
                    self_drift[k] = max(self_drift[k],
                                        drift(moved[k], base[dev][k]))
        cross = {k: drift(base[DEV][k], base["cpu"][k]) for k in STEP_KEYS}
        ratio = {k: cross[k] / self_drift[k] if self_drift[k] > 0
                 else float("inf") for k in STEP_KEYS}
        print(f"phase 5b: {what} coloured step {kw} on {H}x{W}x{T} K={K} "
              f"radius={radius}, cuda vs cpu max-rel drift / one-ulp "
              f"self-drift (the larger of cuda's and cpu's) = ratio: " +
              ", ".join(f"{k} {cross[k]:.3e} / {self_drift[k]:.3e} = "
                        f"{ratio[k]:.3f}" for k in STEP_KEYS), flush=True)
        if what == "well-conditioned":
            require(cross["C"] <= 1e-3, f"cuda and cpu steps drift apart on "
                    f"the {what} problem: C {cross['C']:.3e}")
        else:
            require(all(ratio[k] <= 8 for k in STEP_KEYS),
                    f"cuda and cpu steps drift apart on the {what} problem "
                    f"by more than 8x their own rounding: {ratio}")


# ------------------------------------------------------------------ #
# phases 6, 6b and 6c: the out-of-core paths
# ------------------------------------------------------------------ #
# scripts_dev/scale_demo.py --small: the shakeout of SCALE.md
STREAM_STORE = dict(seed=11, H=256, W=256, T=20_000, K=500, gSig=3.0,
                    sn=0.08, bg_strength=0.8, min_dist=7.0, spike_rate=0.01,
                    frames_per_block=1000)


def stream_params():
    return CNMFEParams(
        init=InitParams(gSig=3.0, gSiz=10, min_corr=0.8, min_pnr=8.0,
                        max_neurons=640, seeds_per_round=256, max_rounds=12),
        background=BackgroundParams(model="ring", ring_radius=9,
                                    frame_cap_factor=25),
        merge=MergeParams(dmin=4.0, merge_thr=0.65))


def phase6_stream(tmp: str):
    """fit_streaming at the shakeout size: a 256x256x20,000 float16 store
    with 500 planted neurons (2.6 GB on disk, never resident at once),
    n_outer = 1, a 2000-frame init proxy; a warm-up on a 64x64x2000 store
    first. Detection F1 >= 0.9 against the planted footprints, every
    output finite."""
    t0 = time.perf_counter()
    store = simulate_movie_store(os.path.join(tmp, "stream"), **STREAM_STORE)
    synth = time.perf_counter() - t0
    warm = simulate_movie_store(os.path.join(tmp, "warm"), **dict(
        STREAM_STORE, H=64, W=64, T=2000, K=30))
    params = stream_params()
    fit_streaming(warm, params, n_outer=1, init_budget_frames=2000,
                  device=DEV)
    torch.cuda.synchronize()

    timer = StageTimer(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    with main_path() as launches:
        t0 = time.perf_counter()
        state = fit_streaming(store, params, n_outer=1,
                              init_budget_frames=2000, device=DEV,
                              timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    n = int(state.n_active())
    A = state.A[:n].cpu().numpy()
    C = state.C[:n].cpu().numpy()
    finite = all(bool(torch.isfinite(getattr(state, k)).all())
                 for k in ("A", "C", "C_raw", "S", "b0"))
    gt = np.load(os.path.join(store.root, "ground_truth.npz"))
    f1 = detection_f1(A, np.asarray(gt["A"], np.float32))
    gtC = np.asarray(np.load(os.path.join(store.root, "gt_C_decim.npy")),
                     np.float32)
    Cd = C[:, ::25][:, :gtC.shape[1]]
    tc = trace_corr(Cd, gtC[:, :Cd.shape[1]], f1["matches"])
    T, H, W = store.shape
    up_s, up_b = timer.times.get("upload", 0.0), timer.bytes.get("upload", 0)
    stages = {k: round(v, 4) for k, v in timer.times.items()}
    print(f"phase 6: fit_streaming {H}x{W}x{T} (float16 store, "
          f"{store.n_blocks()} blocks, synthesized in {synth:.1f} s), "
          f"{gt['A'].shape[0]} planted neurons, n_outer=1: wall {wall:.3f} s "
          f"({H * W * T / wall / 1e6:.1f} Mpixel-frames/s), n_active {n}, F1 "
          f"{f1['f1']:.4f} (precision {f1['precision']:.4f}, recall "
          f"{f1['recall']:.4f}), median trace corr on the T//25 truth grid "
          f"{float(np.median(tc)) if len(tc) else 0.0:.4f}, peak memory "
          f"{peak / 2**30:.3f} GiB, uploaded {up_b / 2**30:.3f} GiB in "
          f"{timer.counts.get('upload', 0)} chunks, {up_s:.3f} s on the copy "
          f"stream ({up_s / wall:.3f} of the wall), finite {finite}",
          flush=True)
    print(f"phase 6: stage seconds (StageTimer, each stage closed by a "
          f"device synchronisation) {json.dumps(stages)}; launches "
          f"{json.dumps(launches)}", flush=True)
    check_path(launches, PATH_EXACT, "streaming")
    require(finite, "fit_streaming gave non-finite values")
    require(f1["f1"] >= 0.9, f"streaming F1 {f1['f1']:.4f} < 0.9")
    return launches, (A, C, wall, stages)


BATCH_T, N_BATCHES = 6000, 3


def phase6b_batches():
    """fit_batches on the phase-4 movie at 6000 frames, in three batches of
    2000 with the phase-4 parameters; F1 >= 0.8. Returns the launches and
    phase 13's reference: the active neurons' A and C, the per-batch
    counts, the wall, the peak and the stage seconds."""
    gt, params = fit_problem(T=BATCH_T)
    batches = np.split(gt.Y, N_BATCHES)
    fit_batches(batches[:2], params, device=DEV)              # warm-up
    torch.cuda.synchronize()
    timer = StageTimer(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    with main_path() as launches:
        t0 = time.perf_counter()
        final, per_batch = fit_batches(batches, params, device=DEV,
                                       timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    act = final.active.cpu().numpy()
    A = final.A.cpu().numpy()[act]
    finite = all(bool(torch.isfinite(getattr(final, k)).all())
                 for k in ("A", "C", "C_raw", "S"))
    f1 = detection_f1(A, gt.A)
    print(f"phase 6b: fit_batches 256x256x6000 in 3 batches of 2000 "
          f"(preset_1p, K_max=192): wall {wall:.3f} s, n_active "
          f"{int(act.sum())} (per batch "
          f"{[int(p.n_active()) for p in per_batch]}), F1 {f1['f1']:.4f} "
          f"(precision {f1['precision']:.4f}, recall {f1['recall']:.4f}), "
          f"peak memory {peak / 2**30:.3f} GiB, finite {finite}, stage "
          f"seconds {stage_line(timer)}, launches {json.dumps(launches)}",
          flush=True)
    check_path(launches, PATH_EXACT, "batch")
    require(finite, "fit_batches gave non-finite values")
    require(f1["f1"] >= 0.8, f"batch F1 {f1['f1']:.4f} < 0.8")
    n = int(act.sum())
    return launches, dict(A=A, C=final.C.cpu().numpy()[act],
                          per_batch=[int(p.n_active()) for p in per_batch],
                          wall=wall, peak=peak, stages=dict(timer.times))


def phase6c_stream_consistency(tmp: str):
    """fit_streaming of a 48x48x600 store on the card and on the CPU: the
    same n_active, footprints and traces matched with correlation >=
    0.99."""
    store = simulate_movie_store(
        os.path.join(tmp, "small"), seed=3, H=48, W=48, T=600, K=7,
        gSig=2.5, sn=0.06, bg_strength=0.6, min_dist=12.0, spike_rate=0.04,
        frames_per_block=200)
    params = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=4),
        background=BackgroundParams(model="ring", ring_radius=7),
        merge=MergeParams(dmin=4.0))
    out = {}
    for dev in (DEV, "cpu"):
        st = fit_streaming(store, params, n_outer=1, init_budget_frames=300,
                           device=dev)
        n = int(st.n_active())
        out[str(dev)] = (n, st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy())
    (n_g, A_g, C_g), (n_c, A_c, C_c) = out[str(DEV)], out["cpu"]
    require(n_g == n_c > 0, f"streaming n_active differs: cuda {n_g}, cpu "
            f"{n_c}")
    pairs = match_by_footprint(A_g, A_c)
    a_corr = min(p[2] for p in pairs)
    c_corr = min(float(np.corrcoef(C_g[i], C_c[j])[0, 1])
                 for i, j, _ in pairs)
    print(f"phase 6c: fit_streaming cuda vs cpu on a 48x48x600 store: "
          f"n_active {n_g} == {n_c}; min footprint corr {a_corr:.5f}, min "
          f"trace corr {c_corr:.5f} (>= 0.99)", flush=True)
    require(a_corr >= 0.99 and c_corr >= 0.99,
            "cuda and cpu streaming fits disagree")


# ------------------------------------------------------------------ #
# phase 7: the command line (cnmf_e_tpu_torch/run.py) on the card
# ------------------------------------------------------------------ #
# the figure step's host packages; without them the CLI's figure step
# raises ImportError, so phase 7 then runs its fit/export/DF-F step alone
PLOTTING_MISSING = [m for m in ("matplotlib", "PIL")
                    if importlib.util.find_spec(m) is None]
PLOTTING = not PLOTTING_MISSING


def cli_run(what, movie, workdir, flags, path, absent=()):
    """One CLI run through run.py's steps (fit/export/DF-F, figures,
    summary) as main() runs them, inside main_path(): every kernel of
    ``path`` launched, none of ``absent``. Returns (run directory,
    summary, launches)."""
    argv = [movie, "--workdir", workdir, "--quiet", *flags]
    if PLOTTING:
        argv += ["--report", "--neuron-panels"]
    args = cli.parse_args(argv)
    torch.cuda.reset_peak_memory_stats(DEV)
    with main_path() as launches:
        t0 = time.perf_counter()
        r = cli.fit_step(args)
        if PLOTTING:
            cli.figure_step(r)
        summary = cli.write_summary(r)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    secs = {k: round(v, 3) for k, v in r.seconds.items()}
    fit = sum(r.seconds[k] for k in ("load", "fit", "export"))
    print(f"phase 7: cli {what}: wall {wall:.3f} s; the fit step {fit:.3f} "
          f"s, DF/F {r.seconds.get('dff', 0.0):.3f} s, figures "
          f"{r.seconds.get('figures', 0.0):.3f} s; seconds "
          f"{json.dumps(secs)} (load = the movie read or the store written,"
          f" fit = the fit and the decisions, export = results and "
          f"snapshots), peak memory {peak / 2**30:.3f} GiB, n_neurons "
          f"{summary['n_neurons']}, launches {json.dumps(launches)}",
          flush=True)
    check_path(launches, path, f"cli {what}")
    require(all(launches[k] == 0 for k in absent),
            f"cli {what} launched {absent}: {launches}")
    return r.run_log.dir, summary, launches


def cli_score(what, rdir, gt, gate: str, bar: float):
    """F1 / recall of results.npz against ground truth; dff.npz finite."""
    with np.load(os.path.join(rdir, "results.npz")) as z:
        A = z["A"]
    f1 = detection_f1(A, gt.A)
    with np.load(os.path.join(rdir, "dff.npz")) as z:
        dff_ok = bool(np.isfinite(z["C_df"]).all()
                      and np.isfinite(z["F0"]).all())
    print(f"phase 7: cli {what}: {A.shape[0]} neurons in results.npz, F1 "
          f"{f1['f1']:.4f} (precision {f1['precision']:.4f}, recall "
          f"{f1['recall']:.4f}), DF/F finite {dff_ok}", flush=True)
    require(f1[gate] >= bar, f"cli {what}: {gate} {f1[gate]:.4f} < {bar}")
    require(dff_ok, f"cli {what}: non-finite DF/F")


def phase7_cli(tmp: str):
    """7a: phase 4's movie as a float32 TIFF through the CLI (1p preset,
    --dff --save-mat), F1 >= 0.8, then --resume from its final snapshot
    with a decisions.json; 7b: the same TIFF in 1000-frame batches with
    --dff, F1 >= 0.8; 7c: the 2p preset (svd) on a 2p movie, recall >=
    0.75, no ring kernel, and once with --bg-model nmf, recall >= 0.75."""
    if not PLOTTING:
        print(f"phase 7: figures not written: {' and '.join(PLOTTING_MISSING)}"
              f" not installed on this machine; the CLI's figure step (host "
              f"work) is skipped, the fit, export and DF/F run in full",
              flush=True)
    per_path = {}
    gt, _ = fit_problem()
    tif = os.path.join(tmp, "movie_1p.tif")
    write_tiff(tif, gt.Y)
    rdir, summary, per_path["cli_1p"] = cli_run(
        "1p 256x256x2000 --max-neurons 192 --dff --save-mat", tif,
        os.path.join(tmp, "cli_1p"), ["--max-neurons", "192", "--dff",
                                      "--save-mat"], PATH_EXACT)
    cli_score("1p", rdir, gt, "f1", 0.8)
    require(os.path.exists(os.path.join(rdir, "results.mat")),
            "cli 1p wrote no results.mat")

    (snap,) = [f for f in os.listdir(rdir) if "_final_" in f]
    dec = os.path.join(tmp, "decisions.json")
    with open(dec, "w") as f:
        json.dump({"rejected": [1, 3], "merge": [[0, 2]]}, f)
    rdir2, summary2, per_path["cli_resume"] = cli_run(
        "1p --resume <final snapshot> --apply-decisions (2 rejected, 1 "
        "merge pair)", tif, os.path.join(tmp, "cli_resume"),
        ["--max-neurons", "192", "--resume", os.path.join(rdir, snap),
         "--apply-decisions", dec], PATH_EXACT)
    logs = open(os.path.join(rdir2, "logs.txt")).read()
    fitted = int(logs.split("done: ")[1].split(" neurons")[0])
    merged = int(logs.split("merged ")[1].split(" pairs")[0])
    print(f"phase 7: cli resume: the resumed fit found {fitted} neurons; "
          f"{merged} merged, 2 dropped; summary.json {summary2['n_neurons']}",
          flush=True)
    require(summary2["n_neurons"] == fitted - merged - 2,
            f"cli resume with decisions: {summary2['n_neurons']} neurons, "
            f"not {fitted} - {merged} - 2")

    rdir, _, per_path["cli_batch"] = cli_run(
        "1p --batch-frames 1000 --dff", tif, os.path.join(tmp, "cli_batch"),
        ["--max-neurons", "192", "--batch-frames", "1000", "--dff"],
        PATH_EXACT)
    cli_score("batch", rdir, gt, "f1", 0.8)
    os.remove(tif)

    phase7c_consistency()
    gt = simulate_movie(seed=13, H=256, W=256, T=2000, K=120, gSig=3.0,
                        sn=0.06, bg_strength=0.5, min_dist=9.0,
                        spike_rate=0.02)
    tif = os.path.join(tmp, "movie_2p.tif")
    write_tiff(tif, gt.Y)
    flags = ["--preset", "2p", "--gsig", "3", "--gsiz", "13",
             "--max-neurons", "192", "--dff"]
    rdir, _, per_path["cli_2p_svd"] = cli_run(
        "2p svd 256x256x2000", tif, os.path.join(tmp, "cli_2p"), flags,
        PATH_2P, absent=("ring_stencil",))
    cli_score("2p svd", rdir, gt, "recall", 0.75)
    rdir, _, per_path["cli_2p_nmf"] = cli_run(
        "2p --bg-model nmf", tif, os.path.join(tmp, "cli_nmf"),
        flags + ["--bg-model", "nmf"], PATH_2P, absent=("ring_stencil",))
    cli_score("2p nmf", rdir, gt, "recall", 0.75)
    return per_path


def phase7c_consistency():
    """A 64x64x600 svd fit and its DF/F on the card and on the CPU: equal
    n_active, footprints and traces matched at correlation >= 0.99, F0 of
    matched neurons within 1e-4 relative; and DF/F of the card's state
    computed on both devices, F0 within 1e-4 relative."""
    gt = simulate_movie(seed=13, H=64, W=64, T=600, K=10, gSig=2.5,
                        sn=0.06, bg_strength=0.5, min_dist=11.0,
                        spike_rate=0.04)
    params = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=30, seeds_per_round=16, max_rounds=5),
        background=BackgroundParams(model="svd", rank=3),
        merge=MergeParams(dmin=4.0))
    out, states = {}, {}
    for dev in (DEV, "cpu"):
        model = CNMFE(params, device=dev)
        st = model.fit(gt.Y, n_outer=1)
        _, _, F0 = model.dff(gt.Y)
        n = int(st.n_active())
        states[str(dev)] = st
        out[str(dev)] = (n, st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy(),
                         F0[:n, 0].cpu().numpy())
    (n_g, A_g, C_g, F_g), (n_c, A_c, C_c, F_c) = out[str(DEV)], out["cpu"]
    require(n_g == n_c > 0, f"2p n_active differs: cuda {n_g}, cpu {n_c}")
    pairs = match_by_footprint(A_g, A_c)
    a_corr = min(p[2] for p in pairs)
    c_corr = min(float(np.corrcoef(C_g[i], C_c[j])[0, 1])
                 for i, j, _ in pairs)
    f0_rel = max(abs(F_g[i] - F_c[j]) / abs(F_c[j]) for i, j, _ in pairs)
    # DF/F alone: the card's fitted state on both devices
    Y = torch.as_tensor(gt.Y)
    same = [extract_dff(Y.to(dev), state_from_numpy(
        state_to_numpy(states[str(DEV)]), device=dev), params)[2].cpu()
        for dev in (DEV, "cpu")]
    same_rel = float(((same[0] - same[1]).abs() / same[1].abs()).max())
    print(f"phase 7c: svd fit + DF/F cuda vs cpu on 64x64x600: n_active "
          f"{n_g} == {n_c}; min footprint corr {a_corr:.5f}, min trace corr "
          f"{c_corr:.5f} (>= 0.99); F0 of matched neurons max rel diff "
          f"{f0_rel:.3e}, DF/F of one state on both devices F0 max rel diff "
          f"{same_rel:.3e} (<= 1e-4)", flush=True)
    require(a_corr >= 0.99 and c_corr >= 0.99,
            "cuda and cpu svd fits disagree")
    require(f0_rel <= 1e-4 and same_rel <= 1e-4,
            "cuda and cpu DF/F baselines disagree")


# ------------------------------------------------------------------ #
# phase 8: the 2p pipelines of BASELINE configs 1 and 4
# ------------------------------------------------------------------ #
@contextlib.contextmanager
def stage_calls(module, name: str, timer: StageTimer, stage: str):
    """Time every call of ``module.name`` as ``stage`` of ``timer`` (each
    call closed by a device synchronisation)."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        with timer.stage(stage):
            return fn(*a, **kw)
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def movie_2p(T=2000):
    """Phase 7c's simulated 256x256 2p movie (an AR(1) decay, the svd
    preset's recording)."""
    return simulate_movie(seed=13, H=256, W=256, T=T, K=120, gSig=3.0,
                          sn=0.06, bg_strength=0.5, min_dist=9.0,
                          spike_rate=0.02)


def ar2_movie(seed=3, H=256, W=256, T=2000, K=120, d=0.92, r=0.45, sn=0.06):
    """tests/test_ar2_pipeline.py::_ar2_movie at the given size: a 2p-like
    movie with AR(2) (rise and decay) traces."""
    rng = np.random.default_rng(seed)
    A, _ = gaussian_footprints(rng, K, H, W, gSig=2.5, min_dist=14.0)
    K = A.shape[0]
    g1, g2 = d + r, -d * r
    C = np.zeros((K, T), np.float32)
    S = (rng.random((K, T)) < 0.03).astype(np.float32) * \
        rng.uniform(0.8, 1.6, (K, T)).astype(np.float32)
    for t in range(T):
        C[:, t] = (g1 * C[:, t - 1] if t >= 1 else 0) + \
            (g2 * C[:, t - 2] if t >= 2 else 0) + S[:, t]
    b0 = 1.0 + 0.3 * smooth_field(rng, H, W, scale=32)
    Y = (C.T @ A.reshape(K, -1)).reshape(T, H, W) + b0[None]
    Y += sn * rng.standard_normal((T, H, W)).astype(np.float32)
    return Y.astype(np.float32), A, C, S


def stage_line(timer: StageTimer) -> str:
    return json.dumps({k: round(v, 4) for k, v in timer.times.items()})


def phase8a_cnmf():
    """BASELINE config 1: the vanilla CNMF class (lasso, then nnls) on
    phase 7c's 256x256x2000 2p movie; K1 to K4 launched, no ring kernel,
    recall >= 0.75 and median matched trace correlation >= 0.85
    (tests/test_cnmf2p.py's gates)."""
    gt = movie_2p()
    K = gt.A.shape[0] + 8
    warm = simulate_movie(seed=13, H=64, W=64, T=600, K=10, gSig=3.0,
                          sn=0.06, bg_strength=0.5, min_dist=9.0,
                          spike_rate=0.02)
    cnmf2p.CNMF(K=12, gSig=3.0, nb=2, device=DEV).fit(warm.Y, n_outer=1)
    Y = torch.as_tensor(gt.Y, device=DEV)
    per_path = {}
    for method in ("lasso", "nnls"):
        timer = StageTimer(DEV)
        torch.cuda.reset_peak_memory_stats(DEV)
        with stage_calls(cnmf2p, "greedy_roi", timer, "greedy_roi"), \
                main_path() as launches:
            t0 = time.perf_counter()
            model = cnmf2p.CNMF(K=K, gSig=3.0, nb=2, spatial_method=method,
                                device=DEV)
            state = model.fit(Y, n_outer=2, timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(DEV)
        n = int(state.n_active())
        A = state.A[:n].cpu().numpy()
        C = state.C[:n].cpu().numpy()
        finite = all(bool(torch.isfinite(x).all()) for x in (
            state.A, state.C, state.C_raw, state.S, model.b, model.f))
        f1 = detection_f1(A, gt.A)
        corr = trace_corr(C, gt.C, f1["matches"])
        med = float(np.median(corr)) if len(corr) else 0.0
        gr = timer.times.get("greedy_roi", 0.0)
        print(f"phase 8a: CNMF(K={K}, gSig=3, nb=2, spatial_method="
              f"{method!r}).fit 256x256x2000 ({gt.A.shape[0]} planted), "
              f"n_outer=2: wall {wall:.3f} s, n_active {n}, recall "
              f"{f1['recall']:.4f} (precision {f1['precision']:.4f}), median "
              f"matched trace corr {med:.4f}, peak memory "
              f"{peak / 2**30:.3f} GiB, finite {finite}; stage seconds "
              f"(init = greedy_roi + the NMF background; spatial = the "
              f"{method}; temporal = HALS; deconv = constrained AR(1)) "
              f"{stage_line(timer)}; greedy_roi {gr:.3f} s = "
              f"{gr / wall:.3f} of the wall; solve-entry calls "
              f"{cuda_build.ENTRY_CALLS.get('oasis_solve_launch', 0)}; "
              f"launches {json.dumps(launches)}", flush=True)
        check_path(launches, PATH_2P, f"CNMF {method}")
        require(launches["ring_stencil"] == 0
                and launches["ring_banded_flat"] == 0,
                f"CNMF {method} launched a ring kernel: {launches}")
        require(finite, f"CNMF {method} gave non-finite values")
        if method == "lasso":
            require(f1["recall"] >= 0.75,
                    f"CNMF recall {f1['recall']:.4f} < 0.75")
            require(med >= 0.85, f"CNMF median trace corr {med:.4f} < 0.85")
        per_path[f"cnmf_{method}"] = launches
    return per_path


def ar2_params(preset: str, max_neurons=192, spr=64, rounds=10):
    p = CNMFEParams.preset_2p(preset)
    return p.replace(init=InitParams(
        gSig=2.5, gSiz=8, center_psf=False, min_corr=0.8, min_pnr=8.0,
        max_neurons=max_neurons, seeds_per_round=spr, max_rounds=rounds))


def rss_budget(state, T: int, matches):
    """tests/test_ar2_pipeline.py:47-113 on the matched neurons: each one
    lands within (0.3, 1.3) sn^2 T, or else even its lambda = 0 AR(2) fit
    exceeds the budget and the constrained fit sits at that floor (within
    10%). Returns (on budget, matched, the off-budget proof holds)."""
    n = int(state.n_active())
    C_raw, C, sn = state.C_raw[:n], state.C[:n], state.neuron_sn[:n]
    rss = ((C_raw - C) ** 2).sum(-1).cpu().numpy()
    budget = (sn ** 2 * T).cpu().numpy()
    ratio = rss / np.maximum(budget, 1e-12)
    res0 = deconvolve(C_raw, DeconvParams(model="ar2", method="foopsi",
                                          lam=0.0, optimize_b=False), sn=sn)
    rss0 = ((C_raw - res0.c) ** 2).sum(-1).cpu().numpy()
    on, proof = 0, True
    for k, _ in matches:
        if 0.3 < ratio[k] < 1.3:
            on += 1
        else:
            proof &= bool(rss0[k] >= budget[k]
                          and rss[k] <= rss0[k] * 1.10 + 1e-6)
    return on, len(matches), proof


AR2_T = 1000                # 8b's frames (2000 until phase 13 came)


def phase8b_ar2():
    """BASELINE config 4: CNMFE(preset_2p("ar2_constrained")) and
    CNMFE(preset_2p("ar2_thresholded")) on a simulated 256x256xAR2_T AR(2)
    movie; K1 launched, no ring kernel, g of width 2 with some |g2| >
    1e-4, recall >= 0.75; the constrained fit holds the RSS budget.
    Returns (per-path launches, 192 traces of the constrained fit, the
    traces' ground truth rows)."""
    Y_np, A_true, C_true, _ = ar2_movie(T=AR2_T)
    T = Y_np.shape[0]
    wY, _, _, _ = ar2_movie(H=64, W=64, T=600, K=8)
    Y = torch.as_tensor(Y_np, device=DEV)
    per_path, traces = {}, None
    for preset in ("ar2_constrained", "ar2_thresholded"):
        CNMFE(ar2_params(preset, 24, 8, 6), device=DEV).fit(wY, n_outer=1)
        timer = StageTimer(DEV)
        torch.cuda.reset_peak_memory_stats(DEV)
        with stage_calls(oasis, "onnls_deconvolve", timer, "ar2_deconv"), \
                main_path() as launches:
            t0 = time.perf_counter()
            state = CNMFE(ar2_params(preset), device=DEV).fit(
                Y, n_outer=1, timer=timer)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(DEV)
        n = int(state.n_active())
        A = state.A[:n].cpu().numpy()
        g = state.g[:n].cpu().numpy()
        f1 = detection_f1(A, A_true)
        corr = trace_corr(state.C[:n].cpu().numpy(), C_true, f1["matches"])
        med = float(np.median(corr)) if len(corr) else 0.0
        finite = all(bool(torch.isfinite(getattr(state, k)).all())
                     for k in ("A", "C", "C_raw", "S", "g"))
        ar2 = timer.times.get("ar2_deconv", 0.0)
        line = (f"phase 8b: CNMFE(preset_2p({preset!r})).fit 256x256x{T} "
                f"({A_true.shape[0]} planted, d=0.92, r=0.45), n_outer=1: "
                f"wall {wall:.3f} s, n_active {n}, recall "
                f"{f1['recall']:.4f} (precision {f1['precision']:.4f}), "
                f"median matched trace corr {med:.4f}, g width "
                f"{state.g.shape[1]}, max |g2| {np.abs(g[:, 1]).max():.4f}, "
                f"peak memory {peak / 2**30:.3f} GiB, finite {finite}; "
                f"the AR(2) deconvolution {ar2:.3f} s in "
                f"{timer.counts.get('ar2_deconv', 0)} calls = "
                f"{ar2 / wall:.3f} of the wall; stage seconds (StageTimer; "
                f"ar2_deconv lies inside the others) {stage_line(timer)}")
        if preset == "ar2_constrained":
            on, nm, proof = rss_budget(state, T, f1["matches"])
            line += (f"; RSS budget: {on} of {nm} matched neurons within "
                     f"(0.3, 1.3) sn^2 T, the rest at their lambda = 0 "
                     f"floor: {proof}")
            rows = np.resize(np.arange(n), 192)
            traces = (state.C_raw[:n][torch.as_tensor(rows, device=DEV)],
                      [dict(f1["matches"]).get(int(k)) for k in rows])
        print(f"{line}; launches {json.dumps(launches)}", flush=True)
        check_path(launches, {"hals_sweeps"}, preset)
        require(launches["ring_stencil"] == 0
                and launches["ring_banded_flat"] == 0,
                f"{preset} launched a ring kernel: {launches}")
        require(finite, f"{preset} gave non-finite values")
        require(state.g.shape[1] == 2 and np.abs(g[:, 1]).max() > 1e-4,
                f"{preset}: g is not AR(2)")
        require(f1["recall"] >= 0.75,
                f"{preset} recall {f1['recall']:.4f} < 0.75")
        if preset == "ar2_constrained":
            # tests/test_ar2_pipeline.py allows 3 of its 8 neurons at
            # their lambda = 0 floor: the same share here
            require(proof and on >= nm - max(3, -(-3 * nm // 8)),
                    f"the RSS budget does not hold: {on} of {nm}, {proof}")
        per_path[preset] = launches
    return per_path, traces, C_true


DECONV_FAMILIES = (
    ("ar1_foopsi", dict(model="ar1", method="foopsi")),
    ("ar1_constrained", dict(model="ar1", method="constrained")),
    ("ar1_thresholded", dict(model="ar1", method="thresholded")),
    ("ar2_foopsi", dict(model="ar2", method="foopsi")),
    ("ar2_constrained", dict(model="ar2", method="constrained")),
    ("ar2_thresholded", dict(model="ar2", method="thresholded")),
    ("ar2_optimize_g", dict(model="ar2", method="constrained",
                            optimize_g=2)),
    ("exp2_constrained", dict(model="exp2", method="constrained")),
    ("kernel", dict(model="kernel", method="foopsi")),
    ("mcem", dict(model="ar1", method="mcem")),
    ("mcmc", dict(model="ar1", method="mcmc")))


# the samplers against the planted traces: MCEM refits by constrained
# OASIS; MCMC's default 400 sweeps (100 burn-in) add at most one spike a
# sweep, short of the ~60 spikes of a 2000-sample trace here, and the
# JAX package's mcmc_spikes reaches a median correlation of 0.70 on such
# AR(2) traces too (8 traces, T = 2000, on the CPU)
SAMPLER_BARS = {"mcem": 0.8, "mcmc": 0.6}


def phase8c_deconv(traces, C_true):
    """Every deconvolution family on 192 traces (T = AR2_T) of 8b's
    constrained fit, on the card and, for the deterministic families, on
    the CPU: c and s within 1e-4 of each trace's scale. mcem and mcmc on
    the card only, held to the planted traces (median correlation on the
    matched rows >= SAMPLER_BARS). Each family's median wall on the card
    of three runs after a warm-up, with its solve-entry calls."""
    y, truth = traces
    sn = noise_psd(y)
    g2 = estimate_time_constant(y, p=2, sn=sn)
    h = ar_kernel(g2.median(dim=0).values[None], 200)[0]
    per_path = {}
    for name, kw in DECONV_FAMILIES:
        params = DeconvParams(**kw)
        g = g2 if kw["model"] == "exp2" else h if kw["model"] == "kernel" \
            else None

        def run(dev=DEV):
            return deconvolve(y.to(dev), params, sn=sn.to(dev),
                              g=None if g is None else g.to(dev))
        run()
        times = []
        for _ in range(3):
            with main_path() as launches:
                t0 = time.perf_counter()
                res = run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
        solves = cuda_build.ENTRY_CALLS.get("oasis_solve_launch", 0)
        c_g, s_g = res.c.cpu().numpy(), res.s.cpu().numpy()
        finite = bool(np.isfinite(c_g).all() and np.isfinite(s_g).all())
        line = (f"phase 8c: deconvolve {name} on 192 x {y.shape[1]} traces "
                f"of 8b's fit: card median wall "
                f"{statistics.median(times):.4f} s "
                f"({', '.join(f'{t:.4f}' for t in times)}), {solves} "
                f"solve-entry calls a run, finite {finite}")
        require(finite, f"deconvolve {name} gave non-finite values")
        if name in ("mcem", "mcmc"):
            corr = [float(np.corrcoef(c_g[i], C_true[j])[0, 1])
                    for i, j in enumerate(truth) if j is not None]
            med = float(np.median(corr))
            bar = SAMPLER_BARS[name]
            print(f"{line}; median corr with the planted trace over "
                  f"{len(corr)} matched rows {med:.4f} (>= {bar}); launches "
                  f"{json.dumps(launches)}", flush=True)
            require(med >= bar, f"deconvolve {name}: median corr {med:.4f}")
        else:
            t0 = time.perf_counter()
            ref = run("cpu")
            cpu_s = time.perf_counter() - t0
            scale = np.maximum(np.abs(y.cpu().numpy()).max(-1), 1e-6)
            err = max(float((np.abs(a - b.numpy()).max(-1) / scale).max())
                      for a, b in ((c_g, ref.c), (s_g, ref.s)))
            print(f"{line}; CPU {cpu_s:.3f} s, card vs CPU max err "
                  f"{err:.3e} of scale (<= 1e-4); launches "
                  f"{json.dumps(launches)}", flush=True)
            require(err <= 1e-4, f"deconvolve {name}: card vs CPU {err:.3e}")
        if kw["model"] == "ar1" and name != "mcmc":
            require(solves > 0 and launches["oasis_chunk_pools"] == solves,
                    f"deconvolve {name} ran no OASIS solve: {launches}")
        per_path[f"deconv_{name}"] = launches
    return per_path


def phase8d_consistency():
    """At 64x64x600: CNMFE fits with spatial.algorithm in {hals_thresh,
    nnls, lars} and with temporal.decorrelate on the card and on the CPU
    (equal n_active, footprints and traces matched at correlation >=
    0.99); then mcmc_spikes on planted spikes, on the card, as
    tests/test_mcmc.py:9-53 requires."""
    gt = simulate_movie(seed=13, H=64, W=64, T=600, K=10, gSig=2.5,
                        sn=0.06, bg_strength=0.5, min_dist=11.0,
                        spike_rate=0.04)
    base = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=30, seeds_per_round=16, max_rounds=5),
        background=BackgroundParams(model="svd", rank=3),
        merge=MergeParams(dmin=4.0))
    variants = [(f"spatial.algorithm={a}", base.replace(
        spatial=dataclasses.replace(base.spatial, algorithm=a)))
        for a in ("hals_thresh", "nnls", "lars")]
    variants.append(("temporal.decorrelate", base.replace(
        temporal=dataclasses.replace(base.temporal, decorrelate=True))))
    for what, params in variants:
        out = {}
        for dev in (DEV, "cpu"):
            st = CNMFE(params, device=dev).fit(gt.Y, n_outer=1)
            n = int(st.n_active())
            out[str(dev)] = (n, st.A[:n].cpu().numpy(),
                             st.C[:n].cpu().numpy())
        (n_g, A_g, C_g), (n_c, A_c, C_c) = out[str(DEV)], out["cpu"]
        require(n_g == n_c > 0, f"8d {what}: n_active {n_g} vs {n_c}")
        pairs = match_by_footprint(A_g, A_c)
        a_corr = min(p[2] for p in pairs)
        c_corr = min(float(np.corrcoef(C_g[i], C_c[j])[0, 1])
                     for i, j, _ in pairs)
        print(f"phase 8d: {what} cuda vs cpu on 64x64x600: n_active {n_g} "
              f"== {n_c}; min footprint corr {a_corr:.5f}, min trace corr "
              f"{c_corr:.5f} (>= 0.99)", flush=True)
        require(a_corr >= 0.99 and c_corr >= 0.99,
                f"8d {what}: cuda and cpu fits disagree")

    rng = np.random.default_rng(0)
    g, T, sn = 0.9, 400, 0.15
    spike_times = [50, 150, 260, 340]
    c = np.zeros(T)
    for t in range(T):
        c[t] = (c[t - 1] * g if t else 0) + (2.0 if t in spike_times else 0)
    y = c + 1.0 + sn * rng.standard_normal(T)
    res = mcmc_spikes(torch.tensor(y[None], dtype=torch.float32, device=DEV),
                      torch.tensor([g], device=DEV),
                      torch.tensor([sn], device=DEV), seed=3, n_iter=3000,
                      n_burn=500)
    prob = res.spike_prob[0].cpu().numpy()
    quiet = np.ones(T, bool)
    for t in spike_times:
        quiet[max(t - 5, 0):t + 6] = False
    peaks = [float(prob[max(t - 2, 0):t + 3].max()) for t in spike_times]
    b = float(res.b_mean[0])
    print(f"phase 8d: mcmc_spikes on 4 planted spikes (T={T}, 3000 sweeps) "
          f"on the card: accepted {int(res.n_accept[0])} (> 50), peak "
          f"probability near each spike {peaks} (> 0.5), quiet mean "
          f"{prob[quiet].mean():.4f} (< 0.1), baseline {b:.4f} (1 +- 0.2)",
          flush=True)
    require(int(res.n_accept[0]) > 50 and min(peaks) > 0.5
            and prob[quiet].mean() < 0.1 and abs(b - 1.0) < 0.2,
            "mcmc_spikes missed the planted spikes")


def phase8_2p():
    per_path = phase8a_cnmf()
    ar2_paths, traces, C_true = phase8b_ar2()
    per_path.update(ar2_paths)
    per_path.update(phase8c_deconv(traces, C_true))
    phase8d_consistency()
    return per_path


# ------------------------------------------------------------------ #
# phase 9: the local background and the ellipse search, and the QC,
# ordering, pairing and init utilities
# ------------------------------------------------------------------ #
def local_ellipse(params):
    """``params`` with the local background and the ellipse search."""
    return params.replace(
        background=dataclasses.replace(params.background, model="local"),
        spatial=dataclasses.replace(params.spatial, search_method="ellipse"))


def phase9a_local_ellipse():
    """Phase 4's movie and parameters with background.model="local" and
    spatial.search_method="ellipse" (warm-up fit, then a timed fit with a
    StageTimer): K1, the OASIS solve entry and K6 launched, no plain
    version called, F1 >= 0.8. Returns (launches, state, gt, params)."""
    gt, params = fit_problem()
    params = local_ellipse(params)
    Y = torch.as_tensor(gt.Y, device=DEV)
    CNMFE(params, device=DEV).fit(Y, n_outer=2)             # warm-up
    torch.cuda.synchronize()
    timer = StageTimer(DEV)
    torch.cuda.reset_peak_memory_stats(DEV)
    with stage_calls(background, "local_background", timer,
                     "local_background"), \
            main_path() as launches:
        t0 = time.perf_counter()
        state = CNMFE(params, device=DEV).fit(Y, n_outer=2, timer=timer)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(DEV)
    solves = cuda_build.ENTRY_CALLS.get("oasis_solve_launch", 0)
    n = int(state.n_active())
    A = state.A[:n].cpu().numpy()
    C = state.C[:n].cpu().numpy()
    finite = all(bool(torch.isfinite(getattr(state, k)).all())
                 for k in ("A", "C", "C_raw", "S", "b0")) and \
        bool(torch.isfinite(state.W.w).all())
    f1 = detection_f1(A, gt.A)
    corr = trace_corr(C, gt.C, f1["matches"])
    med = float(np.median(corr)) if len(corr) else 0.0
    lb = timer.times.get("local_background", 0.0)
    print(f"phase 9a: CNMFE.fit preset_1p, background.model='local', "
          f"spatial.search_method='ellipse', 256x256x2000 K_max=192 "
          f"n_outer=2: wall {wall:.3f} s, n_active {n}, F1 {f1['f1']:.4f} "
          f"(precision {f1['precision']:.4f}, recall {f1['recall']:.4f}), "
          f"median matched trace corr {med:.4f}, peak memory "
          f"{peak / 2**30:.3f} GiB, finite {finite}; K1 launches "
          f"{launches['hals_sweeps']}, solve-entry calls {solves}, K6 "
          f"launches {launches['ring_stencil']}; local_background "
          f"{timer.counts.get('local_background', 0)} calls {lb:.3f} s = "
          f"{lb / wall:.3f} of the wall", flush=True)
    print(f"phase 9a: stage seconds (StageTimer; background holds "
          f"local_background, the other stages its predictions) "
          f"{stage_line(timer)}; launches {json.dumps(launches)}", flush=True)
    check_path(launches, PATH_EXACT, "local + ellipse fit")
    require(solves > 0, "the local + ellipse fit made no OASIS solve")
    require(finite, "the local + ellipse fit gave non-finite values")
    require(f1["f1"] >= 0.8, f"local + ellipse F1 {f1['f1']:.4f} < 0.8")
    return launches, state, gt, params, wall, peak


def phase9b_consistency():
    """Phase 3's movie with the local background and the ellipse search on
    the card and on the CPU: the same neurons, footprint and trace
    correlation >= 0.99."""
    gt = simulate_movie(seed=11, H=64, W=64, T=600, K=10, gSig=2.5,
                        sn=0.08, bg_strength=0.8, min_dist=12.0,
                        spike_rate=0.04)
    params = local_ellipse(CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=40, seeds_per_round=16, max_rounds=6),
        background=BackgroundParams(model="ring", ring_radius=9),
        merge=MergeParams(dmin=4.0)))
    out = []
    for dev in (DEV, "cpu"):
        st = CNMFE(params, device=dev).fit(gt.Y, n_outer=2)
        n = int(st.n_active())
        out.append((n, st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy(),
                    st.b0.cpu().numpy()))
    (n_g, A_g, C_g, b_g), (n_c, A_c, C_c, b_c) = out
    require(n_g == n_c, f"local + ellipse n_active differs: cuda {n_g}, "
            f"cpu {n_c}")
    pairs = match_by_footprint(A_g, A_c)
    a_corr = min(p[2] for p in pairs)
    c_corr = min(float(np.corrcoef(C_g[i], C_c[j])[0, 1])
                 for i, j, _ in pairs)
    b_rel = float(np.abs(b_g - b_c).max() / np.abs(b_c).max())
    f1 = detection_f1(A_g, gt.A)["f1"]
    print(f"phase 9b: local + ellipse cuda vs cpu fit on 64x64x600: "
          f"n_active {n_g} == {n_c}, F1 {f1:.4f}; min footprint corr "
          f"{a_corr:.5f}, min trace corr {c_corr:.5f} (>= 0.99); b0 max "
          f"difference {b_rel:.3e} of its scale", flush=True)
    require(a_corr >= 0.99 and c_corr >= 0.99,
            "local + ellipse cuda and cpu fits disagree")


def ellipse_r2(A: np.ndarray, dist=3.0, lo=3.0, hi=8.0) -> np.ndarray:
    """search_locations_ellipse's r2 in float64 numpy (the JAX package's
    eigh form), to tell a boundary tie from a disagreement."""
    A = A.astype(np.float64)
    K, H, W = A.shape
    yy, xx = np.mgrid[0:H, 0:W]
    mass = A.sum(axis=(1, 2)) + 1e-12
    cy = (A * yy).sum(axis=(1, 2)) / mass
    cx = (A * xx).sum(axis=(1, 2)) / mass
    dy = yy[None] - cy[:, None, None]
    dx = xx[None] - cx[:, None, None]
    syx = (A * dx * dy).sum((1, 2))
    cov = np.stack([np.stack([(A * dy * dy).sum((1, 2)), syx], -1),
                    np.stack([syx, (A * dx * dx).sum((1, 2))], -1)], -2)
    ev, V = np.linalg.eigh(cov / mass[:, None, None])
    ax = np.clip(np.sqrt(np.maximum(ev, 1e-6)) * dist, lo, hi)
    p0 = V[:, 0, 0, None, None] * dy + V[:, 1, 0, None, None] * dx
    p1 = V[:, 0, 1, None, None] * dy + V[:, 1, 1, None, None] * dx
    return (p0 / ax[:, 0, None, None]) ** 2 + (p1 / ax[:, 1, None, None]) ** 2


def to_cpu(x):
    """A CPU copy of a tensor or of a state's tensors."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: to_cpu(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def card_and_cpu(what: str, fn, *args):
    """``fn`` on the card's arguments and on their CPU copies; prints the
    card's median wall of 3 runs and the CPU's wall of one. Returns
    (card, cpu)."""
    cpu_args = [to_cpu(a) for a in args]
    walls = {}
    for dev, a, reps in (("cuda", args, 3), ("cpu", cpu_args, 1)):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        walls[dev] = (out, statistics.median(times))
    print(f"phase 9c: {what}: card {walls['cuda'][1] * 1e3:.3f} ms (median "
          f"wall of 3), cpu {walls['cpu'][1] * 1e3:.3f} ms", flush=True)
    return walls["cuda"][0], walls["cpu"][0]


ORDER_KEYS = ("snr", "pnr", "energy", "mean", "decay_time",
              "sparsity_spatial", "sparsity_temporal", "circularity",
              "temporal_cluster", "spatial_cluster")


def phase9c_utilities(state, gt, params):
    """The QC, ordering, pairing and init utilities on 9a's state, card
    against CPU, each timed."""
    st_g, st_c = state, to_cpu(state)
    # order_neurons: equal permutations wherever the keys are distinct
    for key in ORDER_KEYS:
        pg, pc = card_and_cpu(f"order_neurons({key!r})", qc.order_neurons,
                              st_g, key)
        pg, pc = pg.cpu(), pc
        if torch.equal(pg, pc):
            continue
        kc, _ = qc.order_key(st_c, key)      # the cluster orders are host
        kc = torch.where(st_c.active, kc, torch.nan)
        a, b = kc[pg], kc[pc]
        near = torch.isclose(a, b, rtol=1e-5, atol=0, equal_nan=True)
        print(f"phase 9c: order_neurons({key!r}): {int((pg != pc).sum())} "
              f"positions differ, all at keys within 1e-5 of each other: "
              f"{bool(near.all())}", flush=True)
        require(bool(near.all()), f"order_neurons({key!r}) differs at "
                f"distinct keys")
    perm = qc.order_neurons(st_g, "snr")
    og, oc = card_and_cpu("apply_order", qc.apply_order, st_g, perm)
    require(all(torch.equal(getattr(og, k).cpu(), getattr(oc, k))
                for k in ("A", "C", "C_raw", "S", "g", "active")),
            "apply_order differs")
    # QC with an active-pixel mask and classify_components
    mask = torch.as_tensor(gt.A.max(axis=0) > 0.1 * gt.A.max())
    p_cl = params.replace(qc=dataclasses.replace(params.qc,
                                                 classify_cl_thr=0.8))
    kg, kc_ = card_and_cpu("remove_false_positives(active pixels, "
                           "classify_cl_thr=0.8)",
                           lambda st, m: qc.remove_false_positives(
                               st, p_cl, active_pixels=m).active,
                           st_g, mask.to(DEV))
    require(torch.equal(kg.cpu(), kc_), "the QC keep sets differ")
    print(f"phase 9c: QC keeps {int(kc_.sum())} of {int(st_c.n_active())} "
          f"neurons on the planted footprints' mask", flush=True)
    # the three candidate graphs, on thresholds that give edges
    p_m = params.replace(merge=MergeParams(
        dmin=12.0, dmin_only=6.0, merge_thr=0.2,
        merge_thr_spatial=(0.05, 0.2, 0.0)))
    for mode in ("dist_corr", "high_corr", "dist_only"):
        fn = getattr(merge, f"merge_candidates_{mode}")
        ag, ac = card_and_cpu(f"merge_candidates_{mode}",
                              lambda st: fn(st, p_m), st_g)
        print(f"phase 9c: merge_candidates_{mode}: {int(ag.sum()) // 2} "
              f"edges on the card, {int(ac.sum()) // 2} on the cpu",
              flush=True)
        require(np.array_equal(ag, ac), f"merge_candidates_{mode} differ")
    # the ellipse masks and thresholded footprints
    A = st_g.A
    eg, ec = card_and_cpu("search_locations_ellipse",
                          search_locations_ellipse, A)
    differ = (eg.cpu() != ec).numpy()
    tie = np.abs(ellipse_r2(A.cpu().numpy()) - 1.0) <= 1e-4
    print(f"phase 9c: ellipse masks differ at {int(differ.sum())} pixels, "
          f"all within 1e-4 of r2 = 1: {bool(tie[differ].all())}",
          flush=True)
    require(bool(tie[differ].all()), "the ellipse masks differ off the "
            "boundary")
    tg, tc = card_and_cpu("threshold_components", threshold_components, A)
    per = (tg.cpu() != tc).reshape(A.shape[0], -1).sum(dim=1)
    require(int(per.max()) <= 1, f"threshold_components differs at "
            f"{int(per.max())} pixels of one footprint")
    # the projected correlation image against the full one
    Y = torch.as_tensor(gt.Y, device=DEV)
    cg, cc = card_and_cpu("local_correlation_projected(k=1000)",
                          local_correlation_projected, Y)
    t0 = time.perf_counter()
    cn = correlation_image(Y)
    torch.cuda.synchronize()
    cn_ms = (time.perf_counter() - t0) * 1e3
    r = float(np.corrcoef(cg.cpu().numpy().ravel(),
                          cn.cpu().numpy().ravel())[0, 1])
    e = float((cg.cpu() - cc).abs().max())
    print(f"phase 9c: local_correlation_projected vs correlation_image "
          f"(card {cn_ms:.3f} ms): map correlation {r:.4f}; card vs cpu "
          f"max difference {e:.3e}", flush=True)
    require(e <= 1e-4 and r >= 0.9, "local_correlation_projected disagrees")
    # hals_nmf on a 128x128 crop, K1 against its plain version
    crop = Y[:, :128, :128].reshape(Y.shape[0], -1).T.contiguous()
    Ac = st_g.A[:, :128, :128].reshape(st_g.K_max, -1)
    keep = (Ac.sum(dim=1) > 0.5 * st_g.A.sum(dim=(1, 2))) & st_g.active
    A0 = Ac[keep].T.contiguous()
    C0 = st_g.C[keep].contiguous()
    cuda_build.reset_launch_counts()
    (hg, hc) = card_and_cpu(f"hals_nmf on 128x128x2000, K={A0.shape[1]}, "
                            f"10 iterations", hals_nmf, crop, A0, C0)
    k1 = cuda_build.LAUNCHES["hals_sweeps"]
    errs = [float((g.cpu() - c).abs().max() / c.abs().max())
            for g, c in zip(hg, hc)]
    print(f"phase 9c: hals_nmf: K1 launches {k1}; A, C max difference "
          f"{errs[0]:.3e}, {errs[1]:.3e} of their scale", flush=True)
    require(k1 > 0, "hals_nmf launched no K1")
    require(max(errs) <= 1e-3, "hals_nmf card and cpu disagree")
    # k-means++ and the sparse NMF init from the same generator
    Yc = Y[:, :128, :128].contiguous()
    Xk = torch.clamp(Yc.reshape(Yc.shape[0], -1).T, min=0.0)[::8]
    (kg_, lg), (kc2, lc) = card_and_cpu("kmeans_pp(k=24) on 2048 pixel "
                                        "traces", kmeans_pp, Xk, 24)
    ek = float((kg_.cpu() - kc2).abs().max() / kc2.abs().max())
    nl = int((lg.cpu() != lc).sum())
    print(f"phase 9c: kmeans_pp: centres {ek:.3e} of their scale apart, "
          f"{nl} labels differ", flush=True)
    require(ek <= 1e-4 and nl == 0, "kmeans_pp card and cpu disagree")
    (sa, sc), (sa_c, sc_c) = card_and_cpu(
        "sparse_nmf_init(K=24) on 128x128x2000", sparse_nmf_init, Yc, 24)
    es = [float((g.cpu() - c).abs().max() / c.abs().max())
          for g, c in ((sa, sa_c), (sc, sc_c))]
    print(f"phase 9c: sparse_nmf_init: A, C {es[0]:.3e}, {es[1]:.3e} of "
          f"their scale apart", flush=True)
    require(max(es) <= 1e-3, "sparse_nmf_init card and cpu disagree")
    # pairing against the planted footprints
    n = int(st_c.n_active())
    t0 = time.perf_counter()
    pr = pair_neurons(gt.A.reshape(gt.A.shape[0], -1).T, gt.C,
                      st_c.A[:n].reshape(n, -1).T.numpy(),
                      st_c.C[:n].numpy())
    ms = (time.perf_counter() - t0) * 1e3
    matched = int((pr.ind_max >= 0).sum())
    print(f"phase 9c: pair_neurons against the {gt.A.shape[0]} planted "
          f"neurons ({ms:.3f} ms, host): {matched} mutual matches, median "
          f"combined similarity {float(np.nanmedian(pr.max_all)):.4f}",
          flush=True)
    require(matched >= 0.8 * gt.A.shape[0], "pair_neurons matched fewer "
            "than 0.8 of the planted neurons")


def phase9_local():
    """Phases 9a to 9c: 9a's launches, and its fit as phase 12a's
    reference (A, C of the active neurons, wall, peak)."""
    launches, state, gt, params, wall, peak = phase9a_local_ellipse()
    phase9b_consistency()
    phase9c_utilities(state, gt, params)
    n = int(state.n_active())
    return launches, dict(A=state.A[:n].cpu().numpy(),
                          C=state.C[:n].cpu().numpy(), wall=wall, peak=peak)


# ------------------------------------------------------------------ #
# phase 10: the (patch, frame) mesh on torch.distributed
# ------------------------------------------------------------------ #
# phase 5's two exact variants, on the mesh
MESH_CASES = (("deconv_every_5", dict(deconv_every=5)),
              ("colored_every_5", dict(colored=True, deconv_every=5)))
MESH_TIMEOUT = 300      # seconds for one spawn, its ranks' start included


# the chain-drift bar (scripts_dev/chain_drift.py) on C, and A's error
# as a share of its largest entry
STEP_BARS = dict(C=1e-3, A=2e-4)


def a_scale_err(A: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(A - ref).max() / np.abs(ref).max())


def step_self_drift(Y, d, H, W, T, K, chain, kw) -> dict:
    """How far the one-process step on the card moves when Y moves by one
    ulp up and down (np.nextafter): C by ``drift``, A by its error over
    its scale. On step_256's problem the uncoloured chain lets a
    footprint collapse, and one ulp of Y then moves C by more than its
    own scale (the line of phase 10a prints it)."""
    step = make_update_step(None, H, W, T, radius=RADIUS, n_hals=1,
                            chain=chain, **kw)

    def run(Y_):
        out = step(torch.as_tensor(Y_, device=DEV),
                   step_state_from_numpy(d, DEV))
        return out.A.cpu().numpy(), out.C.cpu().numpy()
    A0, C0 = run(Y)
    out = dict(C=0.0, A=0.0)
    for to in (np.inf, -np.inf):
        A1, C1 = run(np.nextafter(Y, np.float32(to)))
        out = dict(C=max(out["C"], drift(C1, C0)),
                   A=max(out["A"], a_scale_err(A1, A0)))
    return out


# tests/test_streaming.py:331-337's tolerances, as shares of the scale
STREAM_BARS = dict(A=5e-4, C=5e-3)
# 10b's rank 0 by stage (s) when its init ran on rank 0 and its state was
# pickled there and back around the QC and the tags (PERF.md section 5)
PICKLED_QC = {"init": 2.049, "qc_merge": 1.223, "tags": 1.649}
REORDER_CHUNK = 64 << 20    # f32 bytes a streamed chunk, in place of 256 MB


def fit_errors(A, C, A_ref, C_ref) -> dict:
    """Footprint and trace errors over their scales, and the least
    correlation of a footprint or a trace with its counterpart (the
    neurons in the same slots)."""
    corr = min(min(float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
                   for a, b in zip(A, A_ref)),
               min(float(np.corrcoef(c, d)[0, 1]) for c, d in zip(C, C_ref)))
    return dict(A=a_scale_err(A, A_ref), C=a_scale_err(C, C_ref), corr=corr)


def stream_reorder_drift(root: str, stream_ref, fit_kw) -> dict:
    """Phase 6's fit again in one process, with chunks of REORDER_CHUNK
    bytes: the same sums in another order. On the 20,000-frame store it
    moves one trace past STREAM_BARS (the line of phase 10b prints it),
    so the mesh is held to 8x this drift where it is the larger (phase
    5b's convention)."""
    A_s, C_s = stream_ref[:2]
    saved = streaming.CHUNK_BYTES
    streaming.CHUNK_BYTES = REORDER_CHUNK
    try:
        st = fit_streaming(MovieStore(root), stream_params(), device=DEV,
                           **fit_kw)
    finally:
        streaming.CHUNK_BYTES = saved
    n = int(st.n_active())
    require(n == A_s.shape[0], f"the reordered one-process fit found {n} "
            f"neurons, phase 6 {A_s.shape[0]}")
    return fit_errors(st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy(), A_s,
                      C_s)


def check_rank_path(info: dict, path: set, what: str) -> None:
    """One rank's counted run (``_selftest._path_run``): every kernel of
    ``path`` launched, the OASIS kernels through the solve entry, no plain
    version called."""
    require(not info["references"], f"{what} called plain versions: "
            f"{info['references']}")
    check_path(info["launches"], path, what)
    solves = info["entries"].get("oasis_solve_launch", 0)
    require(all(info["launches"][k] == solves for k in OASIS_NAMES),
            f"{what} launched OASIS kernels outside the solve entry "
            f"({solves} solves): {info['launches']}")


def ranks_line(infos) -> str:
    return "; ".join(
        f"rank {r}: wall {i['wall']:.4f} s, {i['comm']['bytes']} B handed "
        f"to {i['comm']['calls']} collectives, {i['comm']['seconds']:.4f} s "
        f"inside them" for r, i in enumerate(infos))


def summed_launches(infos) -> dict:
    return {k: sum(i["launches"][k] for i in infos)
            for k in cuda_build.KERNELS}


def phase10_mesh(tmp: str, step_outs: dict, step_ms: dict, stream_ref,
                 H=256, W=256, T=2000, K=192, chain=10):
    """10a, 10c and 10b in one spawn of a 2 x 2 gloo mesh on the card,
    then 10a' on a 1 x 1 NCCL mesh. ``step_outs`` and ``step_ms``: phase
    5's (A, C) and ms per iteration by variant; ``stream_ref``: phase 6's
    (A, C, wall, stages). Returns the launches of each counted run,
    summed over its ranks."""
    Y, d = step_problem(H, W, T, K, RADIUS)
    self_drift = {name: step_self_drift(Y, d, H, W, T, K, chain, kw)
                  for name, kw in MESH_CASES}
    torch.cuda.empty_cache()
    y_path = os.path.join(tmp, "mesh_Y.npy")
    d_path = os.path.join(tmp, "mesh_state.npz")
    np.save(y_path, Y)
    np.savez(d_path, **d)
    del Y
    root = os.path.join(tmp, "stream")
    fit_kw = dict(n_outer=1, init_budget_frames=2000)
    reorder = stream_reorder_drift(root, stream_ref, fit_kw)
    jobs = [("step", "card_step", (y_path, d_path, H, W, T, RADIUS, chain,
                                   MESH_CASES)),
            ("ingest", "card_ingest", (root,)),
            ("stream", "card_stream", (root, os.path.join(tmp, "warm"),
                                       dataclasses.asdict(stream_params()),
                                       fit_kw))]
    t0 = time.perf_counter()
    ranks = launch.spawn(_selftest.cases, 2, 2, backend="gloo", device="cuda",
                         args=(jobs,), timeout=MESH_TIMEOUT)
    card = torch.cuda.get_device_name(0)
    print(f"phase 10: 2 x 2 gloo mesh, 4 ranks on {card}: spawn, ingest, "
          f"step and streamed fit in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    per_path = {}

    # 10a: the step on the mesh against phase 5's single-process step
    for name, _ in MESH_CASES:
        infos = [r["step"][name] for r in ranks]
        for rank, info in enumerate(infos):
            check_rank_path(info, PATH_EXACT, f"mesh step {name} rank {rank}")
        got = infos[0]["state"]
        A_s, C_s = step_outs[name]
        err = dict(C=drift(got["C"], C_s), A=a_scale_err(got["A"], A_s))
        # the chain-drift bar, or 8x the one-process step's own one-ulp
        # drift where the step is ill-conditioned (phase 5b's bar)
        bar = {k: max(STEP_BARS[k], 8 * self_drift[name][k]) for k in err}
        ms_iter = max(i["wall"] for i in infos) * 1e3 / chain
        print(f"phase 10a: step {name} {H}x{W}x{T} K={K} radius={RADIUS} "
              f"chain={chain} on the 2 x 2 gloo mesh: {ms_iter:.3f} ms per "
              f"iteration (the slowest rank's host clock, device "
              f"synchronised) against phase 5's {step_ms[name]:.3f} (one "
              f"process); against phase 5's output C max-rel drift "
              f"{err['C']:.3e}, A max abs / scale {err['A']:.3e}; the "
              f"one-process step's one-ulp self-drift C "
              f"{self_drift[name]['C']:.3e}, A {self_drift[name]['A']:.3e}; "
              f"bars C {bar['C']:.3e}, A "
              f"{bar['A']:.3e}; {ranks_line(infos)}; launches per rank "
              f"{json.dumps([i['launches'] for i in infos])}", flush=True)
        require(all(err[k] <= bar[k] for k in err),
                f"mesh step {name}: {err} past the bars {bar}")
        per_path[f"mesh_{name}"] = summed_launches(infos)

    # 10c: the ingest against a direct read of the store
    store = MovieStore(root)
    direct = np.concatenate([
        np.asarray(store.read_block(i)).sum(axis=(1, 2), dtype=np.float64)
        for i in range(store.n_blocks())])
    sums = ranks[0]["ingest"]["sums"]
    err = float(np.abs(sums - direct).max())
    ok = np.allclose(sums, direct, rtol=1e-4, atol=1e-3)
    shape = "x".join(map(str, store.shape))
    print(f"phase 10c: load_sharded_movie of the {shape} store, frame ranges "
          f"{[r['ingest']['range'] for r in ranks]}, read in "
          f"{[round(r['ingest']['seconds'], 3) for r in ranks]} s; per-frame "
          f"sums all-reduced against a direct read: max abs difference "
          f"{err:.4e} (rtol 1e-4, atol 1e-3: {ok})", flush=True)
    require(ok, f"ingest sums differ from a direct read by {err:.4e}")

    # 10b: fit_streaming on the mesh against phase 6's fit
    infos = [r["stream"] for r in ranks]
    for rank, info in enumerate(infos):
        check_rank_path(info, PATH_EXACT, f"mesh streaming rank {rank}")
    st = infos[0]["state"]
    n = int(st["active"].sum())
    A_s, C_s, wall_s, stages_s = stream_ref
    gt = np.load(os.path.join(root, "ground_truth.npz"))
    f1 = detection_f1(st["A"][:n], np.asarray(gt["A"], np.float32))
    same_n = n == A_s.shape[0]
    err = (fit_errors(st["A"][:n], st["C"][:n], A_s, C_s) if same_n
           else dict(A=np.inf, C=np.inf, corr=0.0))
    bar = {k: max(STREAM_BARS[k], 8 * reorder[k]) for k in STREAM_BARS}
    print(f"phase 10b: fit_streaming {shape} on the 2 x 2 gloo mesh, "
          f"n_outer=1: n_active {n} (phase 6: "
          f"{A_s.shape[0]}), F1 {f1['f1']:.4f} (precision "
          f"{f1['precision']:.4f}, recall {f1['recall']:.4f}); against phase "
          f"6's state A max abs / scale {err['A']:.3e}, C {err['C']:.3e}, "
          f"least footprint and trace correlation {err['corr']:.6f} (>= "
          f"0.999); the one-process fit with {REORDER_CHUNK >> 20} MB chunks "
          f"(its sums in another order) against phase 6's: A "
          f"{reorder['A']:.3e}, C {reorder['C']:.3e}, correlation "
          f"{reorder['corr']:.6f}; bars A {bar['A']:.3e}, C {bar['C']:.3e}; "
          f"wall per rank {[round(i['wall'], 3) for i in infos]} s "
          f"(phase 6, one process: {wall_s:.3f} s); {ranks_line(infos)}",
          flush=True)
    for rank, info in enumerate(infos):
        stages = {k: round(v, 4) for k, v in info["stages"].items()}
        print(f"phase 10b: rank {rank} stage seconds {json.dumps(stages)}, "
              f"peak memory {info['peak'] / 2**30:.3f} GiB", flush=True)
    print(f"phase 10b: phase 6's stage seconds {json.dumps(stages_s)}",
          flush=True)
    split = [[round(i["stages"].get(k, 0.0), 4) for k in PICKLED_QC]
             for i in infos]
    print(f"phase 10b: init, qc_merge and tags on the mesh by rank (s): "
          f"{split}; rank 0's when the init ran there and the state was "
          f"pickled to it and back around the QC and the tags (PERF.md "
          f"section 5): {list(PICKLED_QC.values())}; object "
          f"collectives called per rank {[i['broadcasts'] for i in infos]}",
          flush=True)
    require(all(i["broadcasts"] == 0 for i in infos),
            "mesh streaming: a pickled state was sent")
    require(f1["f1"] >= 0.9, f"mesh streaming F1 {f1['f1']:.4f} < 0.9")
    require(same_n, f"mesh streaming n_active {n} != phase 6's "
            f"{A_s.shape[0]}")
    require(err["corr"] >= 0.999 and all(err[k] <= bar[k] for k in bar),
            f"mesh streaming differs from phase 6: {err}, bars {bar}")
    per_path["mesh_stream"] = summed_launches(infos)

    # 10a': one NCCL rank, the mesh step against mesh=None
    t0 = time.perf_counter()
    one = launch.spawn(_selftest.card_step_identity, 1, 1, backend="nccl",
                       device="cuda", args=(y_path, d_path, H, W, T, RADIUS,
                                            chain, MESH_CASES),
                       timeout=MESH_TIMEOUT)[0]
    for name, _ in MESH_CASES:
        m, none = one[name]["mesh"], one[name]["none"]
        check_rank_path(m, PATH_EXACT, f"NCCL mesh step {name}")
        diff = {k: float(np.abs(m["state"][k] - none["state"][k]).max()
                         / max(float(np.abs(none["state"][k]).max()), 1e-30))
                for k in none["state"]}
        same = all(np.array_equal(m["state"][k], none["state"][k])
                   for k in none["state"])
        print(f"phase 10a': step {name} on a 1 x 1 NCCL mesh against "
              f"mesh=None, one process: bit-identical {same}, max abs "
              f"difference / scale {json.dumps(diff)}; wall {m['wall']:.4f} "
              f"s against {none['wall']:.4f} s, {m['comm']['calls']} "
              f"collectives, {m['comm']['seconds']:.4f} s in them (host "
              f"clock; NCCL queues them on the stream)", flush=True)
        require(same or max(diff.values()) <= 1e-6,
                f"NCCL mesh step {name} differs from mesh=None: {diff}")
        per_path[f"mesh_nccl_{name}"] = dict(m["launches"])
    print(f"phase 10a': spawn and both steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return per_path


# ------------------------------------------------------------------ #
# phase 11: the in-memory fit on the (patch, frame) mesh
# ------------------------------------------------------------------ #
FIT_CORR = 0.999            # tests/test_sharding.py's trace bar


def matched_corr(A, C, A_ref, C_ref) -> dict:
    """The least correlation of a footprint and of a trace with its
    counterpart, the neurons matched one to one by footprint."""
    pairs = match_by_footprint(A, A_ref)
    return dict(A=min(p[2] for p in pairs),
                C=min(float(np.corrcoef(C[i], C_ref[j])[0, 1])
                      for i, j, _ in pairs))


def fit_self_drift(Y, params, ref, n_outer=2, resume_from=None) -> dict:
    """How far a one-process fit (``ref``: A, C of its active neurons, and
    B, its low-rank background, where it has one) moves when Y moves by
    one ulp up and down (np.nextafter): one less the least matched
    footprint and trace correlation with ``ref``, the background's
    relative difference, and the neuron counts."""
    out = dict(A=0.0, C=0.0, n=[])
    for to in (np.inf, -np.inf):
        st = CNMFE(params, device=DEV).fit(torch.as_tensor(
            np.nextafter(Y, np.float32(to)), device=DEV), n_outer=n_outer,
            resume_from=resume_from)
        n = int(st.n_active())
        out["n"].append(n)
        c = matched_corr(st.A[:n].cpu().numpy(), st.C[:n].cpu().numpy(),
                         ref["A"], ref["C"])
        out = dict(out, A=max(out["A"], 1 - c["A"]),
                   C=max(out["C"], 1 - c["C"]))
        if "B" in ref:
            B = lowrank_B(state_to_numpy(st))
            out["B"] = max(out.get("B", 0.0), float(
                np.linalg.norm(B - ref["B"]) / np.linalg.norm(ref["B"])))
    return out


def lowrank_B(st: dict) -> np.ndarray:
    """The low-rank background f^T b + b0 (d, T) of a state's arrays."""
    b, f, b0 = (np.asarray(st[k], np.float64) for k in ("bg_b", "bg_f",
                                                       "b0"))
    return b.reshape(b.shape[0], -1).T @ f + b0.reshape(-1)[:, None]


def hold_to_one_process(what, st, ref, drift, gt, gate, bar_gate):
    """Print and require: ``st`` (full state arrays) against the one-
    process ``ref`` (A, C of its active neurons), with the bars
    min(0.999, 1 - 8 x drift); ``gate``: "f1" or "recall" against the
    planted neurons at ``bar_gate``. Returns the line's numbers."""
    n = int(st["active"].sum())
    A, C = st["A"][:n], st["C"][:n]
    finite = bool(np.isfinite(A).all() and np.isfinite(C).all())
    score = detection_f1(A, gt.A)
    corr = (matched_corr(A, C, ref["A"], ref["C"])
            if n == ref["A"].shape[0] else dict(A=0.0, C=0.0))
    bar = {k: min(FIT_CORR, 1 - 8 * drift[k]) for k in ("A", "C")}
    require(finite, f"{what}: non-finite values")
    require(n == ref["A"].shape[0], f"{what}: n_active {n} != one "
            f"process's {ref['A'].shape[0]}")
    require(score[gate] >= bar_gate, f"{what}: {gate} {score[gate]:.4f} "
            f"< {bar_gate}")
    require(all(corr[k] >= bar[k] for k in bar),
            f"{what} differs from one process: {corr}, bars {bar}")
    return dict(n=n, score=score, corr=corr, bar=bar)


def mesh_lines(what, infos, ref_wall, ref_peak, path):
    """Check each rank's counted run and print its wall, peak, launches
    and collectives by stage."""
    for rank, info in enumerate(infos):
        check_rank_path(info, path, f"{what} rank {rank}")
    require(all(i["broadcasts"] == 0 for i in infos),
            f"{what}: a pickled state was sent")
    require(all(np.array_equal(i["active"], infos[0]["active"])
                for i in infos), f"{what}: the ranks' active masks differ")
    print(f"phase {what}: wall per rank "
          f"{[round(i['wall'], 3) for i in infos]} s against one "
          f"process's {ref_wall:.3f} s; peak per rank "
          f"{[round(i['peak'] / 2**30, 3) for i in infos]} GiB against "
          f"{ref_peak / 2**30:.3f}; {ranks_line(infos)}", flush=True)
    for rank, info in enumerate(infos):
        stages = {k: round(v, 4) for k, v in info["stages"].items()}
        in_comm = {k: [b, round(sec, 4)]
                   for k, (b, sec) in info["stage_comm"].items()}
        print(f"phase {what}: rank {rank} stage seconds "
              f"{json.dumps(stages)}; per stage, bytes handed to "
              f"collectives and host seconds inside them "
              f"{json.dumps(in_comm)}; launches "
              f"{json.dumps(info['launches'])}", flush=True)


def check_identity(what: str, pair: dict, path: set,
                   fit: str = "CNMFE.fit") -> dict:
    """Print and require: a fit on a 1 x 1 NCCL mesh against mesh=None
    (``_selftest.card_fit_identity``'s pair, or another such pair of
    ``fit``), bit-identical or within 1e-6 of scale. Returns the mesh
    run's launches."""
    mm, none = pair["mesh"], pair["none"]
    check_rank_path(mm, path, f"{what} NCCL mesh fit")
    same = all(np.array_equal(mm["state"][k], none["state"][k])
               for k in none["state"])
    diff = {k: float(np.abs(mm["state"][k].astype(np.float64)
                            - none["state"][k]).max()
                     / max(float(np.abs(none["state"][k]).max()), 1e-30))
            for k in none["state"] if k != "active"}
    print(f"phase {what}: {fit} on a 1 x 1 NCCL mesh against mesh=None, "
          f"one process: bit-identical {same}, max abs difference / scale "
          f"{json.dumps(diff)}; wall {mm['wall']:.3f} s against "
          f"{none['wall']:.3f} s, {mm['comm']['calls']} collectives, "
          f"{mm['comm']['seconds']:.4f} s in them", flush=True)
    require(np.array_equal(mm["state"]["active"], none["state"]["active"])
            and (same or max(diff.values()) <= 1e-6),
            f"{what} NCCL mesh fit differs from mesh=None: {diff}")
    return dict(mm["launches"])


def phase11_fit_mesh(tmp: str, ref: dict):
    """CNMFE(mesh=...).fit of phase 4's movie and parameters on a 2 x 2
    mesh of gloo ranks sharing the card (11), then on a 1 x 1 NCCL mesh
    against mesh=None (11'). ``ref``: phase 4's (A, C, wall, peak).
    Returns the launches of each counted run, summed over its ranks."""
    gt, params = fit_problem()
    self_drift = fit_self_drift(gt.Y, params, ref)
    torch.cuda.empty_cache()
    y_path = os.path.join(tmp, "fit_Y.npy")
    warm_path = os.path.join(tmp, "fit_warm.npy")
    np.save(y_path, gt.Y)
    np.save(warm_path, simulate_movie(
        seed=3, H=64, W=64, T=2000, K=8, gSig=3.0, sn=0.1, bg_strength=1.0,
        min_dist=9.0, spike_rate=0.02).Y)
    pd = dataclasses.asdict(params)
    card = torch.cuda.get_device_name(0)
    per_path = {}

    # 11: the 2 x 2 gloo mesh against phase 4's one-process fit
    t0 = time.perf_counter()
    infos = launch.spawn(_selftest.card_fit, 2, 2, backend="gloo",
                         device="cuda", args=(y_path, warm_path, pd, 2),
                         timeout=MESH_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    mesh_lines("11", infos, ref["wall"], ref["peak"], PATH_EXACT)
    res = hold_to_one_process("11", infos[0]["state"], ref, self_drift, gt,
                              "f1", 0.8)
    print(f"phase 11: CNMFE(mesh=...).fit preset_1p 256x256x2000 K_max=192 "
          f"n_outer=2 on a 2 x 2 gloo mesh, 4 ranks on {card}, blocks "
          f"{[i['block'] for i in infos]}: n_active {res['n']} (phase 4: "
          f"{ref['A'].shape[0]}), F1 {res['score']['f1']:.4f} (precision "
          f"{res['score']['precision']:.4f}, recall "
          f"{res['score']['recall']:.4f}); against phase 4's state the "
          f"least matched footprint correlation {res['corr']['A']:.6f}, "
          f"trace {res['corr']['C']:.6f}; phase 4's one-ulp self-drift "
          f"{self_drift}; bars {res['bar']}; spawn and both fits "
          f"{spawn_s:.1f} s", flush=True)
    peaks = [round(i["peak"] / 2**30, 3) for i in infos]
    require(max(i["peak"] for i in infos) <= ref["peak"] / 2,
            f"a mesh rank's peak memory {peaks} GiB is over half of phase "
            f"4's {ref['peak'] / 2**30:.3f}")
    per_path["fit_mesh"] = summed_launches(infos)

    # 11': one NCCL rank, the mesh fit against mesh=None
    t0 = time.perf_counter()
    one = launch.spawn(_selftest.card_fit_identity, 1, 1, backend="nccl",
                       device="cuda", args=(y_path, warm_path, pd, 2),
                       timeout=MESH_TIMEOUT)[0]
    per_path["fit_mesh_nccl"] = check_identity("11'", one, PATH_EXACT)
    print(f"phase 11': spawn and the fits {time.perf_counter() - t0:.1f} s",
          flush=True)
    return per_path


# ------------------------------------------------------------------ #
# phase 12: every option and method of CNMFE on the mesh
# ------------------------------------------------------------------ #
def options_2p():
    """12b: ``preset_2p`` (the svd background of rank 3) with phase 7c's
    CLI flags (gSig 3, gSiz 13, 192 slots), hals_thresh and decorrelate."""
    return _selftest.with_fields(CNMFEParams.preset_2p(), {
        "init.gSig": 3.0, "init.max_neurons": 192,
        "spatial.algorithm": "hals_thresh", "temporal.decorrelate": True})


def options_12c():
    """12c's movie (128x128x1000) and its option sets, each on the 1p
    preset with 64 slots."""
    gt = simulate_movie(seed=17, H=128, W=128, T=1000, K=30, gSig=3.0,
                        sn=0.1, bg_strength=1.0, min_dist=9.0,
                        spike_rate=0.02)
    fields = _selftest.with_fields
    base = fields(CNMFEParams.preset_1p(), {
        "init.max_neurons": 64, "init.seeds_per_round": 32,
        "init.max_rounds": 6})
    runs = {"nmf_nnls_init": fields(base, {
                "background.model": "nmf", "background.rank": 3,
                "spatial.algorithm": "nnls", "init.ssub": 2, "init.tsub": 2,
                "init.nk": 3}),
            "lars": fields(base, {"spatial.algorithm": "lars"})}
    return gt, base, runs


def one_process(Y, params, n_outer):
    """A warm-up and a timed one-process fit on the card: (state, wall,
    peak)."""
    Yt = torch.as_tensor(Y, device=DEV)
    CNMFE(params, device=DEV).fit(Yt, n_outer=n_outer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    t0 = time.perf_counter()
    st = CNMFE(params, device=DEV).fit(Yt, n_outer=n_outer)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0, torch.cuda.max_memory_allocated(DEV)


def local_fit_bytes(H, W, T, radius, ssub, n_patch, n_frame) -> dict:
    """The bytes one rank hands to the collectives for the local
    background's weights, once a fit of them: the halo'd slab of all
    its frames and its event mask (one byte a sample) gathered over
    'frame', as ``fit_ring_weights_mesh`` does, against all-reducing
    every pixel's partial Gram and right-hand side (R x R + R floats)
    over 'frame'."""
    Hs, Ws = -(-H // ssub), -(-W // ssub)
    rs = max(int(round(radius / ssub)), 1)
    offs = ring_kernels.ring_offsets(rs)
    R, reach = offs.shape[0], int(np.abs(offs[:, 0]).max())
    rows, frames = Hs // n_patch, T // n_frame
    return dict(R=R, gather=frames * Ws * ((rows + 2 * reach) * 4 + rows),
                grams=rows * Ws * (R * R + R) * 4)


def phase12_options_mesh(local_ref):
    """Every option and method of ``CNMFE`` on a 2 x 2 gloo mesh sharing
    the card (12a-12c, one spawn), then 12a and 12b on a 1 x 1 NCCL mesh
    against mesh=None (12'). ``local_ref``: phase 9a's fit (A, C, wall,
    peak). Returns the launches of each counted run, summed over its
    ranks."""
    card = torch.cuda.get_device_name(0)
    gt_a, params_a = fit_problem()
    params_a = local_ellipse(params_a)
    gt_b, params_b = movie_2p(), options_2p()
    gt_c, base_c, runs_c = options_12c()
    t0 = time.perf_counter()
    drift_a = fit_self_drift(gt_a.Y, params_a, local_ref)
    st_b, wall_b, peak_b = one_process(gt_b.Y, params_b, 2)
    n_b = int(st_b.n_active())
    ref_b = dict(A=st_b.A[:n_b].cpu().numpy(), C=st_b.C[:n_b].cpu().numpy(),
                 B=lowrank_B(state_to_numpy(st_b)))
    drift_b = fit_self_drift(gt_b.Y, params_b, ref_b)
    refs_c = {}
    for name, p in runs_c.items():
        st, wall, peak = one_process(gt_c.Y, p, 1)
        n = int(st.n_active())
        refs_c[name] = dict(A=st.A[:n].cpu().numpy(),
                            C=st.C[:n].cpu().numpy(), wall=wall, peak=peak)
        refs_c[name]["drift"] = fit_self_drift(gt_c.Y, p, refs_c[name],
                                               n_outer=1)
    print(f"phase 12: one-process references and one-ulp drifts in "
          f"{time.perf_counter() - t0:.1f} s: 12a drift {drift_a}, 12b "
          f"wall {wall_b:.3f} s, n_active {n_b}, drift {drift_b}, 12c "
          f"{ {k: (round(v['wall'], 3), v['drift']) for k, v in refs_c.items()} }",
          flush=True)
    per_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_12_") as tmp:
        paths = {}
        for name, Y in (("a", gt_a.Y), ("b", gt_b.Y), ("c", gt_c.Y),
                        ("warm", simulate_movie(
                            seed=3, H=64, W=64, T=2000, K=8, gSig=3.0,
                            sn=0.1, bg_strength=1.0, min_dist=9.0,
                            spike_rate=0.02).Y)):
            paths[name] = os.path.join(tmp, f"movie_{name}.npy")
            np.save(paths[name], Y)
        log_dir = os.path.join(tmp, "runlog")
        os.makedirs(log_dir)
        pa, pb = dataclasses.asdict(params_a), dataclasses.asdict(params_b)
        jobs = [("a", "card_fit", (paths["a"], paths["warm"], pa, 2)),
                ("b", "card_fit", (paths["b"], paths["warm"], pb, 2))]
        jobs += [(f"c_{name}", "card_fit", (paths["c"], None,
                                            dataclasses.asdict(p), 1))
                 for name, p in runs_c.items()]
        jobs.append(("c_methods", "card_methods",
                     (paths["c"], dataclasses.asdict(base_c), 1, log_dir)))
        t0 = time.perf_counter()
        out = launch.spawn(_selftest.cases, 2, 2, backend="gloo",
                           device="cuda", args=(jobs,),
                           timeout=MESH_TIMEOUT)
        spawn_s = time.perf_counter() - t0

        # 12a: phase 9a's local + ellipse fit
        infos = [o["a"] for o in out]
        mesh_lines("12a", infos, local_ref["wall"], local_ref["peak"],
                   PATH_EXACT)
        res = hold_to_one_process("12a", infos[0]["state"], local_ref,
                                  drift_a, gt_a, "f1", 0.8)
        nb = local_fit_bytes(256, 256, 2000, params_a.background.ring_radius,
                             params_a.background.ssub, 2, 2)
        print(f"phase 12a: CNMFE(mesh=...).fit preset_1p, local "
              f"background, ellipse search, 256x256x2000 K_max=192 "
              f"n_outer=2 on a 2 x 2 gloo mesh on {card}: n_active "
              f"{res['n']} (phase 9a: {local_ref['A'].shape[0]}), F1 "
              f"{res['score']['f1']:.4f}; least matched footprint "
              f"correlation {res['corr']['A']:.6f}, trace "
              f"{res['corr']['C']:.6f}; bars {res['bar']}; phase 9a's "
              f"one-ulp self-drift {drift_a}; the local weights' exchange "
              f"a rank and fit (R = {nb['R']}): frames gathered "
              f"{nb['gather']} B, per-pixel Grams all-reduced would be "
              f"{nb['grams']} B", flush=True)
        per_path["options_local_ellipse_mesh"] = summed_launches(infos)

        # 12b: preset_2p with hals_thresh and decorrelate
        infos = [o["b"] for o in out]
        mesh_lines("12b", infos, wall_b, peak_b, PATH_2P)
        require(all(i["launches"]["ring_stencil"] == 0 for i in infos),
                "12b launched the ring kernel")
        res = hold_to_one_process("12b", infos[0]["state"], ref_b, drift_b,
                                  gt_b, "recall", 0.75)
        B = lowrank_B(infos[0]["state"])
        b_err = float(np.linalg.norm(B - ref_b["B"])
                      / np.linalg.norm(ref_b["B"]))
        b_bar = 8 * max(drift_b["B"], 1e-6)
        print(f"phase 12b: CNMFE(mesh=...).fit preset_2p (svd rank 3, "
              f"hals_thresh, decorrelate) 256x256x2000 K_max=192 n_outer=2 "
              f"on a 2 x 2 gloo mesh on {card}: n_active {res['n']} (one "
              f"process: {n_b}), recall {res['score']['recall']:.4f}, F1 "
              f"{res['score']['f1']:.4f}; least matched footprint "
              f"correlation {res['corr']['A']:.6f}, trace "
              f"{res['corr']['C']:.6f}; bars {res['bar']}; background "
              f"f^T b + b0 relative difference {b_err:.3e} (bar {b_bar:.3e}"
              f", 8x the one-process fit's own)", flush=True)
        require(b_err <= b_bar, f"12b background differs: {b_err:.3e} > "
                f"{b_bar:.3e}")
        per_path["options_2p_mesh"] = summed_launches(infos)

        # 12c: the other options, the methods, run_log and resume_from
        for name, p in runs_c.items():
            infos = [o[f"c_{name}"] for o in out]
            ref = refs_c[name]
            path = PATH_2P if p.background.model == "nmf" else PATH_EXACT
            mesh_lines(f"12c {name}", infos, ref["wall"], ref["peak"], path)
            res = hold_to_one_process(f"12c {name}", infos[0]["state"], ref,
                                      ref["drift"], gt_c, "f1", 0.8)
            print(f"phase 12c {name}: 128x128x1000 K_max=64 n_outer=1: "
                  f"n_active {res['n']}, F1 {res['score']['f1']:.4f}; "
                  f"least matched footprint correlation "
                  f"{res['corr']['A']:.6f}, trace {res['corr']['C']:.6f}; "
                  f"bars {res['bar']}", flush=True)
            per_path[f"options_{name}_mesh"] = summed_launches(infos)
        m = out[0]["c_methods"]
        require(all(o["c_methods"]["broadcasts"] == 0 for o in out),
                "12c methods: a pickled state was sent")
        require([s.split("_")[2] for s in m["snaps"]] == ["init", "final"],
                f"12c run log snapshots {m['snaps']}")
        st_r = CNMFE(base_c, device=DEV).fit(gt_c.Y, n_outer=1,
                                             resume_from=m["snap"])
        n = int(st_r.n_active())
        ref_r = dict(A=st_r.A[:n].cpu().numpy(), C=st_r.C[:n].cpu().numpy())
        drift_r = fit_self_drift(gt_c.Y, base_c, ref_r, n_outer=1,
                                 resume_from=m["snap"])
        res = hold_to_one_process("12c resume_from", m["resumed"], ref_r,
                                  drift_r, gt_c, "f1", 0.8)
        errs = {k: float(f"{v:.3e}") for k, v in m["errors"].items()}
        print(f"phase 12c: run log snapshots {m['snaps']} (rank 0); "
              f"resumed from the init snapshot: n_active {res['n']}, least "
              f"matched footprint correlation {res['corr']['A']:.6f}, trace "
              f"{res['corr']['C']:.6f}, bars {res['bar']}; the methods on "
              f"each rank's block against one process on the whole movie, "
              f"largest difference over the mesh / scale {json.dumps(errs)}",
              flush=True)
        require(max(errs.values()) <= 1e-4,
                f"12c methods differ from one process: {errs}")
        print(f"phase 12: spawn and its fits {spawn_s:.1f} s", flush=True)

        # 12': one NCCL rank, 12a and 12b against mesh=None
        t0 = time.perf_counter()
        one = launch.spawn(_selftest.cases, 1, 1, backend="nccl",
                           device="cuda", args=([
                               ("a", "card_fit_identity",
                                (paths["a"], paths["warm"], pa, 2)),
                               ("b", "card_fit_identity",
                                (paths["b"], paths["warm"], pb, 2))],),
                           timeout=MESH_TIMEOUT)[0]
        for what, path in (("a", PATH_EXACT), ("b", PATH_2P)):
            per_path[f"options_{what}_mesh_nccl"] = check_identity(
                f"12{what}'", one[what], path)
        print(f"phase 12': spawn and the fits {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
    return per_path


# ------------------------------------------------------------------ #
# phase 13: batch mode on the (patch, frame) mesh
# ------------------------------------------------------------------ #
def active_rows(st: dict) -> dict:
    """A state's arrays with A and C cut to its active slots, in order
    (``fit_batches`` does not compact its final state)."""
    act = st["active"]
    return dict(A=st["A"][act], C=st["C"][act],
                active=np.ones(int(act.sum()), bool))


def batch_self_drift(batches, params, ref) -> dict:
    """How far phase 6b's fit_batches moves when Y moves by one ulp up and
    down (np.nextafter): one less the least matched footprint and trace
    correlation with ``ref``, and the neuron counts (fit_self_drift's
    measure)."""
    out = dict(A=0.0, C=0.0, n=[])
    for to in (np.inf, -np.inf):
        st, _ = fit_batches([np.nextafter(Yb, np.float32(to))
                             for Yb in batches], params, device=DEV)
        rows = active_rows(state_to_numpy(st))
        out["n"].append(rows["A"].shape[0])
        c = matched_corr(rows["A"], rows["C"], ref["A"], ref["C"])
        out = dict(out, A=max(out["A"], 1 - c["A"]),
                   C=max(out["C"], 1 - c["C"]))
    return out


def phase13_batch_mesh(tmp: str, ref: dict):
    """fit_batches(mesh=...) of phase 6b's problem on a 2 x 2 mesh of gloo
    ranks sharing the card (13), then on a 1 x 1 NCCL mesh against
    mesh=None (13'). ``ref``: phase 6b's. Returns the launches of each
    counted run, summed over its ranks."""
    gt, params = fit_problem(T=BATCH_T)
    self_drift = batch_self_drift(np.split(gt.Y, N_BATCHES), params, ref)
    torch.cuda.empty_cache()
    y_path = os.path.join(tmp, "batch_Y.npy")
    warm_path = os.path.join(tmp, "batch_warm.npy")
    np.save(y_path, gt.Y)
    np.save(warm_path, simulate_movie(
        seed=3, H=64, W=64, T=1200, K=8, gSig=3.0, sn=0.1, bg_strength=1.0,
        min_dist=9.0, spike_rate=0.02).Y)
    pd = dataclasses.asdict(params)
    card = torch.cuda.get_device_name(0)
    per_path = {}

    # 13: the 2 x 2 gloo mesh against phase 6b's one-process run
    t0 = time.perf_counter()
    infos = launch.spawn(_selftest.card_batch, 2, 2, backend="gloo",
                         device="cuda",
                         args=(y_path, warm_path, pd, N_BATCHES),
                         timeout=MESH_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    mesh_lines("13", infos, ref["wall"], ref["peak"], PATH_EXACT)
    same = all(i["digest"] == infos[0]["digest"] for i in infos)
    counts = [i["per_batch"] for i in infos]
    res = hold_to_one_process("13", active_rows(infos[0]["state"]), ref,
                              self_drift, gt, "f1", 0.8)
    print(f"phase 13: fit_batches(mesh=...) preset_1p "
          f"256x256x{BATCH_T} in {N_BATCHES} batches, K_max=192, on a "
          f"2 x 2 gloo mesh, 4 ranks on {card}, blocks "
          f"{[i['block'] for i in infos]}: n_active {res['n']} (6b: "
          f"{ref['A'].shape[0]}), per batch {counts} (6b: "
          f"{ref['per_batch']}), F1 {res['score']['f1']:.4f} (precision "
          f"{res['score']['precision']:.4f}, recall "
          f"{res['score']['recall']:.4f}); against 6b's state the least "
          f"matched footprint correlation {res['corr']['A']:.6f}, trace "
          f"{res['corr']['C']:.6f}; 6b's one-ulp self-drift {self_drift}; "
          f"bars {res['bar']}; every rank's state bit-identical {same}; "
          f"spawn and both runs {spawn_s:.1f} s", flush=True)
    print(f"phase 13: phase 6b's stage seconds (one process) "
          f"{json.dumps({k: round(v, 4) for k, v in ref['stages'].items()})}",
          flush=True)
    require(same, "13: the ranks' states differ")
    require(all(c == ref["per_batch"] for c in counts),
            f"13: per-batch counts {counts} != 6b's {ref['per_batch']}")
    per_path["batch_mesh"] = summed_launches(infos)

    # 13': one NCCL rank, the mesh run against mesh=None
    t0 = time.perf_counter()
    one = launch.spawn(_selftest.card_batch_identity, 1, 1, backend="nccl",
                       device="cuda",
                       args=(y_path, warm_path, pd, N_BATCHES),
                       timeout=MESH_TIMEOUT)[0]
    per_path["batch_mesh_nccl"] = check_identity("13'", one, PATH_EXACT,
                                                  "fit_batches")
    require(one["mesh"]["per_batch"] == one["none"]["per_batch"],
            f"13': per-batch counts {one['mesh']['per_batch']} != "
            f"{one['none']['per_batch']}")
    print(f"phase 13': spawn and the runs {time.perf_counter() - t0:.1f} s",
          flush=True)
    return per_path


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}; nvidia-smi name, power limit:",
          flush=True)
    print(smi[0] if smi else "", flush=True)

    t0 = time.perf_counter()
    cuda_build.load_library()
    print(f"phase 1: built and loaded the CUDA kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in cuda_build.build_info.get("log", "").splitlines():
        if ("registers" in line or "spill" in line
                or "Function properties" in line):
            print(f"phase 1: ptxas {line.strip()}")

    t0 = time.perf_counter()
    results = phase2_kernels()
    results.update(phase2_ring())
    fit_grid = phase2_ring_fit_grid()
    results["ring_stencil"]["max_abs_err"] = max(
        results["ring_stencil"]["max_abs_err"], fit_grid["max_abs_err"])
    results["ring_stencil"]["bit_identical"] &= fit_grid["bit_identical"]
    results["ring_stencil"]["stream_block"] = phase2_ring_stream_block()
    print(f"phase seconds: 2 {time.perf_counter() - t0:.1f}", flush=True)
    t0 = time.perf_counter()
    phase3_consistency()
    print(f"phase seconds: 3 {time.perf_counter() - t0:.1f}", flush=True)
    seconds = {}

    def timed_phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t, 1)
        print(f"phase seconds: {name} {seconds[name]}", flush=True)
        return out

    per_path = {}
    per_path["fit"], fit_ref = timed_phase("4", phase4_full)
    step_paths, step_outs, step_ms = timed_phase("5", phase5_step)
    per_path.update(step_paths)
    timed_phase("5b", phase5b_consistency)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        per_path["stream"], stream_ref = timed_phase("6", phase6_stream, tmp)
        per_path["batch"], batch_ref = timed_phase("6b", phase6b_batches)
        timed_phase("6c", phase6c_stream_consistency, tmp)
        per_path.update(timed_phase("7", phase7_cli, tmp))
        per_path.update(timed_phase("10", phase10_mesh, tmp, step_outs,
                                    step_ms, stream_ref))
        per_path.update(timed_phase("11", phase11_fit_mesh, tmp, fit_ref))
        per_path.update(timed_phase("13", phase13_batch_mesh, tmp,
                                    batch_ref))
    per_path.update(timed_phase("8", phase8_2p))
    per_path["local_ellipse"], local_ref = timed_phase("9", phase9_local)
    per_path.update(timed_phase("12", phase12_options_mesh, local_ref))
    print(f"phase seconds: {json.dumps(seconds)}", flush=True)

    # launches: the sum over the main-path runs of phases 4 to 13 (phases
    # 10 to 13 summed over their ranks)
    launches = {k: sum(p[k] for p in per_path.values())
                for k in cuda_build.KERNELS}
    print(f"launches per main-path run: {json.dumps(per_path)}", flush=True)
    kernels = [{"name": name, "route": "cuda", "source": KERNEL_META[name][0],
                "replaces": KERNEL_META[name][1], "launches": launches[name],
                **results[name]}
               for name in cuda_build.KERNELS]
    # the stencil's times above are at the step's 256x256 grid; the fit
    # runs it on the coarse grid
    kernels[cuda_build.KERNELS.index("ring_stencil")]["fit_grid"] = fit_grid
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
