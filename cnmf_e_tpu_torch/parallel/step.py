"""The chained model-update step (port of ``cnmf_e_tpu/parallel/step.py``,
one device).

One background refresh, then ``chain`` CNMF-E iterations against that
frozen background:

  * :func:`make_bg_projection` evaluates Ysig = Y - B once, with
    B = W(Y - b0 - A C) + w0 + b0 frozen at the state passed in — the
    reference's A_prev/C_prev snapshot (``update_background_parallel.m:
    311-317``). The ring apply is the f32 stencil kernel K6, or with
    ``mxu=True`` the banded bf16 product K5;
  * :func:`make_hals_iteration` runs spatial HALS, temporal HALS, the
    sub-median baseline and OASIS on Ysig, ``chain`` times, touching no
    ring machinery;
  * :func:`make_update_step` chains the two.

The ``make_*`` functions return plain functions (closures) in place of
the JAX package's jitted programs, and the chain is a Python loop in place
of ``fori_loop``/``cond``. Not ported: the ``dots`` precision modes.

On a :class:`~cnmf_e_tpu_torch.parallel.mesh.Mesh` every rank runs the
same code on its blocks (``parallel/mesh.py``'s layout: Y and the ring
weights split over 'patch' rows and 'frame', C over 'frame') with the
collectives GSPMD inserts in the JAX package written out
(``parallel/comm.py``; they are the identity without a mesh):

  * projection: the ring apply takes its halo rows from the patch
    neighbours (``ops/ring.py::apply_ring``);
  * spatial: C's mean, V = Cc Cc^T and U = Cc Ysig summed over 'frame',
    then K1 on the rank's pixels (the spatial update is independent per
    pixel);
  * temporal: Vt = A A^T and Ut = A Ysig^T summed over 'patch', then K1 on
    the rank's frames (independent per frame);
  * baseline, noise and OASIS on whole traces: each patch rank gathers
    its K/n_patch rows over 'frame', and the results go back to the
    frame slabs over 'patch' (``comm.traces_to_neurons`` / ``_frames``);
  * the coloured step dilates the footprints with a halo and sums the
    overlap counts over 'patch', so every rank colours the same graph.

K, H and T must divide over their axes (a ValueError names the one that
does not), and ``mxu=True`` takes no mesh, as in the JAX package, whose
banded MXU stencil runs on one device only (``step.py:74-79``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops.coloring import (class_step_schedule, greedy_color,
                                           overlap_adjacency)
from cnmf_e_tpu_torch.ops.hals import (hals_spatial_sweeps_rows,
                                       hals_temporal_sweeps)
from cnmf_e_tpu_torch.ops.morphology import search_locations_dilate
from cnmf_e_tpu_torch.ops.noise import noise_psd
from cnmf_e_tpu_torch.ops.oasis import foopsi_ar1
from cnmf_e_tpu_torch.ops.ring import apply_ring
from cnmf_e_tpu_torch.ops.ring_kernels import (apply_ring_mxu_flat,
                                               ring_dense_bands)
from cnmf_e_tpu_torch.ops.stats import submedian_mean
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.mesh import check_divisible


@dataclass
class StepState:
    """Tensors carried through one model-update iteration."""
    A: torch.Tensor        # (K, H, W)
    C: torch.Tensor        # (K, T)
    C_raw: torch.Tensor    # (K, T)
    S: torch.Tensor        # (K, T)
    g: torch.Tensor        # (K,) AR(1) coefficient per neuron
    b0: torch.Tensor       # (H, W)
    ring_w: torch.Tensor   # (H*W, R)
    ring_w0: torch.Tensor  # (H*W,)

    def replace(self, **kw) -> "StepState":
        return dataclasses.replace(self, **kw)


def _check_mesh(mesh, H: int, T: int, mxu: Optional[bool]) -> None:
    check_divisible(mesh, H=H, T=T)
    if mesh is not None and mxu:
        raise ValueError("mxu=True runs the banded stencil on one device; "
                         "a mesh takes the exact stencil (mxu=None)")


def make_bg_projection(mesh, H: int, W: int, T: int, radius: int,
                       mxu: Optional[bool] = None,
                       gram_dtype: Optional[str] = None):
    """Build ``proj(Y, state) -> Ysig``, the background-subtracted movie
    (T, H, W) with B frozen at ``state``.

    ``mxu``: None or False runs the exact f32 stencil (K6); True builds the
    bf16 bands and runs the banded product (K5), about 1e-3 relative error
    on B. ``gram_dtype``: None or "float32" keeps Ysig in f32;
    "bfloat16" stores it in bf16 (the HALS Grams then take its bf16 values
    upcast to f32). ``mesh``: Y and the state are this rank's blocks."""
    _check_mesh(mesh, H, T, mxu)
    if gram_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"gram_dtype {gram_dtype!r}")
    p_dtype = torch.bfloat16 if gram_dtype == "bfloat16" else torch.float32

    def proj(Y: torch.Tensor, st: StepState) -> torch.Tensor:
        K = st.A.shape[0]
        Q = Y - st.b0[None]
        X = Q - (st.C.T @ st.A.reshape(K, -1)).reshape(Y.shape)
        weights = RingWeights(w=st.ring_w, w0=st.ring_w0)
        if mxu:
            bands = ring_dense_bands(weights, H, W, radius)
            WX = apply_ring_mxu_flat(bands, st.ring_w0, X, H, W, radius)
        else:                                               # W(X) + w0
            WX = apply_ring(weights, X, H, W, radius, mesh=mesh)
        return (Q - WX).to(p_dtype)

    return proj


def make_hals_iteration(mesh, H: int, W: int, T: int, radius: int,
                        n_hals: int = 2,
                        deconv: Optional[DeconvParams] = None,
                        smin: float = -3.0, mxu: Optional[bool] = None,
                        chain: int = 1, deconv_every: int = 1,
                        colored: bool = False, mask_dilate: int = 2,
                        color_block: int = 64):
    """Build ``iterate(Ysig, state) -> state``: ``chain`` iterations of
    spatial HALS, temporal HALS, baseline removal and AR(1) deconvolution
    against the frozen Ysig from :func:`make_bg_projection`.

    ``deconv_every``: deconvolve only at iterations i with
    (i + 1) % deconv_every == 0, and at the last; the others carry
    C = max(C_raw, 0) and the previous S (``HALS_temporal.m:66-68``).
    ``smin < 0`` means |smin| times each trace's noise level.

    ``colored``: search-location masks (the footprint supports dilated by
    ``mask_dilate``) on the spatial factor, and one greedy colouring of
    their overlap graph (``update_order.m:1-21``) that orders the neurons
    and schedules both factors' sweeps, ``color_block`` rows a step. The
    masks and the colouring are frozen for the call (one host colouring
    per call); the returned state is in the caller's neuron order.
    Otherwise the sweeps run in neuron order, 16 rows a step, unmasked.
    ``deconv`` is accepted for the JAX signature and unused. ``mesh``:
    Ysig and the state are this rank's blocks.
    """
    _check_mesh(mesh, H, T, mxu)

    def one_iteration(Ysig, st: StepState, do_deconv: bool, mask, sched
                      ) -> StepState:
        K = st.A.shape[0]
        Pf = Ysig.reshape(Ysig.shape[0], -1)                 # (T, d) local
        if Pf.dtype == torch.bfloat16:
            # bf16 operands, f32 products: round to bf16, compute in f32
            Pg = Pf.to(torch.float32)
            to_gram = lambda x: x.to(torch.bfloat16).to(torch.float32)
        else:
            Pg = Pf
            to_gram = lambda x: x
        block = color_block if sched is not None else 16

        # spatial: U = Ysig Cc^T with the uncentred Ysig — its mean term
        # vanishes against the centred Cc (HALS_spatial.m:28-32)
        Cc = st.C - comm.psum(st.C.sum(dim=1, keepdim=True), mesh,
                              "frame") / T
        V = comm.psum(Cc @ Cc.T, mesh, "frame")
        U = comm.psum(to_gram(Cc) @ Pg, mesh, "frame")        # (K, d)
        Ar = hals_spatial_sweeps_rows(U, V, st.A.reshape(K, -1), mask=mask,
                                      n_iter=n_hals, block=block,
                                      schedule=sched)

        # temporal: the mask-overlap schedule certifies Vt's zeros too
        Vt = comm.psum(Ar @ Ar.T, mesh, "patch")
        Ut = comm.psum(to_gram(Ar) @ Pg.T, mesh, "patch")     # (K, T)
        C_raw = hals_temporal_sweeps(Ut, Vt, st.C, n_iter=n_hals,
                                     schedule=sched, block=block)

        # baseline and deconvolution on whole traces: this patch rank's
        # K / n_patch of them under a mesh
        rows = comm.traces_to_neurons(C_raw, mesh)
        base = submedian_mean(rows, dim=-1)
        if do_deconv:
            rows = rows - base[:, None]
            k0, k1 = (0, K) if mesh is None else mesh.neurons(K)
            res = foopsi_ar1(rows, st.g[k0:k1], smin=smin,
                             sn=noise_psd(rows), optimize_b=False)
            C = comm.traces_to_frames(res.c, T, mesh)
            S = comm.traces_to_frames(res.s, T, mesh)
        if mesh is not None:
            base = comm.all_gather_cat(base, 0, mesh.patch_group)
        C_raw = C_raw - base[:, None]
        if not do_deconv:
            C, S = torch.clamp(C_raw, min=0.0), st.S
        return st.replace(A=Ar.reshape(st.A.shape), C=C, C_raw=C_raw, S=S)

    def run_chain(Ysig, st: StepState, mask=None, sched=None) -> StepState:
        for i in range(chain):
            do_deconv = (deconv_every <= 1 or (i + 1) % deconv_every == 0
                         or i == chain - 1)
            st = one_iteration(Ysig, st, do_deconv, mask, sched)
        return st

    def iterate(Ysig: torch.Tensor, st: StepState) -> StepState:
        K = st.A.shape[0]
        check_divisible(mesh, K=K)
        if not colored:
            return run_chain(Ysig, st)
        M = search_locations_dilate(st.A, radius=mask_dilate,
                                    mesh=mesh).reshape(K, -1)
        colors = greedy_color(overlap_adjacency(M, mesh))
        order = torch.argsort(colors, stable=True)
        inverse = torch.argsort(order)
        sched = class_step_schedule(colors[order], block=color_block)
        perm = st.replace(A=st.A[order], C=st.C[order],
                          C_raw=st.C_raw[order], S=st.S[order],
                          g=st.g[order])
        out = run_chain(Ysig, perm, mask=M[order], sched=sched)
        return out.replace(A=out.A[inverse], C=out.C[inverse],
                           C_raw=out.C_raw[inverse], S=out.S[inverse],
                           g=st.g)

    return iterate


def make_update_step(mesh, H: int, W: int, T: int, radius: int,
                     n_hals: int = 2, deconv: Optional[DeconvParams] = None,
                     smin: float = -3.0, mxu: Optional[bool] = None,
                     gram_dtype: Optional[str] = None, chain: int = 1,
                     deconv_every: int = 1, colored: bool = False,
                     mask_dilate: int = 2, color_block: int = 64):
    """Build ``step(Y, state) -> state``: one background projection, then
    ``chain`` iterations against it (``demo_large_data_1p.m:199-213``:
    the background once, then spatial/temporal updates against the fixed
    B). Arguments as :func:`make_bg_projection` and
    :func:`make_hals_iteration`; under a ``mesh``, ``H`` and ``T`` are the
    full movie's and ``step`` takes and returns this rank's blocks
    (``convert.shard_step_state`` / ``gather_step_state``)."""
    proj = make_bg_projection(mesh, H, W, T, radius, mxu=mxu,
                              gram_dtype=gram_dtype)
    iterate = make_hals_iteration(mesh, H, W, T, radius, n_hals=n_hals,
                                  deconv=deconv, smin=smin, mxu=mxu,
                                  chain=chain, deconv_every=deconv_every,
                                  colored=colored, mask_dilate=mask_dilate,
                                  color_block=color_block)

    def step(Y: torch.Tensor, st: StepState) -> StepState:
        return iterate(proj(Y, st), st)

    return step
