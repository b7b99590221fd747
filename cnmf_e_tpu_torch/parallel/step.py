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
of ``fori_loop``/``cond``. Not ported: the ``mesh`` (multi-device) branch,
which raises ``NotImplementedError``, and the ``dots`` precision modes.
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


def _single_device(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the multi-device (mesh) step is not "
                                  "ported yet; pass mesh=None")


def make_bg_projection(mesh, H: int, W: int, T: int, radius: int,
                       mxu: Optional[bool] = None,
                       gram_dtype: Optional[str] = None):
    """Build ``proj(Y, state) -> Ysig``, the background-subtracted movie
    (T, H, W) with B frozen at ``state``.

    ``mxu``: None or False runs the exact f32 stencil (K6); True builds the
    bf16 bands and runs the banded product (K5), about 1e-3 relative error
    on B. ``gram_dtype``: None or "float32" keeps Ysig in f32;
    "bfloat16" stores it in bf16 (the HALS Grams then take its bf16 values
    upcast to f32)."""
    _single_device(mesh)
    if gram_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"gram_dtype {gram_dtype!r}")
    p_dtype = torch.bfloat16 if gram_dtype == "bfloat16" else torch.float32

    def proj(Y: torch.Tensor, st: StepState) -> torch.Tensor:
        K = st.A.shape[0]
        Q = Y - st.b0[None]
        X = Q - (st.C.T @ st.A.reshape(K, H * W)).reshape(T, H, W)
        weights = RingWeights(w=st.ring_w, w0=st.ring_w0)
        if mxu:
            bands = ring_dense_bands(weights, H, W, radius)
            WX = apply_ring_mxu_flat(bands, st.ring_w0, X, H, W, radius)
        else:
            WX = apply_ring(weights, X, H, W, radius)        # W(X) + w0
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
    ``deconv`` and ``mxu`` are accepted for the JAX signature and unused.
    """
    _single_device(mesh)
    d = H * W

    def one_iteration(Ysig, st: StepState, do_deconv: bool, mask, sched
                      ) -> StepState:
        K = st.A.shape[0]
        Pf = Ysig.reshape(T, d)
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
        Cc = st.C - st.C.mean(dim=1, keepdim=True)
        V = Cc @ Cc.T
        U = to_gram(Cc) @ Pg                                  # (K, d)
        Ar = hals_spatial_sweeps_rows(U, V, st.A.reshape(K, d), mask=mask,
                                      n_iter=n_hals, block=block,
                                      schedule=sched)

        # temporal: the mask-overlap schedule certifies Vt's zeros too
        Vt = Ar @ Ar.T
        Ut = to_gram(Ar) @ Pg.T                               # (K, T)
        C_raw = hals_temporal_sweeps(Ut, Vt, st.C, n_iter=n_hals,
                                     schedule=sched, block=block)
        C_raw = C_raw - submedian_mean(C_raw, dim=-1)[:, None]

        if do_deconv:
            res = foopsi_ar1(C_raw, st.g, smin=smin, sn=noise_psd(C_raw),
                             optimize_b=False)
            C, S = res.c, res.s
        else:
            C, S = torch.clamp(C_raw, min=0.0), st.S
        return st.replace(A=Ar.reshape(K, H, W), C=C, C_raw=C_raw, S=S)

    def run_chain(Ysig, st: StepState, mask=None, sched=None) -> StepState:
        for i in range(chain):
            do_deconv = (deconv_every <= 1 or (i + 1) % deconv_every == 0
                         or i == chain - 1)
            st = one_iteration(Ysig, st, do_deconv, mask, sched)
        return st

    def iterate(Ysig: torch.Tensor, st: StepState) -> StepState:
        if not colored:
            return run_chain(Ysig, st)
        K = st.A.shape[0]
        M = search_locations_dilate(st.A, radius=mask_dilate).reshape(K, d)
        colors = greedy_color(overlap_adjacency(M))
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
    :func:`make_hals_iteration`."""
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
