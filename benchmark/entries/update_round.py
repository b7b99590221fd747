"""The system under test: one model-update round of ``cnmf_e_tpu_torch``,
as ``models/pipeline.py::CNMFE.fit`` runs it (refit the background,
subtract it, update the footprints, then the traces)."""

from __future__ import annotations

import contextlib
import json
from types import SimpleNamespace

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.background import (subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState, RingWeights
from cnmf_e_tpu_torch.models.temporal import update_temporal

STAGES = ("background", "spatial", "temporal")


def params(config: dict) -> CNMFEParams:
    """The preset that the configuration names, which has to be what the
    configuration's file states, key for key."""
    p = getattr(CNMFEParams, config["preset"])()
    if json.loads(p.to_json()) != config["params"]:
        raise ValueError(f"{config['name']}: the file's params are not "
                         f"CNMFEParams.{config['preset']}()")
    return p


def start_state(start: dict, p: CNMFEParams) -> CNMFEState:
    """The port's state for the benchmark's start state."""
    A, C, active = start["A"], start["C"], start["active"]
    K, T = C.shape
    f32 = dict(dtype=torch.float32, device=A.device)
    W = None
    if "w_old" in start:
        W = RingWeights(w=start["w_old"], w0=start["w0_old"])
    return CNMFEState(
        A=A, C=C, C_raw=C, S=torch.zeros((K, T), **f32), active=active,
        g=torch.full((K, 1), 0.9, **f32), neuron_sn=torch.zeros(K, **f32),
        b0=torch.zeros(A.shape[1:], **f32), W=W,
        tags=torch.zeros(K, dtype=torch.int32, device=A.device))


def round_(Y: torch.Tensor, st: CNMFEState, p: CNMFEParams,
           sn_pix: torch.Tensor, stage=None) -> CNMFEState:
    """``pipeline.py:229-236``. ``stage(name)``: a context around each
    layer's calls (the background's two, the spatial, the temporal)."""
    stage = stage or (lambda name: contextlib.nullcontext())
    with stage("background"):
        st = update_background(Y, st, p, sn_pix=sn_pix)
        Ysig = subtract_background(Y, st, p)
    with stage("spatial"):
        st = update_spatial(Ysig, st, p, sn_pix=sn_pix)
    with stage("temporal"):
        st = update_temporal(Ysig, st, p)
    return st


def outputs(st: CNMFEState, rows: np.ndarray) -> dict:
    """What the check judges, as the reference returns it: the
    background's outputs, every footprint, and the traces ``rows`` (on
    the host)."""
    if st.W is not None:
        out = {"w": st.W.w, "w0": st.W.w0, "b0": st.b0}
    else:
        out = {"b": st.b, "f": st.f, "b0": st.b0}
    ri = torch.as_tensor(rows, device=st.C.device)
    out["A"] = st.A
    out.update({k: getattr(st, k)[ri].cpu() for k in ("C_raw", "C", "S")})
    return out


def control_round(reference, params: dict, rows: np.ndarray):
    """The control, as a round that takes the program's place: the plain
    reference's round with TF32 products (its operands rounded to TF32
    and the card's TF32 mode on), from the same start state. It
    deconvolves the traces ``rows`` alone (those the check draws) and
    leaves the other rows of C_raw, C and S zero."""

    def round_(Y, st, p, sn_pix, stage=None):
        start = {"A": st.A, "C": st.C, "active": st.active}
        if st.W is not None:
            start.update(w_old=st.W.w, w0_old=st.W.w0)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = reference.run_round(Y, start, sn_pix, params, rows,
                                      reference.Precision(tf32=True))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        ri = torch.as_tensor(rows, device=st.C.device)
        traces = {}
        for k in ("C_raw", "C", "S"):
            full = torch.zeros_like(st.C)
            full[ri] = torch.as_tensor(out[k], dtype=full.dtype,
                                       device=full.device)
            traces[k] = full
        W = RingWeights(w=out["w"], w0=out["w0"]) if "w" in out else None
        return SimpleNamespace(W=W, b=out.get("b"), f=out.get("f"),
                               b0=out["b0"], A=out["A"], **traces)
    return round_
