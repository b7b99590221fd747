"""The system under test: the model-update round of ``cnmf_e_tpu_torch``
on a (patch, frame) mesh of ranks that stay up between rounds
(``parallel/launch.py::ResidentMesh``), one card a rank where the host
has them: each rank runs ``update_background``, ``subtract_background``,
``update_spatial`` and ``update_temporal`` with ``mesh=`` on its block
of the movie, (T / n_frame, H / n_patch, W), and of the state, as
``parallel/mesh.py`` lays them out.

The harness's process is rank 0 (``cuda:0``). ``start_state`` brings the
other ranks up (after the harness has loaded the kernels, so that they
load them and never build them); the first round ships each rank its
blocks of Y, A, C, the old ring weights and the pixel noise from rank 0
(``launch.scatter``), which every rank keeps; each round then runs from
those blocks, with the harness's ``stage(name)`` contexts on rank 0.
``outputs`` gathers what the check judges to rank 0 and closes the mesh,
so that the check has ``cuda:0`` to itself.

The configuration's ``mesh`` gives the layout (``n_patch``, ``n_frame``);
its ``params`` are the preset's, key for key, and the layout goes into
their ``patch`` section. The ranks keep their blocks in this module
(``_HELD``), one mesh a process.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.background import (subtract_background,
                                                update_background)
from cnmf_e_tpu_torch.models.spatial import update_spatial
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.models.temporal import update_temporal
from cnmf_e_tpu_torch.parallel.launch import (ResidentMesh, broadcast,
                                              scatter)
from cnmf_e_tpu_torch.parallel.mesh import (gather_footprints, gather_image,
                                            gather_traces, shard_footprints,
                                            shard_image, shard_movie,
                                            shard_traces)

from benchmark.entries import update_round as one_card

STAGES = one_card.STAGES
PG_TIMEOUT = 180.0          # seconds a collective may wait for its peers

_MESH: dict = {}            # rank 0: the resident mesh
_HELD: dict = {}            # every rank: its blocks, params, last state


def params(config: dict) -> CNMFEParams:
    """The preset, checked against the file key for key, with the
    configuration's mesh as its ``patch`` layout."""
    p = one_card.params(config)
    if p.background.model != "ring":
        raise ValueError("the mesh round covers the ring background")
    m = config["mesh"]
    return dataclasses.replace(p, patch=dataclasses.replace(
        p.patch, n_patch=int(m["n_patch"]), n_frame=int(m["n_frame"])))


def close() -> None:
    """End the mesh and drop every block this process holds."""
    mesh = _MESH.pop("mesh", None)
    if mesh is not None:
        mesh.close()
    _HELD.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def start_state(start: dict, p: CNMFEParams) -> CNMFEState:
    """The whole start state on rank 0 (``entries/update_round.py``'s),
    and the other ranks brought up."""
    close()
    st = one_card.start_state(start, p)
    _MESH["mesh"] = ResidentMesh(
        p.patch.n_patch, p.patch.n_frame,
        device="cuda" if st.A.device.type == "cuda" else "cpu",
        pg_timeout=PG_TIMEOUT)
    return st


def _ship(mesh, p: CNMFEParams, Y=None, st=None, sn_pix=None) -> None:
    """Every rank's blocks of rank 0's movie, start state and pixel
    noise; the other ranks pass None."""
    blocks = {"A": scatter(None if st is None else st.A, shard_footprints,
                           mesh),
              "C": scatter(None if st is None else st.C, shard_traces, mesh),
              "active": broadcast(None if st is None else st.active, mesh),
              "w_old": scatter(None if st is None else st.W.w, shard_image,
                               mesh),
              "w0_old": scatter(None if st is None else st.W.w0,
                                shard_image, mesh)}
    _HELD.update(Y=scatter(Y, shard_movie, mesh),
                 sn=scatter(sn_pix, shard_image, mesh),
                 st0=one_card.start_state(blocks, p), p=p)


def _round(mesh, stage=None) -> CNMFEState:
    """One round on this rank's blocks, from the start state; the state
    it ends in (this rank's blocks) is kept and returned."""
    stage = stage or (lambda name: contextlib.nullcontext())
    _HELD.pop("last", None)
    Y, st, p, sn = _HELD["Y"], _HELD["st0"], _HELD["p"], _HELD["sn"]
    with stage("background"):
        st = update_background(Y, st, p, sn_pix=sn, mesh=mesh)
        Ysig = subtract_background(Y, st, p, mesh=mesh)
    with stage("spatial"):
        st = update_spatial(Ysig, st, p, sn_pix=sn, mesh=mesh)
    with stage("temporal"):
        st = update_temporal(Ysig, st, p, mesh=mesh)
    _HELD["last"] = st
    return st


def round_(Y: torch.Tensor, st: CNMFEState, p: CNMFEParams,
           sn_pix: torch.Tensor, stage=None) -> CNMFEState:
    """One round on the mesh (the first ships the blocks); rank 0's
    blocks of the state it ends in."""
    mesh = _MESH["mesh"]
    if "st0" not in _HELD:
        mesh.call(_ship, p, Y=Y, st=st, sn_pix=sn_pix)
    return mesh.call(_round, stage=stage)


def _gather(mesh, rows: np.ndarray):
    """The last round's outputs that the check judges, whole, on rank 0
    (None on the others)."""
    st = _HELD["last"]
    ri = torch.as_tensor(rows, device=st.C.device)
    out = {"w": gather_image(st.W.w, mesh), "w0": gather_image(st.W.w0, mesh),
           "b0": gather_image(st.b0, mesh), "A": gather_footprints(st.A, mesh)}
    out.update({k: gather_traces(getattr(st, k)[ri], mesh).cpu()
                for k in ("C_raw", "C", "S")})
    return out if mesh.rank == 0 else None


def outputs(st, rows: np.ndarray) -> dict:
    """What the check judges, as the reference returns it (the
    background's outputs, every footprint, the traces ``rows`` on the
    host), gathered from the mesh; then the mesh is closed. A round that
    did not run on the mesh (the control) gives its own outputs."""
    try:
        if "mesh" in _MESH and _HELD.get("last") is st:
            return _MESH["mesh"].call(_gather, rows)
        return one_card.outputs(st, rows)
    finally:
        close()


def control_round(reference, params: dict, rows: np.ndarray):
    """The control: the plain reference's round with TF32 products in
    the program's place, as ``entries/update_round.py`` makes it, with
    ``reference`` this round's (blocked) reference."""
    return one_card.control_round(reference, params, rows)
