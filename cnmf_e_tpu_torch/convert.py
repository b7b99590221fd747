"""State <-> numpy conversion.

``state_from_numpy`` builds the port's state from a dict of numpy arrays
(the JAX ``CNMFEState`` fields, or a bundle written by
``cnmf_e_tpu/io/export.py``); ``state_to_numpy`` writes the same keys as
that export (``ring_w``/``ring_w0`` for the ring weights) plus ``active``,
and the low-rank background as ``bg_b``/``bg_f``, for every slot, so a
round trip is lossless. ``step_state_from_numpy`` and
``step_state_to_numpy`` do the same for the update step's ``StepState``,
and ``shard_step_state`` / ``gather_step_state`` carry one onto the ranks
of a mesh and back, and ``shard_state`` (``state_blocks`` of a state already on the device)
/ ``gather_state`` a ``CNMFEState``.
Both functions put the state on the card unless the caller passes
``device="cpu"``. ``params_from_dict`` builds the port's
:class:`~cnmf_e_tpu_torch.config.CNMFEParams` from the nested dict of any
params object with the same fields (``dataclasses.asdict``).
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState, RingWeights
from cnmf_e_tpu_torch.parallel import mesh as mesh_mod
from cnmf_e_tpu_torch.parallel.step import StepState

_F32_KEYS = ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0")


def _f32(x, device) -> torch.Tensor:
    # numpy defaults to float64; the model runs in float32 throughout
    return torch.tensor(np.asarray(x, np.float32), device=device)


def state_from_numpy(d: dict, device="cuda") -> CNMFEState:
    """Build a state on ``device`` from a dict of numpy arrays.

    Keys: A, C, C_raw, S, g, neuron_sn, b0; optional active (default: all
    slots active, as in an export bundle), tags, the ring weights as
    ring_w/ring_w0 (export names) or W.w/W.w0 (JAX field names), and the
    low-rank background as bg_b/bg_f (export names) or b/f (JAX field
    names)."""
    kw = {k: _f32(d[k], device) for k in _F32_KEYS}
    K = kw["A"].shape[0]
    active = d.get("active")
    kw["active"] = (torch.ones(K, dtype=torch.bool, device=device)
                    if active is None else
                    torch.tensor(np.asarray(active, bool), device=device))
    if d.get("tags") is not None:
        kw["tags"] = torch.tensor(np.asarray(d["tags"], np.int32),
                                  device=device)
    w = d.get("ring_w", d.get("W.w"))
    w0 = d.get("ring_w0", d.get("W.w0"))
    if w is not None:
        kw["W"] = RingWeights(w=_f32(w, device), w0=_f32(w0, device))
    b = d.get("bg_b", d.get("b"))
    if b is not None:
        kw["b"] = _f32(b, device)
        kw["f"] = _f32(d.get("bg_f", d.get("f")), device)
    return CNMFEState(**kw)


def state_to_numpy(state: CNMFEState) -> dict:
    """All slots of ``state`` as numpy arrays, under the export key names."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in _F32_KEYS}
    out["active"] = state.active.detach().cpu().numpy()
    if state.tags is not None:
        out["tags"] = state.tags.detach().cpu().numpy()
    if state.W is not None:
        out["ring_w"] = state.W.w.detach().cpu().numpy()
        out["ring_w0"] = state.W.w0.detach().cpu().numpy()
    if state.b is not None:
        out["bg_b"] = state.b.detach().cpu().numpy()
        out["bg_f"] = state.f.detach().cpu().numpy()
    return out


_STEP_KEYS = ("A", "C", "C_raw", "S", "g", "b0", "ring_w", "ring_w0")


def step_state_from_numpy(d: dict, device="cuda") -> StepState:
    """A :class:`StepState` on ``device`` from a dict of numpy arrays under
    the JAX ``StepState`` field names."""
    return StepState(**{k: _f32(d[k], device) for k in _STEP_KEYS})


def step_state_to_numpy(st: StepState) -> dict:
    """The fields of a ``StepState`` as numpy arrays."""
    return {k: getattr(st, k).detach().cpu().numpy() for k in _STEP_KEYS}


# each StepState field's block on a mesh (parallel/mesh.py's layout)
_STEP_SHARDS = dict(A=(mesh_mod.shard_footprints, mesh_mod.gather_footprints),
                    C=(mesh_mod.shard_traces, mesh_mod.gather_traces),
                    C_raw=(mesh_mod.shard_traces, mesh_mod.gather_traces),
                    S=(mesh_mod.shard_traces, mesh_mod.gather_traces),
                    b0=(mesh_mod.shard_image, mesh_mod.gather_image),
                    ring_w=(mesh_mod.shard_image, mesh_mod.gather_image),
                    ring_w0=(mesh_mod.shard_image, mesh_mod.gather_image))


def shard_step_state(d: dict, mesh) -> StepState:
    """This rank's blocks of a full ``StepState`` given as a dict of numpy
    arrays (the JAX ``StepState`` field names), on the mesh's device; g
    replicated."""
    kw = {k: fn(np.asarray(d[k], np.float32), mesh)
          for k, (fn, _) in _STEP_SHARDS.items()}
    return StepState(g=_f32(d["g"], mesh.device), **kw)


def gather_step_state(st: StepState, mesh) -> dict:
    """The full ``StepState`` from every rank's blocks, as numpy arrays
    (on every rank)."""
    out = {k: fn(getattr(st, k), mesh).detach().cpu().numpy()
           for k, (_, fn) in _STEP_SHARDS.items()}
    out["g"] = st.g.detach().cpu().numpy()
    return out


def shard_state(d: dict, mesh) -> CNMFEState:
    """This rank's blocks of a full ``CNMFEState`` given as a dict of numpy
    arrays (:func:`state_from_numpy`'s keys), on the mesh's device."""
    return state_blocks(state_from_numpy(d, device=mesh.device), mesh)


def state_blocks(st: CNMFEState, mesh) -> CNMFEState:
    """This rank's blocks of a full ``CNMFEState`` (``parallel/mesh.py``'s
    layout: A, b0, the ring weights and the low-rank background's b
    split over 'patch' rows, the traces and its f over 'frame'; the
    per-neuron vectors replicated). The ring
    weights' pixels are those of the grid they were fitted on; traces of
    one frame (the placeholders of a state not yet deconvolved) stay
    whole."""
    h0, h1 = mesh.rows(st.A.shape[1])
    kw = {}
    for k in ("C", "C_raw", "S"):
        tr = getattr(st, k)
        if tr.shape[1] > 1:
            t0, t1 = mesh.frames(tr.shape[1])
            kw[k] = tr[:, t0:t1].contiguous()
    if st.W is not None:
        p0, p1 = mesh.rows(st.W.w.shape[0])
        kw["W"] = RingWeights(w=st.W.w[p0:p1].contiguous(),
                              w0=st.W.w0[p0:p1].contiguous())
    if st.b is not None:
        t0, t1 = mesh.frames(st.f.shape[1])
        kw.update(b=st.b[:, h0:h1].contiguous(),
                  f=st.f[:, t0:t1].contiguous())
    return st.replace(A=st.A[:, h0:h1].contiguous(),
                      b0=st.b0[h0:h1].contiguous(), **kw)


def gather_state(st: CNMFEState, mesh) -> CNMFEState:
    """The full ``CNMFEState`` from every rank's blocks, on every rank (a
    collective: every rank calls it)."""
    kw = {k: mesh_mod.gather_traces(getattr(st, k), mesh)
          for k in ("C", "C_raw", "S")}
    if st.W is not None:
        kw["W"] = RingWeights(w=mesh_mod.gather_image(st.W.w, mesh),
                              w0=mesh_mod.gather_image(st.W.w0, mesh))
    if st.b is not None:
        kw.update(b=mesh_mod.gather_footprints(st.b, mesh),
                  f=mesh_mod.gather_traces(st.f, mesh))
    return st.replace(A=mesh_mod.gather_footprints(st.A, mesh),
                      b0=mesh_mod.gather_image(st.b0, mesh), **kw)


def _dataclass_from_dict(cls, d: dict):
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = {}
    for name, v in d.items():
        if dataclasses.is_dataclass(hints[name]):
            v = _dataclass_from_dict(hints[name], v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[name] = v
    return cls(**kw)


def params_from_dict(d: dict) -> CNMFEParams:
    """The port's ``CNMFEParams`` from a nested dict of fields, such as
    ``dataclasses.asdict`` of the JAX package's params or a parsed
    ``to_json``. Missing fields keep their defaults; an unknown field
    raises."""
    return _dataclass_from_dict(CNMFEParams, d)
