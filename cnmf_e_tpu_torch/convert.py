"""State <-> numpy conversion.

``state_from_numpy`` builds the port's state from a dict of numpy arrays
(the JAX ``CNMFEState`` fields, or a bundle written by
``cnmf_e_tpu/io/export.py``); ``state_to_numpy`` writes the same keys as
that export (``ring_w``/``ring_w0`` for the ring weights) plus ``active``,
for every slot, so a round trip is lossless.
"""

from __future__ import annotations

import numpy as np
import torch

from cnmf_e_tpu_torch.models.state import CNMFEState, RingWeights

_F32_KEYS = ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0")


def _f32(x, device) -> torch.Tensor:
    # numpy defaults to float64; the model runs in float32 throughout
    return torch.tensor(np.asarray(x, np.float32), device=device)


def state_from_numpy(d: dict, device="cpu") -> CNMFEState:
    """Build a state on ``device`` from a dict of numpy arrays.

    Keys: A, C, C_raw, S, g, neuron_sn, b0; optional active (default: all
    slots active, as in an export bundle), tags, and the ring weights as
    ring_w/ring_w0 (export names) or W.w/W.w0 (JAX field names)."""
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
    return out
