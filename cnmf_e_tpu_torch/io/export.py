"""Result export/import (port of ``cnmf_e_tpu/io/export.py``, with the same
npz keys and dtypes).

Reference: ``save_workspace`` / ``save_neurons`` / ``compress_results`` /
``obj2struct`` (``Sources2D.m:1796-1953``). Results save as a compressed
.npz (canonical) and optionally a MATLAB-compatible .mat (via scipy.io) so
downstream tooling built for the reference can consume them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.state import CNMFEState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def state_to_arrays(state: CNMFEState, compress: bool = True) -> dict:
    """Flatten a state into a dict of numpy arrays (active slots only)."""
    sel = np.nonzero(_np(state.active))[0]
    out = {
        "A": _np(state.A)[sel],
        "C": _np(state.C)[sel],
        "C_raw": _np(state.C_raw)[sel],
        "S": _np(state.S)[sel],
        "g": _np(state.g)[sel],
        "neuron_sn": _np(state.neuron_sn)[sel],
        "b0": _np(state.b0),
    }
    if state.tags is not None:
        out["tags"] = _np(state.tags)[sel]
    if state.W is not None:
        out["ring_w"] = _np(state.W.w)
        out["ring_w0"] = _np(state.W.w0)
    if state.b is not None:
        out["bg_b"] = _np(state.b)
        out["bg_f"] = _np(state.f)
    if compress:
        # sparsify footprints/spikes like compress_results (Sources2D.m:1884)
        A = out["A"]
        out["A"] = np.where(A > 0, A, 0).astype(np.float32)
        out["S"] = out["S"].astype(np.float32)
    return out


def save_results(path: str, state: CNMFEState,
                 params: Optional[CNMFEParams] = None,
                 extras: Optional[dict] = None) -> str:
    """Save to ``<path>.npz`` (+ params json sidecar). Returns the path."""
    arrays = state_to_arrays(state)
    if extras:
        arrays.update({k: np.asarray(v) for k, v in extras.items()})
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez_compressed(path, **arrays)
    if params is not None:
        with open(path.replace(".npz", "_params.json"), "w") as f:
            f.write(params.to_json())
    return path


def save_results_mat(path: str, state: CNMFEState) -> str:
    """MATLAB-compatible export: A as (d, K), C/S as (K, T) — the
    reference's array conventions for downstream MATLAB tooling."""
    import scipy.io
    arrays = state_to_arrays(state)
    K, H, W = arrays["A"].shape if arrays["A"].ndim == 3 else (0, 0, 0)
    mat = {
        "A": arrays["A"].reshape(K, H * W).T,
        "C": arrays["C"],
        "C_raw": arrays["C_raw"],
        "S": arrays["S"],
        "b0": arrays["b0"],
        "neuron_sn": arrays["neuron_sn"],
    }
    if not path.endswith(".mat"):
        path = path + ".mat"
    scipy.io.savemat(path, mat, do_compression=True)
    return path


def load_results(path: str) -> dict:
    """Load an .npz result bundle as a dict of arrays."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
