"""Cross-result neuron pairing, component classification, update ordering
(the port's own copy of ``cnmf_e_tpu/models/pairing.py``, float64 numpy on
the host).

* :func:`pair_neurons` matches neurons between two demixing results by
  the product of spatial and temporal cosine similarities, with
  mutual-best assignment (reference ``endoscope/pair_neurons.m``).
* :func:`classify_components` keeps components that retain at least
  ``cl_thr`` of their l2 norm on the active-pixel mask (reference
  ``utilities/classify_components.m``).
* :func:`update_order` partitions neurons into groups of non-overlapping
  footprints by a greedy approximate vertex cover (reference
  ``utilities/update_order.m``).

All three work on small (K- or K x K-sized) host arrays; callers holding
tensors pass them through ``.cpu().numpy()``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class PairResult(NamedTuple):
    ind_max: np.ndarray        # (K1,) index into result-2 or -1 (no match)
    ind_spatial: np.ndarray    # (K1,) best spatial match
    ind_temporal: np.ndarray   # (K1,) best temporal match
    max_spatial: np.ndarray    # (K1,) spatial similarity of the match
    max_temporal: np.ndarray   # (K1,) temporal similarity of the match
    max_all: np.ndarray        # (K1,) combined similarity of the match


def pair_neurons(A1: np.ndarray, C1: np.ndarray,
                 A2: np.ndarray, C2: np.ndarray) -> PairResult:
    """Match neurons of result 1 to result 2 (``pair_neurons.m:1-45``).

    A1: (d, K1), C1: (K1, T); A2: (d, K2), C2: (K2, T). A pair is assigned
    only when it is the argmax along BOTH axes of the combined similarity
    (mutual best match); unmatched neurons get ``ind_max = -1``.
    """
    A1 = np.asarray(A1, np.float64)
    A2 = np.maximum(np.asarray(A2, np.float64), 0.0)
    C1 = np.asarray(C1, np.float64)
    C2 = np.asarray(C2, np.float64)

    def _unit(x, axis):
        n = np.sqrt(np.sum(x * x, axis=axis, keepdims=True))
        return x / np.maximum(n, 1e-12)

    C1n, C2n = _unit(C1, 1), _unit(C2, 1)
    A1n, A2n = _unit(A1, 0), _unit(A2, 0)
    K1 = A1.shape[1]

    C_sim = C2n @ C1n.T                        # (K2, K1)
    ind_temporal = np.argmax(C_sim, axis=0)

    # spatial similarity restricted to result-1 masks (pair_neurons.m:20-24)
    IND = (A1n > 1e-5).astype(np.float64)      # (d, K1)
    A2norm = np.sqrt((A2n ** 2).T @ IND)       # (K2, K1)
    A2norm[A2norm < 1e-5] = np.inf
    A_sim = (A2n.T @ A1n) / A2norm
    ind_spatial = np.argmax(A_sim, axis=0)

    all_sim = A_sim * C_sim
    ind1 = all_sim == all_sim.max(axis=0, keepdims=True)
    ind2 = all_sim == all_sim.max(axis=1, keepdims=True)
    mutual = ind1 & ind2
    val_max = mutual.any(axis=0)
    ind_max = np.argmax(mutual, axis=0)

    max_spatial = np.full(K1, np.nan)
    max_temporal = np.full(K1, np.nan)
    max_all = np.full(K1, np.nan)
    sel = np.where(val_max)[0]
    max_spatial[sel] = A_sim[ind_max[sel], sel]
    max_temporal[sel] = C_sim[ind_max[sel], sel]
    max_all[sel] = all_sim[ind_max[sel], sel]
    ind_max = np.where(val_max, ind_max, -1)
    return PairResult(ind_max, ind_spatial, ind_temporal,
                      max_spatial, max_temporal, max_all)


def classify_components(A: np.ndarray, active_pixels: np.ndarray,
                        cl_thr: float = 0.8) -> np.ndarray:
    """True for components keeping >= cl_thr of their l2 norm on active
    pixels (``classify_components.m:31-38``). A: (d, K); active: (d,)."""
    A = np.asarray(A, np.float64)
    act = np.asarray(active_pixels, np.float64).reshape(-1, 1)
    e_all = np.sum(A * A, axis=0)
    e_act = np.sum((A * act) ** 2, axis=0)
    return e_act >= (cl_thr ** 2) * e_all


def update_order(A: np.ndarray,
                 rng: Optional[np.random.Generator] = None
                 ) -> List[np.ndarray]:
    """Group neurons so that footprints within a group never overlap
    (``update_order.m:1-26``: repeated approximate vertex cover on the
    A^T A > 0 graph). A: (d, K). Returns groups ordered largest-last like
    the reference's ``fliplr``; deterministic highest-degree-first cover
    unless ``rng`` is given (the reference samples randomly).
    """
    A = np.asarray(A)
    K = A.shape[1]
    F = (A.T @ A) > 0
    np.fill_diagonal(F, False)
    rem = np.arange(K)
    groups: List[np.ndarray] = []
    while rem.size:
        sub = F[np.ix_(rem, rem)].copy()
        cover: List[int] = []
        while sub.any():
            if rng is None:
                u = int(np.argmax(sub.sum(axis=1)))
            else:
                rows = np.unique(np.nonzero(sub)[0])
                u = int(rng.choice(rows))
            cover.append(u)
            sub[u, :] = False
            sub[:, u] = False
        cover_arr = np.array(sorted(cover), dtype=int)
        keep = np.setdiff1d(np.arange(rem.size), cover_arr)
        groups.append(rem[keep])
        rem = rem[cover_arr]
    return groups[::-1]
