"""Evaluation metrics: spatial IoU, trace correlation, F1 matching, RSS (a
copy of ``cnmf_e_tpu/utils/metrics.py``).

Used by the parity/integration tests (SURVEY.md section 4 test plan) and by
the benchmark harness. Host-side numpy; small inputs only (K x K matchings).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def spatial_iou(a: np.ndarray, b: np.ndarray, thr: float = 0.2) -> float:
    """IoU of thresholded supports of two footprints (H, W)."""
    am = a > thr * max(a.max(), 1e-12)
    bm = b > thr * max(b.max(), 1e-12)
    inter = np.logical_and(am, bm).sum()
    union = np.logical_or(am, bm).sum()
    return float(inter) / max(float(union), 1.0)


def greedy_match(A_est: np.ndarray, A_true: np.ndarray,
                 iou_thr: float = 0.3) -> Tuple[list, np.ndarray]:
    """Greedy IoU matching of estimated to true footprints.

    Returns (matches, iou_matrix); matches is a list of (est_idx, true_idx).
    """
    Ke, Kt = A_est.shape[0], A_true.shape[0]
    # vectorized pairwise IoU on thresholded supports (same semantics as
    # spatial_iou): the per-pair python loop is O(Ke*Kt*d) scalar work —
    # hours at the config-5 scale (2000^2 pairs x 512^2 pixels) — where
    # one sgemm computes every intersection at once
    thr = 0.2
    Me = (A_est.reshape(Ke, -1)
          > thr * np.maximum(A_est.reshape(Ke, -1).max(1, keepdims=True),
                             1e-12)).astype(np.float32)
    Mt = (A_true.reshape(Kt, -1)
          > thr * np.maximum(A_true.reshape(Kt, -1).max(1, keepdims=True),
                             1e-12)).astype(np.float32)
    inter = Me @ Mt.T                                       # (Ke, Kt)
    areas_e = Me.sum(1)[:, None]
    areas_t = Mt.sum(1)[None, :]
    union = areas_e + areas_t - inter
    iou = inter / np.maximum(union, 1.0)
    matches = []
    used_e, used_t = set(), set()
    order = np.argsort(-iou, axis=None)
    for flat in order:
        i, j = np.unravel_index(flat, iou.shape)
        if iou[i, j] < iou_thr:
            break
        if i in used_e or j in used_t:
            continue
        matches.append((int(i), int(j)))
        used_e.add(i); used_t.add(j)
    return matches, iou


def detection_f1(A_est: np.ndarray, A_true: np.ndarray,
                 iou_thr: float = 0.3) -> dict:
    matches, iou = greedy_match(A_est, A_true, iou_thr)
    tp = len(matches)
    fp = A_est.shape[0] - tp
    fn = A_true.shape[0] - tp
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"f1": f1, "precision": precision, "recall": recall,
            "matches": matches, "iou": iou}


def trace_corr(C_est: np.ndarray, C_true: np.ndarray, matches) -> np.ndarray:
    """Pearson correlation of matched trace pairs."""
    out = []
    for i, j in matches:
        a, b = C_est[i], C_true[j]
        sa, sb = a.std(), b.std()
        if sa < 1e-12 or sb < 1e-12:
            out.append(0.0)
        else:
            out.append(float(np.corrcoef(a, b)[0, 1]))
    return np.array(out)


def rss(Y: np.ndarray, A: np.ndarray, C: np.ndarray, B: np.ndarray) -> float:
    """||Y - AC - B||_F^2 (reference: ``Sources2D.m:1358-1510``)."""
    recon = np.einsum("khw,kt->thw", A, C) + B
    return float(np.sum((Y - recon) ** 2))
