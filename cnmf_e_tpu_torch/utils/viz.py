"""Visualization & video export.

Reference layer L6: ``get_contours`` / ``show_contours``
(``Sources2D.m:1956-2071``), ``show_demixed_video`` (raw | background |
denoised | residual panels), ``plot_contours``. Headless matplotlib only;
videos export as TIFF stacks (no codec stack in this environment).

Port of ``cnmf_e_tpu/utils/viz.py``: host numpy and matplotlib, fed with
numpy arrays (``tensor.cpu().numpy()``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from cnmf_e_tpu_torch.io.tiff import write_tiff


def footprint_contours(A: np.ndarray, level: float = 0.6) -> List[np.ndarray]:
    """Iso-energy contour of each footprint (K, H, W).

    ``level`` is the fraction of total energy enclosed (reference
    ``get_contours`` uses the cumulative-energy threshold). Returns a list
    of (n_points, 2) arrays in (row, col) coordinates.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    contours = []
    for a in np.asarray(A):
        flat = np.sort(a.ravel())[::-1]
        csum = np.cumsum(flat**2)
        total = csum[-1] if csum[-1] > 0 else 1.0
        idx = np.searchsorted(csum / total, level)
        thr = flat[min(idx, len(flat) - 1)]
        fig, ax = plt.subplots()
        cs = ax.contour(a, levels=[max(thr, 1e-12)])
        paths = []
        for collection in cs.allsegs:
            for seg in collection:
                paths.append(seg[:, ::-1])  # (x,y) -> (row,col)
        plt.close(fig)
        contours.append(np.concatenate(paths, axis=0) if paths
                        else np.zeros((0, 2)))
    return contours


def plot_summary(path: str, Cn: np.ndarray, A: np.ndarray,
                 C: np.ndarray, level: float = 0.6,
                 max_traces: int = 20) -> str:
    """Save a QC figure: correlation image + contours, and top traces."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax1.imshow(Cn, cmap="gray")
    for cont in footprint_contours(A, level):
        if len(cont):
            ax1.plot(cont[:, 1], cont[:, 0], lw=0.8)
    ax1.set_title(f"Cn + {A.shape[0]} contours")
    ax1.axis("off")

    K = min(max_traces, C.shape[0])
    offset = np.nanmax(np.abs(C[:K])) * 1.2 + 1e-6
    for k in range(K):
        ax2.plot(C[k] + k * offset, lw=0.6)
    ax2.set_title("traces")
    ax2.set_yticks([])
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def save_neuron_panels(out_dir: str, A: np.ndarray, C: np.ndarray,
                       C_raw: Optional[np.ndarray] = None,
                       S: Optional[np.ndarray] = None,
                       fs: float = 10.0, max_neurons: int = 200) -> int:
    """One PNG per neuron: footprint + traces (+spikes) — the headless
    equivalent of ``viewNeurons`` / ``save_neurons``
    (``Sources2D.m:482-502``; the reference writes the same panels into
    LOGS_*/neurons/). Returns the number of files written."""
    import os
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    K = min(A.shape[0], max_neurons)
    t = np.arange(C.shape[1]) / fs
    for k in range(K):
        fig, (ax1, ax2) = plt.subplots(
            1, 2, figsize=(10, 3), width_ratios=[1, 3])
        ax1.imshow(A[k], cmap="hot")
        ax1.set_title(f"neuron {k}")
        ax1.axis("off")
        if C_raw is not None:
            ax2.plot(t, C_raw[k], color="0.7", lw=0.6, label="raw")
        ax2.plot(t, C[k], color="tab:red", lw=0.9, label="denoised")
        if S is not None and S[k].max() > 0:
            sk = S[k] / S[k].max() * C[k].max() * 0.3
            ax2.vlines(t[S[k] > 0], -C[k].max() * 0.35, -C[k].max() * 0.05,
                       color="tab:blue", lw=0.5, label="spikes")
        ax2.set_xlabel("time (s)")
        ax2.legend(loc="upper right", fontsize=7)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"neuron_{k:04d}.png"), dpi=100)
        plt.close(fig)
    return K


def export_demixed_video(path: str, Y: np.ndarray, B: np.ndarray,
                         A: np.ndarray, C: np.ndarray,
                         stride: int = 1) -> str:
    """Panel video [raw | background | denoised AC | residual] as a TIFF
    stack (reference: ``show_demixed_video.m:1-45``)."""
    Y = np.asarray(Y)[::stride]
    B = np.asarray(B)[::stride]
    AC = np.einsum("khw,kt->thw", np.asarray(A),
                   np.asarray(C)[:, ::stride]).astype(np.float32)
    resid = Y - B - AC
    panel = np.concatenate([Y, B, AC, resid], axis=2)  # side by side
    lo, hi = np.percentile(Y, [1, 99.5])
    panel = np.clip((panel - lo) / max(hi - lo, 1e-9), 0, 1)
    write_tiff(path, (panel * 65535).astype(np.uint16))
    return path
