"""Noise-level estimation (port of the parts of ``cnmf_e_tpu/ops/noise.py``
that ``CNMFE.fit`` reaches): the Welch-PSD sigma (``GetSn.m``), its
frames-first matmul form, and the histogram baseline/noise fit
(``estimate_baseline_noise.m``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.ops.stats import median_mid
from cnmf_e_tpu_torch.parallel import comm


def _hamming(n: int) -> np.ndarray:
    # MATLAB 'hamming' (symmetric) window
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def _welch_geometry(T: int):
    seg = min(max(int(T // 4.5), 16), T)
    step = max(seg // 2, 1)
    n_windows = max((T - seg) // step + 1, 1)
    nfft = max(256, int(2 ** np.ceil(np.log2(seg))))
    return seg, step, n_windows, nfft


def welch_psd(y: torch.Tensor) -> Tuple[torch.Tensor, np.ndarray]:
    """One-sided Welch PSD along the last axis with MATLAB pwelch defaults
    (8 segments, 50% overlap, hamming window, nfft >= 256, fs = 1)."""
    T = y.shape[-1]
    seg, step, n_windows, nfft = _welch_geometry(T)
    win_np = _hamming(seg)
    win = torch.as_tensor(win_np, dtype=y.dtype, device=y.device)
    scale = 1.0 / float(np.sum(win_np ** 2))
    idx = (np.arange(n_windows) * step)[:, None] + np.arange(seg)[None, :]
    frames = y[..., torch.as_tensor(idx, device=y.device)] * win
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    psd = spec.abs() ** 2 * scale
    mult = np.full(psd.shape[-1], 2.0)
    mult[0] = mult[-1] = 1.0
    psd = psd * torch.as_tensor(mult, dtype=y.dtype, device=y.device)
    return psd.mean(dim=-2), np.fft.rfftfreq(nfft, d=1.0)


def _band_sigma(sel: torch.Tensor, dim: int, method: str) -> torch.Tensor:
    if method == "mean":
        return torch.sqrt(sel.mean(dim=dim))
    if method == "median":
        return torch.sqrt(median_mid(sel, dim=dim))
    # logmexp (default): geometric mean, robust to signal leakage
    return torch.sqrt(torch.exp(torch.log(sel + 1e-30).mean(dim=dim)))


def noise_psd(y: torch.Tensor, freq_range=(0.25, 0.5),
              method: str = "logmexp") -> torch.Tensor:
    """Noise sigma from the average high-frequency PSD (GetSn.m) along the
    last axis; returns ``y.shape[:-1]``."""
    psd, freqs = welch_psd(y)
    band = np.nonzero((freqs >= freq_range[0]) & (freqs <= freq_range[1]))[0]
    sel = psd[..., torch.as_tensor(band, device=y.device)] / 2.0
    return _band_sigma(sel, -1, method)


def noise_psd_frames(Y: torch.Tensor, freq_range=(0.25, 0.5),
                     method: str = "logmexp", mesh=None,
                     n_frames: Optional[int] = None) -> torch.Tensor:
    """Per-pixel PSD noise over axis 0 of a frames-first array (T, ...):
    the estimate of ``noise_psd`` on the pixel traces, computed as a
    band-restricted DFT matmul per Welch window (no transpose of the
    movie, only the band's bins).

    ``mesh``: Y is this rank's block of frames (T / n_frame of them, in
    'frame' order) and ``n_frames`` the length of the movie's prefix
    whose noise is taken (default all frames). A Welch window inside one
    rank's block is transformed there; a window across a block seam is
    transformed in parts, each rank its own frames, and the parts are
    summed over 'frame' before they are squared (the DFT is linear in
    the frames). The owner of a window's first frame adds its power, and
    the band powers are summed over 'frame'. At 256x256 pixels on 2 x 2
    ranks a rank hands the collectives, per seam window, 2 Nb d_local
    floats (Nb = 65 band bins at 1024 frames, 129 at 2000; d_local =
    32768), then Nb d_local for the sum: 25.6 MB for the 1024-frame pixel
    noise (one seam window), 84.5 MB for the init's 2000 frames (two);
    resharding pixels to whole time series instead would move half of a
    rank's block, 65.5 MB at 1000 frames."""
    if mesh is None or mesh.n_frame == 1:
        mesh, f, n_frame = None, 0, 1         # one block: no collective
    else:
        f, n_frame = mesh.f, mesh.n_frame
    Tl = Y.shape[0]
    T = Tl * n_frame if n_frames is None else min(n_frames, Tl * n_frame)
    t0 = f * Tl
    t1 = min(t0 + Tl, T)
    F, multj, Nb, seg, step, n_windows = _band_dft(T, freq_range, Y.device)
    Yf = Y.reshape(Tl, -1)
    psd = torch.zeros((Nb, Yf.shape[1]), dtype=torch.float32,
                      device=Y.device)
    for w in range(n_windows):
        a, b = w * step, w * step + seg
        owner = a // Tl
        lo, hi = max(a, t0), min(b, t1)
        if owner == (b - 1) // Tl:                # inside one block
            if owner != f:
                continue
            Gw = F @ Yf[a - t0:b - t0]                      # (2 Nb, d)
        else:                                     # across a seam
            Gw = (F[:, lo - a:hi - a] @ Yf[lo - t0:hi - t0] if hi > lo
                  else torch.zeros_like(psd[:1]).expand(2 * Nb, -1))
            Gw = comm.psum(Gw.contiguous(), mesh, "frame")
            if owner != f:
                continue
        psd = psd + (Gw[:Nb] ** 2 + Gw[Nb:] ** 2)
    sel = comm.psum(psd, mesh, "frame") * multj[:, None] / n_windows
    return _band_sigma(sel, 0, method).reshape(Y.shape[1:])


def _band_dft(T: int, freq_range, device):
    """The Welch geometry of T frames and the windowed DFT rows of the
    band's bins: (F (2 Nb, seg), the bins' scale (Nb,), Nb, seg, step,
    n_windows)."""
    seg, step, n_windows, nfft = _welch_geometry(T)
    win = _hamming(seg)
    scale = 1.0 / float(np.sum(win ** 2))
    freqs = np.fft.rfftfreq(nfft, d=1.0)
    bins = np.nonzero((freqs >= freq_range[0]) & (freqs <= freq_range[1]))[0]
    mult = np.where((bins == 0) | (bins == nfft // 2), 1.0, 2.0)
    ang = -2.0 * np.pi * np.outer(bins, np.arange(seg)) / nfft
    F = np.concatenate([(np.cos(ang) * win).astype(np.float32),
                        (np.sin(ang) * win).astype(np.float32)], axis=0)
    F = torch.as_tensor(F, device=device)                   # (2 Nb, seg)
    multj = torch.as_tensor((mult * scale / 2.0).astype(np.float32),
                            device=device)
    return F, multj, len(bins), seg, step, n_windows


def noise_std(y: torch.Tensor) -> torch.Tensor:
    """First-difference robust sigma: std(diff(y)) / sqrt(2)."""
    d = torch.diff(y, dim=-1)
    return d.std(dim=-1, unbiased=False) / np.float32(np.sqrt(2.0))


def estimate_baseline_noise(y: torch.Tensor, n_bins: int = 256
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histogram-mode baseline and Gaussian noise sigma along the last
    axis: a weighted log-parabola fit to the histogram around its mode
    (the JAX package's replacement for ``fit_gauss1``)."""
    lo = torch.quantile(y, 0.001, dim=-1, keepdim=True)
    hi = torch.quantile(y, 0.999, dim=-1, keepdim=True)
    span = torch.clamp(hi - lo, min=1e-12)
    bin_idx = torch.clamp(((y - lo) / span * n_bins).to(torch.int32),
                          0, n_bins - 1)
    counts = torch.zeros(y.shape[:-1] + (n_bins,), dtype=y.dtype,
                         device=y.device)
    counts.scatter_add_(-1, bin_idx.long(), torch.ones_like(y))

    centers01 = (torch.arange(n_bins, dtype=y.dtype, device=y.device)
                 + 0.5) / n_bins
    centers = lo + centers01 * span
    mode_idx = counts.argmax(dim=-1, keepdim=True)
    mode_center = torch.gather(centers, -1, mode_idx)
    peak = torch.gather(counts, -1, mode_idx)
    w = torch.where(counts > 0.05 * peak, counts, 0.0)
    w = torch.where((centers - mode_center).abs() < 0.25 * span, w, 0.0)

    x = centers - mode_center
    logc = torch.log(torch.clamp(counts, min=0.5))
    sw = w.sum(dim=-1)

    def m(p):
        return (w * p).sum(dim=-1) / torch.clamp(sw, min=1e-12)

    x1, x2, x3, x4 = m(x), m(x * x), m(x ** 3), m(x ** 4)
    yx0, yx1, yx2 = m(logc), m(logc * x), m(logc * x * x)
    A = torch.stack([
        torch.stack([x4, x3, x2], dim=-1),
        torch.stack([x3, x2, x1], dim=-1),
        torch.stack([x2, x1, torch.ones_like(x1)], dim=-1),
    ], dim=-2)
    rhs = torch.stack([yx2, yx1, yx0], dim=-1)
    eye = torch.eye(3, dtype=y.dtype, device=y.device)
    sol = torch.linalg.solve(A + 1e-9 * eye, rhs[..., None])[..., 0]
    a = torch.clamp(sol[..., 0], max=-1e-12)                # concave
    b = sol[..., 1]
    sigma = torch.sqrt(-1.0 / (2.0 * a))
    baseline = mode_center[..., 0] + (-b / (2.0 * a))
    ok = (torch.isfinite(sigma) & torch.isfinite(baseline)
          & (sigma < span[..., 0]))
    baseline = torch.where(ok, baseline, median_mid(y, dim=-1))
    sigma = torch.where(ok, sigma, noise_std(y))
    return baseline, sigma


def estimate_noise(y: torch.Tensor, method: str = "psd") -> torch.Tensor:
    """Per-trace noise sigma along the last axis."""
    if method == "psd":
        return noise_psd(y)
    if method == "hist":
        return estimate_baseline_noise(y)[1]
    if method == "std":
        return noise_std(y)
    raise ValueError(f"unknown noise method {method!r}")
