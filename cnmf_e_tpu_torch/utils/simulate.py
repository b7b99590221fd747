"""Synthetic calcium-imaging data with known ground truth (a copy of the
in-memory part of ``cnmf_e_tpu/utils/simulate.py``; the out-of-core
``simulate_movie_store`` is not copied).

The reference has trace-level generators (``OASIS_matlab/functions/gen_data.m``)
used by its self-tests; movie-level fixtures did not exist. This module
generates full movies Y = A C + B + noise with gaussian-blob footprints,
AR(1) traces, and a structured background (smooth spatial profile times a
slow temporal modulation plus a static baseline) so every pipeline stage has
a measurable target (spatial IoU, trace correlation, F1).
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass
class GroundTruth:
    Y: np.ndarray       # (T, H, W) movie
    A: np.ndarray       # (K, H, W) footprints
    C: np.ndarray       # (K, T) calcium traces
    S: np.ndarray       # (K, T) spikes
    b0: np.ndarray      # (H, W) static baseline
    Bf: np.ndarray      # (T, H, W) fluctuating background
    centers: np.ndarray  # (K, 2) row/col centers
    g: float
    sn: float


def ar1_traces(rng: np.random.Generator, K: int, T: int, g: float = 0.95,
               rate: float = 0.02, amp: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    S = (rng.random((K, T)) < rate) * (amp * (0.5 + rng.random((K, T))))
    C = np.zeros((K, T))
    for t in range(T):
        C[:, t] = (C[:, t - 1] * g if t else 0.0) + S[:, t]
    return C, S


def gaussian_footprints(rng: np.random.Generator, K: int, H: int, W: int,
                        gSig: float = 3.0, margin: int = 6,
                        min_dist: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """K gaussian blobs with random centers (rejection-sampled min distance)."""
    centers = []
    tries = 0
    while len(centers) < K and tries < 50 * K:
        tries += 1
        c = np.array([rng.uniform(margin, H - margin),
                      rng.uniform(margin, W - margin)])
        if min_dist > 0 and centers:
            if np.min(np.linalg.norm(np.array(centers) - c, axis=1)) < min_dist:
                continue
        centers.append(c)
    centers = np.array(centers[:K])
    K = len(centers)
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W))
    for k, (cy, cx) in enumerate(centers):
        sig = gSig * rng.uniform(0.8, 1.2)
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig**2))
        blob[blob < np.exp(-2.0)] = 0.0   # truncate at 2 sigma
        A[k] = blob
    return A, centers


def smooth_field(rng: np.random.Generator, H: int, W: int,
                 scale: float = 20.0) -> np.ndarray:
    """Smooth random spatial field in [0, 1] via low-frequency fourier mix.

    All wavelengths are bounded below by ``2 * scale`` so the field stays
    neuropil-like (1p backgrounds are much smoother than somata; without the
    bound, random gaussian frequencies occasionally produce neuron-scale
    ripples that no band-pass filter could reject).
    """
    field = np.zeros((H, W))
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(6):
        theta = rng.uniform(0, 2 * np.pi)
        mag = rng.uniform(0.3, 1.0) / (2.0 * scale)
        fy, fx = mag * np.sin(theta), mag * np.cos(theta)
        ph = rng.uniform(0, 2 * np.pi)
        field += rng.uniform(0.3, 1.0) * np.cos(2 * np.pi * (fy * yy + fx * xx) + ph)
    field -= field.min()
    return field / max(field.max(), 1e-12)


def simulate_movie(seed: int = 0, H: int = 64, W: int = 64, T: int = 1000,
                   K: int = 12, gSig: float = 3.0, g: float = 0.95,
                   sn: float = 0.1, bg_strength: float = 1.0,
                   spike_rate: float = 0.02, min_dist: float = 8.0,
                   baseline: float = 1.0) -> GroundTruth:
    """Full 1p-like movie: neurons + smooth fluctuating background + noise."""
    rng = np.random.default_rng(seed)
    A, centers = gaussian_footprints(rng, K, H, W, gSig, min_dist=min_dist)
    K = A.shape[0]
    C, S = ar1_traces(rng, K, T, g=g, rate=spike_rate)

    b0 = baseline * (0.5 + smooth_field(rng, H, W, scale=max(H, W) / 2))
    # fluctuating background: two smooth spatial modes x slow temporal
    # modes, synthesized as one rank-2 float32 GEMM (a float64 outer()
    # per mode costs ~5 passes over a T*H*W array at 8 bytes — the
    # generation bottleneck for 512x512x10k movies)
    drives = np.zeros((2, T), np.float32)
    profs = np.zeros((2, H * W), np.float32)
    for i in range(2):
        prof = smooth_field(rng, H, W, scale=max(H, W) / 3)
        tau = rng.uniform(50, 200)
        drive = np.convolve(rng.standard_normal(T),
                            np.exp(-np.arange(min(200, T)) / tau),
                            mode="same")
        drive /= max(np.abs(drive).max(), 1e-12)
        drives[i] = drive
        profs[i] = bg_strength * prof.ravel()
    Bf = (drives.T @ profs).reshape(T, H, W)

    # C^T @ A_flat routes through BLAS (einsum "khw,kt->thw" does not and
    # becomes the bottleneck for large movies)
    Y = (C.T.astype(np.float32) @ A.reshape(K, H * W).astype(np.float32)
         ).reshape(T, H, W)
    Y += b0[None].astype(np.float32) + Bf
    rows = max(1, (1 << 26) // (H * W))   # chunk noise gen: float32, bounded
    for t0 in range(0, T, rows):
        t1 = min(t0 + rows, T)
        Y[t0:t1] += sn * rng.standard_normal(
            (t1 - t0, H, W)).astype(np.float32)
    return GroundTruth(Y=Y.astype(np.float32, copy=False),
                       A=A.astype(np.float32, copy=False),
                       C=C.astype(np.float32, copy=False),
                       S=S.astype(np.float32, copy=False),
                       b0=b0.astype(np.float32, copy=False),
                       Bf=Bf.astype(np.float32, copy=False),
                       centers=centers, g=g, sn=sn)
