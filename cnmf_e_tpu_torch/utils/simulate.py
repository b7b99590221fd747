"""Synthetic calcium-imaging data with known ground truth (a copy of
``cnmf_e_tpu/utils/simulate.py``, the out-of-core ``simulate_movie_store``
included).

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


def simulate_movie_store(out_dir: str, seed: int = 0, H: int = 512,
                         W: int = 512, T: int = 100_000, K: int = 2000,
                         gSig: float = 3.0, g: float = 0.95,
                         sn: float = 0.1, bg_strength: float = 1.0,
                         spike_rate: float = 0.01, min_dist: float = 8.0,
                         baseline: float = 1.0,
                         frames_per_block: int = 1000,
                         dtype: str = "float16",
                         overwrite: bool = False):
    """Synthesize an out-of-core movie DIRECTLY into a MovieStore, one
    frame block at a time (bounded host RAM; the AR-trace and background
    temporal recursions carry state across blocks).

    The scale target is BASELINE.md config 5 (512x512x100k, 2k neurons) —
    a movie that never exists in memory at once; ``chip_smoke.py`` streams
    its 256x256x20k, 500-neuron shakeout size. Blocks are written in
    ``dtype`` (float16 halves the disk footprint; ingest casts to f32).
    Ground truth (A as float16, centers, g) is saved to
    ``out_dir/ground_truth.npz``; traces are NOT stored at full rate (they
    would rival the movie's size) — a ``gt_C_decim.npy`` (K, T//25)
    decimation is kept for spot checks.

    Returns the :class:`cnmf_e_tpu_torch.io.store.MovieStore`; the files
    are byte-for-byte those the JAX package's copy writes at equal
    arguments.
    """
    import json
    import os

    from cnmf_e_tpu_torch.io.store import MovieStore

    man_path = os.path.join(out_dir, "manifest.json")
    if os.path.exists(man_path) and not overwrite:
        store = MovieStore(out_dir)
        if tuple(store.shape) == (T, H, W) and \
                store.frames_per_block == frames_per_block:
            return store
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    # sparse footprints: the gaussian is evaluated only inside a 2-sigma
    # box per neuron (a full-FOV exp per neuron is the synthesis
    # bottleneck at K=2000, H=W=512)
    margin = 6
    centers = []
    tries = 0
    while len(centers) < K and tries < 50 * K:
        tries += 1
        c = np.array([rng.uniform(margin, H - margin),
                      rng.uniform(margin, W - margin)])
        if min_dist > 0 and centers:
            if np.min(np.linalg.norm(np.array(centers) - c,
                                     axis=1)) < min_dist:
                continue
        centers.append(c)
    centers = np.array(centers[:K])
    K = len(centers)
    A = np.zeros((K, H, W), np.float32)
    boxes = []
    for k, (cy, cx) in enumerate(centers):
        sig = gSig * rng.uniform(0.8, 1.2)
        half = int(np.ceil(2.0 * sig))
        y0, y1 = max(int(cy) - half, 0), min(int(cy) + half + 1, H)
        x0, x1 = max(int(cx) - half, 0), min(int(cx) + half + 1, W)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2))
        blob[blob < np.exp(-2.0)] = 0.0
        A[k, y0:y1, x0:x1] = blob
        boxes.append((y0, y1, x0, x1))

    b0 = (baseline * (0.5 + smooth_field(rng, H, W, scale=max(H, W) / 2))
          ).astype(np.float32)
    profs = np.stack([
        (bg_strength * smooth_field(rng, H, W, scale=max(H, W) / 3)).ravel()
        for _ in range(2)]).astype(np.float32)                  # (2, H*W)
    bg_g = np.exp(-1.0 / rng.uniform(50, 200, size=2)).astype(np.float32)
    bg_scale = np.sqrt(1.0 - bg_g ** 2)          # unit-variance AR(1)

    n_blocks = -(-T // frames_per_block)
    c_carry = np.zeros(K, np.float32)
    d_carry = np.zeros(2, np.float32)
    C_dec = []
    t_global = 0
    for b in range(n_blocks):
        Tb = min(frames_per_block, T - b * frames_per_block)
        S_blk = ((rng.random((K, Tb)) < spike_rate) * (
            0.5 + rng.random((K, Tb)))).astype(np.float32)
        C_blk = np.empty((K, Tb), np.float32)
        d_noise = rng.standard_normal((2, Tb), dtype=np.float32)
        drives = np.empty((2, Tb), np.float32)
        for t in range(Tb):
            c_carry = c_carry * g + S_blk[:, t]
            C_blk[:, t] = c_carry
            d_carry = d_carry * bg_g + bg_scale * d_noise[:, t]
            drives[:, t] = d_carry
        # rank-1 adds beat a k=2 GEMM here (BLAS is pathological on the
        # (Tb, 2) @ (2, d) shape)
        Y = np.broadcast_to(b0[None], (Tb, H, W)).copy()
        Yf = Y.reshape(Tb, H * W)
        for i in range(2):
            Yf += np.outer(drives[i], profs[i])
        for k in range(K):
            y0, y1, x0, x1 = boxes[k]
            Y[:, y0:y1, x0:x1] += C_blk[k][:, None, None] * \
                A[k, y0:y1, x0:x1][None]
        rows = max(1, (1 << 26) // (H * W))
        for t0 in range(0, Tb, rows):
            t1 = min(t0 + rows, Tb)
            Y[t0:t1] += sn * rng.standard_normal(
                (t1 - t0, H, W), dtype=np.float32)
        np.save(os.path.join(out_dir, f"block_{b:05d}.npy"),
                Y.astype(dtype))
        first = (-t_global) % 25
        C_dec.append(C_blk[:, first::25])
        t_global += Tb

    with open(man_path, "w") as f:
        json.dump({"shape": [T, H, W], "frames_per_block": frames_per_block,
                   "source": "synthetic", "source_dtype": dtype}, f)
    np.savez(os.path.join(out_dir, "ground_truth.npz"),
             A=A.astype(np.float16), centers=centers, g=g, sn=sn, b0=b0)
    np.save(os.path.join(out_dir, "gt_C_decim.npy"),
            np.concatenate(C_dec, axis=1).astype(np.float16))
    return MovieStore(out_dir)
