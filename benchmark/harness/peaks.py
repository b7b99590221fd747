"""The card's published peaks, the roofline bound, and the operations and
bytes of the kernels whose roofline the benchmark reports.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
its 700 W power limit: 67 TFLOP/s in FP32 outside the tensor cores and
3.35 TB/s of HBM3. The bound is the larger of
operations over the peak rate and bytes over the HBM rate, each input
read once and each output written once (``chip_smoke.py::bound``'s
arithmetic).
"""

from __future__ import annotations

import numpy as np

FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = FP32_FLOPS):
    """(the least time in seconds, what sets it)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ring_taps(radius: int) -> int:
    """R: the ring's taps at distance [radius, radius + 1)
    (``get_nhood.m``)."""
    r = int(np.ceil(radius)) + 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    d = np.sqrt(x ** 2 + y ** 2)
    return int(((d >= radius) & (d < radius + 1)).sum())


def ring_stencil_cost(T: int, H: int, W: int, radius: int):
    """(operations, bytes) of one K6 launch on a (T, H, W) float32 movie:
    a multiply and an add per tap and the intercept's add per output, and
    the movie read, the output written, the (H W, R) weights and the
    (H W,) intercept read once."""
    R = ring_taps(radius)
    flops = (2.0 * R + 1.0) * T * H * W
    nbytes = 4.0 * (2 * T * H * W + H * W * R + H * W)
    return flops, nbytes


def ring_geometry(config: dict):
    """(T, Hs, Ws, radius_s): the grid and radius the ring model works
    on, or None without a ring background."""
    bg = config["params"]["background"]
    if bg["model"] != "ring":
        return None
    H, W, T, ssub = config["H"], config["W"], config["T"], bg["ssub"]
    if ssub <= 1:
        return T, H, W, bg["ring_radius"]
    return (T, -(-H // ssub), -(-W // ssub),
            max(int(round(bg["ring_radius"] / ssub)), 1))
