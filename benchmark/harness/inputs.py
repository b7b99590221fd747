"""The cell's movie and start state, made on the device from the seed.

The movie follows the generative model of ``utils/simulate.py``:
gaussian-blob footprints truncated at two sigma, AR(1) traces of
Bernoulli spikes, a smooth static baseline, smooth spatial modes driven
by slow random drives, and white noise. Its parameters come from the
configuration (``movie``: the imaging) and the traffic (the neurons
planted, their spike rate, the start state's perturbation). Everything
is drawn from one device generator seeded with ``--seed``, in a few
large calls: the same seed gives the same inputs on the same card.

Centres lie on a jittered lattice (pitch and jitter from the traffic),
so every seed plants exactly K neurons at no less than
``pitch - 2 * jitter`` pixels from each other.

The start state is what an initialisation hands the first round: every
planted footprint scaled by a random factor and perturbed pixel by pixel
on its support, every trace divided by that factor and perturbed, and,
for the ring background, the uniform annulus average as the old weights.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _smooth_field(gen, H: int, W: int, scale: float, device,
                  n: int = 6) -> torch.Tensor:
    """A smooth random field in [0, 1]: ``n`` plane waves of wavelength
    at least 2 ``scale``."""
    u = torch.rand((4, n), generator=gen, device=device)
    theta, mag = 2 * math.pi * u[0], (0.3 + 0.7 * u[1]) / (2.0 * scale)
    ph, amp = 2 * math.pi * u[2], 0.3 + 0.7 * u[3]
    yy = torch.arange(H, dtype=torch.float32, device=device)[None, :, None]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, None, :]
    fy, fx = (mag * torch.sin(theta))[:, None, None], \
        (mag * torch.cos(theta))[:, None, None]
    field = (amp[:, None, None] * torch.cos(
        2 * math.pi * (fy * yy + fx * xx) + ph[:, None, None])).sum(dim=0)
    field = field - field.min()
    return field / torch.clamp(field.max(), min=1e-12)


def _centres(gen, K: int, H: int, W: int, tr: dict, device):
    pitch, jitter, margin = tr["pitch"], tr["jitter"], tr["margin"]
    ny, nx = (H - 2 * margin) // pitch, (W - 2 * margin) // pitch
    if K > ny * nx:
        raise ValueError(f"{K} neurons do not fit a {ny}x{nx} lattice")
    cell = torch.randperm(ny * nx, generator=gen, device=device)[:K]
    j = jitter * (2 * torch.rand((2, K), generator=gen, device=device) - 1)
    cy = margin + ((cell // nx).to(torch.float32) + 0.5) * pitch + j[0]
    cx = margin + ((cell % nx).to(torch.float32) + 0.5) * pitch + j[1]
    return cy, cx


def _footprints(gen, cy, cx, H: int, W: int, mv: dict, device):
    K = cy.shape[0]
    sig = mv["gSig"] * (1 + mv["gSig_jitter"] * (
        2 * torch.rand(K, generator=gen, device=device) - 1))
    yy = torch.arange(H, dtype=torch.float32, device=device)[None, :]
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    gy = torch.exp(-(yy - cy[:, None]) ** 2 / (2 * sig[:, None] ** 2))
    gx = torch.exp(-(xx - cx[:, None]) ** 2 / (2 * sig[:, None] ** 2))
    A = gy[:, :, None] * gx[:, None, :]
    return A.masked_fill_(A < math.exp(-2.0), 0.0)


def ar1_filter(S: torch.Tensor, g: float) -> torch.Tensor:
    """c_t = g c_{t-1} + s_t along the last axis, as a product with the
    lower-triangular Toeplitz matrix of g's powers, in blocks of frames
    with the carry passed on."""
    K, T = S.shape
    blk = min(T, 512)
    lag = (torch.arange(blk, device=S.device)[None, :]
           - torch.arange(blk, device=S.device)[:, None]).to(torch.float32)
    M = torch.where(lag >= 0, torch.exp(lag.clamp(min=0) * math.log(g)),
                    0.0)                                   # M[s, t]
    decay = torch.exp(torch.arange(1, blk + 1, device=S.device,
                                   dtype=torch.float32) * math.log(g))
    C = torch.empty_like(S)
    carry = torch.zeros((K,), device=S.device)
    for t0 in range(0, T, blk):
        n = min(blk, T - t0)
        C[:, t0:t0 + n] = S[:, t0:t0 + n] @ M[:n, :n] \
            + carry[:, None] * decay[None, :n]
        carry = C[:, t0 + n - 1]
    return C


def _drives(gen, n: int, T: int, tau_range, device) -> torch.Tensor:
    """``n`` slow drives: white noise smoothed by exponentials of time
    constants in ``tau_range`` frames ('same' convolution), each scaled to
    a maximum magnitude of 1."""
    Lk = min(200, T)
    tau = tau_range[0] + (tau_range[1] - tau_range[0]) * torch.rand(
        n, generator=gen, device=device)
    ker = torch.exp(-torch.arange(Lk, device=device,
                                  dtype=torch.float32)[None] / tau[:, None])
    x = torch.randn((1, n, T), generator=gen, device=device)
    full = F.conv1d(F.pad(x, (Lk - 1, Lk - 1)), ker.flip(-1)[:, None],
                    groups=n)[0]
    d = full[:, (Lk - 1) // 2:(Lk - 1) // 2 + T]
    return d / torch.clamp(d.abs().amax(dim=1, keepdim=True), min=1e-12)


def make_movie(gen, H: int, W: int, T: int, mv: dict, tr: dict, device):
    """Y (T, H, W) and its planted footprints (K, H, W) and traces
    (K, T)."""
    K = tr["K"]
    cy, cx = _centres(gen, K, H, W, tr, device)
    A = _footprints(gen, cy, cx, H, W, mv, device)
    lo, hi = tr["amplitude"]
    S = (torch.rand((K, T), generator=gen, device=device) < tr["spike_rate"]
         ) * (lo + (hi - lo) * torch.rand((K, T), generator=gen,
                                          device=device))
    C = ar1_filter(S.to(torch.float32), mv["g"])
    del S
    b0 = mv["baseline"] * (0.5 + _smooth_field(gen, H, W, max(H, W) / 2,
                                               device))
    n = mv["bg_modes"]
    profs = torch.stack([mv["bg_strength"] * _smooth_field(
        gen, H, W, max(H, W) / 3, device) for _ in range(n)]).reshape(n, -1)
    drives = _drives(gen, n, T, mv["bg_tau"], device)
    Y = (C.T @ A.reshape(K, -1)).reshape(T, H, W)
    Y += b0[None]
    blk = max(1, (1 << 28) // (H * W))
    for t0 in range(0, T, blk):
        t1 = min(t0 + blk, T)
        Y[t0:t1] += (drives[:, t0:t1].T @ profs).reshape(t1 - t0, H, W)
        Y[t0:t1] += mv["sn"] * torch.randn((t1 - t0, H, W), generator=gen,
                                           device=device)
    return Y, A, C


def make_start(gen, A: torch.Tensor, C: torch.Tensor, tr: dict
               ) -> Dict[str, torch.Tensor]:
    """The start state from the planted footprints and traces (consumed:
    A is scaled in place)."""
    K, T = C.shape
    st = tr["start"]
    dev = A.device
    lo, hi = st["scale"]
    scale = lo + (hi - lo) * torch.rand(K, generator=gen, device=dev)
    A *= scale[:, None, None]
    for k0 in range(0, K, 256):
        a = A[k0:k0 + 256]
        a *= 1 + st["A_noise"] * torch.randn(a.shape, generator=gen,
                                             device=dev)
        a.clamp_(min=0.0)
    C0 = C / scale[:, None] + st["C_noise"] * torch.randn(
        (K, T), generator=gen, device=dev)
    return {"A": A, "C": C0,
            "active": torch.ones(K, dtype=torch.bool, device=dev)}


def make_inputs(config: dict, traffic: dict, seed: int, device,
                reference) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """(Y, start, sn_pix) of a cell for ``seed``; ``reference`` is the
    plain reference's module, whose ring geometry and pixel noise the
    benchmark uses."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    H, W, T = config["H"], config["W"], config["T"]
    Y, A, C = make_movie(gen, H, W, T, config["movie"], traffic, device)
    start = make_start(gen, A, C, traffic)
    del A, C
    bg = config["params"]["background"]
    if bg["model"] == "ring":
        Hs, Ws, radius_s = reference.ssub_geometry(H, W, bg["ring_radius"],
                                                   bg["ssub"])
        start["w_old"], start["w0_old"] = reference.uniform_ring_weights(
            Hs, Ws, radius_s, device)
    sn_pix = reference.pixel_noise(Y)
    return Y, start, sn_pix


def check_sample(config: dict, traffic: dict, limits: dict, seed: int):
    """The traces whose deconvolution and the frames whose background the
    check compares, drawn from the seed: (rows, frames), sorted."""
    rng = np.random.default_rng(int(seed))
    K, T = traffic["K"], config["T"]
    rows = rng.choice(K, min(K, limits["sample_rows"]), replace=False)
    frames = rng.choice(T, min(T, limits["sample_frames"]), replace=False)
    return np.sort(rows), np.sort(frames)
