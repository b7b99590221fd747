"""AR(p) calcium-dynamics estimation and kernel conversions (port of
``cnmf_e_tpu/ops/ar.py``; reference ``estimate_time_constant.m:36-50``,
``ar2exp.m``, ``exp2kernel.m``, ``make_G_matrix.m`` and
``choose_smin.m``).

Everything works along the last axis, batched over the leading ones. The
unstable AR(2) roots are clamped deterministically, as in the JAX
package, where the reference jitters them with ``randn``.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Optional, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.ops.noise import noise_psd


def autocovariance(y: torch.Tensor, max_lag: int) -> torch.Tensor:
    """Biased autocovariance for lags 0..max_lag along the last axis."""
    T = y.shape[-1]
    yc = y - y.mean(dim=-1, keepdim=True)
    n = T - max_lag
    b = yc[..., :n]
    return torch.stack([(yc[..., k:k + n] * b).sum(dim=-1) / T
                        for k in range(max_lag + 1)], dim=-1)


def estimate_time_constant(y: torch.Tensor, p: int = 1,
                           sn: Optional[torch.Tensor] = None, lags: int = 5,
                           fudge_factor: float = 1.0,
                           g_range: Tuple[float, float] = (0.05, 0.998)
                           ) -> torch.Tensor:
    """AR(p) coefficients per trace, shape (..., p), p in {1, 2}: the
    noise-corrected Yule-Walker least-squares fit (``sn^2`` off the lag-0
    diagonal), with the AR roots clamped into ``g_range`` (non-finite
    roots become 0.8, and 0.3 for the second AR(2) root)."""
    if p not in (1, 2):
        raise NotImplementedError("p must be 1 or 2")
    if sn is None:
        sn = noise_psd(y)
    L = lags + p
    g_lo, g_hi = g_range
    if p == 1:
        xc = autocovariance(y, L)                      # (..., L+1)
        # the (L x 1) Toeplitz column xc[0..L-1] with sn^2 off lag 0
        a = xc[..., :L].clone()
        a[..., 0] = a[..., 0] - sn ** 2
        b = xc[..., 1:L + 1]
        g = (a * b).sum(dim=-1) / ((a * a).sum(dim=-1) + 1e-12)
        r = torch.clamp(g, g_lo, g_hi)
        r = torch.where(torch.isfinite(r), r, 0.8)
        return (fudge_factor * r)[..., None]
    # The 2x2 normal equations are ill-conditioned for slow dynamics: in
    # float32 the JAX package's g lies ~1e-4 from the exact one, and two
    # float32 summation orders ~1e-3 apart. They are built and solved in
    # float64 here, so the port returns the exact fit rounded to float32.
    xc = autocovariance(y.to(torch.float64), L)
    sn2 = torch.as_tensor(sn, device=y.device).to(torch.float64) ** 2
    # A[i, j] = xc[|i - j|] - sn^2 (i == j), i < L, j < 2
    i = np.arange(L)[:, None]
    j = np.arange(p)[None, :]
    A = xc[..., torch.as_tensor(np.abs(i - j), device=y.device)]
    A = A - sn2[..., None, None] * torch.as_tensor(
        (i == j).astype(np.float64), device=y.device)
    b = xc[..., 1:L + 1]
    AtA = torch.einsum("...lp,...lq->...pq", A, A)
    Atb = torch.einsum("...lp,...l->...p", A, b)
    g = torch.linalg.solve(
        AtA + 1e-12 * torch.eye(p, dtype=A.dtype, device=y.device),
        Atb[..., None])[..., 0].to(y.dtype)
    g1, g2 = g[..., 0], g[..., 1]
    disc = g1 * g1 + 4.0 * g2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = (g1 + sq) / 2.0
    r2 = (g1 - sq) / 2.0
    # complex roots: their real part (a deterministic variant of the
    # reference's jitter)
    r1 = torch.where(disc < 0, g1 / 2.0, r1)
    r2 = torch.where(disc < 0, g1 / 2.0 * 0.5, r2)

    def clamp(r):
        return torch.where(r > 1.0, g_hi, torch.where(r < 0.0, g_lo, r))
    r1, r2 = clamp(r1), clamp(r2)
    r1 = fudge_factor * torch.where(torch.isfinite(r1), r1, 0.8)
    r2 = fudge_factor * torch.where(torch.isfinite(r2), r2, 0.3)
    return torch.stack([r1 + r2, -r1 * r2], dim=-1)


def ar2exp(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """AR(2) coefficients -> (decay d, rise r), the roots of
    z^2 - g1 z - g2 with d >= r (``ar2exp.m``)."""
    g1, g2 = g[..., 0], g[..., 1]
    sq = torch.sqrt(torch.clamp(g1 * g1 + 4.0 * g2, min=1e-12))
    return (g1 + sq) / 2.0, (g1 - sq) / 2.0


def exp2ar(d: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(decay, rise) factors -> AR(2) coefficients [d + r, -d r]."""
    return torch.stack([d + r, -d * r], dim=-1)


def ar_kernel(g: torch.Tensor, T: int) -> torch.Tensor:
    """Impulse response of the AR model, length T, batched over the
    leading dims: g^t for AR(1), (d^(t+1) - r^(t+1)) / (d - r) for
    AR(2)."""
    t = torch.arange(T, dtype=torch.promote_types(g.dtype, torch.float32),
                     device=g.device)
    if g.shape[-1] == 1:
        return g[..., 0:1] ** t
    d, r = ar2exp(g)
    dd = torch.clamp(d - r, min=1e-10)
    return (d[..., None] ** (t + 1) - r[..., None] ** (t + 1)) / dd[..., None]


def exp2kernel(tau_d: torch.Tensor, tau_r: torch.Tensor,
               T: int) -> torch.Tensor:
    """Difference-of-exponentials kernel from continuous time constants
    (frames), scaled to a unit maximum (``exp2kernel.m``)."""
    t = torch.arange(T, dtype=torch.float32, device=tau_d.device)
    h = torch.exp(-t / tau_d[..., None]) - torch.exp(-t / tau_r[..., None])
    return h / torch.clamp(h.amax(dim=-1, keepdim=True), min=1e-12)


def make_G_matrix(T: int, g: torch.Tensor) -> torch.Tensor:
    """The AR-difference matrix G with G c = s (``make_G_matrix.m``),
    dense (T, T): 1 on the diagonal and -g_j on the j-th subdiagonal."""
    g = torch.atleast_1d(torch.as_tensor(g, dtype=torch.float32))
    G = torch.eye(T, dtype=torch.float32, device=g.device)
    for j in range(g.shape[0]):
        G = G + torch.diag((-g[j]).expand(T - j - 1), -j - 1)
    return G


def choose_smin(g: torch.Tensor, sn: torch.Tensor,
                prob: float = 0.99999) -> torch.Tensor:
    """Spike-size floor below which pure noise yields a zero solution with
    probability ``prob``: sn / ||h|| * Phi^-1(prob), with ||h||^2 =
    1 / (1 - g^2) for AR(1) and the sum of the squared AR(2) kernel over
    1000 samples."""
    if g.shape[-1] == 1:
        hnorm = torch.sqrt(1.0 / torch.clamp(1.0 - g[..., 0] ** 2, min=1e-8))
    else:
        h = ar_kernel(g, 1000)
        hnorm = torch.sqrt((h * h).sum(dim=-1))
    return sn / hnorm * NormalDist().inv_cdf(prob)
