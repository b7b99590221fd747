"""AR(1) calcium-dynamics estimation (port of the AR(1) part of
``cnmf_e_tpu/ops/ar.py``; reference ``estimate_time_constant.m:36-50`` and
``choose_smin.m``)."""

from __future__ import annotations

from statistics import NormalDist
from typing import Optional, Tuple

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
    """AR(1) coefficient per trace, shape (..., 1): the noise-corrected
    Yule-Walker least-squares fit, clamped into ``g_range`` (non-finite
    fits become 0.8)."""
    if p != 1:
        raise NotImplementedError("only AR(1) is ported")
    if sn is None:
        sn = noise_psd(y)
    L = lags + p
    xc = autocovariance(y, L)                          # (..., L+1)
    # the (L x 1) Toeplitz column xc[0..L-1] with sn^2 off the lag-0 entry
    a = xc[..., :L].clone()
    a[..., 0] = a[..., 0] - sn ** 2
    b = xc[..., 1:L + 1]
    g = (a * b).sum(dim=-1) / ((a * a).sum(dim=-1) + 1e-12)
    r = torch.clamp(g, g_range[0], g_range[1])
    r = torch.where(torch.isfinite(r), r, 0.8)
    return (fudge_factor * r)[..., None]


def choose_smin(g: torch.Tensor, sn: torch.Tensor,
                prob: float = 0.99999) -> torch.Tensor:
    """Spike-size floor below which pure noise yields a zero solution with
    probability ``prob``, for AR(1): sn / ||h|| * Phi^-1(prob)."""
    hnorm = torch.sqrt(1.0 / torch.clamp(1.0 - g[..., 0] ** 2, min=1e-8))
    return sn / hnorm * NormalDist().inv_cdf(prob)
