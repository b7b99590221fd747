"""Event detection and temporal decorrelation (port of
``cnmf_e_tpu/ops/spikes.py``; reference ``Sources2D.m:1774-1793`` and
``decorrTemporal.m``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.ops.ar import ar_kernel
from cnmf_e_tpu_torch.ops.mcmc import conv_rows

_CHUNK = 1 << 24


def event_detection(C: torch.Tensor, neuron_sn: torch.Tensor,
                    sig: float = 5.0, window: int = 10) -> torch.Tensor:
    """Local-maximum events of traces C (K, T): samples that are the
    maximum of their ``window``-wide neighbourhood and exceed its minimum
    by ``sig * sn``; other samples are 0."""
    w = max(int(window), 1)
    pad = (w // 2, w - 1 - w // 2)
    neg = torch.finfo(C.dtype).min
    Emax = F.max_pool1d(F.pad(C[None], pad, value=neg), w, stride=1)[0]
    Emin = -F.max_pool1d(F.pad(-C[None], pad, value=neg), w, stride=1)[0]
    E = torch.where(C >= Emax, C, 0.0)
    return torch.where(C - Emin >= sig * neuron_sn[:, None], E, 0.0)


def decorr_temporal(C: torch.Tensor, S: torch.Tensor, A: torch.Tensor,
                    g: torch.Tensor, neuron_sn: torch.Tensor,
                    gSiz: float = 13.0, wd: int = 1,
                    kernel_len: int = 500) -> torch.Tensor:
    """Reduce temporal crosstalk between neighbouring neurons
    (``decorrTemporal.m``): a spike is zeroed where, in noise units, a
    neuron whose centre lies within gSiz of this one's spikes higher at
    that time; the surviving spikes are convolved with each neuron's AR
    kernel. C/S: (K, T); A: (K, H, W); g: (K, p). Returns the new C."""
    K, T = S.shape
    H, W = A.shape[1:]
    yy = torch.arange(H, dtype=A.dtype, device=A.device)[None, :, None]
    xx = torch.arange(W, dtype=A.dtype, device=A.device)[None, None, :]
    mass = A.sum(dim=(1, 2)) + 1e-12
    cy = (A * yy).sum(dim=(1, 2)) / mass
    cx = (A * xx).sum(dim=(1, 2)) / mass
    dist = torch.sqrt((cy[:, None] - cy[None]) ** 2
                      + (cx[:, None] - cx[None]) ** 2)
    neigh = dist < gSiz                                   # (K, K), self too
    Sn = S / torch.clamp(neuron_sn, min=1e-12)[:, None]
    # per neuron and time, the largest normalized spike of its neighbours,
    # in row chunks of at most _CHUNK elements of the (K, K, T) product
    kc = max(1, _CHUNK // max(K * T, 1))
    neigh_max = torch.cat([
        torch.where(neigh[k0:k0 + kc, :, None], Sn[None], -torch.inf
                    ).amax(dim=1) for k0 in range(0, K, kc)]) if K else Sn
    dominated = Sn < neigh_max
    if wd > 1:
        x = F.pad(dominated.to(Sn.dtype)[:, None], (wd // 2, wd - 1 - wd // 2))
        dominated = F.conv1d(x, torch.ones((1, 1, wd), dtype=Sn.dtype,
                                           device=Sn.device))[:, 0] > 0
    S_kept = torch.where(dominated, 0.0, S)
    return conv_rows(S_kept, ar_kernel(g, min(kernel_len, T)))
