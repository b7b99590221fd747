"""Event detection and temporal decorrelation (port of
``cnmf_e_tpu/ops/spikes.py``; reference ``Sources2D.m:1774-1793`` and
``decorrTemporal.m``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.ops.ar import ar_kernel
from cnmf_e_tpu_torch.ops.mcmc import conv_rows
from cnmf_e_tpu_torch.parallel import comm

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
                    kernel_len: int = 500, mesh=None) -> torch.Tensor:
    """Reduce temporal crosstalk between neighbouring neurons
    (``decorrTemporal.m``): a spike is zeroed where, in noise units, a
    neuron whose centre lies within gSiz of this one's spikes higher at
    that time; the surviving spikes are convolved with each neuron's AR
    kernel. C/S: (K, T); A: (K, H, W); g: (K, p). Returns the new C.

    ``mesh``: C, S, g and ``neuron_sn`` are this patch rank's whole
    traces (``comm.traces_to_neurons``' rows of K) and A its rows of all
    K footprints; the centres take A's moments summed over 'patch', the
    neighbours' spikes and noise are gathered over 'patch', and the new
    C is the rank's traces."""
    K, H, W = A.shape
    T = S.shape[1]
    y0 = 0 if mesh is None else mesh.p * H
    yy = torch.arange(y0, y0 + H, dtype=A.dtype,
                      device=A.device)[None, :, None]
    xx = torch.arange(W, dtype=A.dtype, device=A.device)[None, None, :]
    mom = comm.psum(torch.stack([A.sum(dim=(1, 2)),
                                 (A * yy).sum(dim=(1, 2)),
                                 (A * xx).sum(dim=(1, 2))]), mesh, "patch")
    mass = mom[0] + 1e-12
    cy = mom[1] / mass
    cx = mom[2] / mass
    k0, k1 = (0, K) if mesh is None else mesh.neurons(K)
    dist = torch.sqrt((cy[k0:k1, None] - cy[None]) ** 2
                      + (cx[k0:k1, None] - cx[None]) ** 2)
    neigh = dist < gSiz                                   # (k, K), self too
    Sn = S / torch.clamp(neuron_sn, min=1e-12)[:, None]
    Sn_all = Sn if mesh is None else comm.all_gather_cat(
        S, 0, mesh.patch_group) / torch.clamp(comm.all_gather_cat(
            neuron_sn, 0, mesh.patch_group), min=1e-12)[:, None]
    # per neuron and time, the largest normalized spike of its neighbours,
    # in row chunks of at most _CHUNK elements of the (k, K, T) product
    k = Sn.shape[0]
    kc = max(1, _CHUNK // max(K * T, 1))
    neigh_max = torch.cat([
        torch.where(neigh[i0:i0 + kc, :, None], Sn_all[None], -torch.inf
                    ).amax(dim=1) for i0 in range(0, k, kc)]) if k else Sn
    dominated = Sn < neigh_max
    if wd > 1:
        x = F.pad(dominated.to(Sn.dtype)[:, None], (wd // 2, wd - 1 - wd // 2))
        dominated = F.conv1d(x, torch.ones((1, 1, wd), dtype=Sn.dtype,
                                           device=Sn.device))[:, 0] > 0
    S_kept = torch.where(dominated, 0.0, S)
    return conv_rows(S_kept, ar_kernel(g, min(kernel_len, T)))
