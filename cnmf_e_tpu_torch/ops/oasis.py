"""OASIS spike deconvolution for AR(1) dynamics (port of the AR(1) foopsi
path of ``cnmf_e_tpu/ops/oasis.py``).

Per trace: min_c 1/2 ||c - y||^2 + lam ||s||_1 with s_t = c_t - g c_{t-1}
either 0 or >= smin and c >= 0, solved by pool merging
(``oasisAR1.m:59-109``). Every T runs the exact two-pass divide-and-conquer
solve of :mod:`cnmf_e_tpu_torch.ops.oasis_kernels`: the JAX package's
overlap-windowed approximation for T > 2304 exists only to fit the TPU's
scoped VMEM and is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops.ar import estimate_time_constant
from cnmf_e_tpu_torch.ops.noise import estimate_noise
from cnmf_e_tpu_torch.ops.oasis_kernels import oasis_solve


class DeconvResult(NamedTuple):
    c: torch.Tensor      # denoised traces
    s: torch.Tensor      # spike trains
    b: torch.Tensor      # baselines
    g: torch.Tensor      # AR coefficients, (..., 1)
    lam: torch.Tensor
    smin: torch.Tensor


def _per_trace(x, batch, like: torch.Tensor) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.broadcast_to(x, batch).reshape(-1).contiguous()


def chunk_length(chunk: int) -> int:
    """The chunk length L that :func:`oasis_ar1` runs for ``chunk``."""
    return chunk if chunk > 0 else 128


def oasis_ar1(y: torch.Tensor, g, lam=0.0, smin=0.0,
              chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched exact OASIS AR(1). y: (..., T); g/lam/smin scalars or
    (...,). Returns (c, s) shaped like y.

    Chunk-local pool stacks (pass 1), then a pool-granularity merge across
    chunk seams (pass 2), then the pools -> trace reconstruction, in one
    call on the card (:func:`oasis_solve`). Merging is confluent, so the
    result is that of the sequential algorithm."""
    batch = y.shape[:-1]
    T = y.shape[-1]
    yf = y.reshape(-1, T).to(torch.float32).contiguous()
    if yf.shape[0] == 0:
        return y.clone(), torch.zeros_like(y)
    g, lam, smin = (_per_trace(x, batch, yf) for x in (g, lam, smin))
    c, s = oasis_solve(yf, g, lam, smin, chunk_length(chunk))
    return c.reshape(y.shape), s.reshape(y.shape)


def _g1(g: torch.Tensor, batch) -> torch.Tensor:
    """AR(1) coefficient per trace, shape ``batch``."""
    if g.ndim > len(batch):
        g = g[..., 0]
    return torch.broadcast_to(g, batch)


def foopsi_ar1(y: torch.Tensor, g: torch.Tensor, lam=0.0, smin=0.0,
               sn: Optional[torch.Tensor] = None, optimize_b: bool = False,
               max_iter: int = 10, chunk: int = 128) -> DeconvResult:
    """FOOPSI via OASIS (``foopsi_oasisAR1.m``). ``smin < 0`` means
    ``|smin| * sn``; ``optimize_b`` alternates the baseline
    b = mean(y - c) with re-deconvolution ``max_iter`` times."""
    batch = y.shape[:-1]
    if sn is None:
        sn = estimate_noise(y, "psd")
    g = _g1(torch.as_tensor(g, dtype=y.dtype, device=y.device), batch)
    smin_arr = torch.broadcast_to(
        torch.as_tensor(smin, dtype=y.dtype, device=y.device), batch)
    smin_arr = torch.where(smin_arr < 0, smin_arr.abs() * sn, smin_arr)
    lam_arr = torch.broadcast_to(
        torch.as_tensor(lam, dtype=y.dtype, device=y.device), batch)
    if not optimize_b:
        c, s = oasis_ar1(y, g, lam_arr, smin_arr, chunk=chunk)
        b = torch.zeros(batch, dtype=y.dtype, device=y.device)
        return DeconvResult(c, s, b, g[..., None], lam_arr, smin_arr)
    b = torch.quantile(y, 0.15, dim=-1)
    c = s = torch.zeros_like(y)
    for _ in range(max_iter):
        c, s = oasis_ar1(y - b[..., None], g, lam_arr, smin_arr, chunk=chunk)
        b = (y - c).mean(dim=-1)
    return DeconvResult(c, s, b, g[..., None], lam_arr, smin_arr)


def deconvolve(y: torch.Tensor, params: DeconvParams,
               sn: Optional[torch.Tensor] = None,
               g: Optional[torch.Tensor] = None) -> DeconvResult:
    """Deconvolution entry point (``deconvolveCa.m``) for model "ar1",
    method "foopsi": estimates sn and g when not given, clamps g into
    exp(-1/tau_range), then runs :func:`foopsi_ar1`."""
    if params.model != "ar1" or params.method != "foopsi":
        raise NotImplementedError(
            f"deconvolution {params.model}/{params.method} is not ported")
    if sn is None:
        sn = estimate_noise(y, params.sn_method)
    if g is None:
        g = estimate_time_constant(y, p=1, sn=sn, lags=params.ar_lags,
                                   fudge_factor=params.fudge_factor,
                                   g_range=params.g_range)
    if params.tau_range is not None:
        g_lo = float(torch.exp(torch.tensor(-1.0 / params.tau_range[0])))
        g_hi = float(torch.exp(torch.tensor(-1.0 / params.tau_range[1])))
        g = torch.clamp(g, g_lo, g_hi)
    return foopsi_ar1(y, g, lam=params.lam, smin=params.smin, sn=sn,
                      optimize_b=params.optimize_b,
                      max_iter=params.max_iter, chunk=params.fast_chunk)
