"""OASIS spike deconvolution for AR(1) dynamics and the deconvolution
dispatch (port of ``cnmf_e_tpu/ops/oasis.py``).

Per trace: min_c 1/2 ||c - y||^2 + lam ||s||_1 with s_t = c_t - g c_{t-1}
either 0 or >= smin and c >= 0, solved by pool merging
(``oasisAR1.m:59-109``). Every T runs the exact two-pass divide-and-conquer
solve of :mod:`cnmf_e_tpu_torch.ops.oasis_kernels`: the JAX package's
overlap-windowed approximation for T > 2304 exists only to fit the TPU's
scoped VMEM and is not ported.

The AR(1) method family (``foopsi_oasisAR1.m``, ``constrained_oasisAR1.m``,
``thresholded_oasisAR1.m``, the g search of ``update_g``) runs every
solve through :func:`oasis_ar1`, so each bisection or search step is one
call of the solve entry with a lam or smin per trace. :func:`deconvolve`
dispatches like ``deconvolveCa.m:108-197``: AR(2) and exp2 to the
windowed NNLS of :mod:`cnmf_e_tpu_torch.ops.onnls`, ``mcem`` and
``mcmc`` to :mod:`cnmf_e_tpu_torch.ops.mcem` and
:mod:`cnmf_e_tpu_torch.ops.mcmc`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops.ar import choose_smin, estimate_time_constant
from cnmf_e_tpu_torch.ops.noise import estimate_noise
from cnmf_e_tpu_torch.ops.onnls import (baseline0, causal_conv,
                                        golden_section, onnls_deconvolve,
                                        onnls_kernel, rss)
from cnmf_e_tpu_torch.ops.oasis_kernels import oasis_solve


class DeconvResult(NamedTuple):
    c: torch.Tensor      # denoised traces
    s: torch.Tensor      # spike trains
    b: torch.Tensor      # baselines
    g: torch.Tensor      # AR coefficients (..., p); the kernel (L,)
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


def _zeros(batch, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(batch, dtype=like.dtype, device=like.device)


def constrained_ar1(y: torch.Tensor, g: torch.Tensor,
                    sn: Optional[torch.Tensor] = None, optimize_b: bool = True,
                    n_bisect: int = 20, chunk: int = 128) -> DeconvResult:
    """Noise-constrained deconvolution (``constrained_oasisAR1.m:83-113``):
    lambda bisected in [0, lam_max] so that RSS = sn^2 T, the baseline
    re-estimated after each step; a trace whose lam = 0 fit already
    exceeds the budget keeps lam = 0."""
    batch = y.shape[:-1]
    T = y.shape[-1]
    if sn is None:
        sn = estimate_noise(y, "psd")
    g = _g1(torch.as_tensor(g, dtype=y.dtype, device=y.device), batch)
    thresh = sn * sn * T
    b = baseline0(y, optimize_b)

    def rss_of(lam, b):
        c, s = oasis_ar1(y - b[..., None], g, lam, 0.0, chunk=chunk)
        return rss(y - b[..., None], c), c, s

    rss0, c0, s0 = rss_of(_zeros(batch, y), b)
    lo = _zeros(batch, y)
    hi = torch.clamp(y.abs().amax(dim=-1), min=1.0) * 2.0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        rss_mid, c, _ = rss_of(mid, b)
        too_smooth = rss_mid > thresh
        lo = torch.where(too_smooth, lo, mid)
        hi = torch.where(too_smooth, mid, hi)
        if optimize_b:
            b = (y - c).mean(dim=-1)
    c, s = oasis_ar1(y - b[..., None], g, lo, 0.0, chunk=chunk)
    done0 = rss0 >= thresh
    c = torch.where(done0[..., None], c0, c)
    s = torch.where(done0[..., None], s0, s)
    return DeconvResult(c, s, b, g[..., None], torch.where(done0, 0.0, lo),
                        _zeros(batch, y))


def thresholded_ar1(y: torch.Tensor, g: torch.Tensor,
                    sn: Optional[torch.Tensor] = None,
                    optimize_b: bool = True, thresh_factor: float = 1.0,
                    p_noise: float = 0.9999, n_search: int = 10,
                    chunk: int = 128) -> DeconvResult:
    """Hard-threshold deconvolution (``thresholded_oasisAR1.m:79-140``):
    smin = m * choose_smin(g, sn, p_noise) with the multiplier m bisected
    in [0.5, 8] so that the RSS approaches ``thresh_factor * sn^2 T``."""
    batch = y.shape[:-1]
    T = y.shape[-1]
    if sn is None:
        sn = estimate_noise(y, "psd")
    g1 = _g1(torch.as_tensor(g, dtype=y.dtype, device=y.device), batch)
    thresh = thresh_factor * sn * sn * T
    smin0 = choose_smin(g1[..., None], sn, p_noise)
    b = baseline0(y, optimize_b)
    lo = torch.full(batch, 0.5, dtype=y.dtype, device=y.device)
    hi = torch.full(batch, 8.0, dtype=y.dtype, device=y.device)
    for _ in range(n_search):
        mid = 0.5 * (lo + hi)
        c, _ = oasis_ar1(y - b[..., None], g1, 0.0, mid * smin0, chunk=chunk)
        too_sparse = rss(y - b[..., None], c) > thresh
        lo = torch.where(too_sparse, lo, mid)
        hi = torch.where(too_sparse, mid, hi)
        if optimize_b:
            b = (y - c).mean(dim=-1)
    smin = lo * smin0
    c, s = oasis_ar1(y - b[..., None], g1, 0.0, smin, chunk=chunk)
    return DeconvResult(c, s, b, g1[..., None], _zeros(batch, y), smin)


def optimize_g(y: torch.Tensor, g0: torch.Tensor, lam=0.0, smin=0.0,
               sn: Optional[torch.Tensor] = None,
               g_range: Tuple[float, float] = (0.5, 0.99),
               n_iter: int = 12, chunk: int = 128
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The AR(1) coefficient per trace that minimizes the deconvolution's
    RSS (the role of ``update_g`` in ``foopsi_oasisAR1.m:120-179``): a
    13-point grid over ``g_range``, then ``n_iter`` golden-section steps in
    the best grid bracket, each point a full OASIS solve. ``g0`` is
    accepted for the JAX signature and not read. Returns (g, c, s)."""
    batch = y.shape[:-1]
    smin_arr = torch.broadcast_to(
        torch.as_tensor(smin, dtype=y.dtype, device=y.device), batch)
    if sn is not None:
        smin_arr = torch.where(smin_arr < 0, smin_arr.abs() * sn, smin_arr)
    def rss_at(g):
        c, _ = oasis_ar1(y, g, lam, smin_arr, chunk=chunk)
        return rss(y, c)

    n_grid = 13
    grid = torch.linspace(g_range[0], g_range[1], n_grid, dtype=y.dtype)
    rss_grid = torch.stack([rss_at(torch.full(batch, float(gv),
                                              dtype=y.dtype, device=y.device))
                            for gv in grid])
    best = torch.argmin(rss_grid, dim=0).to(y.dtype)
    step = (g_range[1] - g_range[0]) / (n_grid - 1)
    lo = torch.clamp(float(grid[0]) + (best - 1) * step, min=g_range[0])
    hi = torch.clamp(float(grid[0]) + (best + 1) * step, max=g_range[1])
    g = golden_section(rss_at, lo, hi, n_iter)
    c, s = oasis_ar1(y, g, lam, smin_arr, chunk=chunk)
    return g, c, s


def deconvolve(y: torch.Tensor, params: DeconvParams,
               sn: Optional[torch.Tensor] = None,
               g: Optional[torch.Tensor] = None) -> DeconvResult:
    """Deconvolution entry point (``deconvolveCa.m``). y: (..., T) raw
    traces. Estimates sn (``params.sn_method``) and, for ar1/ar2, the AR
    coefficients when not given, clamps an AR(1) g into
    exp(-1/tau_range), then dispatches on ``params.model`` and
    ``params.method`` as the JAX package does: mcem first, then ar2/exp2
    (windowed NNLS, every method), kernel (g holds the kernel), and for
    ar1 mcmc, foopsi, constrained or thresholded."""
    if sn is None:
        sn = estimate_noise(y, params.sn_method)
    if params.model in ("ar1", "ar2"):
        p = 1 if params.model == "ar1" else 2
        if g is None:
            g = estimate_time_constant(y, p=p, sn=sn, lags=params.ar_lags,
                                       fudge_factor=params.fudge_factor,
                                       g_range=params.g_range)
        if params.tau_range is not None and p == 1:
            g_lo = float(torch.exp(torch.tensor(-1.0 / params.tau_range[0])))
            g_hi = float(torch.exp(torch.tensor(-1.0 / params.tau_range[1])))
            g = torch.clamp(g, g_lo, g_hi)
    if params.method == "mcem":
        from cnmf_e_tpu_torch.ops.mcem import mcem_foopsi
        return mcem_foopsi(y, params, sn=sn, g=g)
    if params.model in ("ar2", "exp2"):
        return onnls_deconvolve(y, g, sn, params)
    batch = y.shape[:-1]
    if params.model == "kernel":
        if g is None:
            raise ValueError("the kernel model needs the kernel as g")
        h = torch.as_tensor(g, dtype=y.dtype, device=y.device).reshape(-1)
        b = baseline0(y, params.optimize_b)
        c, s = onnls_kernel(y - b[..., None], h, lam=params.lam)
        if params.optimize_b:
            b = b + (y - b[..., None] - c).mean(dim=-1)
            c, s = onnls_kernel(y - b[..., None], h, lam=params.lam)
        if params.smin != 0:
            floor = ((abs(params.smin) * sn)[..., None] if params.smin < 0
                     else params.smin)
            s = torch.where(s >= floor, s, 0.0)
            c = causal_conv(s, h)
        return DeconvResult(
            c, s, b, h, torch.full(batch, params.lam, dtype=y.dtype,
                                   device=y.device),
            torch.full(batch, params.smin, dtype=y.dtype, device=y.device))
    if params.model != "ar1":
        raise NotImplementedError(f"model {params.model!r}")
    ck = params.fast_chunk
    if params.method == "mcmc":
        from cnmf_e_tpu_torch.ops.mcmc import mcmc_spikes
        yf = y.reshape(-1, y.shape[-1])
        res = mcmc_spikes(yf, _g1(g, (yf.shape[0],)), sn.reshape(-1))
        return DeconvResult(
            c=res.c_mean.reshape(y.shape), s=res.spike_mean.reshape(y.shape),
            b=res.b_mean.reshape(batch), g=g, lam=_zeros(batch, y),
            smin=_zeros(batch, y))
    if params.method == "foopsi":
        return foopsi_ar1(y, g, lam=params.lam, smin=params.smin, sn=sn,
                          optimize_b=params.optimize_b,
                          max_iter=params.max_iter, chunk=ck)
    if params.method == "constrained":
        return constrained_ar1(y, g, sn=sn, optimize_b=params.optimize_b,
                               chunk=ck)
    if params.method == "thresholded":
        return thresholded_ar1(y, g, sn=sn, optimize_b=params.optimize_b,
                               thresh_factor=params.thresh_factor,
                               p_noise=params.p_noise, chunk=ck)
    raise ValueError(f"unknown method {params.method!r}")
