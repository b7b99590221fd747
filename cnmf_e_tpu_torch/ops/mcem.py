"""Monte-Carlo EM deconvolution with time-constant resampling (port of
``cnmf_e_tpu/ops/mcem.py``; reference
``ca_source_extraction/utilities/MCEM_foopsi.m``).

EM over every trace of the batch at once: the E-step is a Metropolis
random walk on the rise and decay time constants, each proposal
re-synthesizing the trace from the current spikes under the proposed
kernel (``MCEM_foopsi.m:58-122``); the M-step rebuilds g from the mean
sampled time constants and refits by constrained deconvolution, whose
AR(1) solves run through the OASIS solve entry. Out-of-range proposals
are rejected, as in the JAX package.

The proposals and acceptance draws of one E-step come from a seeded CPU
``torch.Generator`` in one draw and one upload, so the card and the CPU
make the same draws; they are not the JAX package's (``jax.random``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops.ar import ar2exp, exp2ar
from cnmf_e_tpu_torch.ops.mcmc import conv_rows


def _exp_filt(s: torch.Tensor, g: torch.Tensor, L: int) -> torch.Tensor:
    """Causal exponential filter sum_{k < L} g^k s[t - k] per trace."""
    k = torch.arange(L, dtype=s.dtype, device=s.device)
    return conv_rows(s, torch.clamp(g, min=1e-6)[:, None] ** k[None])


def _synth(s, b, tau1, tau2, p, L):
    """The trace of the spikes under the kernel of (tau1, tau2)
    (``MCEM_foopsi.m:66-73``)."""
    g2 = torch.exp(-1.0 / torch.clamp(tau2, min=1e-3))
    if p == 1:
        return _exp_filt(s, g2, L) + b[:, None]
    g1 = torch.exp(-1.0 / torch.clamp(tau1, min=1e-3))
    h = torch.clamp(g2 - g1, min=1e-4)
    c = (g2[:, None] * _exp_filt(s, g2, L)
         - g1[:, None] * _exp_filt(s, g1, L)) / h[:, None]
    return c + b[:, None]


def _mcem_block(y, s, b, tau1, tau2, sn, gen: torch.Generator, p: int,
                n_inner: int, L: int):
    """One E-step: ``n_inner`` MH sweeps over (tau1, tau2). Returns the
    mean sampled (tau1, tau2) and the accepted-move counts."""
    N = y.shape[0]
    dev = y.device
    inv = 1.0 / torch.clamp(2.0 * sn * sn, min=1e-12)
    tau_max = 2.0 * tau2
    Z = torch.randn((n_inner, 2, N), generator=gen).to(dev)
    U = torch.rand((n_inner, 2, N), generator=gen).to(dev)

    def neg_rss(t1, t2):
        r = y - _synth(s, b, t1, t2, p, L)
        return -(r * r).sum(dim=-1)

    t1, t2 = tau1, tau2
    acc = torch.zeros(N, dtype=torch.int32, device=dev)
    sum1 = torch.zeros_like(t1)
    sum2 = torch.zeros_like(t2)
    for i in range(n_inner):
        logC = neg_rss(t1, t2)
        if p >= 2:
            # rise-time move (MCEM_foopsi.m:58-85), std max(tau1 / 5, 0.2)
            t1p = t1 + torch.clamp(t1 / 5.0, min=0.2) * Z[i, 0]
            ok1 = (t1p > 0) & (t1p < t2)
            logC1 = neg_rss(torch.where(ok1, t1p, t1), t2)
            take1 = ok1 & (torch.log(U[i, 0] + 1e-12) < (logC1 - logC) * inv)
            t1 = torch.where(take1, t1p, t1)
            logC = torch.where(take1, logC1, logC)
            acc = acc + take1
        # decay-time move (MCEM_foopsi.m:90-122), std min(tau2 / 10, 2)
        t2p = t2 + torch.clamp(t2 / 10.0, max=2.0) * Z[i, 1]
        ok2 = (t2p > t1) & (t2p < tau_max)
        logC2 = neg_rss(t1, torch.where(ok2, t2p, t2))
        take2 = ok2 & (torch.log(U[i, 1] + 1e-12) < (logC2 - logC) * inv)
        t2 = torch.where(take2, t2p, t2)
        acc = acc + take2
        sum1 = sum1 + t1
        sum2 = sum2 + t2
    return sum1 / n_inner, sum2 / n_inner, acc


def mcem_foopsi(y: torch.Tensor, params: DeconvParams,
                sn: Optional[torch.Tensor] = None,
                g: Optional[torch.Tensor] = None, seed: int = 0,
                n_em: int = 4, n_inner: int = 25, L: int = 200):
    """Batched MCEM deconvolution. y: (..., T). Returns a DeconvResult
    whose g holds the EM-refined AR coefficients."""
    from cnmf_e_tpu_torch.ops.oasis import DeconvResult, deconvolve

    batch = y.shape[:-1]
    yf = y.reshape(-1, y.shape[-1])
    L = min(L, yf.shape[1])
    p = 1 if params.model == "ar1" else 2
    inner = dataclasses.replace(params, method="constrained")
    gen = torch.Generator().manual_seed(seed)

    res = deconvolve(yf, inner, sn=sn, g=g)
    sn_use = (sn.reshape(-1) if sn is not None
              else torch.clamp((yf - res.c).std(dim=-1, correction=0),
                               min=1e-6))
    for _ in range(n_em):
        if p == 1:
            tau2 = -1.0 / torch.log(torch.clamp(res.g[:, 0], 1e-4, 1 - 1e-6))
            tau1 = torch.zeros_like(tau2)
        else:
            d, r = ar2exp(res.g)
            tau2 = -1.0 / torch.log(torch.clamp(d, 1e-4, 1 - 1e-6))
            tau1 = -1.0 / torch.log(torch.clamp(r, 1e-4, 1 - 1e-6))
        t1m, t2m, _ = _mcem_block(yf, res.s, res.b, tau1, tau2, sn_use, gen,
                                  p, n_inner, L)
        # M-step: g from the mean sampled taus, then a constrained refit
        if p == 1:
            g_new = torch.exp(-1.0 / torch.clamp(t2m, min=1e-3))[:, None]
        else:
            g_new = exp2ar(torch.exp(-1.0 / torch.clamp(t2m, min=1e-3)),
                           torch.exp(-1.0 / torch.clamp(t1m, min=1e-3)))
        res = deconvolve(yf, inner, sn=sn, g=g_new)
    return DeconvResult(
        c=res.c.reshape(y.shape), s=res.s.reshape(y.shape),
        b=res.b.reshape(batch), g=res.g,
        lam=res.lam.reshape(batch) if res.lam.ndim else res.lam,
        smin=res.smin.reshape(batch) if res.smin.ndim else res.smin)
