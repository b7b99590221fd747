"""Bayesian spike inference by MCMC (port of ``cnmf_e_tpu/ops/mcmc.py``;
reference ``OASIS_matlab/packages/MCMC/cont_ca_sampler.m``).

Discrete-time Metropolis-within-Gibbs over spike vectors, every trace of
the batch at once. Each sweep, per trace: a birth/death move on the spike
support, a time-shift move of one spike by -2..+2 bins, an exact
truncated-Gaussian draw of one spike's amplitude, an exact baseline Gibbs
draw, and (``sample_g``) a random-walk move on the time constants with the
kernel and the residual rebuilt on acceptance.

Model:  y = b + conv(s, h) + eps,  eps ~ N(0, sn^2),
        P(s_t > 0) = p_spike, amplitude ~ Exp(1 / mu_amp).

The random numbers of a block of sweeps are drawn at once from a seeded
CPU ``torch.Generator`` and uploaded in one copy, so a run on the card
and one on the CPU make the same draws. They are not the JAX package's
draws (``jax.random``): the two samplers agree in distribution, and the
tests hold both to the same statistical gates.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.ops.ar import ar2exp, ar_kernel, exp2ar
from cnmf_e_tpu_torch.ops.stats import median_mid

# uniforms and normals a sweep draws per trace (rows of one block's draw)
(_U_MOVE, _U_TPROP, _U_AMP, _U_DEL, _U_ACC, _U_PICK_MV, _U_SHIFT, _U_MV,
 _U_PICK_AMP, _U_AMP_NEW, _U_G) = range(11)
_N_UNIFORM = 11
_Z_B, _Z_G0, _Z_G1 = range(3)
_N_NORMAL = 3
_SHIFTS = (-2, -1, 1, 2)


class MCMCResult(NamedTuple):
    spike_prob: torch.Tensor    # (N, T) posterior spike probability
    spike_mean: torch.Tensor    # (N, T) posterior mean spike amplitude
    c_mean: torch.Tensor        # (N, T) posterior mean denoised trace
    b_mean: torch.Tensor        # (N,) posterior mean baseline
    n_accept: torch.Tensor      # (N,) accepted moves
    g_mean: torch.Tensor        # (N, p) posterior mean AR coefficients
    geweke_z: np.ndarray        # (N,) split-mean convergence z-score


class _Chain(NamedTuple):
    s: torch.Tensor       # (N, T) spike amplitudes
    b: torch.Tensor       # (N,) baseline
    g: torch.Tensor       # (N, p) AR coefficients
    h: torch.Tensor       # (N, L) current kernel
    resid: torch.Tensor   # (N, T) y - b - conv(s, h)
    acc: torch.Tensor     # (N,) accepted moves


def conv_rows(s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Each row of s (N, T) convolved with its own kernel h (N, L), the
    first T samples of the full convolution."""
    N, T = s.shape
    L = h.shape[-1]
    x = F.pad(s[None], (L - 1, 0))
    return F.conv1d(x, h.flip(-1)[:, None, :], groups=N)[0]


def _full_resid(y, s, b, h):
    return y - b[:, None] - conv_rows(s, h)


def _draws(gen: torch.Generator, n_sweeps: int, N: int, device):
    U = torch.rand((n_sweeps, _N_UNIFORM, N), generator=gen)
    Z = torch.randn((n_sweeps, _N_NORMAL, N), generator=gen)
    return U.to(device), Z.to(device)


def _mcmc_block(chain: _Chain, gen: torch.Generator, y, sn, mu_amp,
                p_spike: float, n_sweeps: int, sample_g: bool):
    """``n_sweeps`` sweeps. Returns (chain, sums, counts): sums = (sum_on,
    sum_s, sum_b, sum_g) over the block and counts the per-sweep spike
    count (n_sweeps, N) for the Geweke diagnostic."""
    N, T = y.shape
    L = chain.h.shape[-1]
    dev = y.device
    rows = torch.arange(N, device=dev)
    lag = torch.arange(L, device=dev)
    log_prior_on = float(np.log(p_spike / (1 - p_spike)))
    inv_var = 1.0 / torch.clamp(sn * sn, min=1e-12)
    shifts = torch.as_tensor(_SHIFTS, device=dev)
    U, Z = _draws(gen, n_sweeps, N, dev)

    def window(resid, h, t_idx):
        pos = t_idx[:, None] + lag[None, :]
        valid = pos < T
        r_win = torch.where(valid, resid.gather(1, pos.clamp(max=T - 1)),
                            0.0)
        return r_win, torch.where(valid, h, 0.0)

    def delta_loglik(resid, h, amp, t_idx):
        """dLL of adding amp * h at bin t: (a <r, h> - a^2 hh / 2) / sn^2
        over the valid window."""
        r_win, hv = window(resid, h, t_idx)
        rh = (r_win * hv).sum(dim=-1)
        hh = (hv * hv).sum(dim=-1)
        return (amp * rh - 0.5 * amp * amp * hh) * inv_var

    def apply_spike(resid, h, amp, t_idx):
        pos = t_idx[:, None] + lag[None, :]
        upd = torch.where(pos < T, amp[:, None] * h, 0.0)
        return resid.scatter_add(1, pos.clamp(max=T - 1), -upd)

    def at(x, t_idx):
        return x.gather(1, t_idx[:, None])[:, 0]

    def pick_existing(s, u):
        """A uniformly random existing spike per trace, and the count."""
        on = s > 0
        n_spk = on.sum(dim=-1)
        csum = torch.cumsum(on.to(y.dtype), dim=-1)
        target = torch.ceil(u * torch.clamp(n_spk, min=1))
        return (csum >= target[:, None]).to(torch.int8).argmax(dim=-1), n_spk

    def randint(u, n):
        return torch.clamp((u * n).long(), max=n - 1)

    s, b, g, h, resid, acc = chain
    sum_on = torch.zeros_like(s)
    sum_s = torch.zeros_like(s)
    sum_b = torch.zeros_like(b)
    sum_g = torch.zeros_like(g)
    counts = torch.empty((n_sweeps, N), dtype=torch.int32, device=dev)
    for i in range(n_sweeps):
        u, z = U[i], Z[i]
        # ---- birth/death on the spike support -------------------------
        move = randint(u[_U_MOVE], 2)
        t_prop = randint(u[_U_TPROP], T)
        amp = -torch.log1p(-u[_U_AMP]) * mu_amp
        occupied = at(s, t_prop) > 0
        log_alpha_birth = delta_loglik(resid, h, amp, t_prop) + log_prior_on
        t_del, n_spk = pick_existing(s, u[_U_DEL])
        amp_del = at(s, t_del)
        log_alpha_death = (delta_loglik(resid, h, -amp_del, t_del)
                           - log_prior_on)
        logu = torch.log(u[_U_ACC] + 1e-12)
        do_birth = (move == 0) & ~occupied & (logu < log_alpha_birth)
        do_death = (move == 1) & (n_spk > 0) & (logu < log_alpha_death)
        a_birth = torch.where(do_birth, amp, 0.0)
        s = s.index_put((rows, t_prop), a_birth, accumulate=True)
        resid = apply_spike(resid, h, a_birth, t_prop)
        a_death = torch.where(do_death, -amp_del, 0.0)
        s = s.index_put((rows, t_del), a_death, accumulate=True)
        resid = apply_spike(resid, h, a_death, t_del)

        # ---- time shift of one existing spike ---------------------------
        t_mv, n_spk_mv = pick_existing(s, u[_U_PICK_MV])
        a_mv = at(s, t_mv)
        t_new = t_mv + shifts[randint(u[_U_SHIFT], 4)]
        in_range = (t_new >= 0) & (t_new < T)
        t_new = t_new.clamp(0, T - 1)
        ok = (n_spk_mv > 0) & in_range & (at(s, t_new) <= 0)
        a_eff = torch.where(ok, a_mv, 0.0)
        dll_rm = delta_loglik(resid, h, -a_eff, t_mv)
        resid_rm = apply_spike(resid, h, -a_eff, t_mv)
        dll_add = delta_loglik(resid_rm, h, a_eff, t_new)
        do_move = ok & (torch.log(u[_U_MV] + 1e-12) < dll_rm + dll_add)
        a_apply = torch.where(do_move, a_eff, 0.0)
        s = s.index_put((rows, t_mv), -a_apply, accumulate=True)
        s = s.index_put((rows, t_new), a_apply, accumulate=True)
        resid = torch.where(do_move[:, None],
                            apply_spike(resid_rm, h, a_eff, t_new), resid)

        # ---- amplitude Gibbs draw of one existing spike -----------------
        t_amp, n_spk = pick_existing(s, u[_U_PICK_AMP])
        a_old = at(s, t_amp)
        has = n_spk > 0
        r_win, hv = window(resid, h, t_amp)
        hh = torch.clamp((hv * hv).sum(dim=-1), min=1e-12)
        rh_plus = (r_win * hv).sum(dim=-1) + a_old * hh
        # N(mean, var) x Exp(1 / mu) truncated at 0
        var_c = 1.0 / (hh * inv_var)
        mean_c = (rh_plus * inv_var - 1.0 / mu_amp) * var_c
        sd_c = torch.sqrt(var_c)
        lo = torch.clamp(torch.special.ndtr(-mean_c / sd_c), max=1.0 - 1e-6)
        uu = lo + u[_U_AMP_NEW] * ((1.0 - 1e-7) - lo)
        a_new = mean_c + sd_c * torch.special.ndtri(uu)
        a_new = torch.where(has, torch.clamp(a_new, min=1e-8), a_old)
        s = s.index_put((rows, t_amp), a_new)
        resid = apply_spike(resid, h, torch.where(has, a_new - a_old, 0.0),
                            t_amp)

        # ---- exact baseline Gibbs draw ------------------------------------
        db = resid.mean(dim=-1) + sn / float(np.sqrt(np.float32(T))) * z[_Z_B]
        b = b + db
        resid = resid - db[:, None]

        # ---- time-constant random walk (log-uniform prior on tau) ---------
        take_g = torch.zeros(N, dtype=torch.bool, device=dev)
        if sample_g:
            if g.shape[-1] == 1:
                tau = -1.0 / torch.log(torch.clamp(g[:, 0], 1e-4, 1.0 - 1e-6))
                tau_p = tau * torch.exp(0.05 * z[_Z_G0])
                in_bounds = tau_p >= 0.2
                g_prop = torch.exp(-1.0 / torch.clamp(tau_p, min=0.2))[:, None]
            else:
                d, r = ar2exp(g)
                d_raw = d * torch.exp(0.05 * z[_Z_G0])
                r_raw = r * torch.exp(0.05 * z[_Z_G1])
                in_bounds = ((d_raw >= 1e-3) & (d_raw <= 1 - 1e-4)
                             & (r_raw >= 1e-4) & (r_raw <= 1 - 1e-4)
                             & (r_raw <= d_raw * (1 - 1e-3)))
                d_p = torch.clamp(d_raw, 1e-3, 1 - 1e-4)
                r_p = torch.clamp(r_raw, 1e-4, 1 - 1e-4)
                g_prop = exp2ar(d_p, torch.minimum(r_p, d_p * (1 - 1e-3)))
            h_prop = ar_kernel(g_prop, L).to(y.dtype)
            resid_prop = _full_resid(y, s, b, h_prop)
            dll_g = -0.5 * inv_var * ((resid_prop * resid_prop).sum(dim=-1)
                                      - (resid * resid).sum(dim=-1))
            take_g = (torch.log(u[_U_G] + 1e-12) < dll_g) & in_bounds
            g = torch.where(take_g[:, None], g_prop, g)
            h = torch.where(take_g[:, None], h_prop, h)
            resid = torch.where(take_g[:, None], resid_prop, resid)

        acc = acc + (do_birth | do_death | do_move | take_g).to(torch.int32)
        on = s > 0
        sum_on += on.to(y.dtype)
        sum_s += s
        sum_b += b
        sum_g += g
        counts[i] = on.sum(dim=-1)
    return (_Chain(s, b, g, h, resid, acc), (sum_on, sum_s, sum_b, sum_g),
            counts)


def _init_chain(y, g, kernel_len):
    N, T = y.shape
    if g.ndim == 1:
        g = g[:, None]
    h = ar_kernel(g, min(kernel_len, T)).to(y.dtype)
    b0 = median_mid(y, dim=-1)
    return _Chain(s=torch.zeros_like(y), b=b0, g=g, h=h,
                  resid=y - b0[:, None],
                  acc=torch.zeros(N, dtype=torch.int32, device=y.device))


def _geweke_z(counts: np.ndarray) -> np.ndarray:
    """Split-mean z-score of the (n, N) spike-count history, first half
    against second half (|z| < 2 ~ converged), on the host."""
    counts = np.asarray(counts, np.float32)
    n = counts.shape[0]
    a, b = counts[: n // 2], counts[n // 2:]
    va = np.var(a, axis=0) / a.shape[0]
    vb = np.var(b, axis=0) / b.shape[0]
    return (np.mean(a, axis=0) - np.mean(b, axis=0)) / \
        np.sqrt(np.maximum(va + vb, 1e-12))


def _finalize(chain, sums, counts, n_samples):
    sum_on, sum_s, sum_b, sum_g = sums
    spike_mean = sum_s / n_samples
    return MCMCResult(spike_prob=sum_on / n_samples, spike_mean=spike_mean,
                      c_mean=conv_rows(spike_mean, chain.h),
                      b_mean=sum_b / n_samples, n_accept=chain.acc,
                      g_mean=sum_g / n_samples, geweke_z=_geweke_z(counts))


def _setup(y, g, sn, mu_amp, kernel_len):
    g = torch.as_tensor(g, dtype=y.dtype, device=y.device)
    sn = torch.as_tensor(sn, dtype=y.dtype, device=y.device)
    chain = _init_chain(y, g, kernel_len)
    if mu_amp is None:
        mu_amp = torch.clamp(y.amax(dim=-1) * 0.5, min=1e-3)
    return chain, sn, mu_amp


def mcmc_spikes(y: torch.Tensor, g: torch.Tensor, sn: torch.Tensor,
                seed: int = 0, n_iter: int = 400, n_burn: int = 100,
                p_spike: float = 0.01, mu_amp: Optional[torch.Tensor] = None,
                kernel_len: int = 200, sample_g: bool = True) -> MCMCResult:
    """Sample spike trains. y: (N, T); g: (N,) or (N, p); sn: (N,).
    ``n_burn`` burn-in sweeps, then ``n_iter - n_burn`` sampling sweeps;
    the draws come from a CPU generator seeded with ``seed``."""
    chain, sn, mu_amp = _setup(y, g, sn, mu_amp, kernel_len)
    gen = torch.Generator().manual_seed(seed)
    if n_burn > 0:
        chain, _, _ = _mcmc_block(chain, gen, y, sn, mu_amp, p_spike,
                                  n_burn, sample_g)
    n_samp = max(n_iter - n_burn, 1)
    chain, sums, counts = _mcmc_block(chain, gen, y, sn, mu_amp, p_spike,
                                      n_samp, sample_g)
    return _finalize(chain, sums, counts.cpu().numpy(), n_samp)


def mcmc_spikes_adaptive(y: torch.Tensor, g: torch.Tensor, sn: torch.Tensor,
                         seed: int = 0, block: int = 250,
                         max_blocks: int = 12, z_thresh: float = 2.0,
                         p_spike: float = 0.01,
                         mu_amp: Optional[torch.Tensor] = None,
                         kernel_len: int = 200,
                         sample_g: bool = True) -> MCMCResult:
    """Burn one block, then sample blocks of ``block`` sweeps until the
    Geweke z-score of every trace's spike-count history is below
    ``z_thresh`` or ``max_blocks`` blocks have run (in place of the
    reference's fixed 400 sweeps)."""
    chain, sn, mu_amp = _setup(y, g, sn, mu_amp, kernel_len)
    gen = torch.Generator().manual_seed(seed)
    chain, _, _ = _mcmc_block(chain, gen, y, sn, mu_amp, p_spike, block,
                              sample_g)
    sums = None
    all_counts = []
    for _ in range(max_blocks):
        chain, bsums, counts = _mcmc_block(chain, gen, y, sn, mu_amp,
                                           p_spike, block, sample_g)
        sums = bsums if sums is None else tuple(
            a + b for a, b in zip(sums, bsums))
        all_counts.append(counts.cpu().numpy())
        z = _geweke_z(np.concatenate(all_counts, axis=0))
        if float(np.max(np.abs(z))) < z_thresh:
            break
    return _finalize(chain, sums, np.concatenate(all_counts, axis=0),
                     block * len(all_counts))
