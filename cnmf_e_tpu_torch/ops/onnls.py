"""Windowed online NNLS deconvolution for AR(2), double-exponential and
arbitrary kernels (port of ``cnmf_e_tpu/ops/onnls.py``; reference
``OASIS_matlab/packages/oasis/onnls.m:1-50``).

A window of ``win`` samples slides by ``shift``; each window solves a
warm-started NNLS by FISTA and commits its first ``shift`` spikes. For a
difference-of-exponentials kernel h[t] = (d^(t+1) - r^(t+1)) / (d - r)
the influence of every committed spike on later samples is carried
exactly by a two-number state (z_d, z_r); for an arbitrary kernel the
residual trace is carried instead. The windows run one after another,
every trace of the batch at once.

The AR(2) recurrence c_t = g1 c_{t-1} + g2 c_{t-2} + s_t runs in blocks
of :data:`REC_BLOCK` samples (:func:`ar2_recurrence`): a batched product
with the block's impulse-response matrix plus the free response of the
two samples before the block, so a trace of T samples costs T /
REC_BLOCK sequential steps instead of T.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops.ar import ar2exp, choose_smin, exp2ar
from cnmf_e_tpu_torch.ops.nnls import nnls_fista

REC_BLOCK = 64          # samples per step of the blocked AR(2) recurrence
_PHI = 0.6180339887498949


def _kernel_cols(d: torch.Tensor, r: torch.Tensor, win: int) -> torch.Tensor:
    """Lower-triangular Toeplitz kernel matrices (..., win, win) with
    H[i, j] = h[i - j] for i >= j."""
    t = torch.arange(win, dtype=d.dtype, device=d.device)
    dd = torch.clamp(d - r, min=1e-6)[..., None]
    h = (d[..., None] ** (t + 1) - r[..., None] ** (t + 1)) / dd
    return _toeplitz(h, win)


def _toeplitz(h: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n, n) lower-triangular Toeplitz matrices from the first n
    taps of h (..., >= n)."""
    i = torch.arange(n, device=h.device)
    lag = i[:, None] - i[None, :]
    return torch.where(lag >= 0, h[..., lag.clamp(0, n - 1)], 0.0)


def _batched(x, batch, like: torch.Tensor) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=like.dtype, device=like.device), batch)


def _windows(T: int, win: int, shift: int):
    win = min(win, T)
    shift = min(shift, win)
    n_win = max((T - (win - shift) + shift - 1) // shift, 1)
    return win, shift, n_win, (n_win - 1) * shift + win


def _hv(H: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """H^T v over the batch: einsum("...ij,...i->...j")."""
    return (v[..., None, :] @ H)[..., 0, :]


def onnls(y: torch.Tensor, d, r, win: int = 200, shift: int = 100,
          fista_iters: int = 60, lam=0.0) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Batched windowed NNLS deconvolution with the kernel of (d, r). y:
    (..., T); d, r and ``lam`` scalars or per trace (...,). Returns
    (c, s)."""
    batch = y.shape[:-1]
    T = y.shape[-1]
    d, r = _batched(d, batch, y), _batched(r, batch, y)
    lam = _batched(lam, batch, y)[..., None]
    win, shift, n_win, Tpad = _windows(T, win, shift)
    ypad = F.pad(y, (0, Tpad - T))

    H = _kernel_cols(d, r, win)                       # (..., win, win)
    G = H.transpose(-1, -2) @ H
    # the last window may cover zero-padded frames: leave those rows out
    # of its normal equations (the padding is shorter than the shift, so
    # only the last window has any)
    row_ok_last = (torch.arange(win, device=y.device)
                   < win - (Tpad - T)).to(y.dtype)
    Hm = H * row_ok_last[:, None]
    G_last = Hm.transpose(-1, -2) @ Hm
    t_idx = torch.arange(win, dtype=y.dtype, device=y.device)
    dd = torch.clamp(d - r, min=1e-6)[..., None]
    dpow_d = d[..., None] ** t_idx * d[..., None]      # d^(t+1)
    rpow_r = r[..., None] ** t_idx * r[..., None]
    # a committed spike at offset u < shift adds d^(shift - u) to zd
    expo = torch.clamp(shift - t_idx, min=0.0)
    in_commit = t_idx < shift
    wd = torch.where(in_commit, d[..., None] ** expo, 0.0)
    wr = torch.where(in_commit, r[..., None] ** expo, 0.0)
    adv_d = d ** float(shift)
    adv_r = r ** float(shift)

    zd = torch.zeros(batch, dtype=y.dtype, device=y.device)
    zr = torch.zeros_like(zd)
    s_acc = torch.zeros(batch + (Tpad,), dtype=y.dtype, device=y.device)
    s_warm = torch.zeros(batch + (win,), dtype=y.dtype, device=y.device)
    for k in range(n_win):
        t0 = k * shift
        last = k == n_win - 1
        yw = ypad[..., t0:t0 + win]
        # the tail of past spikes at t0 + t:
        # (zd d^(t+1) - zr r^(t+1)) / (d - r)
        tail = (zd[..., None] * dpow_d - zr[..., None] * rpow_r) / dd
        v = (yw - tail) * row_ok_last if last else yw - tail
        s_w = nnls_fista(G_last if last else G, _hv(H, v) - lam,
                         x0=s_warm, n_iter=fista_iters)
        # commit the first `shift` spikes (all of them on the last window)
        if last:
            s_acc[..., t0:t0 + win] += s_w
            break
        s_acc[..., t0:t0 + shift] += s_w[..., :shift]
        zd = zd * adv_d + (wd * s_w).sum(dim=-1)
        zr = zr * adv_r + (wr * s_w).sum(dim=-1)
        # the next window starts from this one's uncommitted spikes
        s_warm = F.pad(s_w[..., shift:], (0, shift))
    s = s_acc[..., :T]
    return ar2_recurrence(s, d, r), s


def onnls_kernel(y: torch.Tensor, h: torch.Tensor, win: int = 200,
                 shift: int = 100, fista_iters: int = 60,
                 lam=0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed NNLS deconvolution with an arbitrary finite kernel h (Lh,)
    shared by the batch (the reference 'kernel' model). The committed
    spikes' whole kernel contribution is subtracted from the carried
    residual, like the reference's in-place ``y`` update. Returns (c, s)
    with c the causal convolution of s with h."""
    h = torch.as_tensor(h, dtype=y.dtype, device=y.device).reshape(-1)
    batch = y.shape[:-1]
    T = y.shape[-1]
    lam = _batched(lam, batch, y)[..., None]
    Lh = h.shape[0]
    win, shift, n_win, Tpad = _windows(T, win, shift)
    hw = F.pad(h, (0, max(win - Lh, 0)))[:win]
    H = _toeplitz(hw, win)
    G = H.T @ H
    row_ok_last = (torch.arange(win, device=y.device)
                   < win - (Tpad - T)).to(y.dtype)
    Hm = H * row_ok_last[:, None]
    G_last = Hm.T @ Hm
    # a spike at offset u spreads h over [u, u + Lh)
    Lc = win + Lh - 1
    clag = (torch.arange(Lc, device=y.device)[None, :]
            - torch.arange(win, device=y.device)[:, None])
    Hc = torch.where((clag >= 0) & (clag < Lh), h[clag.clamp(0, Lh - 1)],
                     0.0)                              # (win, Lc)

    y_res = F.pad(y, (0, Tpad + Lc - T))
    s_acc = torch.zeros(batch + (Tpad,), dtype=y.dtype, device=y.device)
    s_warm = torch.zeros(batch + (win,), dtype=y.dtype, device=y.device)
    for k in range(n_win):
        t0 = k * shift
        last = k == n_win - 1
        yw = y_res[..., t0:t0 + win]
        b = (yw * row_ok_last if last else yw) @ H - lam
        s_w = nnls_fista(G_last if last else G, b, x0=s_warm,
                         n_iter=fista_iters)
        s_commit = s_w if last else F.pad(s_w[..., :shift],
                                          (0, win - shift))
        s_acc[..., t0:t0 + win] += s_commit
        y_res[..., t0:t0 + Lc] -= s_commit @ Hc
        s_warm = F.pad(s_w[..., shift:], (0, shift))
    s = s_acc[..., :T]
    return causal_conv(s, h), s


def causal_conv(s: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """c[t] = sum_l h[l] s[t - l], batched over the leading dims of s."""
    h = torch.as_tensor(h, dtype=s.dtype, device=s.device).reshape(-1)
    T = s.shape[-1]
    x = F.pad(s.reshape(-1, 1, T), (h.shape[0] - 1, 0))
    return F.conv1d(x, h.flip(0)[None, None]).reshape(s.shape)


def fit_exp2_to_kernel(h: torch.Tensor, n_grid: int = 40
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d, r) of the difference of exponentials nearest to the kernel h
    (after the best scaling), by grid search."""
    h = torch.as_tensor(h, dtype=torch.float32)
    L = h.shape[-1]
    t = torch.arange(L, dtype=torch.float32, device=h.device)
    ds = torch.linspace(0.5, 0.995, n_grid, device=h.device)
    rs = torch.linspace(0.01, 0.9, n_grid, device=h.device)
    dd, rr = torch.meshgrid(ds, rs, indexing="ij")
    denom = torch.clamp(dd - rr, min=1e-4)
    basis = (dd[..., None] ** (t + 1) - rr[..., None] ** (t + 1)) \
        / denom[..., None]                             # (n, n, L)
    hb = torch.einsum("ijl,l->ij", basis, h)
    bb = (basis * basis).sum(dim=-1)
    scale = hb / torch.clamp(bb, min=1e-12)
    err = (h * h).sum() - scale * hb
    err = torch.where(dd > rr, err, torch.inf)
    idx = torch.argmin(err)
    return dd.reshape(-1)[idx], rr.reshape(-1)[idx]


def ar2_recurrence(s: torch.Tensor, d, r) -> torch.Tensor:
    """c from spikes by the AR(2) recurrence c_t = g1 c_{t-1} + g2 c_{t-2}
    + s_t (g1 = d + r, g2 = -d r; d, r broadcast over the batch).

    Blocked: inside a block of B samples c is the block's spikes through
    the impulse response h (h_0 = 1, h_1 = g1, h_u = g1 h_{u-1} + g2
    h_{u-2}), plus the free response h_{u+1} c_{t0-1} + g2 h_u c_{t0-2}
    of the two samples before the block."""
    batch = s.shape[:-1]
    T = s.shape[-1]
    g1 = _batched(d + r, batch, s)[..., None]
    g2 = _batched(-d * r, batch, s)[..., None]
    B = min(REC_BLOCK, T)
    hs = [torch.ones_like(g1), g1.clone()]
    for _ in range(B - 1):
        hs.append(g1 * hs[-1] + g2 * hs[-2])
    h = torch.cat(hs, dim=-1)                          # (..., B + 1)
    nb = -(-T // B)
    S = F.pad(s, (0, nb * B - T)).reshape(batch + (nb, B))
    forced = S @ _toeplitz(h, B).transpose(-1, -2)     # (..., nb, B)
    alpha = h[..., 1:]                                 # h_{u+1}
    beta = g2 * h[..., :B]                             # g2 h_u
    out = torch.empty_like(forced)
    out[..., 0, :] = forced[..., 0, :]
    for k in range(1, nb):
        prev = out[..., k - 1, :]
        out[..., k, :] = (forced[..., k, :] + alpha * prev[..., -1:]
                          + beta * prev[..., -2:-1])
    return out.reshape(batch + (nb * B,))[..., :T]


def _apply_smin_floor(s, d, r, floor):
    """Zero the spikes below the floor and rebuild c."""
    s = torch.where(s >= floor, s, 0.0)
    return ar2_recurrence(s, d, r), s


def rss(y, c):
    return ((y - c) ** 2).sum(dim=-1)


def baseline0(y: torch.Tensor, optimize_b: bool) -> torch.Tensor:
    """The starting baseline: the 15% quantile of each trace, or 0."""
    if optimize_b:
        return torch.quantile(y, 0.15, dim=-1)
    return torch.zeros(y.shape[:-1], dtype=y.dtype, device=y.device)


def constrained_onnls(y: torch.Tensor, d, r, sn: torch.Tensor,
                      optimize_b: bool = True, n_bisect: int = 12,
                      win: int = 200, shift: int = 100,
                      fista_iters: int = 60):
    """Noise-constrained AR(2)/exp2 deconvolution: lambda bisected in
    [0, lam_max] so that RSS = sn^2 T (``constrained_oasisAR2.m:1-60``);
    a trace whose lam = 0 fit already exceeds the budget keeps lam = 0.
    Returns (c, s, b, lam)."""
    batch = y.shape[:-1]
    T = y.shape[-1]
    thresh = sn * sn * T
    b = baseline0(y, optimize_b)

    def solve(lam, b):
        yb = y - b[..., None]
        c, s = onnls(yb, d, r, win=win, shift=shift,
                     fista_iters=fista_iters, lam=lam)
        return c, s, rss(yb, c)

    c0, s0, rss0 = solve(torch.zeros(batch, dtype=y.dtype,
                                     device=y.device), b)
    lo = torch.zeros(batch, dtype=y.dtype, device=y.device)
    hi = torch.clamp(y.abs().amax(dim=-1), min=1.0) * 2.0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        c, _, rss_mid = solve(mid, b)
        too_smooth = rss_mid > thresh
        lo = torch.where(too_smooth, lo, mid)
        hi = torch.where(too_smooth, mid, hi)
        if optimize_b:
            b = (y - c).mean(dim=-1)
    c, s, _ = solve(lo, b)
    done0 = rss0 >= thresh
    c = torch.where(done0[..., None], c0, c)
    s = torch.where(done0[..., None], s0, s)
    return c, s, b, torch.where(done0, 0.0, lo)


def thresholded_onnls(y: torch.Tensor, d, r, sn: torch.Tensor,
                      optimize_b: bool = True, thresh_factor: float = 1.0,
                      p_noise: float = 0.9999, n_search: int = 10,
                      win: int = 200, shift: int = 100,
                      fista_iters: int = 60):
    """Hard-threshold (smin) AR(2) deconvolution
    (``thresholded_oasisAR2.m:79-140``): one unpenalized solve, then a
    bisection on a multiplier in [0.25, 8] of the statistical smin so
    that the floored fit's RSS approaches ``thresh_factor * sn^2 T``.
    Returns (c, s, b, smin)."""
    batch = y.shape[:-1]
    T = y.shape[-1]
    thresh = thresh_factor * sn * sn * T
    d, r = _batched(d, batch, y), _batched(r, batch, y)
    smin0 = choose_smin(exp2ar(d, r), sn, p_noise)
    b = baseline0(y, optimize_b)
    _, s_raw = onnls(y - b[..., None], d, r, win=win, shift=shift,
                     fista_iters=fista_iters, lam=0.0)
    lo = torch.full(batch, 0.25, dtype=y.dtype, device=y.device)
    hi = torch.full(batch, 8.0, dtype=y.dtype, device=y.device)
    for _ in range(n_search):
        mid = 0.5 * (lo + hi)
        c, _ = _apply_smin_floor(s_raw, d, r, (mid * smin0)[..., None])
        too_sparse = rss(y - b[..., None], c) > thresh
        lo = torch.where(too_sparse, lo, mid)
        hi = torch.where(too_sparse, mid, hi)
        if optimize_b:
            b = (y - c).mean(dim=-1)
    smin = lo * smin0
    c, s = _apply_smin_floor(s_raw, d, r, smin[..., None])
    return c, s, b, smin


def golden_section(f, lo, hi, n: int) -> torch.Tensor:
    """Per-trace minimum of f on [lo, hi] by ``n`` golden-section steps
    (two evaluations each), the midpoint of the last bracket."""
    x1 = hi - _PHI * (hi - lo)
    x2 = lo + _PHI * (hi - lo)
    f1, f2 = f(x1), f(x2)
    for _ in range(n):
        go_left = f1 < f2
        hi = torch.where(go_left, x2, hi)
        lo = torch.where(go_left, lo, x1)
        x1 = hi - _PHI * (hi - lo)
        x2 = lo + _PHI * (hi - lo)
        f1, f2 = f(x1), f(x2)
    return 0.5 * (lo + hi)


def optimize_exp2(y: torch.Tensor, d0, r0, sn: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None, n_outer: int = 2,
                  n_golden: int = 10, win: int = 200, shift: int = 100,
                  fista_iters: int = 40, p_noise: float = 0.9999):
    """Per-trace (d, r) of the exp2/AR(2) kernel by EM-style alternation
    (the role of ``update_kernel_exp2.m``): spikes from a windowed NNLS
    solve floored at ``choose_smin``, then golden-section searches on d
    and on r of the RSS with the spikes held fixed and the best global
    amplitude per candidate. Returns (d, r, c, s)."""
    from cnmf_e_tpu_torch.ops.noise import estimate_noise

    batch = y.shape[:-1]
    if b is None:
        b = torch.zeros(batch, dtype=y.dtype, device=y.device)
    yb = y - b[..., None]
    if sn is None:
        sn = estimate_noise(yb, "psd")

    def floor_spikes(s, d, r):
        smin = choose_smin(exp2ar(d, r), sn, p_noise)
        return torch.where(s >= smin[..., None], s, 0.0)

    def rss_fixed_spikes(s_fix, d, r):
        d = torch.maximum(d, r + 0.01)
        c = ar2_recurrence(s_fix, d, r)
        num = (yb * c).sum(dim=-1)
        den = torch.clamp((c * c).sum(dim=-1), min=1e-12)
        alpha = torch.clamp(num / den, min=0.0)
        return rss(yb, alpha[..., None] * c)

    d = _batched(d0, batch, y)
    r = _batched(r0, batch, y)
    for _ in range(n_outer):
        _, s = onnls(yb, d, r, win=win, shift=shift,
                     fista_iters=fista_iters, lam=0.0)
        s_fix = floor_spikes(s, d, r)
        d = golden_section(lambda dv: rss_fixed_spikes(s_fix, dv, r),
                    torch.clamp(r + 0.02, min=0.3),
                    torch.full(batch, 0.998, dtype=y.dtype,
                               device=y.device), n_golden)
        r = golden_section(lambda rv: rss_fixed_spikes(s_fix, d, rv),
                    torch.full(batch, 0.005, dtype=y.dtype,
                               device=y.device),
                    torch.clamp(d - 0.02, max=0.95), n_golden)
    c, s = onnls(yb, d, r, win=win, shift=shift, fista_iters=fista_iters,
                 lam=0.0)
    return d, r, c, s


def onnls_deconvolve(y: torch.Tensor, g: torch.Tensor, sn: torch.Tensor,
                     params: DeconvParams):
    """The AR(2)/exp2 branch of ``deconvolve``: foopsi (fixed lambda),
    constrained (``constrained_oasisAR2.m``) or thresholded
    (``thresholded_oasisAR2.m``); ``optimize_g > 0`` first optimizes (d,
    r) per trace."""
    from cnmf_e_tpu_torch.ops.oasis import DeconvResult

    batch = y.shape[:-1]
    d, r = ar2exp(g)
    d = torch.broadcast_to(d, batch)
    r = torch.broadcast_to(r, batch)
    if params.optimize_g:
        d, r, _, _ = optimize_exp2(y, d, r, sn=sn,
                                   b=baseline0(y, params.optimize_b),
                                   n_outer=min(int(params.optimize_g), 3))
    g_out = exp2ar(d, r)
    zeros = torch.zeros(batch, dtype=y.dtype, device=y.device)
    if params.method == "constrained":
        c, s, b, lam = constrained_onnls(y, d, r, sn,
                                         optimize_b=params.optimize_b)
        return DeconvResult(c, s, b, g_out, lam, zeros)
    if params.method == "thresholded":
        c, s, b, smin = thresholded_onnls(
            y, d, r, sn, optimize_b=params.optimize_b,
            thresh_factor=params.thresh_factor, p_noise=params.p_noise)
        return DeconvResult(c, s, b, g_out, zeros, smin)
    # foopsi: a fixed lambda
    lam = params.lam
    b = baseline0(y, params.optimize_b)
    c, s = onnls(y - b[..., None], d, r, lam=lam)
    if params.optimize_b:
        b = b + (y - b[..., None] - c).mean(dim=-1)
        c, s = onnls(y - b[..., None], d, r, lam=lam)
    if params.smin != 0:
        floor = ((abs(params.smin) * sn)[..., None] if params.smin < 0
                 else params.smin)
        c, s = _apply_smin_floor(s, d, r, floor)
    return DeconvResult(c, s, b, g_out, _batched(lam, batch, y),
                        _batched(params.smin, batch, y))
