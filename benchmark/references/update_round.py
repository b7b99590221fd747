"""The plain reference of one CNMF-E model-update round.

A round is what ``CNMFE.fit`` repeats on every movie: refit the
background (the ring model of ``fit_ring_model.m`` or the rank-r svd of
``fit_svd_model.m``), subtract it, update the footprints
(``update_spatial_parallel.m``: HALS on dilated search locations, then
the peak-connected blob), then update the traces
(``update_temporal_parallel.m``: HALS, the sub-median baseline, the
Welch-PSD noise, the AR(1) fit and OASIS foopsi with the baseline
re-estimated). Everything here is plain PyTorch on the tensors' device,
and the OASIS solve is plain NumPy on the host for a sample of traces
(each trace's deconvolution is independent of the others given its raw
trace). It is a frozen copy of the plain versions of the port's
algorithms (the same coloured Gauss-Seidel order, the same two-pass
chunked OASIS), written without any of the port's code, so that both
compute the same round and differ only by rounding.

Every product goes through :meth:`Precision.mm`, which can round both
operands to TF32 (10 mantissa bits, nearest even) first: the control
that a comparison has to reject (the nearest precision below the
configuration's float32 with TF32 off).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- #
# precision
# --------------------------------------------------------------------- #
def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest even (finite
    values; the exponent range is float32's)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


class Precision:
    """The products' precision: float32 (``tf32=False``) or TF32
    operands with float32 accumulation. A movie-sized operand is rounded
    in blocks of its free dimension (``BLOCK`` elements at a time), so
    that TF32 holds no second copy of the movie."""

    BLOCK = 1 << 28

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return torch.matmul(a, b)
        if b.dim() == 2 and b.numel() > self.BLOCK \
                and b.numel() >= a.numel():
            n = max(1, self.BLOCK // b.shape[0])
            a = to_tf32(a)
            return torch.cat([torch.matmul(a, to_tf32(b[:, j:j + n]))
                              for j in range(0, b.shape[1], n)], dim=-1)
        if a.dim() == 2 and a.numel() > self.BLOCK:
            n = max(1, self.BLOCK // a.shape[1])
            b = to_tf32(b)
            return torch.cat([torch.matmul(to_tf32(a[i:i + n]), b)
                              for i in range(0, a.shape[0], n)], dim=0)
        return torch.matmul(to_tf32(a), to_tf32(b))


# --------------------------------------------------------------------- #
# resampling and noise
# --------------------------------------------------------------------- #
def box_downsample(Y: torch.Tensor, ssub: int) -> torch.Tensor:
    """Spatial box mean of (T, H, W); a ragged edge is edge-padded."""
    if ssub <= 1:
        return Y
    T, H, W = Y.shape
    Hs, Ws = -(-H // ssub), -(-W // ssub)
    Yp = F.pad(Y[:, None], (0, Ws * ssub - W, 0, Hs * ssub - H),
               mode="replicate")[:, 0]
    return Yp.reshape(T, Hs, ssub, Ws, ssub).mean(dim=(2, 4))


def resize_linear(X: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of the last two axes, half-pixel centres."""
    lead = X.shape[:-2]
    out = F.interpolate(X.reshape((-1, 1) + tuple(X.shape[-2:])),
                        size=tuple(out_hw), mode="bilinear",
                        align_corners=False)
    return out.reshape(lead + tuple(out_hw))


def _hamming(n: int) -> np.ndarray:
    if n == 1:
        return np.ones(1)
    k = np.arange(n)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def noise_psd(y: torch.Tensor) -> torch.Tensor:
    """Noise sigma along the last axis (``GetSn.m``): the Welch PSD
    (hamming segments of T / 4.5, half overlap, nfft >= 256), its
    geometric mean over [0.25, 0.5] of the sampling rate, halved."""
    T = y.shape[-1]
    seg = min(max(int(T // 4.5), 16), T)
    step = max(seg // 2, 1)
    n_windows = max((T - seg) // step + 1, 1)
    nfft = max(256, int(2 ** np.ceil(np.log2(seg))))
    win_np = _hamming(seg)
    win = torch.as_tensor(win_np, dtype=y.dtype, device=y.device)
    idx = (np.arange(n_windows) * step)[:, None] + np.arange(seg)[None, :]
    spec = torch.fft.rfft(y[..., torch.as_tensor(idx, device=y.device)]
                          * win, n=nfft, dim=-1)
    psd = spec.abs() ** 2 * (1.0 / float(np.sum(win_np ** 2)))
    mult = np.full(psd.shape[-1], 2.0)
    mult[0] = mult[-1] = 1.0
    psd = (psd * torch.as_tensor(mult, dtype=y.dtype, device=y.device)
           ).mean(dim=-2)
    freqs = np.fft.rfftfreq(nfft, d=1.0)
    band = np.nonzero((freqs >= 0.25) & (freqs <= 0.5))[0]
    sel = psd[..., torch.as_tensor(band, device=y.device)] / 2.0
    return torch.sqrt(torch.exp(torch.log(sel + 1e-30).mean(dim=-1)))


def pixel_noise(Y: torch.Tensor, n_frames: int = 1024,
                block: int = 1 << 16) -> torch.Tensor:
    """(H, W) noise sigma of each pixel over the first ``n_frames``
    frames, in blocks of pixels."""
    T, H, W = Y.shape
    Yf = Y[:min(n_frames, T)].reshape(-1, H * W)
    return torch.cat([noise_psd(Yf[:, p0:p0 + block].T.contiguous())
                      for p0 in range(0, H * W, block)]).reshape(H, W)


# --------------------------------------------------------------------- #
# the ring background
# --------------------------------------------------------------------- #
def ring_offsets(radius: int) -> np.ndarray:
    """(R, 2) offsets (dy, dx) at distance in [radius, radius + 1)
    (``get_nhood.m``)."""
    r = int(np.ceil(radius)) + 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    d = np.sqrt(x ** 2 + y ** 2)
    sel = (d >= radius) & (d < radius + 1)
    return np.stack([y[sel], x[sel]], axis=1).astype(np.int32)


def ssub_geometry(H: int, W: int, radius: int, ssub: int):
    """The ring fit's grid (Hs, Ws) and radius on it."""
    if ssub <= 1:
        return H, W, radius
    return -(-H // ssub), -(-W // ssub), max(int(round(radius / ssub)), 1)


def neighbor_index(H: int, W: int, offsets: np.ndarray):
    """Flat gather indices (H*W, R) into the zero-padded frame and the
    in-field-of-view mask (H*W, R)."""
    m = int(np.abs(offsets).max())
    yy, xx = np.mgrid[0:H, 0:W]
    ny = yy.reshape(-1, 1) + offsets[None, :, 0]
    nx = xx.reshape(-1, 1) + offsets[None, :, 1]
    valid = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
    return ((ny + m) * (W + 2 * m) + (nx + m)).astype(np.int64), valid


def uniform_ring_weights(H: int, W: int, radius: int, device):
    """The annulus average: each pixel's in-FOV ring taps weighted
    equally, no intercept. Returns (w (H*W, R), w0 (H*W,))."""
    _, valid = neighbor_index(H, W, ring_offsets(radius))
    w = valid / np.maximum(valid.sum(axis=1, keepdims=True), 1)
    w = torch.as_tensor(w, dtype=torch.float32, device=device)
    return w, torch.zeros(H * W, dtype=torch.float32, device=device)


def apply_ring(w: torch.Tensor, w0: torch.Tensor, X: torch.Tensor,
               radius: int) -> torch.Tensor:
    """W X + w0 of a (T, H, W) movie: the weighted sum of the ring's
    shifts of the zero-padded frames, in offset order."""
    T, H, W = X.shape
    offsets = ring_offsets(radius)
    m = int(np.abs(offsets).max())
    Xp = F.pad(X, (m, m, m, m))
    w_img = w.reshape(H, W, -1)
    out = torch.zeros_like(X)
    for r, (dy, dx) in enumerate(offsets):
        out = out + w_img[None, :, :, r] * Xp[:, m + dy:m + dy + H,
                                              m + dx:m + dx + W]
    return out + w0.reshape(1, H, W)


def fit_ring_weights(Bf: torch.Tensor, radius: int, ridge_eps: float,
                     P: Precision, chunk: int = 1024
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pixel's ridge regression on its ring and an intercept,
    (G + eps tr(G) I) w = X y (``fit_ring_model.m:104``), in blocks of
    pixels and frames. Returns (w (H*W, R), w0 (H*W,))."""
    T, H, W = Bf.shape
    dev = Bf.device
    offsets = ring_offsets(radius)
    R = offsets.shape[0]
    m = int(np.abs(offsets).max())
    idx, valid = neighbor_index(H, W, offsets)
    d = H * W
    Bf_flat = F.pad(Bf, (m, m, m, m)).reshape(T, -1)
    y_flat = Bf.reshape(T, d)
    idx_t = torch.as_tensor(idx, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    TB = min(512, T)
    eye = torch.eye(R + 1, dtype=torch.float32, device=dev)
    sols = []
    for p0 in range(0, d, chunk):
        ic = idx_t[p0:p0 + chunk]
        vc = valid_t[p0:p0 + chunk].to(torch.float32)
        n = ic.shape[0]
        G = torch.zeros((n, R, R), dtype=torch.float32, device=dev)
        sx = torch.zeros((n, R), dtype=torch.float32, device=dev)
        Xy = torch.zeros((n, R), dtype=torch.float32, device=dev)
        sy = torch.zeros((n,), dtype=torch.float32, device=dev)
        for t0 in range(0, T, TB):
            X = Bf_flat[t0:t0 + TB][:, ic] * vc[None]          # (tb, n, R)
            yb = y_flat[t0:t0 + TB, p0:p0 + n]                  # (tb, n)
            Xp = X.permute(1, 2, 0)                             # (n, R, tb)
            G = G + P.mm(Xp, Xp.transpose(1, 2))
            sx = sx + X.sum(dim=0)
            Xy = Xy + P.mm(Xp, yb.T[:, :, None])[..., 0]
            sy = sy + yb.sum(dim=0)
        cnt = torch.full((n, 1, 1), float(T), device=dev)
        Gfull = torch.cat([torch.cat([G, sx[:, :, None]], dim=2),
                           torch.cat([sx[:, None, :], cnt], dim=2)], dim=1)
        rhs = torch.cat([Xy, sy[:, None]], dim=1)
        tr = torch.diagonal(Gfull, dim1=1, dim2=2).sum(dim=1)
        Lc, _ = torch.linalg.cholesky_ex(
            Gfull + (ridge_eps * tr)[:, None, None] * eye)
        sols.append(torch.cholesky_solve(rhs[..., None], Lc)[..., 0])
    sol = torch.cat(sols, dim=0)
    return torch.where(valid_t, sol[:, :R], 0.0), sol[:, R].contiguous()


def fit_ring_model(Y, A, C, w_old, sn, bg: dict, P: Precision):
    """The ring background fit: b0, the centred neuron-free residual on
    the ``ssub`` grid, its outliers clamped to the old weights'
    prediction, its frames strided down to ``frame_cap_factor * R``, and
    the weights fitted on it. Returns (w, w0, b0)."""
    T, H, W = Y.shape
    K = A.shape[0]
    ssub = bg["ssub"]
    A_flat = A.reshape(K, -1)
    Ymean = Y.mean(dim=0)
    Cmean = C.mean(dim=-1)
    b0 = Ymean - P.mm(Cmean, A_flat).reshape(H, W)
    Cc = C - Cmean[:, None]
    Bf = (Y - Ymean[None]) - P.mm(Cc.T, A_flat).reshape(T, H, W)
    Hs, Ws, radius_s = ssub_geometry(H, W, bg["ring_radius"], ssub)
    Bf = box_downsample(Bf, ssub)
    if w_old is not None and sn is not None \
            and math.isfinite(bg["thresh_outlier"]):
        sn_s = box_downsample(sn[None], ssub)[0]
        pred = apply_ring(w_old, torch.zeros_like(w_old[:, 0]), Bf, radius_s)
        Bf = torch.where(Bf > pred + bg["thresh_outlier"] * sn_s[None],
                         pred, Bf)
        del pred
    R = ring_offsets(radius_s).shape[0]
    nmax = bg["frame_cap_factor"] * R
    stride = int(np.ceil(T / nmax)) if T > nmax else 1
    Bf_fit = Bf[::stride] if stride > 1 else Bf
    w, w0 = fit_ring_weights(Bf_fit, radius_s, bg["ridge_eps"], P)
    return w, w0, b0


def ring_background(w, w0, b0, Y, A, C, bg: dict, P: Precision):
    """B = W (Y - b0 - A C) + w0 + b0, the ring predicting on the
    ``ssub`` grid and upsampled bilinearly (``Sources2D.m:1247-1355``)."""
    T, H, W = Y.shape
    K = A.shape[0]
    X = Y - b0[None] - P.mm(C.T, A.reshape(K, -1)).reshape(T, H, W)
    ssub = bg["ssub"]
    _, _, radius_s = ssub_geometry(H, W, bg["ring_radius"], ssub)
    if ssub <= 1:
        return apply_ring(w, w0, X, radius_s) + b0[None]
    Bs = apply_ring(w, w0, box_downsample(X, ssub), radius_s)
    return resize_linear(Bs, (H, W)) + b0[None]


# --------------------------------------------------------------------- #
# the low-rank background
# --------------------------------------------------------------------- #
def randomized_svd(X: torch.Tensor, k: int, P: Precision, n_iter: int = 4,
                   oversample: int = 8, seed: int = 0):
    """Truncated SVD by randomized subspace iteration; the test matrix
    drawn on the host from ``seed``."""
    m, n = X.shape
    p = min(k + oversample, min(m, n))
    gen = torch.Generator().manual_seed(seed)
    Omega = torch.randn((n, p), generator=gen, dtype=X.dtype).to(X.device)
    Q = torch.linalg.qr(P.mm(X, Omega))[0]
    for _ in range(n_iter):
        Qz = torch.linalg.qr(P.mm(X.T, Q))[0]
        Q = torch.linalg.qr(P.mm(X, Qz))[0]
    Ub, s, Vt = torch.linalg.svd(P.mm(Q.T, X), full_matrices=False)
    return P.mm(Q, Ub)[:, :k], s[:k], Vt[:k]


def fit_svd_model(Y, A, C, rank: int, P: Precision):
    """B = b f + b0 from the rank-``rank`` SVD of the centred residual
    Y - A C (``fit_svd_model.m:27-42``). Returns (b, f, b0)."""
    T, H, W = Y.shape
    K = A.shape[0]
    resid = Y.reshape(T, -1) - P.mm(C.T, A.reshape(K, -1))
    b0 = resid.mean(dim=0)
    Xc = (resid - b0[None]).T
    del resid
    U, s, Vt = randomized_svd(Xc, rank, P)
    return (U * s[None]).T.reshape(rank, H, W), Vt, b0.reshape(H, W)


# --------------------------------------------------------------------- #
# HALS on a colouring of the overlap graph
# --------------------------------------------------------------------- #
def greedy_color(adj: torch.Tensor) -> np.ndarray:
    """Row k takes the smallest colour unused by its lower neighbours."""
    a = adj.detach().cpu().numpy()
    K = a.shape[0]
    colors = np.full(K, K, np.int64)
    for k in range(K):
        used = np.zeros(K + 1, bool)
        used[colors[a[k]]] = True
        colors[k] = int(np.argmin(used[:K]))
    return colors


def class_steps(colors_sorted: np.ndarray, block: int):
    """The sweep steps (rows [lo, hi), free) over rows sorted by colour:
    one step per ``block`` rows of a class, anchored at the 8-aligned
    class start, clipped to the 8-aligned ``block``-row window; the
    in-order block grid where the steps overflow ceil(K / block) + 32."""
    K = colors_sorted.shape[0]
    nb = -(-K // block)
    n_cap = nb + 32
    counts = np.bincount(colors_sorted, minlength=K)[:K]
    cstart = np.cumsum(counts) - counts
    cend = cstart + counts
    cs = colors_sorted
    r = np.arange(K)
    cs8 = (cstart // 8) * 8
    opens = (r == cstart[cs]) | ((r > cstart[cs])
                                 & ((r - cs8[cs]) % block == 0))
    B = max(8, -(-min(block, max(K, 1)) // 8) * 8)
    Kp = -(-K // B) * B
    if opens.sum() <= n_cap:
        raw = [(int(s), int(cend[cs[s]]), True) for s in r[opens]]
    else:
        raw = []
        for j in range(nb):
            s = j * block
            last = min(s + block, K) - 1
            raw.append((s, K, bool(cs[last] == cs[s])))
    steps = []
    for s, e, fr in raw:
        sc = max(min(s // 8 * 8, Kp - B), 0)
        steps.append((s, min(sc + B, e, K), fr))
    return steps


def hals_sweeps(U, V, X, gate, steps, P: Precision, mask=None,
                n_iter: int = 5, relu: bool = True) -> torch.Tensor:
    """Gauss-Seidel sweeps on a row-major factor X (K, n): a free step
    as one product from its snapshot, any other row by row. A mask folds
    into U as a -1e30 sentinel that the relu returns to 0."""
    X = X.clone()
    if mask is not None:
        X = torch.where(mask, X, 0.0)
        U = torch.where(mask, U, -1e30)
    diag = torch.diagonal(V)
    gate = gate.to(torch.float32) * (diag > 0)
    cc = torch.clamp(diag, min=1e-12)
    for _ in range(n_iter):
        for r0, r1, free in steps:
            if r1 <= r0:
                continue
            if free:
                xn = X[r0:r1] + (U[r0:r1] - P.mm(V[r0:r1], X)) \
                    / cc[r0:r1, None]
                if relu:
                    xn = torch.clamp(xn, min=0.0)
                X[r0:r1] = torch.where(gate[r0:r1, None] > 0, xn, X[r0:r1])
                continue
            for k in range(r0, r1):
                if not gate[k] > 0:
                    continue
                xn = X[k] + (U[k] - P.mm(V[k], X)) / cc[k]
                X[k] = torch.clamp(xn, min=0.0) if relu else xn
    return X


_BLOCK = 64


def colored_sweeps(adj, U, V, X, gate, P: Precision, mask=None,
                   n_iter: int = 5, relu: bool = True) -> torch.Tensor:
    """Sweeps with rows ordered by a greedy colouring of ``adj`` so that
    rows of one class share a step; returns rows in the input order."""
    colors = greedy_color(adj)
    order = np.argsort(colors, kind="stable")
    inverse = np.argsort(order)
    o = torch.as_tensor(order, device=X.device)
    out = hals_sweeps(U[o], V[o][:, o], X[o], gate[o],
                      class_steps(colors[order], _BLOCK), P,
                      mask=None if mask is None else mask[o],
                      n_iter=n_iter, relu=relu)
    return out[torch.as_tensor(inverse, device=X.device)]


# --------------------------------------------------------------------- #
# the spatial update
# --------------------------------------------------------------------- #
def _maxpool(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    H, W = x.shape[-2:]
    x4 = x.reshape((-1, 1, H, W))
    if np.all(kernel > 0) and kh % 2 == 1 and kw % 2 == 1:
        return F.max_pool2d(x4, (kh, kw), stride=1,
                            padding=(ph, pw)).reshape(x.shape)
    xp = F.pad(x4, (pw, kw - 1 - pw, ph, kh - 1 - ph),
               value=torch.finfo(x.dtype).min)
    out = None
    for dy, dx in np.argwhere(kernel > 0):
        s = xp[..., dy:dy + H, dx:dx + W]
        out = s if out is None else torch.maximum(out, s)
    return out.reshape(x.shape)


def disc(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return ((x ** 2 + y ** 2) <= radius ** 2).astype(np.float32)


_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.float32)


def label_from_seed(mask, seed_row, seed_col) -> torch.Tensor:
    """The 4-connected component of ``mask`` (K, H, W) that holds the
    seed pixel, by neighbour-max propagation to its fixed point (checked
    every 16 steps, at most H + W steps)."""
    H, W = mask.shape[-2:]
    m = mask.to(torch.float32)
    reach = (F.one_hot(seed_row.long(), H).to(torch.float32)[..., :, None]
             * F.one_hot(seed_col.long(), W).to(torch.float32)[..., None, :]
             ) * m
    done = 0
    while done < H + W:
        prev = reach
        for _ in range(min(16, H + W - done)):
            reach = torch.minimum(_maxpool(reach, _CROSS), m)
        done += 16
        if torch.equal(reach, prev):
            break
    return reach > 0.5


def connectivity_constraint(img: torch.Tensor, thr: float = 0.01,
                            se_size: int = 3) -> torch.Tensor:
    """Keep each footprint's peak-connected blob: grey opening, threshold
    at ``thr`` of the peak, the component holding the peak."""
    k = np.ones((se_size, se_size), np.float32)
    opened = _maxpool(-_maxpool(-img, k), k)
    peak = img.amax(dim=(-2, -1), keepdim=True)
    core = opened > torch.clamp(peak * thr, min=1e-12)
    W = img.shape[-1]
    arg = img.reshape(img.shape[:-2] + (-1,)).argmax(dim=-1)
    keep = label_from_seed(core, arg // W, arg % W)
    return torch.where(keep, img, 0.0)


def update_spatial(Ysig, A, C, active, sp: dict, P: Precision):
    """HALS on the footprints within their search locations (each
    support dilated by a disc), with means removed from the movie and
    the traces (``HALS_spatial.m``), then the shape prior."""
    if sp["algorithm"] != "hals" or sp["search_method"] != "dilate" \
            or sp["circular"]:
        raise ValueError("the reference covers hals on dilated supports")
    T, H, W = Ysig.shape
    K = A.shape[0]
    d = H * W
    masks = _maxpool((A > 0).to(torch.float32),
                     disc(sp["dilate_radius"])) > 0.5
    masks = (masks & active[:, None, None]).reshape(K, d)
    Yf = Ysig.reshape(T, d)
    Ymean = Yf.mean(dim=0)[None]                           # (1, d)
    Cmean = C.mean(dim=1, keepdim=True)                    # (K, 1)
    U = P.mm(C, Yf) - T * P.mm(Cmean, Ymean)               # (K, d)
    V = P.mm(C, C.T) - T * P.mm(Cmean, Cmean.T)
    S = masks.to(torch.float32)
    adj = (P.mm(S, S.T) > 0) & ~torch.eye(K, dtype=torch.bool,
                                           device=A.device)
    del S
    Ad = colored_sweeps(adj, U, V, A.reshape(K, d),
                        torch.ones(K, device=A.device), P, mask=masks,
                        n_iter=sp["n_iter"], relu=True)
    del U, masks
    A_new = Ad.reshape(K, H, W)
    if sp["connected"]:
        A_new = connectivity_constraint(A_new, se_size=3)
    return A_new * active[:, None, None]


# --------------------------------------------------------------------- #
# the temporal update
# --------------------------------------------------------------------- #
def fast_median(x: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """Median along the last axis by value-space bisection (the upper
    bracket after ``iters`` halvings), keepdim."""
    n = x.shape[-1]
    target = (n + 1) // 2
    lo = x.amin(dim=-1, keepdim=True)
    hi = x.amax(dim=-1, keepdim=True)
    lo = lo - torch.clamp(1e-6 * lo.abs(), min=1e-6)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ge = (x <= mid).sum(dim=-1, keepdim=True) >= target
        lo = torch.where(ge, lo, mid)
        hi = torch.where(ge, mid, hi)
    return hi


def submedian_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of the samples below the median (``HALS_temporal.m:79``)."""
    below = x < fast_median(x)
    return torch.where(below, x, 0.0).sum(dim=-1) \
        / below.sum(dim=-1).clamp(min=1)


def ar1_coefficient(y: torch.Tensor, sn: torch.Tensor, lags: int,
                    g_range) -> torch.Tensor:
    """The noise-corrected Yule-Walker AR(1) fit over ``lags + 1``
    autocovariance lags (``estimate_time_constant.m:36-50``), clamped
    into ``g_range``."""
    T = y.shape[-1]
    L = lags + 1
    yc = y - y.mean(dim=-1, keepdim=True)
    n = T - L
    b = yc[..., :n]
    xc = torch.stack([(yc[..., k:k + n] * b).sum(dim=-1) / T
                      for k in range(L + 1)], dim=-1)
    a = xc[..., :L].clone()
    a[..., 0] = a[..., 0] - sn ** 2
    g = (a * xc[..., 1:L + 1]).sum(dim=-1) / ((a * a).sum(dim=-1) + 1e-12)
    r = torch.clamp(g, g_range[0], g_range[1])
    return torch.where(torch.isfinite(r), r, 0.8)


def _merge_top(v, w, ln, n, logg, smin, cand):
    """Merge the top two pools of lanes ``cand`` while they violate."""
    while cand.size:
        nl = n[cand]
        p = np.maximum(nl - 2, 0)
        q = np.maximum(nl - 1, 0)
        gl = np.exp(logg[cand] * ln[cand, p].astype(np.float32))
        vp = np.maximum(v[cand, p] / w[cand, p], np.float32(0))
        vq = v[cand, q] / w[cand, q]
        viol = (nl >= 2) & (vq < vp * gl + smin[cand])
        cand, p, q, gl = cand[viol], p[viol], q[viol], gl[viol]
        v[cand, p] = v[cand, p] + v[cand, q] * gl
        w[cand, p] = w[cand, p] + w[cand, q] * gl * gl
        ln[cand, p] = ln[cand, p] + ln[cand, q]
        n[cand] -= 1


def oasis_ar1(y: np.ndarray, g: np.ndarray, smin: np.ndarray,
              L: int) -> Tuple[np.ndarray, np.ndarray]:
    """OASIS AR(1) (lam = 0) with the spike floor ``smin`` (K,), in the
    two passes of the divide-and-conquer solve: pools within each
    length-L chunk, then the chunks' pool lists pushed in order and
    merged across the seams; then c and s from the pools."""
    f32 = np.float32
    K, T = y.shape
    Tp = -(-T // L) * L
    vinit = y.astype(f32)
    if Tp != T:
        # strictly increasing pad samples far above the trace never merge
        big = np.abs(vinit).max() * f32(2) + f32(1e6)
        ramp = f32(1) + np.arange(Tp - T, dtype=f32)
        vinit = np.concatenate([vinit, np.broadcast_to(big * ramp,
                                                       (K, Tp - T))], 1)
    logg = np.log(np.maximum(g, f32(1e-10))).astype(f32)
    nc = Tp // L
    # pass 1: one lane per (trace, chunk)
    N = K * nc
    yl = vinit.reshape(N, L)
    lg1, sm1 = np.repeat(logg, nc), np.repeat(smin.astype(f32), nc)
    v = np.zeros((N, L), f32)
    w = np.ones((N, L), f32)
    ts = np.zeros((N, L), np.int64)
    ln = np.zeros((N, L), np.int64)
    n = np.zeros(N, np.int64)
    lanes = np.arange(N)
    t_off = (lanes % nc) * L
    for t in range(L):
        v[lanes, n] = yl[:, t]
        w[lanes, n] = 1
        ts[lanes, n] = t_off + t
        ln[lanes, n] = 1
        n += 1
        _merge_top(v, w, ln, n, lg1, sm1, lanes)
    v, w = v.reshape(K, nc, L), w.reshape(K, nc, L)
    ts, ln, n_in = ts.reshape(K, nc, L), ln.reshape(K, nc, L), n.reshape(K, nc)
    # pass 2: one lane per trace
    v2 = np.zeros((K, nc * L), f32)
    w2 = np.ones((K, nc * L), f32)
    ts2 = np.zeros((K, nc * L), np.int64)
    ln2 = np.zeros((K, nc * L), np.int64)
    n2 = np.zeros(K, np.int64)
    sm = smin.astype(f32)
    rows = np.arange(K)
    for c in range(nc):
        m = n_in[:, c]
        for i in range(int(m.max()) if K else 0):
            live = rows[i < m]
            nl = n2[live]
            v2[live, nl] = v[live, c, i]
            w2[live, nl] = w[live, c, i]
            ts2[live, nl] = ts[live, c, i]
            ln2[live, nl] = ln[live, c, i]
            n2[live] += 1
            _merge_top(v2, w2, ln2, n2, logg, sm, live)
    # pools -> traces; pools that start at or past T are padding
    valid = (np.arange(nc * L)[None, :] < n2[:, None]) & (ts2 < T)
    is_start = np.zeros((K, T), np.int64)
    r_idx, p_idx = np.nonzero(valid)
    is_start[r_idx, ts2[r_idx, p_idx]] = 1
    is_start[:, 0] = 1
    seg = np.cumsum(is_start, axis=1) - 1
    pool_val = np.maximum(v2 / np.maximum(w2, f32(1e-20)), f32(0))
    t0 = np.take_along_axis(ts2, seg, 1)
    val = np.take_along_axis(pool_val, seg, 1)
    tgrid = np.arange(T)[None, :]
    c_out = (val * np.exp(logg[:, None] * (tgrid - t0).astype(f32))
             ).astype(f32)
    c_prev = np.concatenate([np.zeros((K, 1), f32), c_out[:, :-1]], 1)
    s_out = np.where((is_start == 1) & (tgrid > 0),
                     c_out - g[:, None].astype(f32) * c_prev, f32(0))
    return c_out, s_out.astype(f32)


def foopsi(y: np.ndarray, g: np.ndarray, sn: np.ndarray,
           dc: dict) -> Dict[str, np.ndarray]:
    """FOOPSI by OASIS (``foopsi_oasisAR1.m``) with the spike floor
    |smin| sn and the baseline b = mean(y - c) re-estimated
    ``max_iter`` times from its 15% quantile."""
    f32 = np.float32
    smin = dc["smin"]
    floor = (abs(smin) * sn if smin < 0
             else np.full_like(sn, smin)).astype(f32)
    if dc["lam"] != 0 or not dc["optimize_b"]:
        raise ValueError("the reference covers lam = 0 with optimize_b")
    b = np.quantile(y.astype(np.float64), 0.15, axis=-1).astype(f32)
    c = s = np.zeros_like(y)
    for _ in range(dc["max_iter"]):
        c, s = oasis_ar1(y - b[:, None], g, floor, dc["fast_chunk"])
        b = (y - c).mean(axis=-1, dtype=np.float64).astype(f32)
    return {"c": c, "s": s, "b": b}


def update_temporal(Ysig, A, C, active, tp: dict, rows: np.ndarray,
                    P: Precision) -> Dict[str, torch.Tensor]:
    """HALS on the traces (``HALS_temporal.m``), the sub-median baseline
    and the PSD noise of every trace, then the AR(1) fit and FOOPSI of
    the traces ``rows``. Returns C_raw, C and S of those rows (the
    round's outputs there) on the host."""
    dc = tp["deconv"]
    if not dc["enabled"] or dc["model"] != "ar1" \
            or dc["method"] != "foopsi" or tp["decorrelate"] \
            or dc["tau_range"] is not None or dc["sn_method"] != "psd":
        raise ValueError("the reference covers AR(1) foopsi")
    T, H, W = Ysig.shape
    K = A.shape[0]
    A_flat = A.reshape(K, H * W)
    U = P.mm(A_flat, Ysig.reshape(T, H * W).T)              # (K, T)
    V = P.mm(A_flat, A_flat.T)
    adj = (V != 0) & ~torch.eye(K, dtype=torch.bool, device=V.device)
    C_raw = colored_sweeps(adj, U, V, C, active, P, n_iter=tp["n_iter"],
                           relu=False)
    C_raw = C_raw - submedian_mean(C_raw)[:, None]
    sn = noise_psd(C_raw)
    g = ar1_coefficient(C_raw, sn, dc["ar_lags"], dc["g_range"])
    g = dc["fudge_factor"] * g
    ri = torch.as_tensor(rows, device=C.device)
    y = C_raw[ri].cpu().numpy()
    res = foopsi(y, g[ri].cpu().numpy(), sn[ri].cpu().numpy(), dc)
    c_raw = y - res["b"][:, None]
    dead = np.abs(res["c"]).sum(axis=-1) == 0
    act = active[ri].cpu().numpy()[:, None]
    c = np.where(dead[:, None], c_raw, res["c"])
    return {k: torch.as_tensor(np.where(act, x, 0.0).astype(np.float32))
            for k, x in (("C_raw", c_raw), ("C", c), ("S", res["s"]))}


# --------------------------------------------------------------------- #
# the round
# --------------------------------------------------------------------- #
def background_frames(out: dict, Y, A, C, frames: np.ndarray, bg: dict,
                      P: Precision) -> torch.Tensor:
    """The background that a round's background outputs ``out`` predict
    on the movie's frames ``frames`` (given the round's start footprints
    A and traces C)."""
    fi = torch.as_tensor(frames, device=Y.device)
    Yt, Ct = Y[fi], C[:, fi]
    if bg["model"] == "ring":
        return ring_background(out["w"], out["w0"], out["b0"], Yt, A, Ct,
                               bg, P)
    rank = out["b"].shape[0]
    return (P.mm(out["f"][:, fi].T, out["b"].reshape(rank, -1))
            ).reshape(Yt.shape) + out["b0"][None]


def run_round(Y: torch.Tensor, start: dict, sn_pix: torch.Tensor,
              params: dict, rows: np.ndarray,
              P: Optional[Precision] = None) -> dict:
    """One round from the start state ``start`` (A, C, active and, for
    the ring, the old weights w_old) on the movie Y (T, H, W). Returns
    the background outputs (w, w0, b0 or b, f, b0), A, and C_raw, C, S of
    the traces ``rows``."""
    P = P or Precision()
    bg, sp, tp = params["background"], params["spatial"], params["temporal"]
    active = start["active"]
    A = start["A"] * active[:, None, None]
    C = start["C"] * active[:, None]
    if bg["model"] == "ring":
        w, w0, b0 = fit_ring_model(Y, A, C, start.get("w_old"), sn_pix, bg,
                                   P)
        out = {"w": w, "w0": w0, "b0": b0}
        Ysig = Y - ring_background(w, w0, b0, Y, A, C, bg, P)
    elif bg["model"] == "svd":
        b, f, b0 = fit_svd_model(Y, A, C, bg["rank"], P)
        out = {"b": b, "f": f, "b0": b0}
        Ysig = Y - (P.mm(f.T, b.reshape(b.shape[0], -1)).reshape(Y.shape)
                    + b0[None])
    else:
        raise ValueError(f"the reference covers ring and svd, not "
                         f"{bg['model']!r}")
    A_new = update_spatial(Ysig, A, C, active, sp, P)
    out["A"] = A_new
    out.update(update_temporal(Ysig, A_new * active[:, None, None], C,
                               active, tp, rows, P))
    return out
