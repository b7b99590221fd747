"""The plain reference of the model-update round of a movie too large to
hold twice on one card: the round of ``references/update_round.py``
(its docstring says what a round is), computed in blocks of frames so
that it runs on ``cuda:0`` beside the harness's whole movie.

Nothing of the port is imported; the pieces of the round that hold no
movie-sized array are ``update_round.py``'s own functions, reused as
they are. What is blocked, and how that departs from the unblocked
order of ``update_round.run_round`` (all rounding only):

  * the ring fit's residual is made only on the frames its stride keeps,
    in blocks of them, and the outlier clamp runs on those frames alone
    (the clamp is per frame, so the frames the fit reads are the same);
  * the subtracted movie ``Ysig = Y - B`` is never held whole: each pass
    over it recomputes it a block of frames at a time
    (``update_round.ring_background`` on the block);
  * the spatial products ``C Ysig^T`` and ``sum_t Ysig`` are sums of the
    blocks' products, added in block order, and the temporal product
    ``A Ysig^T`` is made a block of columns at a time.

The means of Y and C, the Grams ``C C^T`` and ``A A^T``, the sweeps, the
shape prior, the baseline, the noise, the AR(1) fit and OASIS are
``update_round.py``'s, unblocked.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from benchmark.references.update_round import (  # noqa: F401
    Precision, _maxpool, ar1_coefficient, background_frames,
    box_downsample, colored_sweeps, connectivity_constraint, disc, foopsi,
    fit_ring_weights, noise_psd, pixel_noise, ring_background,
    ring_offsets, ssub_geometry, submedian_mean, uniform_ring_weights,
    apply_ring)

BLOCK_ELEMENTS = 1 << 28        # a block of frames holds at most this many


def frame_block(Y: torch.Tensor) -> int:
    """Frames a block: at most ``BLOCK_ELEMENTS`` pixels of the movie."""
    T, H, W = Y.shape
    return max(1, min(T, BLOCK_ELEMENTS // (H * W)))


def fit_ring_model(Y, A, C, w_old, sn, bg: dict, P: Precision,
                   block: int):
    """``update_round.fit_ring_model`` on the strided frames alone, made
    ``block`` of them at a time. Returns (w, w0, b0)."""
    T, H, W = Y.shape
    K = A.shape[0]
    ssub = bg["ssub"]
    A_flat = A.reshape(K, -1)
    Ymean = Y.mean(dim=0)
    Cmean = C.mean(dim=-1)
    b0 = Ymean - P.mm(Cmean, A_flat).reshape(H, W)
    Cc = C - Cmean[:, None]
    Hs, Ws, radius_s = ssub_geometry(H, W, bg["ring_radius"], ssub)
    R = ring_offsets(radius_s).shape[0]
    nmax = bg["frame_cap_factor"] * R
    stride = int(np.ceil(T / nmax)) if T > nmax else 1
    clamp = w_old is not None and sn is not None \
        and math.isfinite(bg["thresh_outlier"])
    sn_s = box_downsample(sn[None], ssub)[0] if clamp else None
    frames = torch.arange(0, T, stride, device=Y.device)
    parts = []
    for i in range(0, frames.numel(), block):
        fi = frames[i:i + block]
        Bf = (Y[fi] - Ymean[None]) - P.mm(Cc[:, fi].T, A_flat).reshape(
            fi.numel(), H, W)
        Bf = box_downsample(Bf, ssub)
        if clamp:
            pred = apply_ring(w_old, torch.zeros_like(w_old[:, 0]), Bf,
                              radius_s)
            Bf = torch.where(Bf > pred + bg["thresh_outlier"] * sn_s[None],
                             pred, Bf)
            del pred
        parts.append(Bf)
    Bf_fit = torch.cat(parts)
    del parts
    w, w0 = fit_ring_weights(Bf_fit, radius_s, bg["ridge_eps"], P)
    return w, w0, b0


def signal_blocks(Y, out: dict, A, C, bg: dict, P: Precision, block: int):
    """(t0, t1, Ysig of frames [t0, t1) as (t1 - t0, H W)), block by
    block: the movie less the background that the round's ring outputs
    ``out`` predict."""
    T, H, W = Y.shape
    for t0 in range(0, T, block):
        t1 = min(t0 + block, T)
        Yb = Y[t0:t1]
        Ysig = Yb - ring_background(out["w"], out["w0"], out["b0"], Yb, A,
                                    C[:, t0:t1], bg, P)
        yield t0, t1, Ysig.reshape(t1 - t0, H * W)


def update_spatial(U, Ysum, A, C, active, sp: dict, P: Precision):
    """``update_round.update_spatial`` from its products: ``U`` = C Ysig^T
    (K, H W) and ``Ysum`` = the frames' sum of Ysig (H W,)."""
    if sp["algorithm"] != "hals" or sp["search_method"] != "dilate" \
            or sp["circular"]:
        raise ValueError("the reference covers hals on dilated supports")
    K, H, W = A.shape
    T = C.shape[1]
    d = H * W
    masks = _maxpool((A > 0).to(torch.float32),
                     disc(sp["dilate_radius"])) > 0.5
    masks = (masks & active[:, None, None]).reshape(K, d)
    Ymean = (Ysum / T)[None]                               # (1, d)
    Cmean = C.mean(dim=1, keepdim=True)                    # (K, 1)
    U = U - T * P.mm(Cmean, Ymean)                         # (K, d)
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


def update_temporal(U, A, C, active, tp: dict, rows: np.ndarray,
                    P: Precision) -> Dict[str, torch.Tensor]:
    """``update_round.update_temporal`` from its product ``U`` = A
    Ysig^T (K, T)."""
    dc = tp["deconv"]
    if not dc["enabled"] or dc["model"] != "ar1" \
            or dc["method"] != "foopsi" or tp["decorrelate"] \
            or dc["tau_range"] is not None or dc["sn_method"] != "psd":
        raise ValueError("the reference covers AR(1) foopsi")
    K = A.shape[0]
    A_flat = A.reshape(K, -1)
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


def run_round(Y: torch.Tensor, start: dict, sn_pix: torch.Tensor,
              params: dict, rows: np.ndarray,
              P: Optional[Precision] = None,
              block: Optional[int] = None) -> dict:
    """``update_round.run_round`` of the ring background (the same
    arguments and outputs), in blocks of ``block`` frames (default
    :func:`frame_block`)."""
    P = P or Precision()
    bg, sp, tp = params["background"], params["spatial"], params["temporal"]
    if bg["model"] != "ring":
        raise ValueError(f"the blocked reference covers the ring, not "
                         f"{bg['model']!r}")
    block = block or frame_block(Y)
    T, H, W = Y.shape
    active = start["active"]
    A = start["A"] * active[:, None, None]
    C = start["C"] * active[:, None]
    K = A.shape[0]
    w, w0, b0 = fit_ring_model(Y, A, C, start.get("w_old"), sn_pix, bg, P,
                               block)
    out = {"w": w, "w0": w0, "b0": b0}
    U = torch.zeros((K, H * W), dtype=torch.float32, device=Y.device)
    Ysum = torch.zeros(H * W, dtype=torch.float32, device=Y.device)
    for t0, t1, Ysig in signal_blocks(Y, out, A, C, bg, P, block):
        U += P.mm(C[:, t0:t1], Ysig)
        Ysum += Ysig.sum(dim=0)
    A_new = update_spatial(U, Ysum, A, C, active, sp, P)
    del U
    out["A"] = A_new
    A_act = A_new * active[:, None, None]
    A_flat = A_act.reshape(K, H * W)
    Ut = torch.empty((K, T), dtype=torch.float32, device=Y.device)
    for t0, t1, Ysig in signal_blocks(Y, out, A, C, bg, P, block):
        Ut[:, t0:t1] = P.mm(A_flat, Ysig.T)
    out.update(update_temporal(Ut, A_act, C, active, tp, rows, P))
    return out
