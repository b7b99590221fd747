"""Morphological ops and shape priors, batched over neurons (port of
``cnmf_e_tpu/ops/morphology.py``; reference ``circular_constraints.m``,
``connectivity_constraint.m``, ``determine_search_location.m``,
``threshold_components.m``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.parallel import comm


def disc_kernel(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return ((x ** 2 + y ** 2) <= radius ** 2).astype(np.float32)


_CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.float32)
_CHECK_EVERY = 16           # propagation steps between fixed-point checks


def _maxpool(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Max-filter of (..., H, W) by a structuring element; out-of-image
    samples never win."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    lead = x.shape[:-2]
    H, W = x.shape[-2:]
    x4 = x.reshape((-1, 1, H, W))
    if np.all(kernel > 0) and kh % 2 == 1 and kw % 2 == 1:
        out = F.max_pool2d(x4, (kh, kw), stride=1, padding=(ph, pw))
        return out.reshape(x.shape)
    neg = torch.finfo(x.dtype).min
    xp = F.pad(x4, (pw, kw - 1 - pw, ph, kh - 1 - ph), value=neg)
    out = None
    for dy, dx in np.argwhere(kernel > 0):
        s = xp[..., dy:dy + H, dx:dx + W]
        out = s if out is None else torch.maximum(out, s)
    return out.reshape(lead + (H, W))


def dilate(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary dilation of (..., H, W) by a disc."""
    return _maxpool(mask.to(torch.float32), disc_kernel(radius)) > 0.5


def erode(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Binary erosion of (..., H, W) by a disc."""
    return ~(_maxpool((~mask).to(torch.float32), disc_kernel(radius)) > 0.5)


def opening(img: torch.Tensor, size: int = 5) -> torch.Tensor:
    """Grayscale opening with a square structuring element."""
    k = np.ones((size, size), np.float32)
    return _maxpool(-_maxpool(-img, k), k)


def label_from_seed(mask: torch.Tensor, seed_row: torch.Tensor,
                    seed_col: torch.Tensor) -> torch.Tensor:
    """The 4-connected component of ``mask`` (..., H, W) containing
    (seed_row, seed_col), by iterated neighbor-max propagation.

    Runs the JAX package's H + W propagation steps, but stops early once a
    block of ``_CHECK_EVERY`` steps changes nothing: the propagation is
    then at its fixed point and further steps return the same mask."""
    H, W = mask.shape[-2:]
    n_iter = H + W
    m = mask.to(torch.float32)
    seed = (F.one_hot(seed_row.long(), H).to(torch.float32)[..., :, None]
            * F.one_hot(seed_col.long(), W).to(torch.float32)[..., None, :])
    reach = seed * m
    done = 0
    while done < n_iter:
        prev = reach
        for _ in range(min(_CHECK_EVERY, n_iter - done)):
            reach = torch.minimum(_maxpool(reach, _CROSS), m)
        done += _CHECK_EVERY
        if torch.equal(reach, prev):
            break
    return reach > 0.5


def _peak_rc(img: torch.Tensor):
    W = img.shape[-1]
    flat_arg = img.reshape(img.shape[:-2] + (-1,)).argmax(dim=-1)
    return flat_arg // W, flat_arg % W


def on_gathered(fn, img: torch.Tensor, mesh) -> torch.Tensor:
    """``fn`` of whole footprints, such as the shape priors
    :func:`connectivity_constraint` and :func:`circular_constraint`:
    under a mesh ``img`` (..., H/patch, W) is this rank's rows, gathered
    over 'patch', ``fn`` runs on the whole field of view, the same on
    every rank (its ops are deterministic), and the rank keeps its rows
    of the result; ``fn(img)`` without a mesh.

    The flood fills of the shape priors cross slabs, and at K = 192
    footprints of 256x256 the gather hands each of 2 patch ranks 25.2 MB
    once a call. A ghost-zone fill would exchange 2 x ``_CHECK_EVERY``
    rows of every footprint per block of steps: 6.3 MB a block, so 12.6
    MB for a blob that settles in two blocks and up to 201 MB for the
    H + W steps, besides the opening's and the peak's exchanges."""
    if mesh is None:
        return fn(img)
    Hl = img.shape[-2]
    full = comm.all_gather_cat(img, img.dim() - 2, mesh.patch_group)
    return fn(full)[..., mesh.p * Hl:(mesh.p + 1) * Hl, :].contiguous()


def connectivity_constraint(img: torch.Tensor, thr: float = 0.01,
                            se_size: int = 5) -> torch.Tensor:
    """Keep only the peak-connected blob of each footprint (..., H, W):
    open, threshold at thr * max, keep the component holding the peak."""
    opened = opening(img, se_size)
    peak = img.amax(dim=(-2, -1), keepdim=True)
    core = opened > torch.clamp(peak * thr, min=1e-12)
    pr, pc = _peak_rc(img)
    keep = label_from_seed(core, pr, pc)
    return torch.where(keep, img, 0.0)


def circular_constraint(img: torch.Tensor) -> torch.Tensor:
    """Zero dim pixels whose gradient points away from the peak, then keep
    the peak's (dilated) connected component."""
    H, W = img.shape[-2:]
    pr, pc = _peak_rc(img)
    vmax = img.amax(dim=(-2, -1), keepdim=True)
    fy, fx = torch.gradient(img, dim=(-2, -1))
    yy = torch.arange(H, dtype=img.dtype, device=img.device)[:, None]
    xx = torch.arange(W, dtype=img.dtype, device=img.device)[None, :]
    dy = pr.to(img.dtype)[..., None, None] - yy
    dx = pc.to(img.dtype)[..., None, None] - xx
    bad = ((fx * dx + fy * dy) < 0) & (img < vmax / 3.0)
    out = torch.where(bad, 0.0, img)
    keep = dilate(label_from_seed(out > 0, pr, pc), 1)
    return torch.where(keep, out, 0.0)


def search_locations_dilate(A: torch.Tensor, radius: int = 4,
                            thr: float = 0.0, mesh=None) -> torch.Tensor:
    """'dilate' search masks: grow each footprint's support by a disc.

    ``mesh``: A is this rank's (K, H/patch, W) rows; the slab takes
    ``radius`` rows from its patch neighbours before the dilation and
    drops them after, and the peaks are the maxima over 'patch'."""
    peak = A.amax(dim=(-2, -1), keepdim=True)
    if mesh is None:
        return dilate(A > torch.clamp(thr * peak, min=0.0), radius)
    peak = comm.all_reduce_max(peak, mesh.patch_group)
    Hp = A.shape[-2]
    Ap = comm.halo_rows(A, radius, mesh)
    return dilate(Ap > torch.clamp(thr * peak, min=0.0),
                  radius)[..., radius:radius + Hp, :]


def search_locations_ellipse(A: torch.Tensor, dist: float = 3.0,
                             min_size: float = 3.0, max_size: float = 8.0,
                             mesh=None) -> torch.Tensor:
    """'ellipse' search masks (``determine_search_location.m``'s
    default): per neuron, an ellipse centred at the footprint's centre of
    mass with axes along the principal axes of its pixel-coordinate
    covariance, each half-axis ``dist`` standard deviations clamped to
    [min_size, max_size]. A: (K, H, W) -> bool (K, H, W).

    The 2x2 eigen-decompositions are in closed form, elementwise over
    the K neurons: one angle theta = atan2(2 s_yx, s_yy - s_xx) / 2 gives
    both eigenvectors. The mask depends on the eigenvectors only through
    the squared projections, so their signs do not matter, nor their
    rotation when the two eigenvalues are equal (the ellipse is then a
    disc). Unlike ``torch.linalg.eigh`` this runs the same elementwise
    operations on the card and on the CPU, with no solver call.

    ``mesh``: A is this rank's (K, H/patch, W) rows, y counts the whole
    field of view's rows, the mass, the centre and the second moments
    are summed over 'patch', and each rank builds its rows' masks."""
    K, H, W = A.shape
    y0 = 0 if mesh is None else mesh.p * H
    yy = torch.arange(y0, y0 + H, dtype=A.dtype, device=A.device)[:, None]
    xx = torch.arange(W, dtype=A.dtype, device=A.device)[None, :]
    first = comm.psum(torch.stack([A.sum(dim=(1, 2)),
                                   (A * yy[None]).sum(dim=(1, 2)),
                                   (A * xx[None]).sum(dim=(1, 2))]),
                      mesh, "patch")
    mass = first[0] + 1e-12
    cy = first[1] / mass
    cx = first[2] / mass
    dy = yy[None] - cy[:, None, None]
    dx = xx[None] - cx[:, None, None]
    second = comm.psum(torch.stack([(A * dy * dy).sum(dim=(1, 2)),
                                    (A * dx * dx).sum(dim=(1, 2)),
                                    (A * dx * dy).sum(dim=(1, 2))]),
                       mesh, "patch") / mass
    syy, sxx, sxy = second[0], second[1], second[2]
    half = (syy - sxx) / 2
    rad = torch.sqrt(half * half + sxy * sxy)
    mid = (syy + sxx) / 2
    evals = torch.stack([mid - rad, mid + rad], dim=-1)     # ascending
    axes = torch.clamp(torch.sqrt(torch.clamp(evals, min=1e-6)) * dist,
                       min_size, max_size)                  # (K, 2)
    theta = torch.atan2(2 * sxy, syy - sxx) / 2
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    # the minor axis (-sin, cos), the major axis (cos, sin), in (y, x)
    p_minor = -sin * dy + cos * dx
    p_major = cos * dy + sin * dx
    r2 = (p_minor / axes[:, 0, None, None]) ** 2 \
        + (p_major / axes[:, 1, None, None]) ** 2
    return r2 <= 1.0


def threshold_components(A: torch.Tensor, energy_frac: float = 0.99
                         ) -> torch.Tensor:
    """Keep each footprint's smallest pixel set holding ``energy_frac`` of
    its energy (``threshold_components.m``): the pixels whose squared
    value is at least that of the last pixel the descending cumulative
    energy needs."""
    K = A.shape[0]
    flat = A.reshape(K, -1)
    e = flat * flat
    order = torch.sort(e, dim=-1, descending=True).values
    csum = torch.cumsum(order, dim=-1)
    n_keep = (csum < energy_frac * csum[:, -1:]).sum(dim=-1) + 1
    thr2 = torch.gather(order, 1, torch.clamp(n_keep[:, None] - 1,
                                              max=order.shape[1] - 1))
    return (flat * (e >= thr2)).reshape(A.shape)
