"""The ring-background kernels, their plain PyTorch versions and the dispatch
(port of ``cnmf_e_tpu/ops/pallas_ring.py`` and
``cnmf_e_tpu/ops/pallas_ring_mxu.py``).

  * :func:`apply_ring_stencil` (K6) — the direct f32 ring stencil
    ``out[t,h,w] = w0[h,w] + sum_r w[h*W+w, r] * X[t, h+dy_r, w+dx_r]``,
    zero outside the field of view (replaces ``apply_ring_pallas``);
  * :func:`apply_ring_mxu_flat` (K5) and :func:`apply_ring_mxu` (K7) — the
    same apply as a banded bf16 product with f32 accumulation,
    ``out[t, h, :] = w0[h, :] + Xpad[t, h*W:(h+D)*W] @ bands[h]``, on the
    flat (T, H*W) and the (H, T, W) layout of the movie (replace
    ``apply_ring_mxu_flat`` and ``apply_ring_mxu``). ``bands`` comes from
    :func:`ring_dense_bands`.

CUDA tensors launch ``csrc/ring_stencil.cu`` and ``csrc/ring_banded.cu``;
CPU tensors run the ``*_reference`` versions. :func:`ring_offsets` lives
here so that ``ops/ring.py`` can dispatch to these kernels. The geometry
the kernels need is computed here, where the CPU tests reach it:
:func:`_stencil_plan` picks K6's body and tiling, :func:`banded_k_blocks`
lists the k blocks of K5's and K7's bands that hold a tap.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.cuda_build import check_cuda, launch
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops.hals_kernels import _sm_count

_SMEM_CAP = 232448          # opt-in shared memory per block on Hopper
_STENCIL_FRAMES = 128       # frames per CTA of the shared-memory body
# K6's register body (csrc/ring_stencil.cu: kHT, kWT, kStages, kWideTaps,
# kFNarrow, kFWide, kMaxRegRadius): an 8 x 32 pixel tile, 3 frame groups
# staged; up to 56 taps 4 frames a thread and two CTAs an SM, past that 8
# frames and one CTA; a template per integer radius up to 14 (radius 15's
# halos pass the shared memory a CTA can have)
_REGS_TILE = (8, 32)
_REGS_STAGES = 3
_REGS_WIDE_TAPS = 56
_REGS_FRAMES = (4, 8)
_REGS_MAX_RADIUS = 14
# K5/K7 (csrc/ring_banded.cu: TN, KB): output columns a CTA, depth of a
# listed k block
_BAND_TN = 64
_BAND_KB = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ring_offsets(radius: int) -> np.ndarray:
    """(R, 2) int32 pixel offsets (dy, dx) at distance in
    [radius, radius + 1) (``get_nhood.m``)."""
    r = int(np.ceil(radius)) + 1
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    R = np.sqrt(x ** 2 + y ** 2)
    sel = (R >= radius) & (R < radius + 1)
    return np.stack([y[sel], x[sel]], axis=1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _ring_size(radius) -> Tuple[int, int]:
    """(R, mr): the ring's tap count and its largest offset."""
    offsets = ring_offsets(radius)
    return int(offsets.shape[0]), int(np.abs(offsets).max())


@functools.lru_cache(maxsize=64)
def _offsets_on(radius, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring's (dy, dx), int32 on ``device``, copied there once: a copy
    per call would make the host wait for the card."""
    offsets = ring_offsets(radius)
    return tuple(torch.as_tensor(offsets[:, i], device=device).contiguous()
                 for i in (0, 1))


def _masked_weights(w: torch.Tensor, H: int, W: int,
                    offsets: np.ndarray) -> torch.Tensor:
    """w (H*W, R) with its out-of-FOV taps set to 0."""
    dev = w.device
    dy, dx = (torch.as_tensor(offsets[:, i], device=dev) for i in (0, 1))
    yy = torch.arange(H, device=dev)[:, None, None] + dy
    xx = torch.arange(W, device=dev)[None, :, None] + dx
    valid = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)      # (H, W, R)
    return w * valid.reshape(H * W, -1).to(w.dtype)


# --------------------------------------------------------------------- #
# K6: the f32 stencil
# --------------------------------------------------------------------- #
def apply_ring_stencil_reference(w: torch.Tensor, w0: torch.Tensor,
                                 X: torch.Tensor, H: int, W: int,
                                 radius: int) -> torch.Tensor:
    """Sum of R weighted shifts of the zero-padded movie, in offset order,
    then w0. X: (T, H, W); w: (H*W, R); w0: (H*W,)."""
    offsets = ring_offsets(radius)
    m = int(np.abs(offsets).max())
    Xp = F.pad(X, (m, m, m, m))
    w_img = w.reshape(H, W, -1)
    out = torch.zeros_like(X)
    for r, (dy, dx) in enumerate(offsets):
        shifted = Xp[:, m + dy:m + dy + H, m + dx:m + dx + W]
        out = out + w_img[None, :, :, r] * shifted
    return out + w0.reshape(1, H, W)


def _stencil_tile(H: int, W: int, R: int, mr: int) -> Tuple[int, int]:
    """(HT, WT) of the shared-memory body: a pixel tile of at most 256
    pixels, 32 columns wide, shrunk until its (R, HT*WT) weights and two
    frame halos fit in shared memory."""
    WT = min(W, 32)
    HT = max(1, min(H, 256 // WT))

    def smem(ht, wt):
        return (R * ht * wt + 2 * (ht + 2 * mr) * (wt + 2 * mr) + R) * 4

    while smem(HT, WT) > _SMEM_CAP and HT * WT > 1:
        if HT > 1:
            HT //= 2
        else:
            WT //= 2
    if smem(HT, WT) > _SMEM_CAP:
        raise ValueError(f"{R} ring taps do not fit one pixel in shared "
                         f"memory")
    return HT, WT


class StencilPlan(NamedTuple):
    """K6's launch: which body, its pixel tile, the frames a thread sums at
    once, the frames a CTA walks and the shared memory a CTA takes."""
    body: str               # "registers" or "shared"
    HT: int
    WT: int
    frames_per_thread: int
    TT: int
    smem_bytes: int


def _regs_frames_ctas(R: int) -> Tuple[int, int]:
    """Frames a thread and CTAs an SM of the register body for R taps."""
    wide = R > _REGS_WIDE_TAPS
    return _REGS_FRAMES[wide], 1 if wide else 2


def _regs_frames_per_cta(T: int, H: int, W: int, frames: int, ctas: int,
                         n_sm: int) -> int:
    """TT: the register body's CTAs split T so that about ``ctas`` CTAs an
    SM cover the movie in one wave; a multiple of ``frames``."""
    HT, WT = _REGS_TILE
    tiles = _cdiv(H, HT) * _cdiv(W, WT)
    split = max(1, min(_cdiv(T, frames), round(ctas * n_sm / tiles)))
    return _cdiv(_cdiv(T, split), frames) * frames


@functools.lru_cache(maxsize=256)
def _stencil_plan(T: int, H: int, W: int, radius, n_sm: int) -> StencilPlan:
    """The register body for an integer radius up to ``_REGS_MAX_RADIUS``
    (its taps are compiled in) on a width whose rows the halo's tensor map
    can stride (W % 4 == 0: 16-byte strides); the shared-memory body for
    every other shape."""
    R, mr = _ring_size(radius)
    if float(radius).is_integer() and 1 <= radius <= _REGS_MAX_RADIUS \
            and W % 4 == 0:
        HT, WT = _REGS_TILE
        frames, ctas = _regs_frames_ctas(R)
        TT = _regs_frames_per_cta(T, H, W, frames, ctas, n_sm)
        mra = _cdiv(mr, 4) * 4            # halo columns start 16-byte aligned
        # the halo groups and an mbarrier each
        smem = _REGS_STAGES * (frames * (HT + 2 * mr) * (WT + 2 * mra) * 4
                               + 8)
        return StencilPlan("registers", HT, WT, frames, TT, smem)
    HT, WT = _stencil_tile(H, W, R, mr)
    smem = (R * HT * WT + 2 * (HT + 2 * mr) * (WT + 2 * mr) + R) * 4
    return StencilPlan("shared", HT, WT, 1, _STENCIL_FRAMES, smem)


def apply_ring_stencil(w: torch.Tensor, w0: torch.Tensor, X: torch.Tensor,
                       H: int, W: int, radius: int) -> torch.Tensor:
    """The ring prediction W X + w0 of a (T, H, W) movie (K6). Taps
    outside the field of view read zeros, whatever their weight."""
    if not X.is_cuda:
        return apply_ring_stencil_reference(w, w0, X, H, W, radius)
    R, mr = _ring_size(radius)
    T = X.shape[0]
    if tuple(X.shape) != (T, H, W) or tuple(w.shape) != (H * W, R) \
            or w0.numel() != H * W:
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, w "
                         f"{tuple(w.shape)}, w0 {tuple(w0.shape)} for "
                         f"H={H}, W={W}, R={R}")
    X = X.to(torch.float32).contiguous()
    if X.data_ptr() % 16:
        X = X.clone()           # a tensor map's base is 16-byte aligned
    wt = w.to(torch.float32).T.contiguous()                  # (R, H*W)
    w0 = w0.to(torch.float32).reshape(-1).contiguous()
    out = torch.empty_like(X)
    check_cuda(X, wt, w0, out, dtypes=(torch.float32,) * 4)
    if T == 0 or H * W == 0:
        return out
    plan = _stencil_plan(T, H, W, radius, _sm_count(X.device.index))
    if plan.body == "registers":
        launch("ring_stencil", X.device, X, wt, w0, out, T, H, W,
               int(radius), plan.TT, entry="ring_stencil_regs_launch")
        return out
    dy, dx = _offsets_on(radius, X.device)
    launch("ring_stencil", X.device, X, wt, w0, dy, dx, out, T, H, W, R, mr,
           plan.HT, plan.WT, plan.TT, entry="ring_stencil_smem_launch")
    return out


# --------------------------------------------------------------------- #
# K5 / K7: the banded bf16 product
# --------------------------------------------------------------------- #
def _band_geometry(radius: int) -> Tuple[int, int]:
    mr = int(np.abs(ring_offsets(radius)).max())
    return mr, 2 * mr + 1


def ring_dense_bands(weights: RingWeights, H: int, W: int, radius: int
                     ) -> torch.Tensor:
    """The banded product's operand, (H, D*W, W) bf16 with D = 2*mr + 1:
    bands[h, (dy+mr)*W + w + dx, w] = w[h*W + w, r] for every in-FOV tap
    r = (dy, dx), zero elsewhere. One scatter, as
    ``pallas_ring_mxu.py:52-81``."""
    offsets = ring_offsets(radius)
    R = int(offsets.shape[0])
    mr, D = _band_geometry(radius)
    wm = _masked_weights(weights.w, H, W, offsets).reshape(H, W, R)
    wcol = np.arange(W)
    d_idx = np.broadcast_to((offsets[:, 0] + mr)[None, :], (W, R))
    row_idx = wcol[:, None] + offsets[None, :, 1]
    col_idx = np.broadcast_to(wcol[:, None], (W, R))
    # taps whose column passes W have no band entry. The JAX scatter wraps
    # a negative column to column + W before it drops: those taps are out
    # of the FOV, so they write a masked weight (a signed zero) where no
    # live tap lands while W > 2*mr. Scattering them first, and the live
    # taps after, keeps the bands bit-identical and lets a live tap win.
    dev = weights.w.device
    bands = torch.zeros((H, D, W, W), dtype=torch.bfloat16, device=dev)
    for sel in (row_idx < 0, (row_idx >= 0) & (row_idx < W)):
        wi, ri = (torch.as_tensor(a, device=dev) for a in np.nonzero(sel))
        d, row, col = (torch.as_tensor(a[sel], device=dev)
                       for a in (d_idx, row_idx % W, col_idx))
        bands[:, d, row, col] = wm[:, wi, ri].to(torch.bfloat16)
    return bands.reshape(H, D * W, W)


def _bf16_f32(X: torch.Tensor) -> torch.Tensor:
    return X.to(torch.bfloat16).to(torch.float32)


def apply_ring_mxu_flat_reference(bands: torch.Tensor, w0: torch.Tensor,
                                  X: torch.Tensor, H: int, W: int,
                                  radius: int) -> torch.Tensor:
    """K5's plain version: the f32 product of the bf16-rounded operands,
    one output row at a time on a strided window of the padded flat movie
    (a window of all rows at once would be a T x H x D*W copy)."""
    mr, D = _band_geometry(radius)
    T = X.shape[0]
    Xp = F.pad(_bf16_f32(X.reshape(T, H * W)), (mr * W, mr * W))
    out = torch.empty((T, H, W), dtype=torch.float32, device=X.device)
    for h in range(H):
        out[:, h, :] = Xp[:, h * W:(h + D) * W] @ bands[h].to(torch.float32)
    return out + w0.to(torch.float32).reshape(1, H, W)


def apply_ring_mxu_reference(bands: torch.Tensor, w0: torch.Tensor,
                             X: torch.Tensor, H: int, W: int,
                             radius: int) -> torch.Tensor:
    """K7's plain version: the f32 product of the bf16-rounded operands on
    the (H, T, W) layout, one output row at a time."""
    mr, D = _band_geometry(radius)
    T = X.shape[0]
    Xt = F.pad(_bf16_f32(X).permute(1, 0, 2), (0, 0, 0, 0, mr, mr))
    out = torch.empty((H, T, W), dtype=torch.float32, device=X.device)
    for h in range(H):
        slab = Xt[h:h + D].permute(1, 0, 2).reshape(T, D * W)
        out[h] = slab @ bands[h].to(torch.float32)
    return out.permute(1, 0, 2) + w0.to(torch.float32).reshape(1, H, W)


def banded_k_blocks(radius, W: int, tn: int = _BAND_TN, kb: int = _BAND_KB
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The kb-deep blocks of the bands' D*W rows that hold a tap, for each
    tile of tn output columns: ``(kstart, koff)``, int32, where tile j's
    blocks start at rows ``kstart[koff[j]:koff[j + 1]]`` (ascending). Output
    columns [n0, n1] take band row d's taps from rows d*W + [n0 + dxmin_d,
    n1 + dxmax_d], clipped to [0, W); every other block of the tile is
    zero."""
    offsets = ring_offsets(radius)
    mr, D = _band_geometry(radius)
    spans = [(d, offsets[offsets[:, 0] == d - mr, 1]) for d in range(D)]
    kstart, koff = [], [0]
    for n0 in range(0, W, tn):
        n1 = min(n0 + tn, W) - 1
        blocks = set()
        for d, dx in spans:
            if dx.size == 0:
                continue
            lo, hi = max(0, n0 + int(dx.min())), min(W - 1, n1 + int(dx.max()))
            if lo <= hi:
                blocks.update(range((d * W + lo) // kb,
                                    (d * W + hi) // kb + 1))
        kstart += sorted(b * kb for b in blocks)
        koff.append(len(kstart))
    return np.asarray(kstart, np.int32), np.asarray(koff, np.int32)


@functools.lru_cache(maxsize=64)
def _k_blocks_on(radius, W: int, device: torch.device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`banded_k_blocks` at the kernels' tile sizes, on ``device``,
    built once per (radius, W)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in banded_k_blocks(radius, W))


def _banded(kernel: str, Xb: torch.Tensor, bands: torch.Tensor,
            w0: torch.Tensor, T: int, H: int, W: int, radius
            ) -> torch.Tensor:
    """Launch K5 (``ring_banded_flat``, Xb the (T, H*W) bf16 movie) or K7
    (``ring_banded_htw``, Xb (H, T, W)); the kernels read rows outside
    [0, H) as zeros, so the movie comes unpadded."""
    if W % 8:
        raise ValueError(f"the banded kernels load rows in 16-byte chunks "
                         f"and need W % 8 == 0, got W={W}")
    _, D = _band_geometry(radius)
    if tuple(bands.shape) != (H, D * W, W) or w0.numel() != H * W \
            or Xb.numel() != T * H * W:
        raise ValueError(f"shape mismatch: X {tuple(Xb.shape)}, bands "
                         f"{tuple(bands.shape)}, w0 {tuple(w0.shape)} for "
                         f"T={T}, H={H}, W={W}, D={D}")
    bands = bands.to(torch.bfloat16).contiguous()
    w0 = w0.to(torch.float32).reshape(-1).contiguous()
    out = torch.empty((T, H, W), dtype=torch.float32, device=Xb.device)
    kstart, koff = _k_blocks_on(radius, W, Xb.device)
    check_cuda(Xb, bands, w0, kstart, koff, out,
               dtypes=(torch.bfloat16,) * 2 + (torch.float32,)
               + (torch.int32,) * 2 + (torch.float32,))
    if T == 0 or H * W == 0:
        return out
    launch(kernel, Xb.device, Xb, bands, w0, kstart, koff, out, T, H, W, D)
    return out


def apply_ring_mxu_flat(bands: torch.Tensor, w0: torch.Tensor,
                        X: torch.Tensor, H: int, W: int,
                        radius: int) -> torch.Tensor:
    """Banded-product ring apply on the flat movie (K5). X: (T, H, W) f32,
    rounded to bf16 here; returns (T, H, W) f32 including w0."""
    if not X.is_cuda:
        return apply_ring_mxu_flat_reference(bands, w0, X, H, W, radius)
    T = X.shape[0]
    Xb = X.reshape(T, H * W).to(torch.bfloat16).contiguous()
    return _banded("ring_banded_flat", Xb, bands, w0, T, H, W, radius)


def apply_ring_mxu(bands: torch.Tensor, w0: torch.Tensor, X: torch.Tensor,
                   H: int, W: int, radius: int) -> torch.Tensor:
    """Banded-product ring apply on the (H, T, W) layout (K7, the same
    kernel body as K5 through strides). X: (T, H, W) f32, rounded to bf16
    here; returns (T, H, W) f32 including w0."""
    if not X.is_cuda:
        return apply_ring_mxu_reference(bands, w0, X, H, W, radius)
    T = X.shape[0]
    Xb = X.to(torch.bfloat16).permute(1, 0, 2).contiguous()
    return _banded("ring_banded_htw", Xb, bands, w0, T, H, W, radius)
