"""The fused multi-sweep HALS kernel, its plain PyTorch version and the
dispatch (port of ``cnmf_e_tpu/ops/pallas_hals.py``).

:func:`hals_sweeps` runs ``n_iter`` class-scheduled Gauss-Seidel sweeps on
a row-major factor X (K, d) given U (K, d) and the symmetric Gram V (K, K)
— both HALS factors (``HALS_spatial.m:26-46``, ``HALS_temporal.m:58-107``)
go through it. CUDA tensors launch ``csrc/hals_sweeps.cu``; CPU tensors run
:func:`hals_sweeps_reference`. A masked call launches the kernel's
compacted body, which runs each column tile on the rows its mask touches,
and the dense body on the tiles it could not hold (more than
:data:`COMPACT_ROWS` active rows); :func:`compact_stats` counts them.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from cnmf_e_tpu_torch.cuda_build import check_cuda, device_counters, launch

_SMEM_CAP = 232448          # opt-in shared memory per block on Hopper
# active rows a column tile of the compacted body holds (kCap in
# csrc/hals_sweeps.cu); a tile with more runs the dense body
COMPACT_ROWS = 64
_STATS = "hals_compact"     # device counters: compacted tiles, fallback
                            # tiles, active rows of the compacted tiles


def _rows_per_step(K: int, block: int) -> int:
    """B: rows per schedule step, ``block`` rounded up to the JAX kernel's
    8-row grid (``pallas_hals.py:284-286``)."""
    return max(8, -(-min(block, max(K, 1)) // 8) * 8)


def _step_rows(schedule: Tuple, K: int, B: int):
    """(lo, hi, free) per schedule step. A step starting at row s of a
    class ending at e covers rows [s, min(sc + B, e, K)), with
    sc = min(8 * (s // 8), Kp - B) clamped at 0: the JAX kernel's 8-aligned
    B-row window, gated to the class (the CUDA kernel computes the same)."""
    starts, ends, free, n_steps = schedule
    Kp = -(-K // B) * B
    steps = list(zip(starts.tolist(), ends.tolist(), free.tolist()))
    out = []
    for s, e, fr in steps[:int(n_steps)]:
        sc = max(min(s // 8 * 8, Kp - B), 0)
        out.append((s, min(sc + B, e, K), fr))
    return out


def hals_sweeps_reference(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
                          gate: torch.Tensor, schedule: Tuple,
                          mask: Optional[torch.Tensor] = None,
                          n_iter: int = 5, block: int = 16,
                          relu: bool = True) -> torch.Tensor:
    """The plain version of :func:`hals_sweeps`: a free step as one matmul
    from its snapshot, a non-free step row by row. The mask folds into U as
    the JAX kernel's -1e30 sentinel: masked entries start at 0 and every
    update relus (x + (-1e30 - .) / cc) back to 0."""
    K = X.shape[0]
    U = U.to(torch.float32)
    V = V.to(torch.float32)
    X = X.to(torch.float32).clone()
    if mask is not None:
        if not relu:
            raise ValueError("a support mask needs relu=True")
        mb = mask if mask.dtype == torch.bool else mask > 0
        X = torch.where(mb, X, 0.0)
        U = torch.where(mb, U, -1e30)
    diag = torch.diagonal(V)
    gate = gate.to(torch.float32) * (diag > 0)
    cc = torch.clamp(diag, min=1e-12)
    steps = _step_rows(schedule, K, _rows_per_step(K, block))
    for _ in range(n_iter):
        for r0, r1, fr in steps:
            if r1 <= r0:
                continue
            if fr:
                R = U[r0:r1] - V[r0:r1] @ X
                xn = X[r0:r1] + R / cc[r0:r1, None]
                if relu:
                    xn = torch.clamp(xn, min=0.0)
                X[r0:r1] = torch.where(gate[r0:r1, None] > 0, xn, X[r0:r1])
                continue
            for k in range(r0, r1):
                if not gate[k] > 0:
                    continue
                xn = X[k] + (U[k] - V[k] @ X) / cc[k]
                X[k] = torch.clamp(xn, min=0.0) if relu else xn
    return X


# shared-memory floats of one CTA, as csrc/hals_sweeps.cu lays them out:
# the V slice (KC Gram columns of up to 64 rows, stride 68), the (K, TD) X
# tile, the in-order chunk's residual rows (32 x TD) and V block
# (32 x 33), and its rows' cc and gate (32 each)
_VS_STRIDE = 68
_ROWS_SEQ = 32


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _smem_bytes(K: int, TD: int, KC: int) -> int:
    return 4 * (KC * _VS_STRIDE + _round4(K * TD) + _round4(_ROWS_SEQ * TD)
                + _ROWS_SEQ * (_ROWS_SEQ + 1) + 2 * _ROWS_SEQ)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _tiling(K: int, d: int, n_sm: int) -> Tuple[int, int]:
    """(TD, KC): columns per CTA and Gram columns per staged V slice.

    TD is the widest of 64, 32, 16 that still gives every SM a CTA (16
    when none does: d = 2000 gives 125 CTAs; on an H100, 250 CTAs of 8
    columns ran slower there, the kernel's K split keeping a 16-column
    CTA's threads busy instead), halved while the (K, TD) tile and a V
    slice of min(K, 64) columns do not fit in shared memory, so a large K
    narrows the tile instead of failing. KC is all of K when it fits."""
    TD = next((t for t in (64, 32, 16) if -(-d // t) >= n_sm), 16)
    while TD > 1 and _smem_bytes(K, TD, min(K, 64)) > _SMEM_CAP:
        TD //= 2
    if _smem_bytes(K, TD, min(K, 64)) > _SMEM_CAP:
        raise ValueError(f"K={K} rows do not fit one column in shared memory")
    return TD, min(K, (_SMEM_CAP - _smem_bytes(K, TD, 0))
                   // (4 * _VS_STRIDE))


@functools.lru_cache(maxsize=64)
def block_grid_schedule(K: int, block: int, device) -> Tuple:
    """The uncoloured schedule: ceil(K / B) non-free steps of B rows, each
    ending at K, so every row updates in order (``pallas_hals.py:302-310``).
    Returns (starts, ends, free, n_steps) like
    :func:`cnmf_e_tpu_torch.ops.coloring.class_step_schedule`. Cached per
    (K, block, device): the step builds it on every HALS call, and its
    tensors are only read."""
    B = _rows_per_step(K, block)
    nb = -(-K // B)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.arange(nb, **i32) * B, torch.full((nb,), K, **i32),
            torch.zeros((nb,), **i32), torch.tensor(nb, **i32))


def hals_sweeps(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
                gate: torch.Tensor, schedule: Tuple,
                mask: Optional[torch.Tensor] = None, n_iter: int = 5,
                block: int = 16, relu: bool = True) -> torch.Tensor:
    """Run ``n_iter`` scheduled Gauss-Seidel sweeps on row-major factors.

    X, U: (K, d); V: (K, K) symmetric; gate: (K,) — rows with gate == 0
    (or V_kk == 0) keep their value; mask: optional (K, d) support (needs
    relu); schedule: (starts, ends, free, n_steps) from
    :func:`cnmf_e_tpu_torch.ops.coloring.class_step_schedule` over rows
    already in colored order, or :func:`block_grid_schedule`. Returns the
    updated (K, d) factor.

    CUDA tensors launch ``csrc/hals_sweeps.cu``, which reads the mask and
    the schedule as they are and writes a new tensor; f32 contiguous
    factors, a bool or uint8 mask and int32 schedules pass through without
    a copy."""
    if not X.is_cuda:
        return hals_sweeps_reference(U, V, X, gate, schedule, mask, n_iter,
                                     block, relu)
    K, d = X.shape
    if V.shape != (K, K) or U.shape != (K, d) or gate.shape != (K,):
        raise ValueError(f"shape mismatch: U {tuple(U.shape)}, "
                         f"V {tuple(V.shape)}, X {tuple(X.shape)}, "
                         f"gate {tuple(gate.shape)}")
    f32 = lambda t: t.to(torch.float32).contiguous()
    U, V, X, gate = f32(U), f32(V), f32(X), f32(gate)
    if mask is not None:
        if not relu:
            raise ValueError("a support mask needs relu=True")
        if mask.shape != (K, d):
            raise ValueError(f"mask {tuple(mask.shape)} is not {(K, d)}")
        if mask.dtype not in (torch.bool, torch.uint8):
            mask = mask > 0
        mask = mask.contiguous().view(torch.uint8)
    starts, ends, free, n_steps = (t.to(torch.int32).contiguous()
                                   for t in schedule)
    check_cuda(U, V, X, gate, starts, ends, free, n_steps,
               dtypes=(torch.float32,) * 4 + (torch.int32,) * 4)
    if mask is not None:
        check_cuda(U, mask, dtypes=(torch.float32, torch.uint8))
    out = torch.empty_like(X)
    if K == 0 or d == 0:
        return out
    n_sm = _sm_count(X.device.index)
    TD, KC = _tiling(K, d, n_sm)
    B = _rows_per_step(K, block)
    if mask is None:
        launch("hals_sweeps", X.device, U, V, X, out, mask, gate, starts,
               ends, free, n_steps, K, d, n_iter, int(relu), B, TD, KC)
        return out
    # the compacted body's list of tiles for the dense body: a count, then
    # up to one entry a tile
    work = torch.empty(-(-d // TD) + 1, dtype=torch.int32, device=X.device)
    launch(("hals_sweeps", "hals_sweeps"), X.device, U, V, X, out, mask,
           gate, starts, ends, free, n_steps, work,
           device_counters(_STATS, X.device, 3), K, d, n_iter, B, TD, KC,
           n_sm, entry="hals_sweeps_masked_launch")
    return out


def compact_stats(device) -> dict:
    """The masked calls' tile counts on ``device`` since the last
    :func:`cnmf_e_tpu_torch.cuda_build.reset_launch_counts`: tiles the
    compacted body ran (``compact_tiles``), tiles it handed to the dense
    body (``fallback_tiles``), and the compacted tiles' active rows
    (``active_rows``). Reads the device, so it synchronises."""
    vals = device_counters(_STATS, device, 3).tolist()
    return dict(zip(("compact_tiles", "fallback_tiles", "active_rows"),
                    vals))
