"""The fused multi-sweep HALS kernel, its plain PyTorch version and the
dispatch (port of ``cnmf_e_tpu/ops/pallas_hals.py``).

:func:`hals_sweeps` runs ``n_iter`` class-scheduled Gauss-Seidel sweeps on
a row-major factor X (K, d) given U (K, d) and the symmetric Gram V (K, K)
— both HALS factors (``HALS_spatial.m:26-46``, ``HALS_temporal.m:58-107``)
go through it. CUDA tensors launch ``csrc/hals_sweeps.cu``; CPU tensors run
:func:`hals_sweeps_reference`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cnmf_e_tpu_torch.cuda_build import check_cuda, launch

_SMEM_CAP = 232448          # opt-in shared memory per block on Hopper


def _prepare(U, V, X, gate, schedule, mask, block, relu):
    """Shared prologue: fold the mask, clamp the denominators, and turn the
    schedule into per-step row ranges [lo, hi).

    A step starting at row s of a class ending at e covers rows
    [s, min(sc + B, e)), sc = min(8 * (s // 8), Kp - B): the JAX kernel's
    8-aligned B-row window, gated to the class."""
    K = X.shape[0]
    dev = X.device
    U = U.to(torch.float32)
    X = X.to(torch.float32)
    if mask is not None:
        if not relu:
            raise ValueError("a support mask needs relu=True")
        # masked entries: x starts at 0 and every update relus
        # (x + (-1e30 - .) / cc) back to 0
        mb = mask if mask.dtype == torch.bool else mask > 0
        X = torch.where(mb, X, 0.0)
        U = torch.where(mb, U, -1e30)
    B = max(8, -(-min(block, max(K, 1)) // 8) * 8)
    Kp = -(-K // B) * B
    starts, ends, free, n_steps = schedule
    starts = starts.to(torch.int64)
    sc = torch.clamp(torch.minimum((starts // 8) * 8,
                                   torch.tensor(Kp - B, device=dev)),
                     0, Kp - B)
    hi = torch.minimum(torch.minimum(sc + B, ends.to(torch.int64)),
                       torch.tensor(K, device=dev))
    lo = starts.to(torch.int32).contiguous()
    hi = hi.to(torch.int32).contiguous()
    free = free.to(torch.int32).contiguous()
    n_steps = torch.as_tensor(n_steps, dtype=torch.int32,
                              device=dev).reshape(1)
    diag = torch.diagonal(V).to(torch.float32)
    gate = (gate.to(torch.float32) * (diag > 0)).contiguous()
    cc = torch.clamp(diag, min=1e-12).contiguous()
    return U.contiguous(), X.contiguous(), cc, gate, lo, hi, free, n_steps, B


def hals_sweeps_reference(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
                          gate: torch.Tensor, schedule: Tuple,
                          mask: Optional[torch.Tensor] = None,
                          n_iter: int = 5, block: int = 16,
                          relu: bool = True) -> torch.Tensor:
    U, X, cc, gate, lo, hi, free, n_steps, _ = _prepare(
        U, V, X, gate, schedule, mask, block, relu)
    X = X.clone()
    V = V.to(torch.float32)
    steps = list(zip(lo.tolist(), hi.tolist(), free.tolist()))
    steps = steps[:int(n_steps.item())]
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


def _tile_width(K: int, B: int) -> int:
    """Columns per CTA: 128, halved until the (K + B, TD) tile fits in
    shared memory, so a large K shrinks the tile instead of failing."""
    TD = 128
    while TD > 1 and (K + B) * TD * 4 > _SMEM_CAP:
        TD //= 2
    if (K + B) * TD * 4 > _SMEM_CAP:
        raise ValueError(f"K={K} rows do not fit one column in shared memory")
    return TD


def hals_sweeps(U: torch.Tensor, V: torch.Tensor, X: torch.Tensor,
                gate: torch.Tensor, schedule: Tuple,
                mask: Optional[torch.Tensor] = None, n_iter: int = 5,
                block: int = 16, relu: bool = True) -> torch.Tensor:
    """Run ``n_iter`` scheduled Gauss-Seidel sweeps on row-major factors.

    X, U: (K, d); V: (K, K) symmetric; gate: (K,) — rows with gate == 0
    (or V_kk == 0) keep their value; mask: optional (K, d) support (needs
    relu); schedule: (starts, ends, free, n_steps) from
    :func:`cnmf_e_tpu_torch.ops.coloring.class_step_schedule` over rows
    already in colored order. Returns the updated (K, d) factor."""
    if not X.is_cuda:
        return hals_sweeps_reference(U, V, X, gate, schedule, mask, n_iter,
                                     block, relu)
    U, X, cc, gate, lo, hi, free, n_steps, B = _prepare(
        U, V, X, gate, schedule, mask, block, relu)
    V = V.to(torch.float32).contiguous()
    check_cuda(U, V, X, cc, gate, lo, hi, free, n_steps,
               dtypes=(torch.float32,) * 5 + (torch.int32,) * 4)
    K, d = X.shape
    if V.shape != (K, K) or U.shape != (K, d):
        raise ValueError(f"shape mismatch: U {tuple(U.shape)}, "
                         f"V {tuple(V.shape)}, X {tuple(X.shape)}")
    out = X.clone()
    if K == 0 or d == 0:
        return out
    TD = _tile_width(K, B)
    launch("hals_sweeps", X.device, U, V, out, cc, gate, lo, hi, free,
           n_steps, K, d, n_iter, int(relu), TD, B)
    return out
