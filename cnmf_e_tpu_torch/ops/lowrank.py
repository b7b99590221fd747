"""Low-rank background models (2p path): truncated SVD and NMF (port of
``randomized_svd``, ``nmf_hals`` and ``fit_lowrank_model`` of
``cnmf_e_tpu/ops/lowrank.py``).

Reference: ``endoscope/fit_svd_model.m:27-42`` (rank-nb truncated SVD of
the background residual via ``svdsecon``) and ``fit_nmf_model.m:14-25``
(``nnmf``): a randomized range-finder SVD (products and thin QR) and HALS
NMF with fixed iteration counts.

The random test matrix and the NMF starting factors come from a CPU
``torch.Generator`` seeded with ``seed`` and are then moved to the data's
device, so a fit on the card and one on the CPU start from the same
numbers. They are not the JAX package's numbers (``jax.random``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _randn(shape, gen: torch.Generator, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype).to(device)


def randomized_svd(X: torch.Tensor, k: int, n_iter: int = 4,
                   oversample: int = 8, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD of X (m, n) by randomized subspace iteration.

    Returns (U (m, k), s (k,), Vt (k, n))."""
    m, n = X.shape
    p = min(k + oversample, min(m, n))
    gen = torch.Generator().manual_seed(seed)
    Omega = _randn((n, p), gen, X.dtype, X.device)
    Q, _ = torch.linalg.qr(X @ Omega)
    for _ in range(n_iter):
        Qz, _ = torch.linalg.qr(X.T @ Q)
        Q, _ = torch.linalg.qr(X @ Qz)
    Ub, s, Vt = torch.linalg.svd(Q.T @ X, full_matrices=False)
    return (Q @ Ub)[:, :k], s[:k], Vt[:k]


def nmf_hals(X: torch.Tensor, rank: int, n_iter: int = 50, seed: int = 0,
             init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative matrix factorization X (m, n) ~= W H, W (m, r), H (r, n),
    by HALS with a fixed iteration count (replaces MATLAB ``nnmf``). X is
    clipped at 0 (backgrounds are nonnegative here).

    ``init``: starting factors (W0, H0); by default both are |N(0, 1)|
    draws scaled by sqrt(mean(X+) / rank)."""
    m, n = X.shape
    Xp = torch.clamp(X, min=0.0)
    if init is None:
        gen = torch.Generator().manual_seed(seed)
        scale = torch.sqrt(Xp.mean() / rank)
        Wf = _randn((m, rank), gen, X.dtype, X.device).abs() * scale
        Hf = _randn((rank, n), gen, X.dtype, X.device).abs() * scale
    else:
        Wf, Hf = (torch.as_tensor(a, dtype=X.dtype, device=X.device).clone()
                  for a in init)
    for _ in range(n_iter):
        # H row by row, each row seeing the rows updated before it
        WtW = Wf.T @ Wf
        WtX = Wf.T @ Xp
        for k in range(rank):
            num = WtX[k] - WtW[k] @ Hf + WtW[k, k] * Hf[k]
            Hf[k] = torch.clamp(num / torch.clamp(WtW[k, k], min=1e-12),
                                min=0.0)
        HHt = Hf @ Hf.T
        XHt = Xp @ Hf.T
        for k in range(rank):
            num = XHt[:, k] - Wf @ HHt[:, k] + HHt[k, k] * Wf[:, k]
            Wf[:, k] = torch.clamp(num / torch.clamp(HHt[k, k], min=1e-12),
                                   min=0.0)
    return Wf, Hf


def fit_lowrank_model(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                      rank: int, mode: str = "svd"
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit B = b f (+ b0) to the residual Y - A C.

    Y: (T, H, W); A: (K, H, W); C: (K, T).
    Returns (b (rank, H, W), f (rank, T), b0 (H, W)).
    Reference: ``fit_svd_model.m:27-42``: the residual is mean-centred per
    pixel (the mean becomes b0) before the rank-nb factorization."""
    T, H, W = Y.shape
    K = A.shape[0]
    resid = Y.reshape(T, -1) - C.T @ A.reshape(K, -1)
    b0 = resid.mean(dim=0)
    Xc = (resid - b0[None]).T                       # (d, T)
    if mode == "svd":
        U, s, Vt = randomized_svd(Xc, rank)
        b = (U * s[None]).T.reshape(rank, H, W)
        f = Vt
    elif mode == "nmf":
        Wf, Hf = nmf_hals(Xc, rank)
        b = Wf.T.reshape(rank, H, W)
        f = Hf
    else:
        raise ValueError(f"unknown low-rank mode {mode!r}")
    return b, f, b0.reshape(H, W)
