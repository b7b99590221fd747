"""Low-rank models: the truncated SVD and NMF of the 2p background, and
the k-means++ / sparse-NMF initializer (port of
``cnmf_e_tpu/ops/lowrank.py``).

Reference: ``endoscope/fit_svd_model.m:27-42`` (rank-nb truncated SVD of
the background residual via ``svdsecon``) and ``fit_nmf_model.m:14-25``
(``nnmf``): a randomized range-finder SVD (products and thin QR) and HALS
NMF with fixed iteration counts.

The random test matrix, the NMF starting factors and the k-means++ draws
come from a CPU ``torch.Generator`` seeded with ``seed`` and are then
moved to the data's device, so a fit on the card and one on the CPU start
from the same numbers. They are not the JAX package's numbers
(``jax.random``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.utils.profiling import span


def _randn(shape, gen: torch.Generator, dtype, device) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype).to(device)


def _qr_rows(Y: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Q of the thin QR of a tall factor (rows, p) whose rows are split
    over the mesh axis ``axis``: the factor is gathered whole, every rank
    runs the one-process QR on it and keeps its own rows of Q."""
    if mesh is None:
        return torch.linalg.qr(Y)[0]
    n = Y.shape[0]
    i = mesh.p if axis == "patch" else mesh.f
    Q = torch.linalg.qr(comm.all_gather_cat(Y, 0, mesh.group(axis)))[0]
    return Q[i * n:(i + 1) * n]


def _own(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's block along ``dim`` of a full tensor split over the
    mesh axis ``axis``; ``x`` without a mesh. A view: the QR's and the
    SVD's factors are column-major, and a 1 x 1 mesh multiplies them in
    the layout one process does (the card's products round by layout)."""
    if mesh is None:
        return x
    n = x.shape[dim]
    i0, i1 = mesh.rows(n) if axis == "patch" else mesh.frames(n)
    return x.narrow(dim, i0, i1 - i0)


def _full_size(n: int, mesh, axis: str) -> int:
    if mesh is None:
        return n
    return n * (mesh.n_patch if axis == "patch" else mesh.n_frame)


def randomized_svd(X: torch.Tensor, k: int, n_iter: int = 4,
                   oversample: int = 8, seed: int = 0, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD of X (m, n) by randomized subspace iteration.

    Returns (U (m, k), s (k,), Vt (k, n)).

    ``mesh``: X is this rank's block, its rows split over 'patch' and its
    columns over 'frame'; U is its rows, Vt its columns. Every rank draws
    the whole test matrix and takes its rows; X Omega is summed over
    'frame' and X^T Q over 'patch', each tall factor is gathered for its
    QR, and Q^T X over 'frame' for the small SVD."""
    m, n = X.shape
    M, N = _full_size(m, mesh, "patch"), _full_size(n, mesh, "frame")
    p = min(k + oversample, min(M, N))
    gen = torch.Generator().manual_seed(seed)
    Omega = _own(_randn((N, p), gen, X.dtype, X.device), 0, mesh, "frame")
    Q = _qr_rows(comm.psum(X @ Omega, mesh, "frame"), mesh, "patch")
    for _ in range(n_iter):
        Qz = _qr_rows(comm.psum(X.T @ Q, mesh, "patch"), mesh, "frame")
        Q = _qr_rows(comm.psum(X @ Qz, mesh, "frame"), mesh, "patch")
    Z = comm.psum(Q.T @ X, mesh, "patch")
    if mesh is not None:
        Z = comm.all_gather_cat(Z, 1, mesh.frame_group)
    Ub, s, Vt = torch.linalg.svd(Z, full_matrices=False)
    return ((Q @ Ub)[:, :k], s[:k],
            _own(Vt[:k], 1, mesh, "frame"))


def nmf_hals(X: torch.Tensor, rank: int, n_iter: int = 50, seed: int = 0,
             init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
             mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nonnegative matrix factorization X (m, n) ~= W H, W (m, r), H (r, n),
    by HALS with a fixed iteration count (replaces MATLAB ``nnmf``). X is
    clipped at 0 (backgrounds are nonnegative here).

    ``init``: starting factors (W0, H0); by default both are |N(0, 1)|
    draws scaled by sqrt(mean(X+) / rank).

    ``mesh``: X is this rank's block (rows over 'patch', columns over
    'frame'), and so are ``init``'s and the returned W rows and H
    columns. Every rank draws the whole starting factors and takes its
    blocks; X H^T and H H^T are summed over 'frame', W^T X and W^T W
    over 'patch'."""
    m, n = X.shape
    Xp = torch.clamp(X, min=0.0)
    if init is None:
        M, N = _full_size(m, mesh, "patch"), _full_size(n, mesh, "frame")
        gen = torch.Generator().manual_seed(seed)
        if mesh is None or M * N == m * n:
            mean = Xp.mean()
        else:
            mean = comm.psum(comm.psum(Xp.sum(), mesh, "patch"), mesh,
                             "frame") / (M * N)
        scale = torch.sqrt(mean / rank)
        Wf = _own(_randn((M, rank), gen, X.dtype, X.device), 0, mesh,
                  "patch").abs() * scale
        Hf = _own(_randn((rank, N), gen, X.dtype, X.device), 1, mesh,
                  "frame").abs() * scale
    else:
        Wf, Hf = (torch.as_tensor(a, dtype=X.dtype, device=X.device).clone()
                  for a in init)
    for _ in range(n_iter):
        # H row by row, each row seeing the rows updated before it
        WtW = comm.psum(Wf.T @ Wf, mesh, "patch")
        WtX = comm.psum(Wf.T @ Xp, mesh, "patch")
        for k in range(rank):
            num = WtX[k] - WtW[k] @ Hf + WtW[k, k] * Hf[k]
            Hf[k] = torch.clamp(num / torch.clamp(WtW[k, k], min=1e-12),
                                min=0.0)
        HHt = comm.psum(Hf @ Hf.T, mesh, "frame")
        XHt = comm.psum(Xp @ Hf.T, mesh, "frame")
        for k in range(rank):
            num = XHt[:, k] - Wf @ HHt[:, k] + HHt[k, k] * Wf[:, k]
            Wf[:, k] = torch.clamp(num / torch.clamp(HHt[k, k], min=1e-12),
                                   min=0.0)
    return Wf, Hf


_DIST_ELEMS = 1 << 26        # (n, k, d) elements of one distance block


def _sq_dist(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) squared distances sum((x - c)^2) over d, as differences
    (not the Gram expansion), in blocks of centres."""
    n, d = X.shape
    kc = max(1, _DIST_ELEMS // max(n * d, 1))
    return torch.cat([((X[:, None] - centers[None, c0:c0 + kc]) ** 2
                       ).sum(dim=-1)
                      for c0 in range(0, centers.shape[0], kc)], dim=1)


def _kmeans_pp_seeds(X: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeding: a uniform first centre, then each next centre
    drawn with probability proportional to its squared distance from the
    centres so far, by inverse CDF on uniforms from a CPU generator."""
    n = X.shape[0]
    gen = torch.Generator().manual_seed(seed)
    first = int(torch.randint(n, (1,), generator=gen))
    u = torch.rand(max(k - 1, 0), generator=gen,
                   dtype=torch.float64).to(X.device)
    centers = torch.zeros((k, X.shape[1]), dtype=X.dtype, device=X.device)
    centers[0] = X[first]
    d2 = _sq_dist(X, centers[:1])[:, 0]
    for i in range(1, k):
        d2 = torch.where(torch.isfinite(d2), d2, 1.0)
        cdf = torch.cumsum(d2.to(torch.float64), 0)
        idx = torch.clamp(torch.searchsorted(cdf, u[i - 1] * cdf[-1],
                                             right=True), max=n - 1)
        centers[i] = X[idx]
        d2 = torch.minimum(d2, _sq_dist(X, centers[i:i + 1])[:, 0])
    return centers


def kmeans_pp(X: torch.Tensor, k: int, seed: int = 0, n_iter: int = 10,
              init: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-means++ clustering of the rows of X (n, d) (reference
    ``utilities/kmeans_pp.m``): seeding, then ``n_iter`` Lloyd steps; an
    empty cluster keeps its centre. ``init``: starting centres (k, d) in
    place of the seeding. Returns (centers (k, d), labels (n,)), the
    labels those of the last Lloyd step's assignment."""
    centers = (_kmeans_pp_seeds(X, k, seed) if init is None else
               torch.as_tensor(init, dtype=X.dtype, device=X.device).clone())
    labels = _sq_dist(X, centers).argmin(dim=1)
    for it in range(n_iter):
        if it:
            labels = _sq_dist(X, centers).argmin(dim=1)
        one_hot = torch.nn.functional.one_hot(labels, k).to(X.dtype)
        counts = one_hot.sum(dim=0)
        new_c = (one_hot.T @ X) / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new_c, centers)
    return centers, labels


def sparse_nmf_init(Y: torch.Tensor, K: int, seed: int = 0,
                    n_iter: int = 60, l1_c: float = 0.0,
                    init: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse-NMF initialization of (A, C) (reference
    ``utilities/sparse_NMF_initialization.m``): k-means++ on a subsample
    of the pixel traces (every ceil(d / 2048)-th) seeds the traces, then
    ``n_iter`` HALS rounds, each footprint column then each trace row in
    order, with an optional l1 penalty on the traces. ``init``: the
    k-means starting centres (K, T). Y: (T, H, W). Returns
    (A (K, H, W), C (K, T))."""
    T, H, W = Y.shape
    Yf = torch.clamp(Y.reshape(T, H * W).T, min=0.0)         # (d, T)
    stride = max(Yf.shape[0] // 2048, 1)
    centers, _ = kmeans_pp(Yf[::stride], K, seed=seed, init=init)
    Hf = torch.clamp(centers, min=0.0)                       # (K, T)
    Wf = torch.clamp(Yf @ Hf.T, min=0.0) / torch.clamp(
        (Hf * Hf).sum(dim=-1)[None], min=1e-12)
    for _ in range(n_iter):
        HHt = Hf @ Hf.T
        XHt = Yf @ Hf.T
        for k in range(K):
            num = XHt[:, k] - Wf @ HHt[:, k] + HHt[k, k] * Wf[:, k]
            Wf[:, k] = torch.clamp(num / torch.clamp(HHt[k, k], min=1e-12),
                                   min=0.0)
        WtW = Wf.T @ Wf
        WtX = Wf.T @ Yf
        for k in range(K):
            num = WtX[k] - WtW[k] @ Hf + WtW[k, k] * Hf[k] - l1_c
            Hf[k] = torch.clamp(num / torch.clamp(WtW[k, k], min=1e-12),
                                min=0.0)
    return Wf.T.reshape(K, H, W), Hf


def fit_lowrank_model(Y: torch.Tensor, A: torch.Tensor, C: torch.Tensor,
                      rank: int, mode: str = "svd", mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit B = b f (+ b0) to the residual Y - A C.

    Y: (T, H, W); A: (K, H, W); C: (K, T).
    Returns (b (rank, H, W), f (rank, T), b0 (H, W)).
    Reference: ``fit_svd_model.m:27-42``: the residual is mean-centred per
    pixel (the mean becomes b0) before the rank-nb factorization.

    ``mesh``: Y, A and C are this rank's blocks (T/frame, H/patch, W),
    (K, H/patch, W) and (K, T/frame), and so are b, f and b0: the
    residual Xc (d, T) has its rows over 'patch' and its columns over
    'frame'."""
    with span("lowrank.fit"):
        T, H, W = Y.shape
        K = A.shape[0]
        resid = Y.reshape(T, -1) - C.T @ A.reshape(K, -1)
        b0 = comm.frame_mean(resid, 0, mesh)
        Xc = (resid - b0[None]).T                       # (d, T)
        if mode == "svd":
            U, s, Vt = randomized_svd(Xc, rank, mesh=mesh)
            b = (U * s[None]).T.reshape(rank, H, W)
            f = Vt
        elif mode == "nmf":
            Wf, Hf = nmf_hals(Xc, rank, mesh=mesh)
            b = Wf.T.reshape(rank, H, W)
            f = Hf
        else:
            raise ValueError(f"unknown low-rank mode {mode!r}")
        return b, f, b0.reshape(H, W)
