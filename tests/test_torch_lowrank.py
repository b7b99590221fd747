"""The low-rank background of the port (``cnmf_e_tpu_torch/ops/lowrank.py``)
against the JAX package's ``ops/lowrank.py`` on the CPU.

The port draws its random test matrix and NMF starting factors from a
torch generator, not from ``jax.random``, so the randomized SVD is held,
as the JAX one is, to the exact truncated SVD; the NMF, given JAX's own
starting draw, must follow the JAX iteration step for step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.ops import lowrank as jax_lowrank
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.ops import lowrank

torch.set_num_threads(1)


def _decaying(rng, m=200, n=80):
    X = rng.standard_normal((m, n)).astype(np.float32)
    return (X @ np.diag(np.exp(-np.arange(n) / 5.0)).astype(np.float32)
            @ rng.standard_normal((n, n)).astype(np.float32))


def _truncated(X, k):
    U, s, Vt = np.linalg.svd(np.asarray(X, np.float64),
                             full_matrices=False)
    return (U[:, :k] * s[:k]) @ Vt[:k], s[:k]


@pytest.mark.parametrize("k, seed", [(10, 0), (3, 1), (1, 2)])
def test_randomized_svd_matches_exact(k, seed):
    """tests/test_background.py::test_randomized_svd_matches_exact's bar:
    singular values at rtol 1e-3, residual norm at rtol 1e-2."""
    X = _decaying(np.random.default_rng(seed))
    U, s, Vt = lowrank.randomized_svd(torch.as_tensor(X), k)
    assert U.shape == (200, k) and s.shape == (k,) and Vt.shape == (k, 80)
    recon_true, s_true = _truncated(X, k)
    np.testing.assert_allclose(s.numpy(), s_true, rtol=1e-3)
    recon = (U * s[None]).numpy() @ Vt.numpy()
    np.testing.assert_allclose(np.linalg.norm(X - recon),
                               np.linalg.norm(X - recon_true), rtol=1e-2)


def test_randomized_svd_is_seeded():
    X = torch.as_tensor(_decaying(np.random.default_rng(3)))
    a = lowrank.randomized_svd(X, 4, seed=5)
    b = lowrank.randomized_svd(X, 4, seed=5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# fit_lowrank_model's background, held to the exact rank-r SVD of the
# centred residual: relative Frobenius error of b^T f + b0 within 1e-3
LOWRANK_TOL = 1e-3


@pytest.mark.parametrize("rank", [1, 3])
def test_fit_lowrank_model_svd_both_packages_hit_the_truncated_svd(rank):
    gt = simulate_movie(seed=4, H=32, W=32, T=300, K=4, sn=0.05,
                        bg_strength=1.0)
    A, C = gt.A[:3], gt.C[:3]          # one neuron left in the residual
    T, H, W = gt.Y.shape
    resid = (gt.Y - np.einsum("khw,kt->thw", A, C)).reshape(T, -1)
    b0_true = resid.mean(0)
    exact, _ = _truncated((resid - b0_true).T, rank)      # (d, T)
    exact = exact + b0_true[:, None]

    def background(b, f, b0):
        b, f, b0 = (np.asarray(x, np.float64) for x in (b, f, b0))
        assert b.shape == (rank, H, W) and f.shape == (rank, T)
        return b.reshape(rank, -1).T @ f + b0.reshape(-1)[:, None]

    ours = lowrank.fit_lowrank_model(torch.as_tensor(gt.Y),
                                     torch.as_tensor(A), torch.as_tensor(C),
                                     rank, mode="svd")
    theirs = jax_lowrank.fit_lowrank_model(jnp.asarray(gt.Y),
                                           jnp.asarray(A), jnp.asarray(C),
                                           rank, mode="svd")
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(theirs[2]),
                               rtol=1e-5, atol=1e-6)
    for got in (ours, theirs):
        err = np.linalg.norm(background(*got) - exact) / np.linalg.norm(
            exact - b0_true[:, None])
        assert err < LOWRANK_TOL, err


def _jax_draw(X, rank, seed=0):
    """nmf_hals' own starting factors (cnmf_e_tpu/ops/lowrank.py:53-58)."""
    Xp = jnp.maximum(jnp.asarray(X), 0.0)
    kw, kh = jax.random.split(jax.random.PRNGKey(seed))
    scale = jnp.sqrt(jnp.mean(Xp) / rank)
    W0 = jnp.abs(jax.random.normal(kw, (X.shape[0], rank), Xp.dtype)) * scale
    H0 = jnp.abs(jax.random.normal(kh, (rank, X.shape[1]), Xp.dtype)) * scale
    return np.array(W0), np.array(H0)


@pytest.mark.parametrize("rank, n_iter, signed", [
    (3, 50, False), (2, 20, True), (1, 50, False)])
def test_nmf_hals_follows_jax_from_the_same_draw(rank, n_iter, signed):
    rng = np.random.default_rng(rank)
    X = (np.abs(rng.standard_normal((60, rank))) @ np.abs(
        rng.standard_normal((rank, 90)))).astype(np.float32)
    if signed:                          # clipped at 0 by both
        X = X - 0.5 * X.mean()
    Wj, Hj = jax_lowrank.nmf_hals(jnp.asarray(X), rank, n_iter=n_iter)
    Wt, Ht = lowrank.nmf_hals(torch.as_tensor(X), rank, n_iter=n_iter,
                              init=_jax_draw(X, rank))
    np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=1e-4,
                               atol=1e-5)


def test_nmf_hals_own_draw_reconstructs():
    """tests/test_background.py::test_nmf_hals_reconstructs on the port's
    own starting draw."""
    rng = np.random.default_rng(0)
    X = (np.abs(rng.standard_normal((60, 3))) @ np.abs(
        rng.standard_normal((3, 90)))).astype(np.float32)
    Wf, Hf = lowrank.nmf_hals(torch.as_tensor(X), 3, n_iter=200)
    assert bool((Wf >= 0).all() and (Hf >= 0).all())
    rel = np.linalg.norm(X - Wf.numpy() @ Hf.numpy()) / np.linalg.norm(X)
    assert rel < 0.02, rel


def test_fit_lowrank_model_nmf_and_unknown_mode():
    gt = simulate_movie(seed=4, H=24, W=24, T=200, K=3, sn=0.05)
    args = (torch.as_tensor(gt.Y), torch.as_tensor(gt.A),
            torch.as_tensor(gt.C))
    b, f, b0 = lowrank.fit_lowrank_model(*args, 2, mode="nmf")
    assert b.shape == (2, 24, 24) and f.shape == (2, 200)
    assert bool((b >= 0).all() and (f >= 0).all())
    with pytest.raises(ValueError, match="low-rank mode"):
        lowrank.fit_lowrank_model(*args, 2, mode="pca")
