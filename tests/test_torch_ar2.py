"""AR(2) estimation and kernel conversions in the PyTorch port
(``cnmf_e_tpu_torch/ops/ar.py``) vs the JAX package
(``cnmf_e_tpu/ops/ar.py``), on the same seeded numpy traces.

Tolerances: the conversions (``ar2exp``, ``exp2ar``, ``ar_kernel``,
``exp2kernel``, ``make_G_matrix``) at 1e-5 relative; ``choose_smin``'s
AR(2) branch at 1e-4 relative (the JAX package evaluates ``norm.ppf`` in
float32, 7e-5 from the float64 quantile). The AR(2) Yule-Walker fit is
ill-conditioned in float32: the port builds and solves its 2x2 normal
equations in float64, so it is held at 1e-5 relative to an independent
float64 numpy fit, and the JAX package's float32 fit to the port within
1.5x the JAX fit's own distance from that float64 fit (plus 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.ops import ar as jax_ar
from cnmf_e_tpu.ops.noise import noise_psd as jax_noise_psd
from cnmf_e_tpu_torch.ops import ar

REL = 1e-5


def _ar2_traces(seed, K=24, T=600, sn=0.1):
    """AR(2) traces of several time constants, some AR(1)-like and some
    pure noise (the clamp and complex-root branches)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.8, 0.97, K)
    r = rng.uniform(0.0, 0.6, K)
    S = (rng.random((K, T)) < 0.03) * rng.uniform(0.8, 1.6, (K, T))
    S[-4:] = 0.0
    C = np.zeros((K, T))
    for t in range(T):
        C[:, t] = ((d + r) * C[:, t - 1] if t >= 1 else 0) \
            + (-d * r * C[:, t - 2] if t >= 2 else 0) + S[:, t]
    return (C + sn * rng.standard_normal((K, T))).astype(np.float32)


def _fit64(y, sn, lags=5, g_range=(0.05, 0.998)):
    """The noise-corrected Yule-Walker AR(2) fit with the JAX package's
    root clamp, in float64 numpy."""
    y = y.astype(np.float64)
    sn = sn.astype(np.float64)
    L = lags + 2
    T = y.shape[-1]
    yc = y - y.mean(-1, keepdims=True)
    xc = np.stack([(yc[:, k:T - L + k] * yc[:, :T - L]).sum(-1) / T
                   for k in range(L + 1)], -1)
    i, j = np.arange(L)[:, None], np.arange(2)[None, :]
    A = xc[:, np.abs(i - j)] - (sn ** 2)[:, None, None] * (i == j)
    g = np.linalg.solve(np.einsum("klp,klq->kpq", A, A) + 1e-12 * np.eye(2),
                        np.einsum("klp,kl->kp", A, xc[:, 1:L + 1])[..., None]
                        )[..., 0]
    g1, g2 = g[:, 0], g[:, 1]
    disc = g1 * g1 + 4 * g2
    sq = np.sqrt(np.maximum(disc, 0))
    r1 = np.where(disc < 0, g1 / 2, (g1 + sq) / 2)
    r2 = np.where(disc < 0, g1 / 4, (g1 - sq) / 2)
    clamp = lambda r: np.where(r > 1, g_range[1],  # noqa: E731
                               np.where(r < 0, g_range[0], r))
    r1, r2 = clamp(r1), clamp(r2)
    return np.stack([r1 + r2, -r1 * r2], -1), disc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_time_constant_ar2(seed):
    y = _ar2_traces(seed)
    sn = np.asarray(jax_noise_psd(jnp.asarray(y)))
    g_t = ar.estimate_time_constant(torch.tensor(y), p=2,
                                    sn=torch.tensor(sn)).numpy()
    g_j = np.asarray(jax_ar.estimate_time_constant(jnp.asarray(y), p=2,
                                                   sn=jnp.asarray(sn)))
    g64, disc = _fit64(y, sn)
    assert g_t.shape == g_j.shape == (y.shape[0], 2)
    np.testing.assert_allclose(g_t, g64, rtol=REL, atol=REL)
    err_j = np.abs(g_j - g64).max()
    assert np.abs(g_t - g_j).max() <= 1.5 * err_j + REL, err_j
    # without sn both estimate it with their own Welch PSD
    g_t0 = ar.estimate_time_constant(torch.tensor(y), p=2).numpy()
    np.testing.assert_allclose(g_t0, g_t, rtol=1e-4, atol=1e-5)


def test_estimate_time_constant_ar2_complex_roots():
    """White noise gives complex roots (disc < 0): both packages take the
    real part, r1 = g1 / 2 and r2 = g1 / 4, then the same clamp."""
    rng = np.random.default_rng(9)
    y = rng.standard_normal((16, 500)).astype(np.float32)
    sn = np.full(16, 0.5, np.float32)
    g64, disc = _fit64(y, sn)
    assert (disc < 0).any()
    g_t = ar.estimate_time_constant(torch.tensor(y), p=2,
                                    sn=torch.tensor(sn)).numpy()
    g_j = np.asarray(jax_ar.estimate_time_constant(jnp.asarray(y), p=2,
                                                   sn=jnp.asarray(sn)))
    np.testing.assert_allclose(g_t, g64, rtol=REL, atol=REL)
    assert np.abs(g_t - g_j).max() <= 1.5 * np.abs(g_j - g64).max() + REL


def _g2(seed=4, K=32):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 0.99, K)
    r = rng.uniform(0.01, 0.45, K)
    return np.stack([d + r, -d * r], -1).astype(np.float32)


def test_ar2exp_exp2ar():
    g = _g2()
    d_t, r_t = ar.ar2exp(torch.tensor(g))
    d_j, r_j = jax_ar.ar2exp(jnp.asarray(g))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=REL)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=REL,
                               atol=REL)
    np.testing.assert_allclose(
        ar.exp2ar(d_t, r_t).numpy(),
        np.asarray(jax_ar.exp2ar(d_j, r_j)), rtol=REL, atol=REL)
    np.testing.assert_allclose(ar.exp2ar(d_t, r_t).numpy(), g, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("T", [1, 50, 1000])
@pytest.mark.parametrize("p", [1, 2])
def test_ar_kernel(T, p):
    g = _g2()[:, :p] if p == 2 else _g2()[:, :1] * 0.5
    h_t = ar.ar_kernel(torch.tensor(g), T).numpy()
    h_j = np.asarray(jax_ar.ar_kernel(jnp.asarray(g), T))
    assert h_t.shape == h_j.shape == (g.shape[0], T)
    np.testing.assert_allclose(h_t, h_j, rtol=REL,
                               atol=REL * np.abs(h_j).max())


def test_exp2kernel():
    rng = np.random.default_rng(5)
    tau_d = rng.uniform(5.0, 40.0, 8).astype(np.float32)
    tau_r = rng.uniform(0.5, 4.0, 8).astype(np.float32)
    h_t = ar.exp2kernel(torch.tensor(tau_d), torch.tensor(tau_r), 300)
    h_j = jax_ar.exp2kernel(jnp.asarray(tau_d), jnp.asarray(tau_r), 300)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=REL,
                               atol=REL)


@pytest.mark.parametrize("g", [[0.9], [1.3, -0.42], [0.5, 0.1, -0.05]])
def test_make_G_matrix(g):
    G_t = ar.make_G_matrix(40, torch.tensor(g)).numpy()
    G_j = np.asarray(jax_ar.make_G_matrix(40, jnp.asarray(g)))
    np.testing.assert_allclose(G_t, G_j, rtol=REL, atol=0)
    # G c = s for c from the AR recurrence
    rng = np.random.default_rng(1)
    s = rng.random(40)
    c = np.zeros(40)
    for t in range(40):
        c[t] = s[t] + sum(g[j] * c[t - j - 1] for j in range(len(g))
                          if t - j - 1 >= 0)
    np.testing.assert_allclose(G_t @ c, s, atol=1e-5)


def test_choose_smin_ar2():
    g = _g2()
    sn = np.random.default_rng(6).uniform(0.05, 0.5, g.shape[0]).astype(
        np.float32)
    for prob in (0.99999, 0.9999):
        s_t = ar.choose_smin(torch.tensor(g), torch.tensor(sn), prob)
        s_j = jax_ar.choose_smin(jnp.asarray(g), jnp.asarray(sn), prob)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-4)
