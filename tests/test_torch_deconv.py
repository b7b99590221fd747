"""The deconvolution families of the PyTorch port
(``cnmf_e_tpu_torch/ops/oasis.py``, ``ops/onnls.py``) vs the JAX package,
on the same seeded numpy traces (K = 16, T = 600).

The AR(1) solves run the port's OASIS kernels through their plain
versions (CPU tensors), the JAX package's through its XLA
divide-and-conquer path, as its own tests run them on the CPU. AR(2) and
exp2 cases take the JAX package's estimated g, so both solvers see the
same kernel (``tests/test_torch_ar2.py`` holds the estimates).

Tolerances, per field of the DeconvResult: c, s and b within 1e-4 of each
trace's scale (its largest |y|); g within 1e-5; smin
within 1e-4 relative; lam and the thresholded smin within one final step
of their bisection (a step whose RSS lies within float32 rounding of the
budget may branch either way in two float32 implementations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import DeconvParams as JaxDeconvParams
from cnmf_e_tpu.ops import oasis as jax_oasis
from cnmf_e_tpu.ops.ar import estimate_time_constant as jax_estimate
from cnmf_e_tpu.ops.ar import ar_kernel as jax_ar_kernel
from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.ops import oasis

torch.set_num_threads(1)

TOL = 1e-4
K, T = 16, 600


def _traces(seed=0, p=1):
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.85, 0.95, K)
    r = rng.uniform(0.2, 0.5, K) if p == 2 else np.zeros(K)
    S = (rng.random((K, T)) < 0.03) * rng.uniform(0.8, 1.6, (K, T))
    C = np.zeros((K, T))
    for t in range(T):
        C[:, t] = ((d + r) * C[:, t - 1] if t >= 1 else 0) \
            + (-d * r * C[:, t - 2] if t >= 2 else 0) + S[:, t]
    return (C + 0.1 * rng.standard_normal((K, T)) + 0.4).astype(np.float32)


def _check(res_t, res_j, y, lam_step=0.0, smin_step=None):
    """Hold each DeconvResult field; ``lam_step``: one final bisection
    step of lam; ``smin_step``: one final bisection step of smin, per
    trace (None: smin at 1e-4 relative)."""
    scale = np.abs(y).max(-1)
    for f in ("c", "s"):
        err = np.abs(getattr(res_t, f).numpy() - np.asarray(
            getattr(res_j, f))).max(-1) / scale
        assert err.max() <= TOL, (f, err.max())
    b_err = np.abs(res_t.b.numpy() - np.asarray(res_j.b)) / scale
    assert b_err.max() <= TOL, b_err.max()
    np.testing.assert_allclose(res_t.g.numpy(), np.asarray(res_j.g),
                               atol=1e-5)
    for f, step in (("lam", lam_step),
                    ("smin", 0.0 if smin_step is None else smin_step)):
        a_t, a_j = getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f))
        assert a_t.shape == a_j.shape, f
        assert (np.abs(a_t - a_j) <= TOL * np.abs(a_j) + step + 1e-7).all(), f


def _run(y, model, method, g=None, sn=None, **kw):
    pj = JaxDeconvParams(model=model, method=method, **kw)
    pt = DeconvParams(model=model, method=method, **kw)
    res_j = jax_oasis.deconvolve(
        jnp.asarray(y), pj, sn=None if sn is None else jnp.asarray(sn),
        g=None if g is None else jnp.asarray(g))
    res_t = oasis.deconvolve(
        torch.tensor(y), pt, sn=None if sn is None else torch.tensor(sn),
        g=None if g is None else torch.tensor(g))
    return res_t, res_j


@pytest.mark.parametrize("method,kw", [
    ("foopsi", {}), ("foopsi", {"optimize_b": False, "lam": 0.2}),
    ("constrained", {}), ("thresholded", {}),
    ("foopsi", {"tau_range": (5.0, 8.0)})],
    ids=["foopsi", "foopsi_lam", "constrained", "thresholded", "tau_range"])
def test_deconvolve_ar1(method, kw):
    y = _traces()
    res_t, res_j = _run(y, "ar1", method, **kw)
    hi = 2.0 * np.maximum(np.abs(y).max(-1), 1.0)
    # thresholded: smin = m smin0, m bisected in [0.5, 8] ten times
    smin0 = np.asarray(res_j.smin) / 0.5
    _check(res_t, res_j, y, lam_step=hi / 2 ** 20,
           smin_step=7.5 / 2 ** 10 * smin0 if method == "thresholded"
           else None)
    if "tau_range" in kw:
        g = res_t.g.numpy()
        assert (g >= np.exp(-1 / 5.0) - 1e-7).all()
        assert (g <= np.exp(-1 / 8.0) + 1e-7).all()


def _g_ar2(y):
    return np.asarray(jax_estimate(jnp.asarray(y), p=2))


@pytest.mark.parametrize("model,method,kw", [
    ("ar2", "foopsi", {}), ("ar2", "foopsi", {"optimize_b": False,
                                              "smin": 0.3}),
    ("ar2", "constrained", {}), ("ar2", "thresholded", {}),
    ("ar2", "constrained", {"optimize_g": 2}),
    ("exp2", "constrained", {}), ("exp2", "thresholded", {}),
    ("ar2", "mcmc", {})],
    ids=["ar2_foopsi", "ar2_foopsi_smin", "ar2_constrained",
         "ar2_thresholded", "ar2_optimize_g", "exp2_constrained",
         "exp2_thresholded", "ar2_mcmc_is_foopsi"])
def test_deconvolve_ar2_exp2(model, method, kw):
    y = _traces(seed=1, p=2)
    g = _g_ar2(y)
    res_t, res_j = _run(y, model, method, g=g, **kw)
    assert res_t.g.shape == (K, 2)
    hi = 2.0 * np.maximum(np.abs(y).max(-1), 1.0)
    # thresholded: smin = m smin0, m bisected in [0.25, 8] ten times
    smin0 = np.asarray(res_j.smin) / 0.25
    _check(res_t, res_j, y, lam_step=hi / 2 ** 12,
           smin_step=7.75 / 2 ** 10 * smin0 if method == "thresholded"
           else None)


def test_deconvolve_ar2_estimates_g():
    """With no g given, deconvolve estimates the AR(2) coefficients; the
    port's estimate is the float64 fit (tests/test_torch_ar2.py), so the
    traces are held at 2e-3 of scale here."""
    y = _traces(seed=2, p=2)
    res_t, res_j = _run(y, "ar2", "foopsi", optimize_b=False, smin=0.0)
    assert res_t.g.shape == (K, 2)
    np.testing.assert_allclose(res_t.g.numpy(), np.asarray(res_j.g),
                               atol=2e-3)
    scale = np.abs(np.asarray(res_j.c)).max(-1)
    err = np.abs(res_t.c.numpy() - np.asarray(res_j.c)).max(-1) / scale
    assert err.max() <= 2e-3, err.max()


def test_deconvolve_kernel_model():
    y = _traces(seed=3, p=2)
    g = _g_ar2(y)
    h = np.asarray(jax_ar_kernel(jnp.asarray(g[0]), 80))
    res_t, res_j = _run(y, "kernel", "foopsi", g=h)
    assert res_t.g.shape == (80,)
    _check(res_t, res_j, y)


def test_optimize_g_matches_jax():
    """The grid then golden-section search: g within the search's final
    bracket (two grid steps times phi^n_iter; a comparison of two RSS
    values equal to float32 rounding may go either way), and c within
    1e-4 of scale where g agrees."""
    y = _traces(seed=5)[:4, :300]
    g_t, c_t, s_t = oasis.optimize_g(torch.tensor(y), None, lam=0.1,
                                     n_iter=4)
    g_j, c_j, s_j = jax_oasis.optimize_g(jnp.asarray(y), None, lam=0.1,
                                         n_iter=4)
    g_t, g_j = g_t.numpy(), np.asarray(g_j)
    bracket = 2 * (0.99 - 0.5) / 12 * 0.6180339887498949 ** 4
    assert (np.abs(g_t - g_j) <= bracket).all(), (g_t, g_j)
    same = np.abs(g_t - g_j) <= 1e-6
    assert same.sum() >= 2
    scale = np.abs(np.asarray(c_j)).max(-1)
    err = np.abs(c_t.numpy() - np.asarray(c_j)).max(-1) / scale
    assert err[same].max() <= TOL
