"""The windowed NNLS deconvolution of the PyTorch port
(``cnmf_e_tpu_torch/ops/onnls.py``) vs the JAX package's
(``cnmf_e_tpu/ops/onnls.py``) and vs the float64 full-horizon oracle of
``tests/test_onnls_oracle.py``.

Against JAX, on the same seeded numpy traces (16 x 600): c and s within
1e-4 of each trace's scale (the largest |c| of the JAX trace; both run the
same float32 FISTA steps, which round differently by summation order),
the baseline b within 1e-4 of the trace scale, smin within 1e-4
relative, the fitted (d, r) within 1e-5, and lam within one final step
of its bisection (a step whose RSS lies within float32 rounding of the
budget may branch either way in two float32 implementations). The
blocked AR(2) recurrence is held to the sequential scan at 1e-5
relative. Against the oracle, the port meets the JAX oracle tests' own
gates.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import minimize

from cnmf_e_tpu.ops import onnls as jax_onnls
from cnmf_e_tpu.ops.ar import ar_kernel as jax_ar_kernel
from cnmf_e_tpu_torch.ops import onnls
from cnmf_e_tpu_torch.ops.ar import choose_smin, exp2ar

torch.set_num_threads(1)

TOL = 1e-4
D, R = 0.95, 0.55


def _traces(seed=0, K=16, T=600, d=0.92, r=0.45, sn=0.1):
    rng = np.random.default_rng(seed)
    S = (rng.random((K, T)) < 0.03) * rng.uniform(0.8, 1.6, (K, T))
    C = np.zeros((K, T))
    for t in range(T):
        C[:, t] = ((d + r) * C[:, t - 1] if t >= 1 else 0) \
            + (-d * r * C[:, t - 2] if t >= 2 else 0) + S[:, t]
    y = (C + sn * rng.standard_normal((K, T))).astype(np.float32)
    dk = (d + rng.uniform(-0.03, 0.03, K)).astype(np.float32)
    rk = (r + rng.uniform(-0.1, 0.1, K)).astype(np.float32)
    return y, dk, rk, S.astype(np.float32)


def _close(a_t, a_j, scale, tol=TOL):
    a_t, a_j = np.asarray(a_t), np.asarray(a_j)
    err = np.abs(a_t - a_j).max(axis=-1) / np.maximum(scale, 1e-6)
    assert err.max() <= tol, err.max()


def _scale(c_j):
    return np.abs(np.asarray(c_j)).max(axis=-1)


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.tensor(x) for x in xs]


@pytest.mark.parametrize("T", [64, 600, 2000])
def test_ar2_recurrence_blocked_equals_the_scan(T):
    y, d, r, S = _traces(K=8, T=T)
    c_t = onnls.ar2_recurrence(*_t(S, d, r)).numpy()
    c_j = np.asarray(jax_onnls.ar2_recurrence(*_j(S, d, r)))
    _close(c_t, c_j, _scale(c_j), tol=1e-5)
    # and the float64 recurrence
    c64 = np.zeros(S.shape)
    g1, g2 = (d + r).astype(np.float64), (-d * r).astype(np.float64)
    for t in range(T):
        c64[:, t] = S[:, t] + (g1 * c64[:, t - 1] if t >= 1 else 0) \
            + (g2 * c64[:, t - 2] if t >= 2 else 0)
    _close(c_t, c64, _scale(c64), tol=1e-5)


@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_onnls_matches_jax(lam):
    y, d, r, _ = _traces()
    c_t, s_t = onnls.onnls(*_t(y, d, r), lam=lam)
    c_j, s_j = jax_onnls.onnls(*_j(y, d, r), lam=lam)
    _close(c_t, c_j, _scale(c_j))
    _close(s_t, s_j, _scale(c_j))


def test_onnls_short_trace_one_window():
    y, d, r, _ = _traces(T=150)
    c_t, s_t = onnls.onnls(*_t(y, d, r))
    c_j, s_j = jax_onnls.onnls(*_j(y, d, r))
    _close(c_t, c_j, _scale(c_j))


def test_onnls_kernel_and_causal_conv_match_jax():
    y, d, r, S = _traces()
    h = np.asarray(jax_ar_kernel(jnp.asarray([[d[0] + r[0],
                                               -d[0] * r[0]]]), 60))[0]
    c_t, s_t = onnls.onnls_kernel(*_t(y, h), lam=0.05)
    c_j, s_j = jax_onnls.onnls_kernel(*_j(y, h), lam=0.05)
    _close(c_t, c_j, _scale(c_j))
    _close(s_t, s_j, _scale(c_j))
    cc_t = onnls.causal_conv(*_t(S, h)).numpy()
    cc_j = np.asarray(jax_onnls.causal_conv(*_j(S, h)))
    _close(cc_t, cc_j, _scale(cc_j), tol=1e-5)


def test_fit_exp2_to_kernel_matches_jax():
    for d, r in ((0.9, 0.3), (0.97, 0.6), (0.8, 0.05)):
        t = np.arange(120)
        h = ((d ** (t + 1) - r ** (t + 1)) / (d - r)).astype(np.float32)
        dt, rt = onnls.fit_exp2_to_kernel(torch.tensor(h))
        dj, rj = jax_onnls.fit_exp2_to_kernel(jnp.asarray(h))
        assert abs(float(dt) - float(dj)) <= 1e-5
        assert abs(float(rt) - float(rj)) <= 1e-5


@pytest.mark.parametrize("optimize_b", [False, True])
def test_constrained_onnls_matches_jax(optimize_b):
    y, d, r, _ = _traces(seed=1)
    y = y + 0.3
    sn = np.full(y.shape[0], 0.1, np.float32)
    out_t = onnls.constrained_onnls(*_t(y, d, r, sn), optimize_b=optimize_b)
    out_j = jax_onnls.constrained_onnls(*_j(y, d, r, sn),
                                        optimize_b=optimize_b)
    sc = _scale(out_j[0])
    _close(out_t[0], out_j[0], sc)
    _close(out_t[1], out_j[1], sc)
    _close(out_t[2].numpy()[:, None], np.asarray(out_j[2])[:, None], sc)
    # a bisection step whose RSS lies within float32 rounding of the
    # budget may branch the other way: lam within one final step
    step = 2.0 * np.maximum(np.abs(y).max(-1), 1.0) / 2 ** 12
    assert (np.abs(out_t[3].numpy() - np.asarray(out_j[3]))
            <= step + TOL * np.asarray(out_j[3])).all()


@pytest.mark.parametrize("optimize_b", [False, True])
def test_thresholded_onnls_matches_jax(optimize_b):
    y, d, r, _ = _traces(seed=2)
    sn = np.full(y.shape[0], 0.1, np.float32)
    out_t = onnls.thresholded_onnls(*_t(y, d, r, sn), optimize_b=optimize_b)
    out_j = jax_onnls.thresholded_onnls(*_j(y, d, r, sn),
                                        optimize_b=optimize_b)
    sc = _scale(out_j[0])
    _close(out_t[0], out_j[0], sc)
    _close(out_t[1], out_j[1], sc)
    _close(out_t[2].numpy()[:, None], np.asarray(out_j[2])[:, None], sc)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]),
                               rtol=TOL)


def test_optimize_exp2_matches_jax():
    y, d, r, _ = _traces(seed=3, K=8)
    sn = np.full(y.shape[0], 0.1, np.float32)
    d0 = np.full(8, 0.85, np.float32)
    r0 = np.full(8, 0.2, np.float32)
    out_t = onnls.optimize_exp2(*_t(y, d0, r0), sn=torch.tensor(sn))
    out_j = jax_onnls.optimize_exp2(*_j(y, d0, r0), sn=jnp.asarray(sn))
    np.testing.assert_allclose(out_t[0].numpy(), np.asarray(out_j[0]),
                               atol=1e-5)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]),
                               atol=1e-5)
    sc = _scale(out_j[2])
    _close(out_t[2], out_j[2], sc)
    _close(out_t[3], out_j[3], sc)


# ---- the float64 full-horizon oracle (tests/test_onnls_oracle.py) ----- #

def _H(T, d=D, r=R):
    t = np.arange(T)
    h = (d ** (t + 1) - r ** (t + 1)) / (d - r)
    H = np.zeros((T, T))
    for u in range(T):
        H[u:, u] = h[: T - u]
    return H


def _oracle_traces(seed, T=160, sn=0.12, rate=0.03):
    rng = np.random.default_rng(seed)
    s = (rng.random(T) < rate) * rng.uniform(0.8, 1.6, T)
    s[:3] = 0.0
    c = _H(T) @ s
    return c + sn * rng.standard_normal(T), c


def _oracle_nnls(y, H, lam=0.0, s0=None):
    T = y.size

    def f(s):
        rsd = H @ s - y
        return 0.5 * rsd @ rsd + lam * s.sum(), H.T @ rsd + lam

    res = minimize(f, np.zeros(T) if s0 is None else s0, jac=True,
                   method="L-BFGS-B", bounds=[(0.0, None)] * T,
                   options={"maxiter": 2000, "ftol": 1e-14, "gtol": 1e-10})
    return res.x


def _port(fn, y, **kw):
    return fn(torch.tensor(y, dtype=torch.float32)[None],
              torch.tensor([D]), torch.tensor([R]), **kw)


@pytest.mark.parametrize("lam,seed,bar", [(0.0, 3, 0.02), (0.35, 5, 0.03)])
def test_windowed_nnls_matches_full_horizon_oracle(lam, seed, bar):
    y, c_true = _oracle_traces(seed)
    H = _H(y.size)
    c_or = H @ _oracle_nnls(y, H, lam=lam)
    c, _ = _port(onnls.onnls, y, win=64, shift=32, fista_iters=300, lam=lam)
    c = c[0].numpy().astype(np.float64)
    assert np.linalg.norm(c - c_or) / np.linalg.norm(c_or) < bar
    if lam == 0.0:
        assert np.linalg.norm(c - c_true) <= \
            1.1 * np.linalg.norm(c_or - c_true)


def test_constrained_onnls_matches_oracle_dual():
    sn = 0.12
    y, _ = _oracle_traces(7, sn=sn)
    H = _H(y.size)
    thresh = sn * sn * y.size
    lo, hi = 0.0, 2.0 * max(np.abs(y).max(), 1.0)
    s_warm = None
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        s_warm = _oracle_nnls(y, H, lam=mid, s0=s_warm)
        if float(np.sum((y - H @ s_warm) ** 2)) > thresh:
            hi = mid
        else:
            lo = mid
    c_or = H @ _oracle_nnls(y, H, lam=lo)
    c, s, b, lam = onnls.constrained_onnls(
        torch.tensor(y, dtype=torch.float32)[None], torch.tensor([D]),
        torch.tensor([R]), torch.tensor([sn]), optimize_b=False, win=64,
        shift=32, fista_iters=300)
    c_t = c[0].numpy().astype(np.float64)
    assert float(np.sum((y - c_t) ** 2)) <= 1.15 * thresh
    assert abs(float(lam[0]) - lo) <= 0.15 * max(lo, 0.05)
    assert np.linalg.norm(c_t - c_or) / np.linalg.norm(c_or) < 0.05


def test_thresholded_onnls_matches_oracle_search():
    sn = 0.12
    y, _ = _oracle_traces(11, sn=sn)
    H = _H(y.size)
    thresh = sn * sn * y.size
    smin0 = float(choose_smin(exp2ar(torch.tensor(D), torch.tensor(R))[None],
                              torch.tensor([sn]), 0.9999)[0])
    s_raw = _oracle_nnls(y, H)
    lo, hi = 0.25, 8.0
    for _ in range(10):
        mid = 0.5 * (lo + hi)
        c_m = H @ np.where(s_raw >= mid * smin0, s_raw, 0.0)
        if float(np.sum((y - c_m) ** 2)) > thresh:
            hi = mid
        else:
            lo = mid
    c_or = H @ np.where(s_raw >= lo * smin0, s_raw, 0.0)
    c, s, b, smin = onnls.thresholded_onnls(
        torch.tensor(y, dtype=torch.float32)[None], torch.tensor([D]),
        torch.tensor([R]), torch.tensor([sn]), optimize_b=False, win=64,
        shift=32, fista_iters=300)
    assert abs(float(smin[0]) - lo * smin0) <= 0.25 * lo * smin0
    c_t = c[0].numpy().astype(np.float64)
    assert np.linalg.norm(c_t - c_or) / np.linalg.norm(c_or) < 0.05
