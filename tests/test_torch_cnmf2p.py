"""The vanilla 2p CNMF of the PyTorch port (``cnmf_e_tpu_torch/models/
cnmf2p.py``) vs the JAX package's (``cnmf_e_tpu/models/cnmf2p.py``), on
the same seeded numpy movies.

Tolerances: the preprocessing equal (NaN fill, saturation mask) and the
pixel noise within 1e-6 relative; ``greedy_roi`` finds the same seeds in
the same order and its boxes and traces agree within 1e-5 of their
scale; ``lasso_noise_constrained`` within 1e-5 of the coefficients'
scale on at least 90% of the pixels, and everywhere within the
coefficient change of one final step of the lambda bisection (its RSS,
||y||^2 - 2 a.B + a G a, cancels about four digits in float32, so a step
whose RSS lies within that rounding of the budget may branch either
way). ``CNMF.fit`` (lasso and nnls) at 40x40x300 against the JAX
package's own functions composed as the port's ``CNMF`` composes them
(``greedy_roi``, ``nmf_hals``, the lasso or ``nnls_pixels`` on each
pixel's search locations from ``search_locations_dilate`` with radius 2
plus every background column, ``hals_temporal``, ``deconvolve``,
``merge_neurons``): the same number of neurons, footprints, traces and
background factors matched at correlation >= 0.99, the same footprint
supports, recall >= 0.8 and a median trace
correlation > 0.85 against ground truth (the gates of
``tests/test_cnmf2p.py``). The JAX package's ``CNMF`` regresses every
pixel on every trace; the port confines each pixel, as
``update_spatial_components.m`` does. The background NMF starts, in both
packages, from the JAX package's draw (the port's own draw comes from a
CPU ``torch.Generator``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import CNMFEParams, DeconvParams, MergeParams
from cnmf_e_tpu.models import cnmf2p as J
from cnmf_e_tpu.models.merge import merge_neurons
from cnmf_e_tpu.models.state import compact, empty_state
from cnmf_e_tpu.ops.hals import hals_temporal
from cnmf_e_tpu.ops.lowrank import nmf_hals
from cnmf_e_tpu.ops.morphology import search_locations_dilate
from cnmf_e_tpu.ops.nnls import nnls_pixels
from cnmf_e_tpu.ops.oasis import deconvolve
from cnmf_e_tpu.utils.metrics import detection_f1, trace_corr
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.models import cnmf2p as P
from cnmf_e_tpu_torch.ops import lowrank

torch.set_num_threads(1)


def test_interp_missing_data_matches_jax(rng):
    Y = rng.standard_normal((20, 4, 5)).astype(np.float32)
    Y[5:8, 1, 1] = np.nan                        # an interior gap
    Y[0, 2, 2] = np.nan                          # a leading one
    Y[17:, 3, 3] = np.nan                        # a trailing one
    Y[:, 0, 4] = np.nan                          # nothing to fill from
    out_t = P.interp_missing_data(torch.tensor(Y)).numpy()
    out_j = np.asarray(J.interp_missing_data(jnp.asarray(Y)))
    np.testing.assert_array_equal(out_t, out_j)
    clean = rng.standard_normal((9, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        P.interp_missing_data(torch.tensor(clean)).numpy(), clean)


def test_find_unsaturated_and_preprocess_match_jax(rng):
    Y = np.abs(rng.standard_normal((100, 8, 8))).astype(np.float32)
    Y[:, 3, 3] = 10.0
    Y[:1, 5, 5] = 10.0                           # pinned for 1% of frames
    m_t = P.find_unsaturated_pixels(torch.tensor(Y)).numpy()
    np.testing.assert_array_equal(
        m_t, np.asarray(J.find_unsaturated_pixels(jnp.asarray(Y))))
    assert not m_t[3, 3] and not m_t[5, 5] and m_t.sum() == 62
    Y[40:43, 2, 2] = np.nan
    Yt, Pt = P.preprocess_data(torch.tensor(Y))
    Yj, Pj = J.preprocess_data(jnp.asarray(Y))
    np.testing.assert_array_equal(Yt.numpy(), np.asarray(Yj))
    np.testing.assert_allclose(Pt["sn_pix"].numpy(),
                               np.asarray(Pj["sn_pix"]), rtol=1e-6)
    np.testing.assert_array_equal(Pt["unsaturated"].numpy(),
                                  np.asarray(Pj["unsaturated"]))


@pytest.mark.parametrize("K,spr", [(6, 16), (7, 3)])
def test_greedy_roi_matches_jax(K, spr):
    gt = simulate_movie(seed=41, H=48, W=48, T=300, K=6, gSig=3.0,
                        sn=0.05, bg_strength=0.0, min_dist=14.0,
                        spike_rate=0.05)
    A_t, C_t, ctr_t = P.greedy_roi(torch.tensor(gt.Y), K=K, gSig=3.0,
                                   seeds_per_round=spr)
    A_j, C_j, ctr_j = J.greedy_roi(jnp.asarray(gt.Y), K=K, gSig=3.0,
                                   seeds_per_round=spr)
    np.testing.assert_array_equal(ctr_t, np.asarray(ctr_j))
    A_j, C_j = np.asarray(A_j), np.asarray(C_j)
    assert A_t.shape == A_j.shape and C_t.shape == C_j.shape
    np.testing.assert_allclose(A_t.numpy(), A_j, rtol=0,
                               atol=1e-5 * np.abs(A_j).max())
    np.testing.assert_allclose(C_t.numpy(), C_j, rtol=0,
                               atol=1e-5 * np.abs(C_j).max())
    f1 = detection_f1(A_t.numpy(), gt.A)
    assert f1["recall"] >= 0.8, f1


@pytest.mark.parametrize("masked", [False, True])
def test_lasso_noise_constrained_matches_jax(rng, masked):
    K, T, d = 6, 400, 50
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    a_true = np.zeros((d, K), np.float32)
    a_true[np.arange(d), rng.integers(0, K, d)] = 1.0
    sn = 0.1
    Y = (a_true @ C + sn * rng.standard_normal((d, T))).astype(np.float32)
    mask = (a_true > 0) | (rng.random((d, K)) < 0.3) if masked else None
    a_t = P.lasso_noise_constrained(
        torch.tensor(C), torch.tensor(Y), torch.full((d,), sn),
        None if mask is None else torch.tensor(mask)).numpy()
    a_j = np.asarray(J.lasso_noise_constrained(
        jnp.asarray(C), jnp.asarray(Y), jnp.full((d,), sn),
        None if mask is None else jnp.asarray(mask)))
    err = np.abs(a_t - a_j).max(-1)
    same = err <= 1e-5 * np.abs(a_j).max()
    assert same.mean() >= 0.9, err
    # elsewhere: lambda one final step (max|B| / 2^12) apart, which moves
    # a coefficient by at most that step over the Gram's diagonal
    B = Y @ C.T
    step = (np.abs(B).max(-1) + 1e-6) / 2 ** 12
    assert (err <= 2 * step / np.diag(C @ C.T).min() + 1e-5).all()
    # and the gates of tests/test_cnmf2p.py
    assert (a_t * (a_true > 0)).sum() / a_t.sum() > 0.9
    np.testing.assert_allclose(a_t.max(axis=1), 1.0, atol=0.15)


def _jax_nmf_start(X, rank, seed=0):
    """The starting factors the JAX package's nmf_hals draws."""
    Xp = np.maximum(np.asarray(X), 0.0)
    kw, kh = jax.random.split(jax.random.PRNGKey(seed))
    s = np.sqrt(Xp.mean() / rank)
    m, n = Xp.shape
    return (np.abs(np.asarray(jax.random.normal(kw, (m, rank)))) * s,
            np.abs(np.asarray(jax.random.normal(kh, (rank, n)))) * s)


def _jax_cnmf_dilate(Y, K, gSig, nb, spatial_method, n_outer=2,
                     merge_thr=0.8, radius=2):
    """``J.CNMF.fit`` with each pixel's spatial regression confined to the
    neurons whose footprint, dilated by ``radius``, covers it, and to
    every background column: the JAX package's functions in the flow of
    the port's ``CNMF.fit``."""
    Y, Pp = J.preprocess_data(jnp.asarray(Y, jnp.float32))
    T, H, W = Y.shape
    sn = Pp["sn_pix"].reshape(-1)
    A0, C0, _ = J.greedy_roi(Y, K, gSig=gSig)
    n0 = A0.shape[0]

    def background(resid, n_iter):
        bW, bH = nmf_hals(jnp.maximum(resid.reshape(T, -1).T, 0.0), nb,
                          n_iter=n_iter)
        return bW.T.reshape(nb, H, W), bH

    b, f = background(Y - jnp.einsum("khw,kt->thw", A0, C0), 30)
    K_cap = int(2 ** np.ceil(np.log2(max(n0, 4))))
    st = empty_state(K_cap, H, W, T)
    st = st.replace(A=st.A.at[:n0].set(A0),
                    C=st.C.at[:n0].set(jnp.maximum(C0, 0.0)),
                    C_raw=st.C_raw.at[:n0].set(C0),
                    active=st.active.at[:n0].set(True))
    params = CNMFEParams(merge=MergeParams(merge_thr=merge_thr))
    dp = DeconvParams(method="constrained", model="ar1")
    Yd = Y.reshape(T, -1).T
    for _ in range(n_outer):
        regs = jnp.concatenate([st.masked_C(), f], axis=0)
        near = (search_locations_dilate(st.masked_A(), radius=radius)
                & st.active[:, None, None])
        mask = jnp.concatenate([near.reshape(K_cap, -1).T,
                                jnp.ones((H * W, nb), bool)], axis=1)
        if spatial_method == "lasso":
            coef = J.lasso_noise_constrained(regs, Yd, sn, mask)
        else:
            coef = nnls_pixels(regs, Yd, mask=mask)
        b = coef[:, K_cap:].T.reshape(nb, H, W)
        st = st.replace(A=coef[:, :K_cap].T.reshape(K_cap, H, W)
                        * st.active[:, None, None])
        Ysig = Y - jnp.einsum("rhw,rt->thw", b, f)
        C_raw, _ = hals_temporal(Ysig.reshape(T, -1).T,
                                 st.masked_A().reshape(K_cap, -1).T,
                                 st.masked_C(), n_iter=3, active=st.active)
        res = deconvolve(C_raw, dp)
        act = st.active[:, None]
        st = st.replace(C=res.c * act, C_raw=(C_raw - res.b[:, None]) * act,
                        S=res.s * act, g=res.g[:, :st.g.shape[1]])
        b, f = background(Y - jnp.einsum("khw,kt->thw", st.masked_A(),
                                         st.masked_C()), 20)
        st, _ = merge_neurons(st, params, "dist_corr")
    return compact(st), b, f


@pytest.mark.parametrize("spatial_method", ["lasso", "nnls"])
def test_cnmf_fit_matches_jax(monkeypatch, spatial_method):
    gt = simulate_movie(seed=43, H=40, W=40, T=300, K=5, gSig=3.0,
                        sn=0.06, bg_strength=0.4, min_dist=14.0,
                        spike_rate=0.05)

    def nmf_from_jax_start(X, rank, n_iter=50, seed=0):
        start = _jax_nmf_start(X.numpy(), rank, seed)
        return lowrank.nmf_hals(X, rank, n_iter=n_iter, init=start)
    monkeypatch.setattr(P, "nmf_hals", nmf_from_jax_start)
    model = P.CNMF(K=8, gSig=3.0, nb=2, spatial_method=spatial_method,
                   device="cpu")
    st = model.fit(gt.Y, n_outer=2)
    sj, b_j, f_j = _jax_cnmf_dilate(gt.Y, K=8, gSig=3.0, nb=2,
                                    spatial_method=spatial_method)
    n = int(st.n_active())
    assert n == int(sj.n_active()) > 0
    assert model.b.shape == (2, 40, 40) and model.f.shape == (2, 300)
    A_t = st.A[:n].numpy().reshape(n, -1)
    A_j = np.asarray(sj.A)[:n].reshape(n, -1)
    C_t, C_j = st.C[:n].numpy(), np.asarray(sj.C)[:n]
    for k in range(n):
        assert np.corrcoef(A_t[k], A_j[k])[0, 1] >= 0.99, k
        assert np.corrcoef(C_t[k], C_j[k])[0, 1] >= 0.99, k
    # the supports agree: confined by the same search locations
    np.testing.assert_array_equal(A_t > 0, A_j > 0)
    for r in range(2):
        assert np.corrcoef(model.f[r].numpy(), np.asarray(f_j)[r])[0, 1] \
            >= 0.99, r
        assert np.corrcoef(model.b[r].numpy().ravel(),
                           np.asarray(b_j)[r].ravel())[0, 1] >= 0.99, r
    f1 = detection_f1(A_t.reshape(n, 40, 40), gt.A)
    assert f1["recall"] >= 0.8, f1
    assert np.median(trace_corr(C_t, gt.C, f1["matches"])) > 0.85


def test_cnmf_fit_search_locations():
    """With the port's own background draw: the JAX gates at 40x40x300,
    and every footprint confined to its search locations (the JAX
    package's unrestricted lasso spreads footprints over the field of
    view)."""
    gt = simulate_movie(seed=43, H=40, W=40, T=300, K=5, gSig=3.0,
                        sn=0.06, bg_strength=0.4, min_dist=14.0,
                        spike_rate=0.05)
    st = P.CNMF(K=8, gSig=3.0, nb=2, device="cpu").fit(gt.Y, n_outer=2)
    n = int(st.n_active())
    A = st.A[:n].numpy()
    f1 = detection_f1(A, gt.A)
    assert f1["recall"] >= 0.8, f1
    assert np.median(trace_corr(st.C[:n].numpy(), gt.C,
                                f1["matches"])) > 0.85
    # greedy boxes of side 2 gSiz + 1 = 15, dilated twice by 2
    assert (A > 0).reshape(n, -1).sum(1).max() <= 19 * 19
