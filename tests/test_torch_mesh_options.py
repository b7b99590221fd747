"""The options of ``CNMFE.fit`` on a 2 x 2 mesh of gloo ranks: the local
and low-rank backgrounds, the ellipse search, ``hals_thresh``, ``nnls``,
``lars`` and ``decorrelate``.

One spawn of 2 x 2 CPU ranks (rank bodies in
``cnmf_e_tpu_torch/parallel/_selftest.py``; a 240 s deadline, a 60 s
timeout on every collective) runs every stage on the inputs of the
one-process tests of that option, and two whole fits on
``tests/test_sharding.py``'s mini movie. Each is held to the port's one
process and to the JAX package's single-device function at the
tolerances of those tests:

  * ``local_background`` (``test_torch_local_background.py``'s movies at
    ssub 1 and 2, neighbour cutoffs 1 and 0.8) and the "local" branches
    of ``update_background`` / ``background_of``: the prediction and b0
    within 1e-4 of their scale, w within 2e-3 (ROADMAP §C (u));
  * the low-rank fits (``test_torch_lowrank.py``): the svd background B
    = f^T b + b0 within 1e-3 of the truncated SVD, as the JAX package's
    is, and within 1e-4 of the port's one process; ``nmf_hals`` from the
    JAX package's starting draw at rtol 1e-4, atol 1e-5;
  * the ellipse masks (``test_torch_extras.py``): equal but where r2 lies
    within 1e-4 of 1;
  * ``update_spatial`` with ``hals_thresh``, ``nnls`` and ``lars``, with
    and without the pixel noise (``test_torch_spatial.py``);
  * ``decorr_temporal`` and ``update_temporal(decorrelate=True)``
    (``test_torch_nnls_spikes.py``);
  * ``CNMFE(mesh=...).fit`` with the local background and the ellipse
    search, and with the svd background, ``hals_thresh`` and
    ``decorrelate``: equal n_active, matched footprints and traces at
    correlation >= 0.99 against the JAX package and >= 0.999 against the
    port's one process, every rank's active mask equal, no pickled
    broadcast.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams, TemporalParams)
from cnmf_e_tpu.models import background as jbg
from cnmf_e_tpu.models import spatial as jspatial
from cnmf_e_tpu.models import state as jstate
from cnmf_e_tpu.models import temporal as jtemporal
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.ops import lowrank as jlowrank
from cnmf_e_tpu.ops import morphology as jmorph
from cnmf_e_tpu.ops import ring as jring
from cnmf_e_tpu.ops import spikes as jspikes
from cnmf_e_tpu.ops.noise import noise_psd_frames as jnoise
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import background as tbg
from cnmf_e_tpu_torch.models import spatial as tspatial
from cnmf_e_tpu_torch.models import temporal as ttemporal
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.ops import lowrank as tlowrank
from cnmf_e_tpu_torch.ops import morphology as tmorph
from cnmf_e_tpu_torch.ops import ring as tring
from cnmf_e_tpu_torch.ops import spikes as tspikes
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn
from test_torch_extras import _ellipse_r2, _footprints
from test_torch_local_background import MOVIES
from test_torch_lowrank import LOWRANK_TOL, _jax_draw, _truncated
from test_torch_nnls_spikes import _neurons

torch.set_num_threads(1)

N_PATCH, N_FRAME = 2, 2
LOCAL = [("seed5_ssub1", 1.0), ("seed6_ssub2", 0.8)]
SPATIAL = [(a, s) for a in ("hals_thresh", "nnls", "lars")
           for s in (True, False)]
DECORR = [(1, 1), (2, 3)]
FITS = {
    "local_ellipse": {"background.model": "local",
                      "spatial.search_method": "ellipse"},
    "svd_thresh_decorrelate": {"background.model": "svd",
                               "spatial.algorithm": "hals_thresh",
                               "temporal.decorrelate": True},
}


def _mini_params(**fields):
    """``tests/test_sharding.py::_mini_params`` with ``fields``."""
    return _selftest.with_fields(CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=6, min_corr=0.7, min_pnr=6.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=3),
        background=BackgroundParams(model="ring", ring_radius=6),
        merge=MergeParams(dmin=4.0)), fields)


def _mini_movie():
    return simulate_movie(seed=11, H=32, W=32, T=256, K=5, gSig=2.0,
                          sn=0.06, bg_strength=0.5, min_dist=9.0,
                          spike_rate=0.05)


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


# ------------------------------------------------------------------ #
# inputs, as the one-process tests build them
# ------------------------------------------------------------------ #
def _local_model_problem(ssub):
    """``test_local_model_update_and_background_match_jax``'s state."""
    gt = simulate_movie(seed=9, H=32, W=32, T=150, K=3, gSig=2.0, sn=0.05,
                        bg_strength=1.0, min_dist=9.0)
    params = CNMFEParams.preset_1p()
    params = params.replace(background=dataclasses.replace(
        params.background, model="local", ring_radius=7, ssub=ssub))
    K = gt.A.shape[0]
    A = np.zeros((K + 2, 32, 32), np.float32)
    A[:K] = gt.A
    C = np.zeros((K + 2, 150), np.float32)
    C[:K] = gt.C
    d = dict(A=A, C=C, C_raw=C, S=np.zeros_like(C),
             g=np.full((K + 2, 1), 0.9, np.float32),
             neuron_sn=np.zeros(K + 2, np.float32),
             b0=np.zeros((32, 32), np.float32),
             active=np.arange(K + 2) < K)
    return gt.Y, d, params, np.full((32, 32), 0.05, np.float32)


def _svd_problem():
    """``test_fit_lowrank_model_svd_both_packages_hit_the_truncated_svd``'s
    residual, one neuron left in it."""
    gt = simulate_movie(seed=4, H=32, W=32, T=300, K=4, sn=0.05,
                        bg_strength=1.0)
    return gt.Y, gt.A[:3], gt.C[:3]


def _nmf_problem():
    rng = np.random.default_rng(3)
    X = (np.abs(rng.standard_normal((60, 3))) @ np.abs(
        rng.standard_normal((3, 90)))).astype(np.float32)
    return X, _jax_draw(X, 3)


def _spatial_problem():
    """``test_torch_spatial.py``'s problem with 32 rows, so that they
    split over 'patch'."""
    sim = simulate_movie(seed=3, H=32, W=31, T=160, K=5, gSig=2.0,
                         sn=0.05, bg_strength=0.0, min_dist=8.0,
                         spike_rate=0.05)
    rng = np.random.default_rng(1)
    K, Kmax = sim.A.shape[0], 8
    H, W = sim.A.shape[1:]
    T = sim.C.shape[1]
    d = {"A": np.zeros((Kmax, H, W), np.float32),
         "C": np.zeros((Kmax, T), np.float32),
         "C_raw": np.zeros((Kmax, T), np.float32),
         "S": np.zeros((Kmax, T), np.float32),
         "active": np.zeros(Kmax, bool),
         "g": np.full((Kmax, 1), 0.9, np.float32),
         "neuron_sn": np.zeros(Kmax, np.float32),
         "b0": np.zeros((H, W), np.float32),
         "tags": np.zeros(Kmax, np.int32)}
    slots = np.array([0, 2, 3, 5, 6])[:K]
    d["A"][slots] = sim.A * (1 + 0.05 * rng.standard_normal(sim.A.shape))
    d["C"][slots] = sim.C
    d["active"][slots] = True
    sn = np.asarray(jnoise(jnp.asarray(sim.Y)))
    return sim.Y, d, sn


def _spatial_params(algorithm):
    p = CNMFEParams(init=InitParams(gSig=2.0, gSiz=7),
                    background=BackgroundParams(model="svd"))
    return p.replace(spatial=dataclasses.replace(p.spatial,
                                                 algorithm=algorithm))


def _temporal_problem():
    """``test_update_temporal_with_decorrelate``'s AR(1) problem."""
    gt = simulate_movie(seed=5, H=32, W=32, T=300, K=6, gSig=2.0, sn=0.05,
                        bg_strength=0.0, min_dist=6.0, spike_rate=0.05)
    K, Kmax = gt.A.shape[0], 8
    H, W = gt.A.shape[1:]
    T = gt.C.shape[1]
    rng = np.random.default_rng(6)
    d = {"A": np.zeros((Kmax, H, W), np.float32),
         "C": np.zeros((Kmax, T), np.float32),
         "C_raw": np.zeros((Kmax, T), np.float32),
         "S": np.zeros((Kmax, T), np.float32),
         "active": np.zeros(Kmax, bool),
         "g": np.full((Kmax, 1), 0.9, np.float32),
         "neuron_sn": np.zeros(Kmax, np.float32),
         "b0": np.zeros((H, W), np.float32),
         "tags": np.zeros(Kmax, np.int32)}
    d["A"][:K] = gt.A * (1 + 0.05 * rng.standard_normal(gt.A.shape))
    d["C"][:K] = gt.C
    d["active"][:K] = True
    params = CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=7),
        temporal=dataclasses.replace(TemporalParams(), decorrelate=True))
    params = params.replace(temporal=dataclasses.replace(
        params.temporal, deconv=dataclasses.replace(
            params.temporal.deconv, model="ar1", method="constrained")))
    return gt.Y, d, params


def _jax_state(d):
    return jstate.CNMFEState(**{k: jnp.asarray(v) for k, v in d.items()})


def _asdict(p):
    return dataclasses.asdict(p)


@pytest.fixture(scope="module")
def ranks():
    jobs = []
    for movie, cutoff in LOCAL:
        kw, ssub = MOVIES[movie]
        jobs.append((f"local_{movie}", "local_bg_case",
                     (simulate_movie(**kw).Y, 8, ssub, cutoff)))
    for ssub in (1, 2):
        Y, d, p, sn = _local_model_problem(ssub)
        jobs.append((f"local_model_{ssub}", "bg_model_case",
                     (Y, d, _asdict(p), sn)))
    Y, A, C = _svd_problem()
    jobs.append(("svd", "lowrank_case", (Y, A, C, 3, "svd")))
    jobs.append(("nmf_model", "lowrank_case", (Y, A, C, 2, "nmf")))
    X, (W0, H0) = _nmf_problem()
    jobs.append(("nmf", "nmf_case", (X, 3, 50, W0, H0)))
    jobs.append(("ellipse", "ellipse_case", (_footprints(), 3.0)))
    Y, d, sn = _spatial_problem()
    for algo, with_sn in SPATIAL:
        jobs.append((f"spatial_{algo}_{with_sn}", "spatial_case",
                     (Y, d, _asdict(_spatial_params(algo)),
                      sn if with_sn else None)))
    for p, wd in DECORR:
        A, S, C, g, sn = _neurons(p=p)
        jobs.append((f"decorr_{p}_{wd}", "decorr_case",
                     (C, S, A, g, sn, 6.0, wd)))
    Y, d, params = _temporal_problem()
    jobs.append(("temporal_decorrelate", "temporal_case",
                 (Y, d, _asdict(params))))
    gt = _mini_movie()
    for name, fields in FITS.items():
        jobs.append((f"fit_{name}", "fit_case",
                     (gt.Y, _asdict(_mini_params(**fields)), 1)))
    return spawn(_selftest.cases, N_PATCH, N_FRAME, device="cpu",
                 args=(jobs,), timeout=240, pg_timeout=60)


# ------------------------------------------------------------------ #
# the local background
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("movie, cutoff", LOCAL)
def test_local_background(ranks, movie, cutoff, against):
    kw, ssub = MOVIES[movie]
    Y = simulate_movie(**kw).Y
    if against == "jax":
        Yest, w, b0 = jring.local_background(
            jnp.asarray(Y), radius=8, ssub=ssub, neighbor_cutoff=cutoff)
        w = w.w
    else:
        Yest, w, b0 = tring.local_background(
            torch.as_tensor(Y), radius=8, ssub=ssub, neighbor_cutoff=cutoff)
        w = w.w
    got = ranks[0][f"local_{movie}"]
    _close(got["Yest"], np.asarray(Yest), 1e-4, "Yest")
    _close(got["b0"], np.asarray(b0), 1e-4, "b0")
    _close(got["w"], np.asarray(w), 2e-3, "w")


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("ssub", [1, 2])
def test_local_model_update_and_background(ranks, ssub, against):
    Y, d, params, sn = _local_model_problem(ssub)
    if against == "jax":
        st = jbg.update_background(jnp.asarray(Y), _jax_state(d), params,
                                   sn_pix=jnp.asarray(sn))
        B = jbg.background_of(jnp.asarray(Y), st, params)
    else:
        tp = params_from_dict(_asdict(params))
        Yt = torch.as_tensor(Y)
        st = tbg.update_background(Yt, state_from_numpy(d, device="cpu"),
                                   tp, sn_pix=torch.as_tensor(sn))
        B = tbg.background_of(Yt, st, tp)
    got = ranks[0][f"local_model_{ssub}"]
    _close(got["b0"], np.asarray(st.b0), 1e-4, "b0")
    _close(got["ring_w"], np.asarray(st.W.w), 2e-3, "w")
    _close(got["B"], np.asarray(B), 1e-4, "background")


# ------------------------------------------------------------------ #
# the low-rank models
# ------------------------------------------------------------------ #
def _background(b, f, b0):
    b, f, b0 = (np.asarray(x, np.float64) for x in (b, f, b0))
    return b.reshape(b.shape[0], -1).T @ f + b0.reshape(-1)[:, None]


@pytest.mark.parametrize("against", ["jax", "port"])
def test_svd_background(ranks, against):
    """B = f^T b + b0 (b and f have free signs): within 1e-3 of the
    truncated SVD, as the one-process fits are, and of theirs."""
    Y, A, C = _svd_problem()
    T = Y.shape[0]
    got = ranks[0]["svd"]
    B = _background(got["b"], got["f"], got["b0"])
    resid = (Y - np.einsum("khw,kt->thw", A, C)).reshape(T, -1)
    b0 = resid.mean(0)
    exact = _truncated((resid - b0).T, 3)[0] + b0[:, None]
    norm = np.linalg.norm(exact - b0[:, None])
    assert np.linalg.norm(B - exact) / norm < LOWRANK_TOL
    if against == "jax":
        ref = jlowrank.fit_lowrank_model(jnp.asarray(Y), jnp.asarray(A),
                                         jnp.asarray(C), 3, mode="svd")
        np.testing.assert_allclose(got["b0"], np.asarray(ref[2]),
                                   rtol=1e-5, atol=1e-6)
        assert np.linalg.norm(B - _background(*ref)) / norm < LOWRANK_TOL
    else:
        ref = tlowrank.fit_lowrank_model(torch.as_tensor(Y),
                                         torch.as_tensor(A),
                                         torch.as_tensor(C), 3, mode="svd")
        assert np.linalg.norm(B - _background(*ref)) / norm < 1e-4


def test_nmf_model_draws_as_one_process(ranks):
    """The mesh draws the whole starting factors and takes its blocks, so
    its NMF background follows the port's one process."""
    Y, A, C = _svd_problem()
    b, f, b0 = tlowrank.fit_lowrank_model(
        torch.as_tensor(Y), torch.as_tensor(A), torch.as_tensor(C), 2,
        mode="nmf")
    got = ranks[0]["nmf_model"]
    for k, ref in (("b", b), ("f", f), ("b0", b0)):
        np.testing.assert_allclose(got[k], ref.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("against", ["jax", "port"])
def test_nmf_hals_from_the_jax_draw(ranks, against):
    X, (W0, H0) = _nmf_problem()
    if against == "jax":
        Wf, Hf = jlowrank.nmf_hals(jnp.asarray(X), 3, n_iter=50)
    else:
        Wf, Hf = tlowrank.nmf_hals(torch.as_tensor(X), 3, n_iter=50,
                                   init=(W0, H0))
    got = ranks[0]["nmf"]
    np.testing.assert_allclose(got["W"], np.asarray(Wf), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["H"], np.asarray(Hf), rtol=1e-4,
                               atol=1e-5)


# ------------------------------------------------------------------ #
# the ellipse search and the spatial algorithms
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("against", ["jax", "port"])
def test_ellipse_masks(ranks, against):
    A = _footprints()
    want = (np.asarray(jmorph.search_locations_ellipse(jnp.asarray(A)))
            if against == "jax" else
            tmorph.search_locations_ellipse(torch.as_tensor(A)).numpy())
    differ = ranks[0]["ellipse"] != want
    assert not (differ & (np.abs(_ellipse_r2(A) - 1.0) > 1e-4)).any()
    assert want.any(axis=(1, 2)).all()


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("algorithm, with_sn", SPATIAL)
def test_spatial_algorithm(ranks, algorithm, with_sn, against):
    """``test_torch_spatial.py``'s bars: lars footprints at correlation
    >= 0.999, the others within 1e-4 (1 + |A|) but at 0.5% of the
    support, and the same support there."""
    Y, d, sn = _spatial_problem()
    p = _spatial_params(algorithm)
    if against == "jax":
        st = jspatial.update_spatial(jnp.asarray(Y), _jax_state(d), p,
                                     sn_pix=jnp.asarray(sn) if with_sn
                                     else None)
    else:
        st = tspatial.update_spatial(
            torch.tensor(Y), state_from_numpy(d, device="cpu"),
            params_from_dict(_asdict(p)),
            sn_pix=torch.tensor(sn) if with_sn else None)
    A_ref = np.asarray(st.A)
    A_m = ranks[0][f"spatial_{algorithm}_{with_sn}"]
    assert (A_m[~d["active"]] == 0).all()
    if algorithm == "lars":
        for k in np.nonzero(d["active"])[0]:
            assert np.corrcoef(A_m[k].ravel(), A_ref[k].ravel())[0, 1] \
                >= 0.999, k
        return
    off = np.abs(A_m - A_ref) > 1e-4 * (1 + np.abs(A_ref))
    assert off.sum() <= 0.005 * max((A_ref > 0).sum(), 1), off.sum()
    assert ((A_m > 0) != (A_ref > 0)).sum() <= 0.005 * (A_ref > 0).sum()


# ------------------------------------------------------------------ #
# decorrelate
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("p, wd", DECORR)
def test_decorr_temporal(ranks, p, wd, against):
    """Each patch rank's whole traces against its neighbours' spikes
    gathered over 'patch': within 1e-5 of each trace's scale."""
    A, S, C, g, sn = _neurons(p=p)
    fn, conv = ((jspikes.decorr_temporal, jnp.asarray) if against == "jax"
                else (tspikes.decorr_temporal, torch.tensor))
    want = np.asarray(fn(*map(conv, (C, S, A, g, sn)), gSiz=6.0, wd=wd))
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(ranks[0][f"decorr_{p}_{wd}"] - want)
            <= 1e-5 * scale + 1e-7).all()


@pytest.mark.parametrize("against", ["jax", "port"])
def test_update_temporal_with_decorrelate(ranks, against):
    Y, d, params = _temporal_problem()
    if against == "jax":
        st = jtemporal.update_temporal(jnp.asarray(Y), _jax_state(d),
                                       params)
    else:
        st = ttemporal.update_temporal(
            torch.tensor(Y), state_from_numpy(d, device="cpu"),
            params_from_dict(_asdict(params)))
    got = ranks[0]["temporal_decorrelate"]
    for k in ("C", "C_raw", "S"):
        ref = np.asarray(getattr(st, k))
        scale = np.maximum(np.abs(ref).max(-1, keepdims=True), 1e-6)
        assert (np.abs(got[k] - ref) / scale).max() <= 1e-4, k
    np.testing.assert_allclose(got["g"], np.asarray(st.g), atol=1e-5)


# ------------------------------------------------------------------ #
# the whole fits
# ------------------------------------------------------------------ #
def _matched(A, C, act, A_ref, C_ref, act_ref, bar):
    n = int(act.sum())
    assert n == int(act_ref.sum()) > 0
    for k in range(n):
        assert np.corrcoef(A[k].ravel(), A_ref[k].ravel())[0, 1] >= bar, k
        assert np.corrcoef(C[k], C_ref[k])[0, 1] >= bar, k


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_with_options(ranks, name, against):
    gt = _mini_movie()
    got = ranks[0][f"fit_{name}"]
    p = _mini_params(**FITS[name])
    if against == "jax":
        st = JaxCNMFE(p).fit(gt.Y, n_outer=1)
        bar = 0.99
    else:
        st = CNMFE(params_from_dict(_asdict(p)), device="cpu").fit(
            gt.Y, n_outer=1)
        bar = 0.999
    s = got["state"]
    _matched(s["A"], s["C"], s["active"], np.asarray(st.A),
             np.asarray(st.C), np.asarray(st.active), bar)
    for r in ranks:
        np.testing.assert_array_equal(r[f"fit_{name}"]["active"],
                                      s["active"])
        assert r[f"fit_{name}"]["broadcasts"] == 0
