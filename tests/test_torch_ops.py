"""Module-by-module parity of the PyTorch port with the JAX package.

The same inputs, made from a numpy seed, go through each JAX function and
its port on the CPU. Tolerances: float32 results that follow the same
arithmetic in another summation order are held at 1e-5 relative (1e-4
where a chain of solves or a long reduction sits between input and
output); integer, boolean and schedule outputs must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import BackgroundParams, CNMFEParams, InitParams
from cnmf_e_tpu.models import background as jbg
from cnmf_e_tpu.models import initialize as jinit
from cnmf_e_tpu.models import merge as jmerge
from cnmf_e_tpu.models import qc as jqc
from cnmf_e_tpu.models import spatial as jspatial
from cnmf_e_tpu.models import state as jstate
from cnmf_e_tpu.models import temporal as jtemporal
from cnmf_e_tpu.ops import coloring as jcoloring
from cnmf_e_tpu.ops import corr as jcorr
from cnmf_e_tpu.ops import filters as jfilters
from cnmf_e_tpu.ops import morphology as jmorph
from cnmf_e_tpu.ops import noise as jnoise
from cnmf_e_tpu.ops import ring as jring
from cnmf_e_tpu.ops import stats as jstats
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import (params_from_dict, state_from_numpy,
                                      state_to_numpy)
from cnmf_e_tpu_torch.models import background as tbg
from cnmf_e_tpu_torch.models import initialize as tinit
from cnmf_e_tpu_torch.models import merge as tmerge
from cnmf_e_tpu_torch.models import qc as tqc
from cnmf_e_tpu_torch.models import spatial as tspatial
from cnmf_e_tpu_torch.models import state as tstate
from cnmf_e_tpu_torch.models import temporal as ttemporal
from cnmf_e_tpu_torch.ops import coloring as tcoloring
from cnmf_e_tpu_torch.ops import corr as tcorr
from cnmf_e_tpu_torch.ops import filters as tfilters
from cnmf_e_tpu_torch.ops import morphology as tmorph
from cnmf_e_tpu_torch.ops import noise as tnoise
from cnmf_e_tpu_torch.ops import ring as tring
from cnmf_e_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)


def close(got, want, rtol=1e-5, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


def T_(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------------------ #
# shared small problem: a simulated 1p movie and a state built on it
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def sim():
    return simulate_movie(seed=3, H=29, W=31, T=160, K=5, gSig=2.0,
                          sn=0.05, bg_strength=0.6, min_dist=8.0,
                          spike_rate=0.05)


def _tp(params):
    """The port's own params with the same fields as the JAX ``params``."""
    return params_from_dict(dataclasses.asdict(params))


def _params(ssub=1, **kw):
    return CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=7, min_corr=0.7, min_pnr=5.0,
                        max_neurons=8, seeds_per_round=6, max_rounds=3),
        background=BackgroundParams(model="ring", ring_radius=6, ssub=ssub),
        **kw)


@pytest.fixture(scope="module")
def state_np(sim):
    """Ground-truth neurons in 5 of 8 slots, with a fitted ring."""
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
    d["C_raw"][slots] = sim.C + 0.05 * rng.standard_normal(sim.C.shape)
    d["S"][slots] = np.maximum(np.diff(sim.C, prepend=0, axis=1), 0)
    d["active"][slots] = True
    d["neuron_sn"][slots] = 0.05
    st = _jax_state(d)
    st = jbg.update_background(jnp.asarray(sim.Y), st, _params())
    return _jax_to_numpy(st)


def _jax_state(d):
    W = (jring.RingWeights(w=jnp.asarray(d["ring_w"]),
                           w0=jnp.asarray(d["ring_w0"]))
         if "ring_w" in d else None)
    return jstate.CNMFEState(
        A=jnp.asarray(d["A"], jnp.float32), C=jnp.asarray(d["C"], jnp.float32),
        C_raw=jnp.asarray(d["C_raw"], jnp.float32),
        S=jnp.asarray(d["S"], jnp.float32), active=jnp.asarray(d["active"]),
        g=jnp.asarray(d["g"], jnp.float32),
        neuron_sn=jnp.asarray(d["neuron_sn"], jnp.float32),
        b0=jnp.asarray(d["b0"], jnp.float32), W=W,
        tags=jnp.asarray(d["tags"], jnp.int32))


def _jax_to_numpy(st):
    d = {k: np.asarray(getattr(st, k)) for k in
         ("A", "C", "C_raw", "S", "active", "g", "neuron_sn", "b0", "tags")}
    if st.W is not None:
        d["ring_w"], d["ring_w0"] = np.asarray(st.W.w), np.asarray(st.W.w0)
    return d


def _states_close(got, want, rtol=1e-4, atol=1e-4, keys=None):
    g, w = state_to_numpy(got), _jax_to_numpy(want)
    for k in keys or ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0"):
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    np.testing.assert_array_equal(g["active"], w["active"])


# ------------------------------------------------------------------ #
# ops/stats.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("shape,axis", [((40, 7), 0), ((6, 51), -1),
                                        ((5, 64), 1)])
def test_fast_median_matches_jax(shape, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    close(tstats.fast_median(T_(x), dim=axis),
          jstats.fast_median(jnp.asarray(x), axis=axis), 0, 0)
    close(tstats.submedian_mean(T_(x), dim=axis),
          jstats.submedian_mean(jnp.asarray(x), axis=axis))


def test_fast_median_masked_and_median_mid():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 30)).astype(np.float32)
    m = rng.random((7, 30)) > 0.4
    m[3] = False                                    # an empty row gives 0
    close(tstats.fast_median_masked(T_(x), T_(m), dim=1),
          jstats.fast_median_masked(jnp.asarray(x), jnp.asarray(m), axis=1),
          0, 0)
    close(tstats.median_mid(T_(x[:, :30]), dim=1), np.median(x, axis=1))


# ------------------------------------------------------------------ #
# ops/noise.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("T", [100, 257, 1000])
def test_noise_psd_matches_jax(T):
    rng = np.random.default_rng(T)
    y = (np.cumsum(rng.standard_normal((6, T)), 1) * 0.05
         + rng.standard_normal((6, T))).astype(np.float32)
    close(tnoise.noise_psd(T_(y)), jnoise.noise_psd(jnp.asarray(y)))
    for method in ("mean", "median"):
        close(tnoise.noise_psd(T_(y), method=method),
              jnoise.noise_psd(jnp.asarray(y), method=method))
    Yf = np.ascontiguousarray(y.T.reshape(T, 2, 3))
    close(tnoise.noise_psd_frames(T_(Yf)),
          jnoise.noise_psd_frames(jnp.asarray(Yf)), 1e-4, 1e-6)


def test_baseline_noise_matches_jax():
    rng = np.random.default_rng(2)
    y = (1.0 + 0.1 * rng.standard_normal((9, 400))
         + (rng.random((9, 400)) < 0.03) * 2.0).astype(np.float32)
    y[4] = 0.0                                      # degenerate trace
    bt, st = tnoise.estimate_baseline_noise(T_(y))
    bj, sj = jnoise.estimate_baseline_noise(jnp.asarray(y))
    close(bt, bj, 1e-4, 1e-5)
    close(st, sj, 1e-4, 1e-5)
    for method in ("psd", "hist", "std"):
        close(tnoise.estimate_noise(T_(y), method),
              jnoise.estimate_noise(jnp.asarray(y), method), 1e-4, 1e-5)


# ------------------------------------------------------------------ #
# ops/filters.py and ops/corr.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("gSig,center", [(2.0, True), (2.5, False),
                                         (3.0, True), (0.0, True)])
def test_filter_movie_matches_jax(gSig, center):
    psf_t = tfilters.gaussian_psf(gSig, center)
    same(psf_t, jfilters.gaussian_psf(gSig, center))
    Y = np.random.default_rng(4).standard_normal((5, 23, 30)).astype(
        np.float32)
    close(tfilters.filter_movie(T_(Y), psf_t),
          jfilters.filter_movie(jnp.asarray(Y), psf_t))


@pytest.mark.parametrize("H,W,ssub", [(29, 31, 2), (30, 32, 2), (25, 25, 3)])
def test_box_downsample_and_linear_resize_match_jax(H, W, ssub):
    Y = np.random.default_rng(5).standard_normal((4, H, W)).astype(np.float32)
    Ys = tfilters.box_downsample(T_(Y), ssub=ssub)
    close(Ys, jfilters.box_downsample(jnp.asarray(Y), ssub=ssub))
    # the ssub upsample: half-pixel centres, border samples clamp
    close(tfilters.resize_linear(Ys, (H, W)),
          jax.image.resize(jnp.asarray(Ys.numpy()), (4, H, W),
                           method="linear"))


def test_correlation_maps_match_jax(sim):
    Y = sim.Y
    close(tcorr.correlation_image(T_(Y)),
          jcorr.correlation_image(jnp.asarray(Y)), 1e-4, 1e-5)
    cn_t, pnr_t = tcorr.correlation_pnr(T_(Y), gSig=2.0)
    cn_j, pnr_j = jcorr.correlation_pnr(jnp.asarray(Y), gSig=2.0)
    close(cn_t, cn_j, 1e-4, 1e-4)
    close(pnr_t, pnr_j, 1e-4, 1e-4)


# ------------------------------------------------------------------ #
# ops/morphology.py
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def footprints():
    rng = np.random.default_rng(6)
    K, H, W = 6, 21, 19
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(4, H - 4), rng.uniform(4, W - 4)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 6.0)
        # a detached speck and some noise: the constraints must cut them
        A[k, int(rng.integers(0, 3)), int(rng.integers(0, 3))] = 0.5
    A += 0.02 * np.abs(rng.standard_normal(A.shape)).astype(np.float32)
    A[5] = 0.0                                       # an empty slot
    return np.where(A > 0.05, A, 0).astype(np.float32)


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_search_locations_dilate_matches_jax(footprints, radius):
    same(tmorph.search_locations_dilate(T_(footprints), radius=radius),
         jmorph.search_locations_dilate(jnp.asarray(footprints),
                                        radius=radius))


@pytest.mark.parametrize("se_size", [3, 5])
def test_connectivity_constraint_matches_jax(footprints, se_size):
    close(tmorph.connectivity_constraint(T_(footprints), se_size=se_size),
          jmorph.connectivity_constraint(jnp.asarray(footprints),
                                         se_size=se_size), 0, 0)


def test_circular_constraint_matches_jax(footprints):
    close(tmorph.circular_constraint(T_(footprints)),
          jmorph.circular_constraint(jnp.asarray(footprints)), 0, 0)


def test_label_from_seed_early_stop_is_exact(monkeypatch):
    """A snake-shaped component needs more propagation steps than the
    H + W the JAX package runs: stopping early at a fixed point must give
    the same mask, cut at the same step."""
    m = np.zeros((15, 15), bool)
    m[::2] = True
    m[1::4, -1] = True
    m[3::4, 0] = True
    mt = T_(m)[None]
    r0, c0 = torch.tensor([0]), torch.tensor([0])
    monkeypatch.setattr(tmorph, "_CHECK_EVERY", 2)
    fast = tmorph.label_from_seed(mt, r0, c0)
    monkeypatch.setattr(tmorph, "_CHECK_EVERY", 10 ** 6)
    full = tmorph.label_from_seed(mt, r0, c0)
    assert torch.equal(fast, full)
    assert bool(fast[0, 2, 5]) and not bool(fast[0, 4, 14])
    same(fast[0], jmorph.label_from_seed(jnp.asarray(m), jnp.asarray(0),
                                         jnp.asarray(0)))


# ------------------------------------------------------------------ #
# ops/coloring.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("seed,K,block", [(0, 30, 8), (1, 70, 64),
                                          (2, 13, 16)])
def test_coloring_and_schedule_identical(seed, K, block):
    rng = np.random.default_rng(seed)
    support = (rng.random((K, 40)) < 0.06).astype(np.float32)
    adj_t = tcoloring.overlap_adjacency(T_(support))
    adj_j = jcoloring.overlap_adjacency(jnp.asarray(support))
    same(adj_t, adj_j)
    col_t = tcoloring.greedy_color(adj_t)
    col_j = jcoloring.greedy_color(adj_j)
    same(col_t, col_j)
    order_t = torch.argsort(col_t, stable=True)
    order_j, _ = jcoloring.color_order(adj_j)
    same(order_t, order_j)
    for n_cap in (None, 3):
        for a, b in zip(tcoloring.class_step_schedule(col_t[order_t], block,
                                                      n_cap),
                        jcoloring.class_step_schedule(col_j[order_j], block,
                                                      n_cap)):
            same(a, b)


# ------------------------------------------------------------------ #
# ops/ring.py and models/background.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("radius", [3, 6, 9])
def test_ring_offsets_and_neighbors_identical(radius):
    same(tring.ring_offsets(radius), jring.ring_offsets(radius))
    off = jring.ring_offsets(radius)
    it, vt = tring._neighbor_index(17, 13, off)
    ij, vj = jring._neighbor_index(17, 13, off)
    same(it, ij)
    same(vt, vj)


def test_ring_fit_and_apply_match_jax(sim):
    rng = np.random.default_rng(7)
    Bf = rng.standard_normal((90, 14, 16)).astype(np.float32)
    wt = tring.fit_ring_weights(T_(Bf), 14, 16, 3, chunk=64)
    wj = jring.fit_ring_weights(jnp.asarray(Bf), 14, 16, 3, chunk=64)
    close(wt.w, wj.w, 1e-3, 1e-4)
    close(wt.w0, wj.w0, 1e-3, 1e-4)
    X = rng.standard_normal((5, 14, 16)).astype(np.float32)
    for icpt in (True, False):
        close(tring.apply_ring(wt, T_(X), 14, 16, 3, icpt),
              jring.apply_ring(wj, jnp.asarray(X), 14, 16, 3, icpt),
              1e-4, 1e-4)


@pytest.mark.parametrize("ssub,cap", [(1, 100), (2, 100), (2, 1)])
def test_fit_ring_model_matches_jax(sim, state_np, ssub, cap):
    """With the previous weights (outlier clamp) and, at cap=1, the
    frame-stride subsample."""
    st = _jax_state(state_np)
    A, C = np.asarray(st.masked_A()), np.asarray(st.masked_C())
    sn = np.asarray(jnoise.noise_psd_frames(jnp.asarray(sim.Y)))
    W_old = None
    if ssub == 1:
        W_old = st.W
    else:
        W_old, _, _ = jring.fit_ring_model(jnp.asarray(sim.Y),
                                           jnp.asarray(A), jnp.asarray(C),
                                           6, ssub=ssub)
    wj, b0j, Bj = jring.fit_ring_model(
        jnp.asarray(sim.Y), jnp.asarray(A), jnp.asarray(C), 6, W_old=W_old,
        sn=jnp.asarray(sn), thresh_outlier=1.0, frame_cap_factor=cap,
        ssub=ssub)
    wt, b0t, Bt = tring.fit_ring_model(
        T_(sim.Y), T_(A), T_(C), 6,
        W_old=tstate.RingWeights(T_(W_old.w), T_(W_old.w0)), sn=T_(sn),
        thresh_outlier=1.0, frame_cap_factor=cap, ssub=ssub)
    close(Bt, Bj, 1e-4, 1e-5)
    close(b0t, b0j, 1e-5, 1e-5)
    close(wt.w, wj.w, 1e-3, 2e-4)
    close(wt.w0, wj.w0, 1e-3, 2e-4)


@pytest.mark.parametrize("ssub", [1, 2])
def test_background_stages_match_jax(sim, state_np, ssub):
    """Two refits in a row (the second clamps outliers against the
    first's weights), then evaluation."""
    params = _params(ssub=ssub)
    Y = sim.Y
    sn = jnoise.noise_psd_frames(jnp.asarray(Y))
    d = {k: v for k, v in state_np.items() if not k.startswith("ring_")}
    st_j, st_t = _jax_state(d), state_from_numpy(d, device="cpu")
    for _ in range(2):
        st_j = jbg.update_background(jnp.asarray(Y), st_j, params, sn_pix=sn)
        st_t = tbg.update_background(T_(Y), st_t, _tp(params),
                                      sn_pix=T_(sn))
    close(st_t.W.w, st_j.W.w, 1e-3, 2e-4)
    close(st_t.b0, st_j.b0, 1e-5, 1e-5)
    # evaluate both on the same weights
    st_t = state_from_numpy(_jax_to_numpy(st_j), device="cpu")
    close(tbg.background_of(T_(Y), st_t, _tp(params)),
          jbg.background_of(jnp.asarray(Y), st_j, params), 1e-4, 1e-4)
    close(tbg.subtract_background(T_(Y), st_t, _tp(params)),
          jbg.subtract_background(jnp.asarray(Y), st_j, params), 1e-4, 1e-4)
    close(tbg.residual_movie(T_(Y), st_t, _tp(params)),
          jbg.residual_movie(jnp.asarray(Y), st_j, params), 1e-4, 1e-4)


# ------------------------------------------------------------------ #
# models/initialize.py
# ------------------------------------------------------------------ #
def test_local_maxima_topk_breaks_ties_like_jax():
    rng = np.random.default_rng(8)
    v = np.round(rng.random((20, 22)) * 4).astype(np.float32)  # many ties
    v[5, 5] = v[5, 7] = 9.0                          # a tied close pair
    for n, dist in ((6, 2), (10, 3), (40, 4)):
        got = tinit._local_maxima_topk(T_(v), n, 1.0, dist)
        want = jinit._local_maxima_topk(jnp.asarray(v), n, 1.0, dist)
        for a, b in zip(got, want):
            same(a, b)


def test_extract_ac_batch_matches_jax(sim):
    Y = jnp.asarray(sim.Y)
    HY, Ysig = jinit._init_prolog(Y, 2.0, True)
    HYt, Ysigt = tinit._init_prolog(T_(sim.Y), 2.0, True)
    close(HYt, HY, 1e-4, 1e-5)
    close(Ysigt, Ysig, 1e-4, 1e-6)
    rows = np.array([3, 10, 20, 27, 0])
    cols = np.array([4, 15, 9, 30, 0])
    rj = jinit.extract_ac_batch(HY, Y, jnp.asarray(rows), jnp.asarray(cols),
                                7, min_pixel=5, corr_thr=0.9)
    rt = tinit.extract_ac_batch(T_(np.asarray(HY)), T_(sim.Y), T_(rows),
                                T_(cols), 7, min_pixel=5, corr_thr=0.9)
    same(rt.ok, rj.ok)
    close(rt.a, rj.a, 1e-3, 1e-4)
    close(rt.c_raw, rj.c_raw, 1e-3, 1e-4)
    close(rt.sn, rj.sn, 1e-3, 1e-5)


@pytest.mark.parametrize("deconv", [True, False])
def test_initialize_greedy_matches_jax(sim, deconv):
    p = _params()
    p = p.replace(init=dataclasses.replace(p.init, deconv_at_init=deconv,
                                           bd=1))
    st_j, info_j = jinit.initialize_greedy(jnp.asarray(sim.Y), p)
    st_t, info_t = tinit.initialize_greedy(T_(sim.Y), _tp(p))
    assert info_t["seeds"] == info_j["seeds"]
    assert info_t["n_found"] == info_j["n_found"]
    _states_close(st_t, st_j, 1e-3, 1e-3)
    close(info_t["Cn"], info_j["Cn"], 1e-4, 1e-4)


# ------------------------------------------------------------------ #
# models/spatial.py, temporal.py, merge.py, qc.py, state.py
# ------------------------------------------------------------------ #
def _ysig(sim, state_np, params):
    return np.asarray(jbg.subtract_background(
        jnp.asarray(sim.Y), _jax_state(state_np), params))


@pytest.mark.parametrize("circular", [False, True])
def test_update_spatial_matches_jax(sim, state_np, circular):
    p = _params()
    p = p.replace(spatial=dataclasses.replace(p.spatial, circular=circular))
    Ysig = _ysig(sim, state_np, p)
    st_j = jspatial.update_spatial(jnp.asarray(Ysig), _jax_state(state_np),
                                   p)
    st_t = tspatial.update_spatial(
        T_(Ysig), state_from_numpy(state_np, device="cpu"), _tp(p))
    close(st_t.A, st_j.A, 1e-4, 1e-4)


def test_update_temporal_matches_jax(sim, state_np):
    p = _params()
    Ysig = _ysig(sim, state_np, p)
    st_j = jtemporal.update_temporal(jnp.asarray(Ysig), _jax_state(state_np),
                                     p)
    st_t = ttemporal.update_temporal(
        T_(Ysig), state_from_numpy(state_np, device="cpu"), _tp(p))
    _states_close(st_t, st_j, 1e-4, 2e-4)


def _merge_state(state_np):
    """Slot 7 duplicates slot 0 (shifted by a pixel, same trace): every
    mode must merge that pair."""
    d = {k: v.copy() for k, v in state_np.items()}
    d["A"][7] = np.roll(d["A"][0], 1, axis=1)
    for k in ("C", "C_raw", "S"):
        d[k][7] = d[k][0] * 0.8
    d["active"][7] = True
    return d


@pytest.mark.parametrize("mode", ["dist_corr", "high_corr", "dist_only"])
@pytest.mark.parametrize("deconv", [True, False])
def test_merge_neurons_matches_jax(state_np, mode, deconv):
    p = _params()
    d = _merge_state(state_np)
    st_j, nm_j = jmerge.merge_neurons(_jax_state(d), p, mode, deconv=deconv)
    st_t, nm_t = tmerge.merge_neurons(state_from_numpy(d, device="cpu"),
                                      _tp(p), mode, deconv=deconv)
    assert int(nm_t) == int(nm_j) >= 1
    _states_close(st_t, st_j, 1e-4, 1e-4)


def test_merge_neurons_seq_matches_jax(state_np):
    p = _params()
    d = _merge_state(state_np)
    modes = ("dist_corr", "high_corr")
    st_j, nm_j = jmerge.merge_neurons_seq(_jax_state(d), p, modes)
    st_t, nm_t = tmerge.merge_neurons_seq(state_from_numpy(d, device="cpu"),
                                          _tp(p), modes)
    assert nm_t == nm_j >= 1
    _states_close(st_t, st_j, 1e-4, 1e-4)
    np.testing.assert_allclose(tmerge.decay_times(st_t),
                               jmerge.decay_times(st_j), rtol=1e-5)


def test_merge_stats_match_jax(state_np):
    d = _merge_state(state_np)
    close(tmerge._merge_stats(state_from_numpy(d, device="cpu")),
          jmerge._merge_stats(_jax_state(d)), 1e-4, 1e-5)


def test_qc_matches_jax(state_np):
    p = _params()
    d = {k: v.copy() for k, v in state_np.items()}
    d["S"][2] = 0.0                                  # no spikes -> tagged
    d["A"][3] = np.where(d["A"][3] > 0.9 * d["A"][3].max(), d["A"][3], 0)
    st_j = jqc.tag_neurons(_jax_state(d), p)
    st_t = tqc.tag_neurons(state_from_numpy(d, device="cpu"), _tp(p))
    same(st_t.tags, st_j.tags)
    assert int((st_t.tags != 0).sum()) >= 1
    _states_close(tqc.remove_false_positives(state_from_numpy(d, device="cpu"),
                                            _tp(p)),
                  jqc.remove_false_positives(_jax_state(d), p), 0, 0)


def test_state_helpers_match_jax(state_np):
    st_t = state_from_numpy(state_np, device="cpu")
    st_j = _jax_state(state_np)
    _states_close(tstate.compact(st_t), jstate.compact(st_j), 0, 0)
    e_t = tstate.empty_state(4, 5, 6, 7)
    e_j = jstate.empty_state(4, 5, 6, 7)
    for k in ("A", "C", "C_raw", "S", "active", "g", "neuron_sn", "b0",
              "tags"):
        same(getattr(e_t, k), getattr(e_j, k))
    assert int(st_t.n_active()) == int(st_j.n_active())
    same(st_t.masked_A(), st_j.masked_A())
