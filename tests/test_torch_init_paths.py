"""The init's decimated and detrended paths of the PyTorch port against the
JAX package: ``initialize_greedy`` at ``init.ssub/tsub > 1`` and
``init.nk > 1``, with what they bring in (``ops/detrend.py``,
``box_downsample``'s ``tsub``, ``spatial_upsample`` and the linear resize
of the traces), and ``qc._apply_keep``. Tolerances as in
``tests/test_torch_ops.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.models import initialize as jinit
from cnmf_e_tpu.models import qc as jqc
from cnmf_e_tpu.ops import detrend as jdetrend
from cnmf_e_tpu.ops import filters as jfilters
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.models import initialize as tinit
from cnmf_e_tpu_torch.models import qc as tqc
from cnmf_e_tpu_torch.ops import detrend as tdetrend
from cnmf_e_tpu_torch.ops import filters as tfilters
from test_torch_ops import (T_, _jax_state, _params, _states_close, _tp,
                            close, same)
from cnmf_e_tpu_torch.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim():
    """A movie with a slow drift on top, for the detrended init."""
    gt = simulate_movie(seed=5, H=30, W=28, T=240, K=5, gSig=2.0, sn=0.05,
                        bg_strength=0.6, min_dist=8.0, spike_rate=0.05)
    drift = np.linspace(0.0, 0.6, gt.Y.shape[0], dtype=np.float32)
    return (gt.Y + drift[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("ssub,tsub,nk,method", [
    (2, 1, 1, "spline"), (1, 2, 1, "spline"), (2, 2, 1, "spline"),
    (1, 1, 4, "spline"), (1, 1, 3, "local_min"), (2, 2, 4, "spline")],
    ids=["ssub2", "tsub2", "ssub2_tsub2", "nk4", "nk3_local_min",
         "ssub2_tsub2_nk4"])
def test_initialize_greedy_decimated_and_detrended_match_jax(
        sim, ssub, tsub, nk, method):
    p = _params()
    p = p.replace(init=dataclasses.replace(
        p.init, ssub=ssub, tsub=tsub, nk=nk, detrend_method=method,
        min_corr=0.6, min_pnr=4.0))
    st_j, info_j = jinit.initialize_greedy(jnp.asarray(sim), p)
    st_t, info_t = tinit.initialize_greedy(T_(sim), _tp(p))
    assert info_t["seeds"] == info_j["seeds"]
    assert info_t["n_found"] == info_j["n_found"] > 0
    assert tuple(st_t.A.shape[1:]) == sim.shape[1:]
    assert st_t.C.shape[1] == sim.shape[0]
    _states_close(st_t, st_j, 1e-3, 1e-3,
                  keys=("A", "C", "C_raw", "S", "g", "neuron_sn"))


def test_initialize_greedy_with_a_state_ignores_ssub(sim):
    """With a state given (the residual pick), the init runs at full
    resolution whatever init.ssub says, as the JAX package's does."""
    p = _params()
    p = p.replace(init=dataclasses.replace(p.init, ssub=2, min_corr=0.6,
                                           min_pnr=4.0))
    st_j0, _ = jinit.initialize_greedy(
        jnp.asarray(sim), p.replace(init=dataclasses.replace(p.init,
                                                             ssub=1)))
    st_j, info_j = jinit.initialize_greedy(jnp.asarray(sim), p, state=st_j0)
    d0 = {k: np.asarray(getattr(st_j0, k)) for k in
          ("A", "C", "C_raw", "S", "active", "g", "neuron_sn", "b0")}
    st_t, info_t = tinit.initialize_greedy(
        T_(sim), _tp(p), state=state_from_numpy(d0, device="cpu"))
    assert info_t["seeds"] == info_j["seeds"]
    _states_close(st_t, st_j, 1e-3, 1e-3,
                  keys=("A", "C", "C_raw", "S", "g", "neuron_sn"))


# ------------------------------------------------------------------ #
# ops/detrend.py
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("T,nk", [(50, 2), (240, 4), (301, 7)])
def test_bspline_basis_is_the_jax_packages(T, nk):
    same(tdetrend.bspline_basis(T, nk), jdetrend.bspline_basis(T, nk))


@pytest.mark.parametrize("method,nk", [("spline", 1), ("spline", 3),
                                       ("spline", 6), ("local_min", 4),
                                       ("local_min", 7)])
def test_detrend_matches_jax(method, nk):
    Y = np.random.default_rng(nk).standard_normal((4, 5, 97)).astype(
        np.float32) + np.linspace(0, 3, 97, dtype=np.float32)
    close(tdetrend.detrend(T_(Y), nk, method),
          jdetrend.detrend(jnp.asarray(Y), nk, method), 1e-5, 1e-5)
    fn_t = (tdetrend.detrend_spline if method == "spline"
            else tdetrend.detrend_local_min)
    fn_j = (jdetrend.detrend_spline if method == "spline"
            else jdetrend.detrend_local_min)
    for a, b in zip(fn_t(T_(Y), max(nk, 2)), fn_j(jnp.asarray(Y),
                                                  max(nk, 2))):
        close(a, b, 1e-5, 1e-5)


# ------------------------------------------------------------------ #
# ops/filters.py: the temporal bin and the resizes
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("T,H,W,ssub,tsub", [(9, 29, 31, 1, 2),
                                             (10, 30, 32, 2, 3),
                                             (12, 25, 25, 3, 4)])
def test_box_downsample_tsub_matches_jax(T, H, W, ssub, tsub):
    Y = np.random.default_rng(T).standard_normal((T, H, W)).astype(
        np.float32)
    close(tfilters.box_downsample(T_(Y), ssub=ssub, tsub=tsub),
          jfilters.box_downsample(jnp.asarray(Y), ssub=ssub, tsub=tsub))


@pytest.mark.parametrize("ssub,hw", [(1, (12, 10)), (2, (24, 20)),
                                     (2, (25, 21)), (3, (36, 30))])
def test_spatial_upsample_matches_jax(ssub, hw):
    A = np.random.default_rng(ssub).random((3, 12, 10)).astype(np.float32)
    close(tfilters.spatial_upsample(T_(A), ssub, hw),
          jfilters.spatial_upsample(jnp.asarray(A), ssub, hw))


@pytest.mark.parametrize("n_in,n_out", [(100, 200), (120, 241), (7, 7)])
def test_resize_linear_last_matches_jax_image_resize(n_in, n_out):
    C = np.random.default_rng(n_in).standard_normal((5, n_in)).astype(
        np.float32)
    close(tfilters.resize_linear_last(T_(C), n_out),
          jax.image.resize(jnp.asarray(C), (5, n_out), method="linear"))


# ------------------------------------------------------------------ #
# models/qc.py
# ------------------------------------------------------------------ #
def test_apply_keep_matches_jax():
    rng = np.random.default_rng(2)
    K, H, W, T = 6, 5, 4, 9
    d = {"A": rng.random((K, H, W)).astype(np.float32),
         "C": rng.random((K, T)).astype(np.float32),
         "C_raw": rng.random((K, T)).astype(np.float32),
         "S": rng.random((K, T)).astype(np.float32),
         "active": np.array([1, 1, 0, 1, 1, 0], bool),
         "g": np.full((K, 1), 0.9, np.float32),
         "neuron_sn": rng.random(K).astype(np.float32),
         "b0": np.zeros((H, W), np.float32),
         "tags": np.zeros(K, np.int32)}
    keep = np.array([1, 0, 0, 1, 0, 1], bool)
    got = state_to_numpy(tqc._apply_keep(state_from_numpy(d, device="cpu"),
                                         torch.as_tensor(keep)))
    want = jqc._apply_keep(_jax_state(d), jnp.asarray(keep))
    for k in ("A", "C", "C_raw", "S", "active"):
        same(got[k], getattr(want, k))
