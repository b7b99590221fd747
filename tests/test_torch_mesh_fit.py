"""The in-memory fit of the port on a 4 x 2 mesh of gloo ranks against the
JAX package.

``tests/test_sharding.py:93-207``'s cases, held to the JAX package's
single-device run and to the port's one-process run at that file's
tolerances: the ring fit of a sharded residual (w atol 1e-3),
``initialize_greedy`` and the whole ``CNMFE.fit(n_outer=1)`` on
``_mini_movie()`` (equal n_active, footprint IoU >= 0.99, every trace's
correlation >= 0.999; the JAX package marks its fit case ``slow``, the
port's runs here), and ``update_background`` from the JAX init's state
(b0 rtol/atol 1e-3, w 2e-3), and the svd, nmf and local models'
``update_background`` and ``background_of`` from the same state (ROADMAP
§C (u)'s and ``tests/test_torch_lowrank.py``'s bars). Every rank must
return the same active mask.
One spawn of 4 x 2 CPU ranks (``cnmf_e_tpu_torch.parallel.launch.spawn``,
rank bodies in ``cnmf_e_tpu_torch/parallel/_selftest.py``) runs every
case: a 120 s deadline, and a 60 s timeout on every collective.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.models.background import background_of as jax_bg_of
from cnmf_e_tpu.models.background import update_background as jax_bg
from cnmf_e_tpu.models.initialize import initialize_greedy as jax_init
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.ops.ring import fit_ring_weights as jax_fit_ring_weights
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import background as tbg
from cnmf_e_tpu_torch.models.initialize import initialize_greedy
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.ops.ring import fit_ring_weights
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

N_PATCH, N_FRAME = 4, 2
RING = dict(H=32, W=32, T=64, radius=4)      # test_ring_fit_compiles_under_mesh
BG_MODELS = ("svd", "nmf", "local")


def _mini_params():
    """``tests/test_sharding.py::_mini_params``."""
    return CNMFEParams(
        init=InitParams(gSig=2.0, gSiz=6, min_corr=0.7, min_pnr=6.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=3),
        background=BackgroundParams(model="ring", ring_radius=6),
        merge=MergeParams(dmin=4.0))


def _bg_params(model):
    """The mini params with another background model (rank 3 for the
    low-rank ones)."""
    p = _mini_params()
    return p.replace(background=dataclasses.replace(p.background,
                                                    model=model, rank=3))


def _mini_movie():
    """``tests/test_sharding.py::_mini_movie``."""
    return simulate_movie(seed=11, H=32, W=32, T=256, K=5, gSig=2.0,
                          sn=0.06, bg_strength=0.5, min_dist=9.0,
                          spike_rate=0.05)


def _ring_residual():
    rng = np.random.default_rng(0)
    return rng.standard_normal((RING["T"], RING["H"], RING["W"])).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_init_state():
    st, _ = jax_init(jnp.asarray(_mini_movie().Y), _mini_params())
    return st


def _state_dict(st) -> dict:
    """The JAX state's fields under the port's names (numpy)."""
    return dict(A=np.asarray(st.A), C=np.asarray(st.C),
                C_raw=np.asarray(st.C_raw), S=np.asarray(st.S),
                g=np.asarray(st.g), neuron_sn=np.asarray(st.neuron_sn),
                b0=np.asarray(st.b0), active=np.asarray(st.active))


@pytest.fixture(scope="module")
def ranks():
    gt = _mini_movie()
    params = _mini_params()
    pd = dataclasses.asdict(params)
    d0 = _state_dict(_jax_init_state())
    jobs = [("ring", "ring_fit_case", (_ring_residual(), RING["H"],
                                       RING["W"], RING["radius"])),
            ("init", "init_case", (gt.Y, pd)),
            ("background", "background_case", (gt.Y, d0, pd)),
            ("fit", "fit_case", (gt.Y, pd, 1))]
    jobs += [(f"bg_{m}", "bg_model_case",
              (gt.Y, d0, dataclasses.asdict(_bg_params(m)), None))
             for m in BG_MODELS]
    return spawn(_selftest.cases, N_PATCH, N_FRAME, device="cpu",
                 args=(jobs,), timeout=180, pg_timeout=60)


def _active(A, C, act):
    n = int(act.sum())
    return n, (A * act[:, None, None])[:n], C[:n]


def _same_neurons(got, want):
    """Equal n_active, footprint IoU >= 0.99, every trace's correlation
    >= 0.999 (``tests/test_sharding.py``'s bars)."""
    (n1, A1, C1), (nN, AN, CN) = want, got
    assert n1 == nN > 0, (n1, nN)
    inter = np.sum((A1 > 0) & (AN > 0))
    union = max(np.sum((A1 > 0) | (AN > 0)), 1)
    assert inter / union >= 0.99, inter / union
    for k in range(n1):
        denom = np.linalg.norm(C1[k]) * np.linalg.norm(CN[k])
        if denom > 0:
            corr = float(C1[k] @ CN[k] / denom)
            assert corr >= 0.999, (k, corr)


@pytest.mark.parametrize("against", ["jax", "port"])
def test_ring_fit_under_mesh(ranks, against):
    """Each rank fits its rows from its slab, a halo of the ring's reach
    and the other frame ranks' frames: w within 1e-3 of the fit of the
    whole residual."""
    Bf = _ring_residual()
    args = (RING["H"], RING["W"], RING["radius"])
    ref = (jax_fit_ring_weights(jnp.asarray(Bf), *args) if against == "jax"
           else fit_ring_weights(torch.tensor(Bf), *args))
    np.testing.assert_allclose(ranks[0]["ring"]["w"], np.asarray(ref.w),
                               atol=1e-3)
    np.testing.assert_allclose(ranks[0]["ring"]["w0"], np.asarray(ref.w0),
                               atol=1e-3)


@pytest.mark.parametrize("against", ["jax", "port"])
def test_initialize_greedy_shard_invariance(ranks, against):
    gt = _mini_movie()
    params = _mini_params()
    got = ranks[0]["init"]["state"]
    if against == "jax":
        st = _jax_init_state()
        want = _active(np.asarray(st.A), np.asarray(st.C),
                       np.asarray(st.active))
    else:
        st, _ = initialize_greedy(torch.tensor(gt.Y),
                                  params_from_dict(dataclasses.asdict(params)))
        want = _active(st.A.numpy(), st.C.numpy(), st.active.numpy())
    _same_neurons(_active(got["A"], got["C"], got["active"]), want)
    assert ranks[0]["init"]["n_found"] == want[0]


def test_update_background_shard_invariance(ranks):
    """The ring refit on the mesh from the JAX init's state equals the JAX
    package's single-device refit (b0 1e-3, w 2e-3)."""
    gt = _mini_movie()
    params = _mini_params()
    st = _jax_init_state()
    ref = jax_bg(jnp.asarray(gt.Y), st, params)
    got = ranks[0]["background"]
    np.testing.assert_allclose(got["b0"], np.asarray(ref.b0), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got["w"], np.asarray(ref.W.w), rtol=2e-3,
                               atol=2e-3)


def _rel(B, ref, b0):
    """||B - ref|| over the norm of ref's part above b0."""
    return float(np.linalg.norm(B - ref)
                 / np.linalg.norm(ref - np.asarray(b0)[None]))


@pytest.mark.parametrize("against", ["jax", "port"])
@pytest.mark.parametrize("model", BG_MODELS)
def test_update_background_models_on_4x2(ranks, model, against):
    """The svd, nmf and local backgrounds refitted on the 4 x 2 mesh
    from the JAX init's state, and their background movie B. b0 within
    1e-4 of its scale (the mean of the residual, or the local model's);
    the local w within 2e-3 and B within 1e-4; the low-rank B (whose b
    and f have free signs) within 1e-3 of the JAX package's and 1e-4 of
    the port's, relative to its part above b0. The NMF's starting draw
    is the port's (``ops/lowrank.py``), so its B is held to the port's
    alone."""
    gt = _mini_movie()
    params = _bg_params(model)
    got = ranks[0][f"bg_{model}"]
    if against == "jax":
        st = jax_bg(jnp.asarray(gt.Y), _jax_init_state(), params)
        B = np.asarray(jax_bg_of(jnp.asarray(gt.Y), st, params))
    else:
        tp = params_from_dict(dataclasses.asdict(params))
        Yt = torch.tensor(gt.Y)
        st = tbg.update_background(Yt, state_from_numpy(
            _state_dict(_jax_init_state()), device="cpu"), tp)
        B = tbg.background_of(Yt, st, tp).numpy()
    b0 = np.asarray(st.b0)
    scale = np.abs(b0).max()
    assert np.abs(got["b0"] - b0).max() <= 1e-4 * scale
    if model == "local":
        w = np.asarray(st.W.w)
        assert np.abs(got["ring_w"] - w).max() <= 2e-3 * np.abs(w).max()
        assert np.abs(got["B"] - B).max() <= 1e-4 * np.abs(B).max()
    elif against == "port":
        assert _rel(got["B"], B, b0) <= 1e-4
    elif model == "svd":
        assert _rel(got["B"], B, b0) <= 1e-3


@pytest.mark.parametrize("against", ["jax", "port"])
def test_full_fit_shard_invariance(ranks, against):
    """``CNMFE(mesh=...).fit(n_outer=1)`` on the 4 x 2 mesh finds the
    neurons of the single-device fit (the reference's parfor/serial
    equivalence, ``update_spatial_parallel.m:218-318``)."""
    gt = _mini_movie()
    params = _mini_params()
    got = ranks[0]["fit"]["state"]
    if against == "jax":
        st = JaxCNMFE(params).fit(gt.Y, n_outer=1)
        want = _active(np.asarray(st.A), np.asarray(st.C),
                       np.asarray(st.active))
    else:
        st = CNMFE(params_from_dict(dataclasses.asdict(params)),
                   device="cpu").fit(gt.Y, n_outer=1)
        want = _active(st.A.numpy(), st.C.numpy(), st.active.numpy())
    _same_neurons(_active(got["A"], got["C"], got["active"]), want)


def test_every_rank_holds_the_same_active_mask(ranks):
    """Each rank's own active mask and n_active after the fit agree: the
    ranks took the same branches and the same decisions; none of them
    sent a pickled state (``comm.broadcast_object``)."""
    first = ranks[0]["fit"]
    assert first["n_active"] == int(first["state"]["active"].sum())
    assert all(r["fit"]["broadcasts"] == 0 for r in ranks)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["fit"]["active"], first["active"])
        assert r["fit"]["n_active"] == first["n_active"]
