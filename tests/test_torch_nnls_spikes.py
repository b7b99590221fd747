"""Batched NNLS, event detection and temporal decorrelation in the
PyTorch port (``cnmf_e_tpu_torch/ops/{nnls,spikes}.py`` and the
``decorrelate`` branch of ``models/temporal.py``) vs the JAX package, on
the same seeded numpy inputs.

Tolerances: ``nnls_fista`` and ``nnls_pixels`` within 1e-5 of the
solution's scale (the same float32 FISTA steps, rounded in another
order); ``event_detection`` exactly equal (a comparison of equal
inputs); ``decorr_temporal`` within 1e-5 of each trace's scale (a
float32 convolution of 500 taps); ``update_temporal`` with
``decorrelate`` within 1e-4 of each trace's scale for AR(1) (the
tolerance of ``tests/test_torch_ops.py::test_update_temporal_matches_jax``)
and 2e-3 for AR(2), whose estimated g carries the JAX package's float32
error (``tests/test_torch_ar2.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import CNMFEParams, InitParams, TemporalParams
from cnmf_e_tpu.models import state as jstate
from cnmf_e_tpu.models import temporal as jtemporal
from cnmf_e_tpu.ops import nnls as jnnls
from cnmf_e_tpu.ops import spikes as jspikes
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import temporal as ttemporal
from cnmf_e_tpu_torch.ops import nnls, spikes

torch.set_num_threads(1)


def _rel(a_t, a_j, tol):
    a_t, a_j = np.asarray(a_t), np.asarray(a_j)
    assert np.abs(a_t - a_j).max() <= tol * max(np.abs(a_j).max(), 1e-6)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("shared", [False, True])
def test_nnls_fista(warm, shared):
    rng = np.random.default_rng(0)
    M = rng.standard_normal((6, 12, 12))
    G = (M @ M.transpose(0, 2, 1) + 0.5 * np.eye(12)).astype(np.float32)
    if shared:
        G = G[0]
    b = rng.standard_normal((6, 12)).astype(np.float32)
    x0 = None
    if warm:
        x0 = np.abs(rng.standard_normal((6, 12))).astype(np.float32)
        x0[2] = 0.0                      # an all-zero warm start
    x_t = nnls.nnls_fista(torch.tensor(G), torch.tensor(b),
                          None if x0 is None else torch.tensor(x0),
                          n_iter=80)
    x_j = jnnls.nnls_fista(jnp.asarray(G), jnp.asarray(b),
                           None if x0 is None else jnp.asarray(x0),
                           n_iter=80)
    assert (x_t >= 0).all()
    _rel(x_t, x_j, 1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_nnls_pixels(masked):
    rng = np.random.default_rng(1)
    C = np.abs(rng.standard_normal((5, 200))).astype(np.float32)
    A = np.abs(rng.standard_normal((40, 5))).astype(np.float32)
    Y = (A @ C + 0.1 * rng.standard_normal((40, 200))).astype(np.float32)
    mask = rng.random((40, 5)) < 0.6 if masked else None
    A0 = np.abs(rng.standard_normal((40, 5))).astype(np.float32)
    x_t = nnls.nnls_pixels(torch.tensor(C), torch.tensor(Y),
                           A0=torch.tensor(A0),
                           mask=None if mask is None else torch.tensor(mask),
                           n_iter=60)
    x_j = jnnls.nnls_pixels(jnp.asarray(C), jnp.asarray(Y),
                            A0=jnp.asarray(A0),
                            mask=None if mask is None else jnp.asarray(mask),
                            n_iter=60)
    _rel(x_t, x_j, 1e-5)
    if masked:
        assert (x_t.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("window", [1, 4, 10])
def test_event_detection(window):
    rng = np.random.default_rng(2)
    C = np.cumsum(rng.standard_normal((7, 300)), axis=1).astype(np.float32)
    sn = rng.uniform(0.1, 1.0, 7).astype(np.float32)
    E_t = spikes.event_detection(torch.tensor(C), torch.tensor(sn),
                                 sig=2.0, window=window)
    E_j = jspikes.event_detection(jnp.asarray(C), jnp.asarray(sn), sig=2.0,
                                  window=window)
    np.testing.assert_array_equal(E_t.numpy(), np.asarray(E_j))


def _neurons(seed=4, K=6, H=24, W=24, T=300, p=2):
    rng = np.random.default_rng(seed)
    A = np.zeros((K, H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    # pairs of neighbours, so some spikes are dominated
    centres = [(5, 5), (7, 8), (15, 6), (16, 17), (6, 18), (18, 10)][:K]
    for k, (cy, cx) in enumerate(centres):
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 8.0)
    S = ((rng.random((K, T)) < 0.05) * rng.uniform(0.5, 2.0, (K, T))
         ).astype(np.float32)
    S[1, S[0] > 0] = 0.7 * S[0, S[0] > 0]          # crosstalk copies
    g = np.tile(np.array([[1.35, -0.42]] if p == 2 else [[0.9]],
                         np.float32), (K, 1))
    sn = np.full(K, 0.1, np.float32)
    C = rng.random((K, T)).astype(np.float32)
    return A, S, C, g, sn


@pytest.mark.parametrize("p,wd", [(1, 1), (2, 1), (2, 3)])
def test_decorr_temporal(p, wd):
    A, S, C, g, sn = _neurons(p=p)
    out_t = spikes.decorr_temporal(*map(torch.tensor, (C, S, A, g, sn)),
                                   gSiz=6.0, wd=wd)
    out_j = jspikes.decorr_temporal(*map(jnp.asarray, (C, S, A, g, sn)),
                                    gSiz=6.0, wd=wd)
    scale = np.abs(np.asarray(out_j)).max(-1, keepdims=True)
    assert (np.abs(out_t.numpy() - np.asarray(out_j)) <= 1e-5 * scale
            + 1e-7).all()
    # the crosstalk copies of neuron 0 in neuron 1 are gone
    h = np.asarray(jspikes.ar_kernel(jnp.asarray(g[1:2]), 300))[0]
    full = np.convolve(S[1], h)[:300]
    assert np.abs(out_t.numpy()[1]).sum() < np.abs(full).sum()


@pytest.mark.parametrize("model", ["ar1", "ar2"])
def test_update_temporal_with_decorrelate(model):
    gt = simulate_movie(seed=5, H=32, W=32, T=300, K=6, gSig=2.0, sn=0.05,
                        bg_strength=0.0, min_dist=6.0, spike_rate=0.05)
    K, Kmax = gt.A.shape[0], 8
    H, W = gt.A.shape[1:]
    T = gt.C.shape[1]
    p = 2 if model == "ar2" else 1
    rng = np.random.default_rng(6)
    d = {"A": np.zeros((Kmax, H, W), np.float32),
         "C": np.zeros((Kmax, T), np.float32),
         "C_raw": np.zeros((Kmax, T), np.float32),
         "S": np.zeros((Kmax, T), np.float32),
         "active": np.zeros(Kmax, bool),
         "g": np.full((Kmax, p), 0.9 if p == 1 else 0.0, np.float32),
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
            params.temporal.deconv, model=model, method="constrained")))
    st_j = jtemporal.update_temporal(
        jnp.asarray(gt.Y), jstate.CNMFEState(
            **{k: jnp.asarray(v) for k, v in d.items()}), params)
    st_t = ttemporal.update_temporal(
        torch.tensor(gt.Y), state_from_numpy(d, device="cpu"),
        params_from_dict(dataclasses.asdict(params)))
    # AR(2): the estimated g carries the JAX package's float32 error
    # (tests/test_torch_ar2.py), ~1e-4, into the traces
    tol, atol = (1e-4, 1e-5) if p == 1 else (2e-3, 2e-3)
    for k in ("C", "C_raw", "S"):
        a_j = np.asarray(getattr(st_j, k))
        a_t = getattr(st_t, k).numpy()
        scale = np.maximum(np.abs(a_j).max(-1, keepdims=True), 1e-6)
        assert (np.abs(a_t - a_j) / scale).max() <= tol, k
    np.testing.assert_allclose(st_t.g.numpy(), np.asarray(st_j.g),
                               atol=atol)
