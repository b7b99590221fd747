"""The spatial algorithms ``hals_thresh``, ``nnls`` and ``lars`` of the
PyTorch port's ``update_spatial`` (``cnmf_e_tpu_torch/models/spatial.py``)
vs the JAX package's, on the same seeded numpy movie and state (the
fixture of ``tests/test_torch_ops.py``), with the stored pixel noise and
with the residual-std fallback.

Tolerances: ``hals_thresh`` and ``nnls`` footprints within 1e-4 (the
tolerance of ``tests/test_torch_ops.py::test_update_spatial_matches_jax``;
a pixel of the 3-sigma gate within rounding of its threshold may fall
either way, so at most 0.5% of the support may differ); ``lars``
footprints matched at correlation >= 0.999 per neuron (its per-pixel
lambda bisection may branch either way where a pixel's RSS lies within
float32 rounding of the budget, ``tests/test_torch_cnmf2p.py``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import BackgroundParams, CNMFEParams, InitParams
from cnmf_e_tpu.models import spatial as jspatial
from cnmf_e_tpu.models import state as jstate
from cnmf_e_tpu.ops.noise import noise_psd_frames
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import spatial as tspatial

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def problem():
    sim = simulate_movie(seed=3, H=29, W=31, T=160, K=5, gSig=2.0,
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
    sn = np.asarray(noise_psd_frames(jnp.asarray(sim.Y)))
    return sim.Y, d, sn


@pytest.mark.parametrize("with_sn", [True, False])
@pytest.mark.parametrize("algorithm", ["hals_thresh", "nnls", "lars"])
def test_spatial_algorithm_matches_jax(problem, algorithm, with_sn):
    Y, d, sn = problem
    p = CNMFEParams(init=InitParams(gSig=2.0, gSiz=7),
                    background=BackgroundParams(model="svd"))
    p = p.replace(spatial=dataclasses.replace(p.spatial,
                                              algorithm=algorithm))
    st_j = jspatial.update_spatial(
        jnp.asarray(Y), jstate.CNMFEState(
            **{k: jnp.asarray(v) for k, v in d.items()}), p,
        sn_pix=jnp.asarray(sn) if with_sn else None)
    st_t = tspatial.update_spatial(
        torch.tensor(Y), state_from_numpy(d, device="cpu"),
        params_from_dict(dataclasses.asdict(p)),
        sn_pix=torch.tensor(sn) if with_sn else None)
    A_t, A_j = st_t.A.numpy(), np.asarray(st_j.A)
    assert (A_t[~d["active"]] == 0).all()
    act = np.nonzero(d["active"])[0]
    if algorithm == "lars":
        for k in act:
            assert np.corrcoef(A_t[k].ravel(), A_j[k].ravel())[0, 1] \
                >= 0.999, k
        return
    off = np.abs(A_t - A_j) > 1e-4 * (1 + np.abs(A_j))
    assert off.sum() <= 0.005 * max((A_j > 0).sum(), 1), off.sum()
    assert ((A_t > 0) != (A_j > 0)).sum() <= 0.005 * (A_j > 0).sum()
