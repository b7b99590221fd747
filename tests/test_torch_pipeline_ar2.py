"""BASELINE config 4 in the PyTorch port: ``CNMFE.fit`` with
``preset_2p("ar2_constrained")`` and ``preset_2p("ar2_thresholded")``
against the JAX package on the same 48x48x400 AR(2) movie
(``tests/test_ar2_pipeline.py::_ar2_movie``), both on the CPU.

Both fits must find the same number of neurons, footprints and traces
matched at correlation >= 0.99 and g within 2e-3 (the port's AR(2) fit is
the float64 one, ``tests/test_torch_ar2.py``), carry g of width 2 with
some |g2| > 1e-4, and reach recall >= 0.75. The constrained fit must hold
the per-trace RSS budget of ``tests/test_ar2_pipeline.py:47-113`` on the
matched neurons.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import CNMFEParams, InitParams
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu_torch.config import DeconvParams
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.ops.oasis import deconvolve
from tests.test_ar2_pipeline import _ar2_movie

torch.set_num_threads(1)


def _params(preset):
    p = CNMFEParams.preset_2p(preset)
    return p.replace(init=InitParams(
        gSig=2.5, gSiz=8, center_psf=False, min_corr=0.8, min_pnr=8.0,
        max_neurons=24, seeds_per_round=8, max_rounds=6))


@pytest.fixture(scope="module")
def movie():
    return _ar2_movie(H=48, W=48, T=400, K=6)


@pytest.fixture(scope="module")
def fits(movie):
    """Each preset's (port state, JAX state), fitted once."""
    done = {}

    def get(preset):
        if preset not in done:
            p = _params(preset)
            port = CNMFE(params_from_dict(dataclasses.asdict(p)),
                         device="cpu")
            port.fit(movie[0], n_outer=1)
            ref = JaxCNMFE(p)
            ref.fit(jnp.asarray(movie[0]), n_outer=1)
            done[preset] = (port.state, ref.state)
        return done[preset]
    return get


@pytest.mark.parametrize("preset", ["ar2_constrained", "ar2_thresholded"])
def test_ar2_fit_matches_jax(fits, movie, preset):
    st, sj = fits(preset)
    n = int(st.n_active())
    assert n == int(sj.n_active()) >= 6, preset
    assert st.g.shape[1] == 2 == sj.g.shape[1]
    g = st.g[:n].numpy()
    assert np.any(np.abs(g[:, 1]) > 1e-4), g
    np.testing.assert_allclose(g, np.asarray(sj.g)[:n], atol=2e-3)
    A_t = st.A[:n].numpy().reshape(n, -1)
    A_j = np.asarray(sj.A)[:n].reshape(n, -1)
    for k in range(n):
        assert np.corrcoef(A_t[k], A_j[k])[0, 1] >= 0.99, k
        assert np.corrcoef(st.C[k].numpy(),
                           np.asarray(sj.C)[k])[0, 1] >= 0.99, k
    f1 = detection_f1(A_t.reshape(n, 48, 48), movie[1])
    assert f1["recall"] >= 0.75, f1


def test_ar2_constrained_fit_holds_the_rss_budget(fits, movie):
    """tests/test_ar2_pipeline.py's budget: ||C_raw - C||^2 lands within
    (0.3, 1.3) sn^2 T on the matched neurons, except where even the
    lambda = 0 AR(2) fit exceeds the budget (then the constrained fit sits
    at that floor), at most 3 of them."""
    st, _ = fits("ar2_constrained")
    T = movie[0].shape[0]
    n = int(st.n_active())
    f1 = detection_f1(st.A[:n].numpy(), movie[1])
    C_raw, C = st.C_raw[:n], st.C[:n]
    sn = st.neuron_sn[:n]
    rss = ((C_raw - C) ** 2).sum(-1).numpy()
    budget = (sn ** 2 * T).numpy()
    ratio = rss / np.maximum(budget, 1e-12)
    res0 = deconvolve(C_raw, DeconvParams(model="ar2", method="foopsi",
                                          lam=0.0, optimize_b=False), sn=sn)
    rss0 = ((C_raw - res0.c) ** 2).sum(-1).numpy()
    matched = [i for i, _ in f1["matches"]]
    assert len(matched) >= 6
    on_budget = 0
    for k in matched:
        if 0.3 < ratio[k] < 1.3:
            on_budget += 1
        else:
            assert rss0[k] >= budget[k], (k, rss0[k], budget[k])
            assert rss[k] <= rss0[k] * 1.10 + 1e-6, (k, rss[k], rss0[k])
    assert on_budget >= len(matched) - 3, (ratio, rss0, budget)
