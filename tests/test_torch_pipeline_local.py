"""``CNMFE.fit`` with the local background and the ellipse search in the
PyTorch port vs the JAX package, at ``test_torch_pipeline.py``'s size.

Both packages fit the same simulated 48x48x300 1p movie on the CPU with
``background.model="local"``, ``spatial.search_method="ellipse"`` or both:
the same number of neurons, footprints and traces matched slot by slot
with correlation >= 0.99, the same F1 against ground truth, the
background within 1e-3 (relative and absolute). ``fit_batches`` with the
local background against the JAX package's, and ``fit_streaming`` with
both options equal to its own default run: the streamed fit reads
neither option, as in the JAX package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.io.store import MovieStore as JaxStore
from cnmf_e_tpu.models import batch as jax_batch
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu.utils.simulate import simulate_movie, simulate_movie_store
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.io.store import MovieStore
from cnmf_e_tpu_torch.models import batch, streaming
from cnmf_e_tpu_torch.models.pipeline import CNMFE

torch.set_num_threads(1)

OPTIONS = {
    "local": dict(model="local"),
    "ellipse": dict(search_method="ellipse"),
    "local_ellipse": dict(model="local", search_method="ellipse"),
}


def _params(model="ring", search_method="dilate", max_neurons=24):
    p = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=max_neurons, seeds_per_round=16,
                        max_rounds=6),
        background=BackgroundParams(model=model, ring_radius=9, ssub=2),
        merge=MergeParams(dmin=4.0))
    return p.replace(spatial=dataclasses.replace(
        p.spatial, search_method=search_method))


def _assert_same_fit(port, ref):
    n = int(port.n_active())
    assert n == int(ref.n_active()) > 0
    A_t = port.A[:n].numpy().reshape(n, -1)
    A_j = np.asarray(ref.A)[:n].reshape(n, -1)
    C_t, C_j = port.C[:n].numpy(), np.asarray(ref.C)[:n]
    for k in range(n):
        assert np.corrcoef(A_t[k], A_j[k])[0, 1] >= 0.99, k
        assert np.corrcoef(C_t[k], C_j[k])[0, 1] >= 0.99, k


@pytest.fixture(scope="module")
def movie():
    return simulate_movie(seed=11, H=48, W=48, T=300, K=6, gSig=2.5, sn=0.08,
                          bg_strength=0.8, min_dist=12.0, spike_rate=0.04)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_fit_matches_jax(movie, option):
    params = _params(**OPTIONS[option])
    port = CNMFE(params_from_dict(dataclasses.asdict(params)), device="cpu")
    port.fit(movie.Y, n_outer=2)
    ref = JaxCNMFE(params)
    ref.fit(jnp.asarray(movie.Y), n_outer=2)
    _assert_same_fit(port.state, ref.state)
    n = int(port.state.n_active())
    f_t = detection_f1(port.state.A[:n].numpy(), movie.A)
    f_j = detection_f1(np.asarray(ref.state.A)[:n], movie.A)
    assert f_t["f1"] == f_j["f1"] >= 0.8
    np.testing.assert_allclose(port.background(movie.Y).numpy(),
                               np.asarray(ref.background(movie.Y)),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(port.state.tags.numpy(),
                                  np.asarray(ref.state.tags))


def test_fit_batches_local_matches_jax():
    gt = simulate_movie(seed=21, H=48, W=48, T=600, K=7, gSig=2.5, sn=0.08,
                        bg_strength=0.7, min_dist=12.0, spike_rate=0.04)
    params = _params(model="local", max_neurons=16)
    batches = [gt.Y[:300], gt.Y[300:]]
    ref, ref_b = jax_batch.fit_batches(batches, params)
    port, port_b = batch.fit_batches(
        batches, params_from_dict(dataclasses.asdict(params)), device="cpu")
    np.testing.assert_array_equal(port.active.numpy(), np.asarray(ref.active))
    assert [int(s.n_active()) for s in port_b] == \
        [int(s.n_active()) for s in ref_b]
    for k in np.nonzero(np.asarray(ref.active))[0]:
        assert np.corrcoef(port.A[k].numpy().ravel(),
                           np.asarray(ref.A[k]).ravel())[0, 1] >= 0.99, k
        assert np.corrcoef(port.C[k].numpy(),
                           np.asarray(ref.C[k]))[0, 1] >= 0.99, k
    # each batch's own local background
    np.testing.assert_allclose(port_b[-1].b0.numpy(),
                               np.asarray(ref_b[-1].b0), rtol=1e-3,
                               atol=1e-3)


def test_fit_streaming_reads_neither_option(tmp_path):
    simulate_movie_store(str(tmp_path / "s"), seed=3, H=48, W=48, T=600,
                         K=7, gSig=2.5, sn=0.06, bg_strength=0.6,
                         min_dist=12.0, spike_rate=0.04,
                         frames_per_block=200)
    kw = dict(n_outer=1, init_budget_frames=300)
    store = MovieStore(str(tmp_path / "s"))
    base = _params(max_neurons=16)
    default = streaming.fit_streaming(
        store, params_from_dict(dataclasses.asdict(base)), device="cpu", **kw)
    both = streaming.fit_streaming(
        store, params_from_dict(dataclasses.asdict(
            _params(model="local", search_method="ellipse", max_neurons=16))),
        device="cpu", **kw)
    assert int(default.n_active()) > 0
    for name in ("A", "C", "C_raw", "S", "active", "b0"):
        assert torch.equal(getattr(both, name), getattr(default, name)), name
    assert torch.equal(both.W.w, default.W.w)
    # and the JAX package's streamed fit reads neither option either
    jstore = JaxStore(str(tmp_path / "s"))
    from cnmf_e_tpu.models import streaming as jax_streaming
    j_default = jax_streaming.fit_streaming(jstore, base, **kw)
    j_both = jax_streaming.fit_streaming(
        jstore, _params(model="local", search_method="ellipse",
                        max_neurons=16), **kw)
    np.testing.assert_array_equal(np.asarray(j_both.A),
                                  np.asarray(j_default.A))
