"""The whole ``CNMFE.fit`` with a low-rank background in the PyTorch port
vs the JAX package.

``tests/test_pipeline.py::test_full_pipeline_2p_svd_background``'s
configuration (48x48x500, 8 neurons, a rank-3 svd background) fit by both
packages on the CPU: the same number of neurons, footprints and traces
matched with correlation >= 0.99, recall >= 0.75 against ground truth.
The port's randomized SVD starts from its own draw, so the two
backgrounds agree only as far as both reach the truncated SVD. One nmf
fit must run and stay finite.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.checkpoint import restore_state as jax_restore_state
from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.io.export import save_results as jax_save_results
from cnmf_e_tpu.models.pipeline import CNMFE as JaxCNMFE
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.checkpoint import restore_state
from cnmf_e_tpu_torch.convert import (params_from_dict, state_from_numpy,
                                      state_to_numpy)
from cnmf_e_tpu_torch.io.export import save_results
from cnmf_e_tpu_torch.models.pipeline import CNMFE

torch.set_num_threads(1)


def _params(model="svd"):
    return CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=30, seeds_per_round=16, max_rounds=5),
        background=BackgroundParams(model=model, rank=3),
        merge=MergeParams(dmin=4.0))


def _movie():
    return simulate_movie(seed=13, H=48, W=48, T=500, K=8, gSig=2.5,
                          sn=0.06, bg_strength=0.5, min_dist=11.0,
                          spike_rate=0.04)


@pytest.fixture(scope="module")
def fits():
    gt = _movie()
    params = _params()
    port = CNMFE(params_from_dict(dataclasses.asdict(params)), device="cpu")
    port.fit(gt.Y, n_outer=1)
    ref = JaxCNMFE(params)
    ref.fit(jnp.asarray(gt.Y), n_outer=1)
    return gt, port, ref


def test_2p_fit_same_neuron_count(fits):
    _, port, ref = fits
    n = int(port.state.n_active())
    assert n == int(ref.state.n_active()) > 0
    assert port.state.b.shape == (3, 48, 48)
    assert port.state.f.shape == (3, 500)
    assert port.state.W is None


def test_2p_fit_footprints_and_traces_match(fits):
    _, port, ref = fits
    n = int(port.state.n_active())
    A_t = port.state.A[:n].numpy().reshape(n, -1)
    C_t = port.state.C[:n].numpy()
    A_j = np.asarray(ref.state.A)[:n].reshape(n, -1)
    C_j = np.asarray(ref.state.C)[:n]
    for k in range(n):
        assert np.corrcoef(A_t[k], A_j[k])[0, 1] >= 0.99, k
        assert np.corrcoef(C_t[k], C_j[k])[0, 1] >= 0.99, k


def test_2p_fit_recall_and_background(fits):
    gt, port, ref = fits
    n = int(port.state.n_active())
    f_t = detection_f1(port.state.A[:n].numpy(), gt.A)
    f_j = detection_f1(np.asarray(ref.state.A)[:n], gt.A)
    assert f_t["recall"] >= 0.75, f_t
    assert f_t["f1"] == f_j["f1"]
    B_t = port.background(gt.Y).numpy()
    B_j = np.asarray(ref.background(gt.Y))
    assert np.linalg.norm(B_t - B_j) <= 1e-3 * np.linalg.norm(B_j)


def test_2p_nmf_fit_runs_and_is_finite():
    gt = _movie()
    params = params_from_dict(dataclasses.asdict(_params("nmf")))
    model = CNMFE(params, device="cpu")
    st = model.fit(gt.Y[:300], n_outer=1)
    assert int(st.n_active()) > 0
    for k in ("A", "C", "C_raw", "S", "b", "f", "b0"):
        assert bool(torch.isfinite(getattr(st, k)).all()), k
    assert bool((st.b >= 0).all() and (st.f >= 0).all())


def test_2p_state_crosses_packages(fits, tmp_path):
    """The JAX svd state through state_from_numpy / state_to_numpy, and
    through a results.npz written by either package and restored by the
    other: b, f and b0 arrive unchanged."""
    _, port, ref = fits
    js = ref.state
    d = {k: np.asarray(getattr(js, k)) for k in
         ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0", "active", "tags",
          "b", "f")}
    st = state_from_numpy(d, device="cpu")
    back = state_to_numpy(st)
    np.testing.assert_array_equal(back["bg_b"], d["b"])
    np.testing.assert_array_equal(back["bg_f"], d["f"])
    assert state_to_numpy(state_from_numpy(back, device="cpu")).keys() \
        == back.keys()

    K, (H, W), T = js.K_max, js.A.shape[1:], js.C.shape[1]
    jax_save_results(str(tmp_path / "jax"), js)
    ours = restore_state(str(tmp_path / "jax.npz"), K, H, W, T,
                         device="cpu")
    np.testing.assert_array_equal(ours.b.numpy(), d["b"])
    np.testing.assert_array_equal(ours.f.numpy(), d["f"])
    np.testing.assert_array_equal(ours.b0.numpy(), d["b0"])

    save_results(str(tmp_path / "port"), port.state)
    theirs = jax_restore_state(str(tmp_path / "port.npz"), K, H, W, T)
    np.testing.assert_array_equal(np.asarray(theirs.b),
                                  port.state.b.numpy())
    np.testing.assert_array_equal(np.asarray(theirs.f),
                                  port.state.f.numpy())
