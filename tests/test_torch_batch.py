"""``fit_batches`` of the PyTorch port against the JAX package's.

Both packages fit the same simulated 48x48x900 movie in three batches of
300 frames on the CPU: the first batch runs the full pipeline, the later
ones inherit its footprints, fit their own background and traces and pick
neurons from their residual; the traces concatenate. The same neurons,
footprints and traces matched with correlation >= 0.99, equal tags, the
same per-batch neuron counts.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.models import batch as jax_batch
from cnmf_e_tpu.models.state import empty_state as jax_empty_state
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.models import batch
from cnmf_e_tpu_torch.models.state import empty_state

torch.set_num_threads(1)


def _params():
    return CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=4),
        background=BackgroundParams(model="ring", ring_radius=9),
        merge=MergeParams(dmin=4.0))


@pytest.fixture(scope="module")
def fits():
    gt = simulate_movie(seed=21, H=48, W=48, T=900, K=7, gSig=2.5, sn=0.08,
                        bg_strength=0.7, min_dist=12.0, spike_rate=0.04)
    batches = [gt.Y[:300], gt.Y[300:600], gt.Y[600:]]
    ref = jax_batch.fit_batches(batches, _params())
    port = batch.fit_batches(
        batches, params_from_dict(dataclasses.asdict(_params())),
        device="cpu")
    return gt, ref, port


def test_fit_batches_same_neurons_and_batches(fits):
    _, (ref, ref_b), (port, port_b) = fits
    np.testing.assert_array_equal(port.active.numpy(),
                                  np.asarray(ref.active))
    assert int(port.n_active()) > 0
    assert [int(s.n_active()) for s in port_b] == \
        [int(s.n_active()) for s in ref_b]
    assert port.C.shape == (16, 900) and port.S.shape == (16, 900)


def test_fit_batches_footprints_traces_and_tags_match(fits):
    _, (ref, _), (port, _) = fits
    idx = np.nonzero(np.asarray(ref.active))[0]
    for k in idx:
        a_t, a_j = port.A[k].numpy().ravel(), np.asarray(ref.A[k]).ravel()
        assert np.corrcoef(a_t, a_j)[0, 1] >= 0.99, k
        for key in ("C", "C_raw"):
            c_t = getattr(port, key)[k].numpy()
            c_j = np.asarray(getattr(ref, key)[k])
            assert np.corrcoef(c_t, c_j)[0, 1] >= 0.99, (key, k)
    np.testing.assert_array_equal(port.tags.numpy(), np.asarray(ref.tags))


def test_union_new_neurons_matches_the_jax_package():
    """Slots active in the batch state and not in the global one are
    copied in (A, g, neuron_sn, active); nothing else moves."""
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    K, H, W = 6, 5, 4
    g_act = np.array([1, 1, 0, 0, 0, 0], bool)
    b_act = np.array([1, 1, 1, 0, 1, 0], bool)
    A_g, A_b = (rng.random((K, H, W)).astype(np.float32) for _ in range(2))
    g_b = rng.random((K, 1)).astype(np.float32)
    sn_b = rng.random(K).astype(np.float32)

    def port_state(A, act, g=None, sn=None):
        st = empty_state(K, H, W, 3, device="cpu")
        return st.replace(A=torch.as_tensor(A), active=torch.as_tensor(act),
                          g=st.g if g is None else torch.as_tensor(g),
                          neuron_sn=st.neuron_sn if sn is None
                          else torch.as_tensor(sn))

    def jax_state(A, act, g=None, sn=None):
        st = jax_empty_state(K, H, W, 3)
        return st.replace(A=jnp.asarray(A), active=jnp.asarray(act),
                          g=st.g if g is None else jnp.asarray(g),
                          neuron_sn=st.neuron_sn if sn is None
                          else jnp.asarray(sn))
    ours, new = batch._union_new_neurons(port_state(A_g, g_act),
                                         port_state(A_b, b_act, g_b, sn_b))
    theirs, new_j = jax_batch._union_new_neurons(
        jax_state(A_g, g_act), jax_state(A_b, b_act, g_b, sn_b))
    np.testing.assert_array_equal(new, new_j)
    for k in ("A", "g", "neuron_sn", "active"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      np.asarray(getattr(theirs, k)),
                                      err_msg=k)


def test_fit_batches_needs_a_batch():
    with pytest.raises(ValueError, match="no batches"):
        batch.fit_batches([], device="cpu")
