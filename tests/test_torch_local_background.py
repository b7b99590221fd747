"""The event-masked local background in the PyTorch port vs the JAX
package: the masked, intercept-free ring fit with the neighbour cutoff,
``local_background`` and the "local" branches of ``update_background`` and
``background_of``. CPU tensors run the ring stencil's plain version.

Tolerances:
- ``fit_ring_weights`` on the JAX oracle test's data (random, well
  conditioned): w and w0 within 1e-5.
- ``local_background``: Yest and b0 within 1e-4 of their scale. w is the
  solution of a ridge system whose ridge is 1e-5 of its trace; on these
  movies the JAX package's own w moves by up to 7.7e-4 of its scale when
  Y moves by one ulp, so w is held within 2e-3 of its scale.
- The data are the JAX tests' own (``tests/test_background.py``): seed 5
  at ssub = 1, seed 6 at ssub = 2. On seed 6 at ssub = 1 one of 320,000
  event tests lies within rounding of its threshold and flips between
  the packages, which moves Yest by 1% of its scale around that sample.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import CNMFEParams
from cnmf_e_tpu.models import background as jbg
from cnmf_e_tpu.models.state import empty_state
from cnmf_e_tpu.ops import ring as jring
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import background as tbg
from cnmf_e_tpu_torch.ops import ring as tring

torch.set_num_threads(1)

FITS = {
    "masked_no_intercept": dict(mask=True, intercept=False),
    "masked_no_intercept_cutoff": dict(mask=True, intercept=False,
                                       neighbor_cutoff=0.8),
    "masked_intercept": dict(mask=True),
    "cutoff_intercept": dict(neighbor_cutoff=0.8),
}


def _oracle_data():
    """tests/test_background.py:91-123's data."""
    rng = np.random.default_rng(0)
    Bf = rng.standard_normal((60, 10, 10)).astype(np.float32)
    mask = rng.random((60, 10, 10)) > 0.3
    return Bf, mask


@pytest.mark.parametrize("case", sorted(FITS))
def test_fit_ring_weights_options_match_jax(case):
    kw = dict(FITS[case])
    Bf, mask = _oracle_data()
    jkw, tkw = dict(kw), dict(kw)
    if kw.pop("mask", False):
        jkw["mask"], tkw["mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    want = jring.fit_ring_weights(jnp.asarray(Bf), 10, 10, 2, **jkw)
    got = tring.fit_ring_weights(torch.as_tensor(Bf), 10, 10, 2, **tkw)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(want.w), atol=1e-5)
    np.testing.assert_allclose(got.w0.numpy(), np.asarray(want.w0),
                               atol=1e-5)
    if not kw.get("intercept", True):
        assert not got.w0.any()


def test_fit_ring_weights_masked_matches_numpy_ridge():
    """The oracle of tests/test_background.py:91-123 for the port: each
    pixel's ridge solved in float64 over its unmasked frames alone."""
    Bf, mask = _oracle_data()
    T, H, W, radius = 60, 10, 10, 2
    got = tring.fit_ring_weights(torch.as_tensor(Bf), H, W, radius,
                                 mask=torch.as_tensor(mask), intercept=False)
    offs = tring.ring_offsets(radius)
    idx, valid = tring._neighbor_index(H, W, offs)
    m = int(np.abs(offs).max())
    Bp = np.pad(Bf, ((0, 0), (m, m), (m, m))).reshape(T, -1)
    for p in range(H * W):
        sel = mask.reshape(T, -1)[:, p]
        X = (Bp[:, idx[p]] * valid[p])[sel].astype(np.float64)
        y = Bf.reshape(T, -1)[sel, p].astype(np.float64)
        G = X.T @ X
        w = np.linalg.solve(G + 1e-5 * np.trace(G) * np.eye(len(G)), X.T @ y)
        np.testing.assert_allclose(got.w[p].numpy()[valid[p]], w[valid[p]],
                                   atol=5e-3, err_msg=str(p))


MOVIES = {
    "seed5_ssub1": (dict(seed=5, H=48, W=48, T=300, K=6, gSig=2.0, sn=0.05,
                         bg_strength=1.5, min_dist=10.0, spike_rate=0.03),
                    1),
    "seed6_ssub2": (dict(seed=6, H=40, W=40, T=200, K=4, gSig=2.0, sn=0.05,
                         bg_strength=1.0, min_dist=10.0), 2),
}


def _close(got, want, rel, what, scale=None):
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


@pytest.mark.parametrize("cutoff", [1.0, 0.8])
@pytest.mark.parametrize("movie", sorted(MOVIES))
def test_local_background_matches_jax(movie, cutoff):
    kw, ssub = MOVIES[movie]
    Y = simulate_movie(**kw).Y
    Yj, wj, bj = jring.local_background(jnp.asarray(Y), radius=8, ssub=ssub,
                                        neighbor_cutoff=cutoff)
    Yt, wt, bt = tring.local_background(torch.as_tensor(Y), radius=8,
                                        ssub=ssub, neighbor_cutoff=cutoff)
    assert Yt.shape == Y.shape
    _close(Yt.numpy(), np.asarray(Yj), 1e-4, "Yest")
    _close(bt.numpy(), np.asarray(bj), 1e-4, "b0")
    _close(wt.w.numpy(), np.asarray(wj.w), 2e-3, "w")
    assert not wt.w0.any()


@pytest.mark.parametrize("ssub", [1, 2])
def test_local_model_update_and_background_match_jax(ssub):
    """update_background on Ybg = Y - A C with the pixel noise given, as
    the pipeline calls it, then background_of from the stored weights."""
    gt = simulate_movie(seed=9, H=32, W=32, T=150, K=3, gSig=2.0, sn=0.05,
                        bg_strength=1.0, min_dist=9.0)
    params = CNMFEParams.preset_1p()
    params = params.replace(background=dataclasses.replace(
        params.background, model="local", ring_radius=7, ssub=ssub))
    K = gt.A.shape[0]
    st = empty_state(K_max=K + 2, H=32, W=32, T=150)
    A = np.zeros((K + 2, 32, 32), np.float32)
    A[:K] = gt.A
    C = np.zeros((K + 2, 150), np.float32)
    C[:K] = gt.C
    active = np.arange(K + 2) < K
    st = st.replace(A=jnp.asarray(A), C=jnp.asarray(C),
                    C_raw=jnp.asarray(C), active=jnp.asarray(active))
    sn = np.full((32, 32), 0.05, np.float32)
    Y = jnp.asarray(gt.Y)
    st_j = jbg.update_background(Y, st, params, sn_pix=jnp.asarray(sn))
    B_j = np.asarray(jbg.background_of(Y, st_j, params))

    tp = params_from_dict(dataclasses.asdict(params))
    st_t = state_from_numpy(dict(
        A=A, C=C, C_raw=C, S=np.zeros_like(C), g=np.full((K + 2, 1), 0.9),
        neuron_sn=np.zeros(K + 2), b0=np.zeros((32, 32)), active=active),
        device="cpu")
    Yt = torch.as_tensor(gt.Y)
    # before any fit the background is the constant b0
    assert torch.equal(tbg.background_of(Yt, st_t, tp),
                       torch.zeros_like(Yt))
    st_t = tbg.update_background(Yt, st_t, tp, sn_pix=torch.as_tensor(sn))
    B_t = tbg.background_of(Yt, st_t, tp).numpy()
    _close(st_t.b0.numpy(), np.asarray(st_j.b0), 1e-4, "b0")
    _close(st_t.W.w.numpy(), np.asarray(st_j.W.w), 2e-3, "w")
    _close(B_t, B_j, 1e-4, "background")
    resid_t = tbg.residual_movie(Yt, st_t, tp).numpy()
    resid_j = np.asarray(jbg.residual_movie(Y, st_j, params))
    # Y - B - A C: B's error on the scale of B
    _close(resid_t, resid_j, 1e-4, "residual", scale=np.abs(B_j).max())
