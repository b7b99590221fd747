"""DF/F extraction in the port (``cnmf_e_tpu_torch/models/dff.py``)
against the JAX package's ``models/dff.py`` on the CPU.

One seeded state and movie (12 slots, 4 of them inactive, 24x24x300) with
a ring background on the ssub=2 grid or a rank-3 low-rank one go through
both packages: C_df, C_raw_df and F0 agree at rtol 1e-5, inactive rows are
zero. The running percentile is held to the JAX one (``jnp.quantile``),
including one case past 2^24 gathered window elements, where
``torch.quantile`` would refuse.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import BackgroundParams, CNMFEParams
from cnmf_e_tpu.models import dff as jax_dff
from cnmf_e_tpu.models.state import empty_state as jax_empty_state
from cnmf_e_tpu.ops.ring import RingWeights as JaxRingWeights
from cnmf_e_tpu_torch.convert import params_from_dict, state_from_numpy
from cnmf_e_tpu_torch.models import dff
from cnmf_e_tpu_torch.ops.ring_kernels import ring_offsets

torch.set_num_threads(1)

RTOL = 1e-5
K, H, W, T = 12, 24, 24, 300
ACTIVE = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 0], bool)


def _params(model):
    bg = (BackgroundParams(model="ring", ring_radius=6, ssub=2)
          if model == "ring" else BackgroundParams(model=model, rank=3))
    return CNMFEParams(background=bg)


def _problem(model, seed=0):
    """Numpy state arrays under the export key names, and the movie."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(3, H - 3, 2)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 5.0)
    A *= ACTIVE[:, None, None]
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    C *= ACTIVE[:, None]
    b0 = (1.0 + 0.2 * rng.random((H, W))).astype(np.float32)
    d = dict(A=A, C=C, C_raw=C + 0.05 * rng.standard_normal((K, T)).astype(
        np.float32), S=np.zeros((K, T), np.float32),
        g=np.full((K, 1), 0.9, np.float32),
        neuron_sn=np.full((K,), 0.05, np.float32), b0=b0, active=ACTIVE,
        tags=np.zeros((K,), np.int32))
    if model == "ring":
        R = ring_offsets(3).shape[0]
        d["ring_w"] = (rng.random((12 * 12, R)) / R).astype(np.float32)
        d["ring_w0"] = (0.1 * rng.random(12 * 12)).astype(np.float32)
    else:
        d["bg_b"] = (0.3 * rng.random((3, H, W))).astype(np.float32)
        d["bg_f"] = (1.0 + rng.standard_normal((3, T))).astype(np.float32)
    field = (1.0 + 0.3 * np.sin(np.arange(T) / 17.0))[:, None, None]
    Y = (np.einsum("khw,kt->thw", A, C) + b0[None] * field
         + 0.05 * rng.standard_normal((T, H, W))).astype(np.float32)
    return d, Y


def _jax_state(d):
    st = jax_empty_state(K, H, W, T)
    kw = {k: jnp.asarray(d[k]) for k in ("A", "C", "C_raw", "S", "g",
                                         "neuron_sn", "b0", "active",
                                         "tags")}
    if "ring_w" in d:
        kw["W"] = JaxRingWeights(jnp.asarray(d["ring_w"]),
                                 jnp.asarray(d["ring_w0"]))
    else:
        kw["b"], kw["f"] = jnp.asarray(d["bg_b"]), jnp.asarray(d["bg_f"])
    return st.replace(**kw)


def _frames(d, sl):
    """The state of one batch: the traces (and f) of frames ``sl``."""
    out = dict(d)
    for k in ("C", "C_raw", "S"):
        out[k] = d[k][:, sl]
    if "bg_f" in d:
        out["bg_f"] = d["bg_f"][:, sl]
    return out


def _check(ours, theirs):
    for a, b in zip(ours, theirs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    for x in ours[:2]:
        assert not x[~torch.as_tensor(ACTIVE)].any()


@pytest.mark.parametrize("model", ["ring", "svd"])
@pytest.mark.parametrize("window, baseline", [
    (None, "percentile"), (101, "percentile"), (300, "percentile"),
    (400, "percentile"), (None, "mode")],
    ids=["session", "running_101", "window_eq_T", "window_past_T", "mode"])
def test_extract_dff_matches_the_jax_package(model, window, baseline):
    d, Y = _problem(model)
    params = _params(model)
    theirs = jax_dff.extract_dff(jnp.asarray(Y), _jax_state(d), params,
                                 window=window, baseline=baseline)
    ours = dff.extract_dff(
        torch.as_tensor(Y), state_from_numpy(d, device="cpu"),
        params_from_dict(dataclasses.asdict(params)), window=window,
        baseline=baseline)
    _check(ours, theirs)


@pytest.mark.parametrize("model", ["ring", "svd"])
@pytest.mark.parametrize("window", [None, 101])
def test_extract_dff_batches_on_three_blocks(model, window):
    d, Y = _problem(model, seed=1)
    params = _params(model)
    cuts = [slice(0, 100), slice(100, 200), slice(200, 300)]
    blocks = [Y[s] for s in cuts]
    theirs = jax_dff.extract_dff_batches(
        blocks, [_jax_state(_frames(d, s)) for s in cuts], _jax_state(d),
        params, window=window)
    ours = dff.extract_dff_batches(
        blocks, [state_from_numpy(_frames(d, s), device="cpu")
                 for s in cuts], state_from_numpy(d, device="cpu"),
        params_from_dict(dataclasses.asdict(params)), window=window)
    _check(ours, theirs)


@pytest.mark.parametrize("shape, window, q, budget", [
    ((5, 40), 7, 50.0, None),
    ((5, 40), 8, 20.0, None),
    ((3, 4, 50), 9, 90.0, None),
    ((7, 33), 1, 50.0, None),
    ((6, 120), 31, 50.0, 120 * 31 * 2),      # rows sorted two at a time
    ((64, 600), 501, 50.0, None),            # 19.2 M gathered > 2^24
], ids=["odd", "even_q20", "3d_q90", "window_1", "chunked", "past_2e24"])
def test_running_percentile_matches_jnp_quantile(shape, window, q, budget,
                                                 monkeypatch):
    if budget is not None:
        monkeypatch.setattr(dff, "SORT_ELEMS", budget)
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    ours = dff.running_percentile(torch.as_tensor(x), window, q).numpy()
    theirs = np.asarray(jax_dff.running_percentile(jnp.asarray(x), window,
                                                   q))
    np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 5, 1000])
@pytest.mark.parametrize("q", [0.0, 0.2, 0.5, 0.9, 1.0])
def test_quantile_is_the_linear_rule(n, q):
    x = np.random.default_rng(n).standard_normal((4, n)).astype(np.float32)
    ours = dff.quantile(torch.as_tensor(x), q).numpy()
    np.testing.assert_allclose(ours, np.asarray(jnp.quantile(
        jnp.asarray(x), q, axis=-1, keepdims=True)), rtol=RTOL, atol=1e-6)
