"""OASIS AR(1) in the PyTorch port vs the JAX package.

The port's three kernels run here as their plain PyTorch versions (CPU
tensors). Each is held against the JAX kernel it replaces (Pallas in
interpret mode, ``cnmf_e_tpu/ops/pallas_oasis.py``), the whole two-pass
solve against the JAX divide-and-conquer paths and against the float64
sequential oracle, atol 1e-4 as in ``tests/test_pallas_oasis.py``. The
divide-and-conquer solve equals the sequential algorithm exactly when
smin == 0 (pool merging is confluent); with smin > 0 it may differ at
isolated samples, so those cases are held to the JAX solve only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import DeconvParams
from cnmf_e_tpu.ops import oasis as jax_oasis
from cnmf_e_tpu.ops import pallas_oasis as jax_pallas
from cnmf_e_tpu_torch.config import DeconvParams as TorchDeconvParams
from cnmf_e_tpu_torch.ops import oasis_kernels
from cnmf_e_tpu_torch.ops.ar import choose_smin, estimate_time_constant
from cnmf_e_tpu_torch.ops.oasis import deconvolve, foopsi_ar1, oasis_ar1
from tests.oracles import oasis_ar1_oracle

torch.set_num_threads(1)


def _traces(K, T, seed, rate=0.05, sn=0.2):
    rng = np.random.default_rng(seed)
    g = rng.uniform(0.7, 0.97, K).astype(np.float32)
    s = (rng.random((K, T)) < rate) * rng.exponential(1.0, (K, T))
    c = np.zeros((K, T), np.float32)
    for t in range(1, T):
        c[:, t] = g * c[:, t - 1] + s[:, t]
    y = (c + sn * rng.standard_normal((K, T))).astype(np.float32)
    return y, g


CASES = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.3), (0.3, 0.2)]


@pytest.mark.parametrize("lam,smin", CASES)
def test_two_pass_matches_jax_pallas_dc(lam, smin):
    K, T, L = 5, 200, 64          # T not a chunk multiple: pads to 256
    y, g = _traces(K, T, seed=int(10 * lam + 100 * smin))
    c_j, s_j = jax_pallas.oasis_ar1_pallas_dc(
        jnp.asarray(y), jnp.asarray(g), jnp.full(K, lam, jnp.float32),
        jnp.full(K, smin, jnp.float32), L=L, interpret=True)
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), lam, smin, chunk=L)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-4)


@pytest.mark.parametrize("lam,smin", CASES)
def test_two_pass_matches_jax_xla(lam, smin):
    K, T = 12, 600
    y, g = _traces(K, T, seed=7 + int(10 * lam + 100 * smin))
    c_j, s_j = jax_oasis.oasis_ar1(jnp.asarray(y), jnp.asarray(g), lam,
                                   smin)
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), lam, smin)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-4)


@pytest.mark.parametrize("T,lam", [(300, 0.0), (300, 0.4), (2500, 0.0)])
def test_two_pass_matches_sequential_oracle(T, lam):
    """smin = 0: exact. T = 2500 lies past the JAX package's 2304-sample
    windowing cut, where only the oracle is exact."""
    K = 3
    y, g = _traces(K, T, seed=T + int(10 * lam))
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), lam, 0.0)
    for k in range(K):
        c_o, s_o = oasis_ar1_oracle(y[k].astype(np.float64), float(g[k]),
                                    lam, 0.0)
        np.testing.assert_allclose(c[k].numpy(), c_o, atol=1e-4)
        np.testing.assert_allclose(s[k].numpy(), s_o, atol=1e-4)


def test_chunk_pools_plain_matches_pallas_pass1():
    K, T, L = 4, 256, 64
    nc = T // L
    y, g = _traces(K, T, seed=3)
    smin = np.full(K, 0.2, np.float32)
    v, w, ts, ln, n = oasis_kernels.oasis_chunk_pools_reference(
        torch.tensor(y), torch.tensor(g), torch.tensor(smin), L)
    vj, wj, tsj, lnj, nj = jax_pallas._oasis_pools_pallas(
        jnp.asarray(y.reshape(K * nc, L)), jnp.asarray(np.repeat(g, nc)),
        jnp.asarray(np.repeat(smin, nc)), interpret=True)
    nj = np.asarray(nj).reshape(K, nc)
    np.testing.assert_array_equal(n.numpy(), nj)
    offs = (np.arange(K * nc) % nc * L).reshape(K, nc, 1)
    valid = np.arange(L)[None, None, :] < nj[:, :, None]
    for got, want, off in ((v, vj, 0), (w, wj, 0), (ts, tsj, offs),
                           (ln, lnj, 0)):
        want = np.asarray(want).reshape(K, nc, L) + off
        np.testing.assert_allclose(np.where(valid, got.numpy(), 0),
                                   np.where(valid, want, 0),
                                   rtol=1e-6, atol=1e-5)


def test_pool_merge_and_reconstruct_plain_match_pallas():
    """Pass 2 and the reconstruction, fed the same pass-1 pools; 128
    traces, the JAX kernels' lane block."""
    K, T, L = 128, 128, 32
    y, g = _traces(K, T, seed=5)
    smin = np.full(K, 0.1, np.float32)
    yt, gt, st = torch.tensor(y), torch.tensor(g), torch.tensor(smin)
    p1 = oasis_kernels.oasis_chunk_pools_reference(yt, gt, st, L)
    v, w, ts, ln, n = oasis_kernels.oasis_pool_merge_reference(*p1, gt, st)
    vj, wj, tsj, lnj, nj = jax_pallas._pool_merge_pallas(
        *(jnp.asarray(x.numpy()) for x in p1), jnp.asarray(g),
        jnp.asarray(smin), interpret=True)
    np.testing.assert_array_equal(n.numpy(), np.asarray(nj))
    valid = np.arange(T)[None, :] < n.numpy()[:, None]
    for got, want in ((v, vj), (w, wj), (ts, tsj), (ln, lnj)):
        np.testing.assert_allclose(np.where(valid, got.numpy(), 0),
                                   np.where(valid, np.asarray(want), 0),
                                   rtol=1e-6, atol=1e-5)
    c, s = oasis_kernels.oasis_reconstruct_reference(v, w, ts, ln, n, gt, T)
    cj, sj = jax_pallas._reconstruct_pallas(
        jnp.asarray(v.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(ts.numpy()), jnp.asarray(ln.numpy()),
        jnp.asarray(n.numpy()), jnp.asarray(g), T, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-4)


def test_plain_kernels_leave_unused_slots_clear():
    y, g = _traces(3, 128, seed=9)
    v, w, ts, ln, n = oasis_kernels.oasis_chunk_pools_reference(
        torch.tensor(y), torch.tensor(g), torch.zeros(3), 64)
    unused = torch.arange(64)[None, None, :] >= n[:, :, None]
    assert bool((v[unused] == 0).all() and (w[unused] == 1).all()
                and (ts[unused] == 0).all() and (ln[unused] == 0).all())


def test_monotone_trace_never_merges_and_decreasing_trace_one_pool():
    up = torch.linspace(1.0, 10.0, 64)[None]
    v, w, ts, ln, n = oasis_kernels.oasis_chunk_pools_reference(
        up, torch.tensor([0.9]), torch.zeros(1), 64)
    assert int(n[0, 0]) == 64
    down = torch.linspace(10.0, 1.0, 64)[None]
    *_, n = oasis_kernels.oasis_chunk_pools_reference(
        down, torch.tensor([0.99]), torch.zeros(1), 64)
    assert int(n[0, 0]) == 1


@pytest.mark.parametrize("optimize_b", [False, True])
def test_foopsi_matches_jax(optimize_b):
    K, T = 8, 400
    y, g = _traces(K, T, seed=21)
    y = y + 0.5
    sn = np.full(K, 0.2, np.float32)
    rj = jax_oasis.foopsi_ar1(jnp.asarray(y), jnp.asarray(g), smin=-2.0,
                              sn=jnp.asarray(sn), optimize_b=optimize_b)
    rt = foopsi_ar1(torch.tensor(y), torch.tensor(g), smin=-2.0,
                    sn=torch.tensor(sn), optimize_b=optimize_b)
    for a, b in ((rt.c, rj.c), (rt.s, rj.s), (rt.b, rj.b)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_deconvolve_default_params_matches_jax():
    """The pipeline's call: sn and g estimated, foopsi with baseline
    optimisation and smin = 5 sn."""
    K, T = 10, 500
    y, _ = _traces(K, T, seed=31, sn=0.1)
    params = DeconvParams()
    rj = jax_oasis.deconvolve(jnp.asarray(y), params)
    rt = deconvolve(torch.tensor(y), TorchDeconvParams())
    np.testing.assert_allclose(rt.g.numpy(), np.asarray(rj.g), atol=1e-5)
    np.testing.assert_allclose(rt.smin.numpy(), np.asarray(rj.smin),
                               rtol=1e-4, atol=1e-6)
    for a, b in ((rt.c, rj.c), (rt.s, rj.s), (rt.b, rj.b)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_ar1_estimation_matches_jax():
    from cnmf_e_tpu.ops import ar as jax_ar
    y, _ = _traces(16, 700, seed=41, sn=0.15)
    gj = jax_ar.estimate_time_constant(jnp.asarray(y), p=1)
    gt = estimate_time_constant(torch.tensor(y), p=1)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-5)
    sn = np.abs(np.random.default_rng(0).standard_normal(16)).astype(
        np.float32)
    sj = jax_ar.choose_smin(gj, jnp.asarray(sn))
    st = choose_smin(torch.tensor(np.asarray(gj)), torch.tensor(sn))
    # the JAX package evaluates norm.ppf(0.99999) in float32, where the
    # probability itself rounds by 1e-8; the port takes the float64
    # quantile: 7e-5 relative apart at this tail
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-4)
