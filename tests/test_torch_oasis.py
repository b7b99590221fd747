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

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import DeconvParams
from cnmf_e_tpu.ops import oasis as jax_oasis
from cnmf_e_tpu.ops import pallas_oasis as jax_pallas
from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.config import DeconvParams as TorchDeconvParams
from cnmf_e_tpu_torch.models.pipeline import CNMFE
from cnmf_e_tpu_torch.ops import oasis_kernels
from cnmf_e_tpu_torch.ops.ar import choose_smin, estimate_time_constant
from cnmf_e_tpu_torch.ops.oasis import (deconvolve, foopsi_ar1, oasis_ar1,
                                        pass1_input)
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


def _check_two_pass_against_pallas_dc(lam, smin, L, seed):
    K, T = 5, 200                 # T not a multiple of L: padded
    y, g = _traces(K, T, seed=seed)
    c_j, s_j = jax_pallas.oasis_ar1_pallas_dc(
        jnp.asarray(y), jnp.asarray(g), jnp.full(K, lam, jnp.float32),
        jnp.full(K, smin, jnp.float32), L=L, interpret=True)
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), lam, smin, chunk=L)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-4)


@pytest.mark.parametrize("lam,smin", CASES)
def test_two_pass_matches_jax_pallas_dc(lam, smin):
    _check_two_pass_against_pallas_dc(lam, smin, 64,
                                      seed=int(10 * lam + 100 * smin))


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


def _violates(vp_, wp, lp, vq, wq, logg, smin):
    """The merge test of pool q on top of pool p, in the plain versions'
    float32 operations."""
    gl = torch.exp(logg * lp.to(torch.float32))
    return vq / wq < torch.clamp(vp_ / wp, min=0.0) * gl + smin, gl


@pytest.mark.parametrize("L", [32, 64, 128])
@pytest.mark.parametrize("lam,smin", CASES)
def test_pass1_adjacent_pools_never_violate(lam, smin, L):
    """The property the pool-merge kernel's seam shortcut rests on: in
    every chunk list pass 1 leaves, no pool violates the one below it."""
    K, T = 4, 256
    y, g = _traces(K, T, seed=50 + L + int(10 * lam + 100 * smin))
    gt = torch.tensor(g)
    st = torch.full((K,), smin, dtype=torch.float32)
    v, w, ts, ln, n = oasis_kernels.oasis_chunk_pools_reference(
        pass1_input(torch.tensor(y), gt, torch.full((K,), lam), L), gt, st,
        L)
    logg = torch.log(torch.clamp(gt, min=1e-10))[:, None, None]
    viol, _ = _violates(v[..., :-1], w[..., :-1], ln[..., :-1], v[..., 1:],
                        w[..., 1:], logg, st[:, None, None])
    pair = torch.arange(1, L)[None, None, :] < n[:, :, None]
    assert int(pair.sum()) > 0
    assert not bool((viol & pair).any())


def _pool_merge_shortcut(v0, w0, ts0, l0, n_in, g, smin):
    """A per-trace model of the pool-merge kernel: push a chunk's pools
    while they merge, then append the rest of the chunk untested."""
    K, nc, L = v0.shape
    out = [torch.zeros((K, nc * L)), torch.ones((K, nc * L)),
           torch.zeros((K, nc * L), dtype=torch.int32),
           torch.zeros((K, nc * L), dtype=torch.int32)]
    n_out = torch.zeros(K, dtype=torch.int32)
    for k in range(K):
        logg = torch.log(torch.clamp(g[k], min=1e-10))
        stack = []

        def pool(c, i):
            return [v0[k, c, i], w0[k, c, i], ts0[k, c, i], l0[k, c, i]]

        for c in range(nc):
            m, i = int(n_in[k, c]), 0
            while i < m:
                stack.append(pool(c, i))
                i += 1
                merged = False
                while len(stack) >= 2:
                    p, q = stack[-2], stack[-1]
                    viol, gl = _violates(p[0], p[1], p[3], q[0], q[1], logg,
                                         smin[k])
                    if not bool(viol):
                        break
                    stack.pop()
                    stack[-1] = [p[0] + q[0] * gl, p[1] + q[1] * gl * gl,
                                 p[2], p[3] + q[3]]
                    merged = True
                if not merged:
                    break
            stack.extend(pool(c, j) for j in range(i, m))
        n_out[k] = len(stack)
        for s, entry in enumerate(stack):
            for arr, x in zip(out, entry):
                arr[k, s] = x
    return (*out, n_out)


@pytest.mark.parametrize("kind,smin", [("random", 0.0), ("random", 0.2),
                                       ("increasing", 0.0),
                                       ("increasing", 0.2),
                                       ("decreasing", 0.0)])
def test_pool_merge_seam_shortcut_is_exact(kind, smin):
    """The kernel's shortcut against the plain full push, bit for bit.
    Fewer than 16 lanes a call keep every exp on one code path."""
    L, T = 32, 256
    if kind == "random":
        y, g = _traces(8, T, seed=61 + int(100 * smin))
        vinit = pass1_input(torch.tensor(y), torch.tensor(g),
                            torch.zeros(8), L)
    else:
        # increasing: no sample merges (at smin = 0); decreasing faster
        # than g: every sample and every seam merges into one pool
        t = torch.arange(T, dtype=torch.float32)
        vinit = (1.0 + t / 32.0 if kind == "increasing"
                 else 10.0 * 0.97 ** t)[None]
        g = np.array([0.9 if kind == "increasing" else 0.99], np.float32)
    K = vinit.shape[0]
    gt = torch.tensor(g)
    st = torch.full((K,), smin, dtype=torch.float32)
    per_trace = [oasis_kernels.oasis_chunk_pools_reference(
        vinit[k:k + 1], gt[k:k + 1], st[k:k + 1], L) for k in range(K)]
    p1 = [torch.cat(x) for x in zip(*per_trace)]
    want = oasis_kernels.oasis_pool_merge_reference(*p1, gt, st)
    got = _pool_merge_shortcut(*p1, gt, st)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if kind == "increasing" and smin == 0.0:
        assert int(want[4][0]) == T
    if kind == "decreasing":
        assert int(want[4][0]) == 1


@pytest.mark.parametrize("lam,smin", CASES)
def test_two_pass_matches_jax_pallas_dc_chunk32(lam, smin):
    _check_two_pass_against_pallas_dc(lam, smin, 32,
                                      seed=71 + int(10 * lam + 100 * smin))


def _params_with_chunk(L):
    p = CNMFEParams.preset_1p()
    deconv = dataclasses.replace(p.temporal.deconv, fast_chunk=L)
    return p.replace(temporal=dataclasses.replace(p.temporal, deconv=deconv))


@pytest.mark.parametrize("device,L,ok", [
    ("cuda", 128, True), ("cuda", oasis_kernels.K2_MAX_L, True),
    ("cuda", oasis_kernels.K2_MAX_L + 1, False),
    ("cpu", oasis_kernels.K2_MAX_L + 1, True)])
def test_card_chunk_limit_raises_when_the_pipeline_is_built(device, L, ok):
    """A chunk longer than pass 1's kernel holds fails at CNMFE(...) on the
    card, before any work; the plain versions on the CPU take it."""
    if ok:
        CNMFE(_params_with_chunk(L), device=device)
    else:
        with pytest.raises(ValueError, match="exceeds"):
            CNMFE(_params_with_chunk(L), device=device)


def test_plain_solve_takes_chunks_past_the_card_limit():
    """smin = 0: exact whatever the chunk, so chunks of K2_MAX_L + 1
    samples give the sequential oracle's answer."""
    K, L = 2, oasis_kernels.K2_MAX_L + 1
    T = 2 * L - 50
    y, g = _traces(K, T, seed=81)
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), 0.0, 0.0, chunk=L)
    for k in range(K):
        c_o, s_o = oasis_ar1_oracle(y[k].astype(np.float64), float(g[k]),
                                    0.0, 0.0)
        np.testing.assert_allclose(c[k].numpy(), c_o, atol=1e-4)
        np.testing.assert_allclose(s[k].numpy(), s_o, atol=1e-4)
