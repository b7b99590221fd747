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
import re
from pathlib import Path

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
from cnmf_e_tpu_torch.ops.oasis import deconvolve, foopsi_ar1, oasis_ar1
from cnmf_e_tpu_torch.ops.oasis_kernels import pass1_input
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


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("L", [128, oasis_kernels.K2_SMEM_MAX_L,
                               oasis_kernels.K2_SMEM_MAX_L + 1, 2048])
def test_card_chunk_limit_raises_when_the_pipeline_is_built(device, L):
    """No chunk limit is left on either device: ``CNMFE`` builds with any
    ``fast_chunk``, on the card as on the CPU (pass 1 keeps its stacks in
    a global scratch past the shared memory's 605 samples)."""
    model = CNMFE(_params_with_chunk(L), device=device)
    assert model.params.temporal.deconv.fast_chunk == L


def test_plain_solve_takes_chunks_past_the_card_limit():
    """smin = 0: exact whatever the chunk, so chunks one sample past what
    pass 1's shared-memory body holds give the sequential oracle's
    answer."""
    K, L = 2, oasis_kernels.K2_SMEM_MAX_L + 1
    T = 2 * L - 50
    y, g = _traces(K, T, seed=81)
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), 0.0, 0.0, chunk=L)
    for k in range(K):
        c_o, s_o = oasis_ar1_oracle(y[k].astype(np.float64), float(g[k]),
                                    0.0, 0.0)
        np.testing.assert_allclose(c[k].numpy(), c_o, atol=1e-4)
        np.testing.assert_allclose(s[k].numpy(), s_o, atol=1e-4)


@pytest.mark.parametrize("T", [600, 2000])
@pytest.mark.parametrize("L", [1024, 2048])
def test_plain_chain_matches_jax_at_long_chunks(L, T):
    """Chunks of 1024 and 2048 samples (pass 1's global-stack body on the
    card), one chunk a trace where L >= T, against the JAX package's CPU
    solve with the same chunk."""
    K, lam, smin = 3, 0.2, 0.3
    y, g = _traces(K, T, seed=90 + L // 512 + T)
    c_j, s_j = jax_oasis.oasis_ar1(jnp.asarray(y), jnp.asarray(g), lam, smin,
                                   chunk=L)
    c, s = oasis_ar1(torch.tensor(y), torch.tensor(g), lam, smin, chunk=L)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-4)


_CSRC = Path(__file__).resolve().parents[1] / "cnmf_e_tpu_torch" / "csrc"


def _constexpr(name):
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (_CSRC / "oasis.cu").read_text())
    assert m, f"oasis.cu has no constexpr int {name}"
    return int(m.group(1))


def test_kernel_constants_match_the_source():
    assert oasis_kernels.K2_SMEM_MAX_L == _constexpr("kSmemOptin") // (3 * 32
                                                                      * 4)
    assert (oasis_kernels.K4_THREADS, oasis_kernels.K4_TILE) == (
        _constexpr("kReconThreads"), _constexpr("kReconTile"))


@pytest.mark.parametrize("L", [128, 605, 606, 2048])
def test_pass1_takes_the_global_stack_body_past_shared_memory(L):
    """The wrapper hands pass 1 a scratch of three [L][32] stacks a warp
    exactly when its shared memory cannot hold them."""
    scratch = oasis_kernels.k2_scratch(70, L, "cpu")
    if 3 * L * 32 * 4 <= 232448:
        assert scratch is None
    else:
        assert scratch.numel() == 3 * 3 * L * 32  # 70 lanes: 3 warps


def _kernel_pool_index(ts, n, T, tile, threads):
    """A model of the reconstruction kernel's lookup, per trace and tile:
    the tile's first pool by the threads-ary search over the sorted
    starts, the staged pools j0 - 1 .. j0 + m - 1, each sample's pool by a
    binary search over the staged starts. Returns the pool of every sample
    (K, T) and, at every pool start, the pool the kernel takes as the
    previous one (-1 elsewhere)."""
    K = ts.shape[0]
    pool = np.full((K, T), -1, np.int64)
    prev = np.full((K, T), -1, np.int64)
    for k in range(K):
        np_ = max(int(n[k]), 1)
        for lo_t in range(0, T, tile):
            hi_t = min(lo_t + tile, T)
            lo, hi = 0, np_
            while hi - lo > 1:
                step = -(-(hi - lo) // threads)
                below = sum(1 for i in range(threads)
                            if lo + i * step < hi
                            and ts[k, lo + i * step] <= lo_t)
                lo += max(below - 1, 0) * step
                hi = min(lo + step, hi)
            j0 = lo
            m = min(np_ - j0, hi_t - lo_t)
            staged = [0 if j < 0 else int(ts[k, j])
                      for j in range(j0 - 1, j0 + m)]
            for t in range(lo_t, hi_t):
                a, b = 1, m + 1
                while b - a > 1:
                    mid = (a + b) >> 1
                    if staged[mid] <= t:
                        a = mid
                    else:
                        b = mid
                pool[k, t] = j0 - 1 + a
                if t == staged[a] and t > 0:
                    prev[k, t] = j0 - 2 + a
    return pool, prev


def _reconstruct_cases():
    cases = {}
    # random traces, T not a multiple of the tile, padded past T
    y, g = _traces(3, 1100, seed=96)
    cases["random"] = (pass1_input(torch.tensor(y), torch.tensor(g),
                                   torch.zeros(3), 128), g, 1100)
    # one pool a trace (a strictly decreasing trace faster than g), and
    # every sample its own pool (over 256 pools: two search rounds)
    t = np.arange(1300, dtype=np.float32)
    down = (10.0 * 0.97 ** t)[None]
    up = (1.0 + t / 64.0)[None]
    cases["one pool"] = (torch.tensor(down), np.array([0.99], np.float32),
                         1300)
    cases["every sample"] = (torch.tensor(up), np.array([0.9], np.float32),
                             1300)
    # long pools across the seams of 512-sample tiles: decays faster than
    # g, each jump ten times the last, the start of one pool
    t = np.arange(1536)
    z = np.stack([10.0 * 0.98 ** t] * 2)
    for k, jumps in enumerate(((300, 700, 1300), (100, 1100))):
        for i, s0 in enumerate(jumps):
            z[k, s0:] += 10.0 ** (i + 2) * 0.98 ** (t[s0:] - s0)
    cases["seam"] = (torch.tensor(z.astype(np.float32)),
                     np.array([0.99, 0.99], np.float32), 1536)
    return cases


@pytest.mark.parametrize("case", ["random", "one pool", "every sample",
                                  "seam"])
def test_reconstruct_tile_lookup_is_exact(case):
    """The reconstruction kernel's per-tile lookup, modelled in numpy at
    the kernel's tile and thread count, finds every sample's pool and
    every spike's previous pool as the plain version does; c and s built
    from those pools equal the plain version's bit for bit."""
    vinit, g, T = _reconstruct_cases()[case]
    gt = torch.tensor(g)
    st = torch.zeros(len(g))
    L = 128 if vinit.shape[1] % 128 == 0 else vinit.shape[1]
    p1 = oasis_kernels.oasis_chunk_pools_reference(vinit, gt, st, L)
    v, w, ts, ln, n = oasis_kernels.oasis_pool_merge_reference(*p1, gt, st)
    pool, prev = _kernel_pool_index(ts.numpy(), n.numpy(), T,
                                    oasis_kernels.K4_TILE,
                                    oasis_kernels.K4_THREADS)
    if case == "one pool":
        assert int(n[0]) == 1
    if case == "every sample":
        assert int(n[0]) == T
    if case == "seam":
        # every trace is a few pools, each across a tile seam
        assert n.tolist() == [4, 3]
        assert (pool[:, 511] == pool[:, 512]).all()
        assert (pool[:, 1023] == pool[:, 1024]).all()
    c_ref, s_ref = oasis_kernels.oasis_reconstruct_reference(v, w, ts, ln, n,
                                                             gt, T)
    idx = torch.tensor(pool)
    t0 = torch.gather(ts.long(), 1, idx)
    starts = (torch.arange(T)[None, :] == t0) & (torch.arange(T)[None, :] > 0)
    assert torch.equal(starts, torch.tensor(prev >= 0))
    # the previous pool of a start is the pool of the sample before it
    k_, t_ = np.nonzero(prev >= 0)
    np.testing.assert_array_equal(prev[k_, t_], pool[k_, t_ - 1])
    val = torch.gather(torch.clamp(v / torch.clamp(w, min=1e-20), min=0.0),
                       1, idx)
    logg = torch.log(torch.clamp(gt, min=1e-10))[:, None]
    c = val * torch.exp(logg * (torch.arange(T)[None, :] - t0).to(
        torch.float32))
    c_prev = torch.cat([torch.zeros((len(g), 1)), c[:, :-1]], dim=1)
    s = torch.where(starts, c - gt[:, None] * c_prev, 0.0)
    assert torch.equal(c, c_ref) and torch.equal(s, s_ref)


def test_reconstruct_plain_ignores_pools_past_T_as_jax_does():
    """Pass 1 on padded traces leaves pools that start at or past T; the
    plain reconstruction of the T real samples skips them and agrees with
    JAX's Pallas reconstruction (interpret mode) on [0, T). 128 traces,
    the JAX kernel's lane block."""
    K, T, L = 128, 200, 64
    y, g = _traces(K, T, seed=97)
    smin = np.full(K, 0.1, np.float32)
    yt, gt, st = torch.tensor(y), torch.tensor(g), torch.tensor(smin)
    p1 = oasis_kernels.oasis_chunk_pools_reference(
        pass1_input(yt, gt, torch.zeros(K), L), gt, st, L)
    v, w, ts, ln, n = oasis_kernels.oasis_pool_merge_reference(*p1, gt, st)
    assert bool((ts.max(dim=1).values >= T).all())
    c, s = oasis_kernels.oasis_reconstruct_reference(v, w, ts, ln, n, gt, T)
    assert c.shape == s.shape == (K, T)
    cj, sj = jax_pallas._reconstruct_pallas(
        jnp.asarray(v.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(ts.numpy()), jnp.asarray(ln.numpy()),
        jnp.asarray(n.numpy()), jnp.asarray(g), T, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), atol=1e-4)


def _pass1_per_lane(vinit, g, smin, L, T):
    """Pass 1 one lane a call (each exp on one code path), as the solve
    entry's kernel runs it: chunks of L of the first T samples of vinit,
    the last ending at T; its slots padded to L with (0, 1, 0, 0)."""
    nc = -(-T // L)
    out = [[] for _ in range(5)]
    for c in range(nc):
        Lc = min(L, T - c * L)
        v, w, ts, ln, n = oasis_kernels.oasis_chunk_pools_reference(
            vinit[:, c * L:c * L + Lc].contiguous(), g, smin, Lc)
        pad = L - Lc
        out[0].append(torch.nn.functional.pad(v[:, 0], (0, pad)))
        out[1].append(torch.nn.functional.pad(w[:, 0], (0, pad), value=1.0))
        live = torch.arange(L)[None, :] < n
        out[2].append(torch.where(live, torch.nn.functional.pad(
            ts[:, 0], (0, pad)) + c * L, 0))
        out[3].append(torch.nn.functional.pad(ln[:, 0], (0, pad)))
        out[4].append(n)
    return tuple(torch.stack(x, dim=1) if i < 4 else torch.cat(x, dim=1)
                 for i, x in enumerate(out))


@pytest.mark.parametrize("T", [2000, 2500])
def test_true_length_last_chunk_matches_padded_pass1(T):
    """The solve entry's pass 1 ends each trace's last chunk at T instead
    of padding it with never-merging samples: pass 2 and the
    reconstruction then give the same c and s on [0, T), bit for bit."""
    L, lam, smin = 128, 0.3, 0.2
    y, g = _traces(2, T, seed=98 + T)
    for k in range(2):
        yk, gk = torch.tensor(y[k:k + 1]), torch.tensor(g[k:k + 1])
        lk, sk = torch.full((1,), lam), torch.full((1,), smin)
        padded = pass1_input(yk, gk, lk, L)
        got = []
        for length in (padded.shape[1], T):
            p1 = _pass1_per_lane(padded, gk, sk, L, length)
            p2 = oasis_kernels.oasis_pool_merge_reference(*p1, gk, sk)
            got.append(oasis_kernels.oasis_reconstruct_reference(*p2, gk, T))
        (c_pad, s_pad), (c_cut, s_cut) = got
        assert torch.equal(c_cut, c_pad) and torch.equal(s_cut, s_pad)
        # and the padded per-lane pass 1 is the batched plain chain's
        c, s = oasis_kernels.oasis_solve_reference(yk, gk, lk, sk, L)
        np.testing.assert_allclose(c_pad.numpy(), c.numpy(), atol=1e-5)
        np.testing.assert_allclose(s_pad.numpy(), s.numpy(), atol=1e-5)
