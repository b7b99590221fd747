"""The chained model-update step of the PyTorch port vs the JAX package.

The same numpy state goes into ``cnmf_e_tpu.parallel.step`` (JAX on the
CPU, XLA sweeps) and ``cnmf_e_tpu_torch.parallel.step`` (the kernels' plain
PyTorch versions), carried over by ``convert.step_state_from_numpy``.
Tolerances are ``tests/test_step.py``'s and ``tests/test_coloring.py``'s;
the chained run is held to the chain-drift bar of
``scripts_dev/chain_drift.py`` (C max-rel drift <= 1e-3).
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.ops import hals as jhals
from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas
from cnmf_e_tpu.ops.ring import ring_offsets
from cnmf_e_tpu.parallel import step as jstep
from cnmf_e_tpu_torch.convert import (step_state_from_numpy,
                                      step_state_to_numpy)
from cnmf_e_tpu_torch.ops.hals_kernels import (block_grid_schedule,
                                               hals_sweeps_reference)
from cnmf_e_tpu_torch.parallel import step as tstep
from tests.test_step import _explicit_reference

torch.set_num_threads(1)


def _state_np(rng, H, W, T, K, radius, ring_w=None, sigma2=4.0, cut=1e-4,
              margin=6):
    R = ring_offsets(radius).shape[0]
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(margin, H - margin), rng.uniform(margin,
                                                              W - margin)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / sigma2)
    A[A < cut] = 0
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    if ring_w is None:
        ring_w = rng.standard_normal((H * W, R)).astype(np.float32) * 0.01 \
            + 1.0 / R
    return dict(A=A, C=C, C_raw=np.zeros((K, T), np.float32),
                S=np.zeros((K, T), np.float32),
                g=np.full((K,), 0.9, np.float32),
                b0=np.ones((H, W), np.float32),
                ring_w=np.broadcast_to(ring_w, (H * W, R)).astype(np.float32),
                ring_w0=np.zeros((H * W,), np.float32))


def _jax_state(d):
    return jstep.StepState(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.fixture(scope="module")
def problem():
    """``tests/test_step.py``'s fixture: 32x32x96, K = 8, radius 4."""
    H = W = 32
    T, K, radius = 96, 8, 4
    rng = np.random.default_rng(0)
    Y = (rng.standard_normal((T, H, W)) * 0.1 + 1.0).astype(np.float32)
    d = _state_np(rng, H, W, T, K, radius)
    return H, W, T, K, radius, Y, d


def _np(st):
    return step_state_to_numpy(st)


def _drift(x, ref):
    """Max relative drift (``scripts_dev/chain_drift.py:70-73``)."""
    scale = np.maximum(np.abs(ref), 0.05 * np.abs(ref).max())
    return float((np.abs(x - ref) / scale).max())


def test_fused_step_matches_jax_and_explicit(problem):
    H, W, T, K, radius, Y, d = problem
    want = jstep.make_update_step(None, H, W, T, radius=radius,
                                  n_hals=1)(jnp.asarray(Y), _jax_state(d))
    got = _np(tstep.make_update_step(None, H, W, T, radius=radius, n_hals=1)(
        torch.tensor(Y), step_state_from_numpy(d, device="cpu")))
    np.testing.assert_allclose(got["A"], np.asarray(want.A), atol=2e-4)
    np.testing.assert_allclose(got["C_raw"], np.asarray(want.C_raw),
                               atol=2e-3)
    np.testing.assert_allclose(got["C"], np.asarray(want.C), atol=5e-3)
    np.testing.assert_allclose(got["S"], np.asarray(want.S), atol=5e-3)
    Ad2, C_raw, c = _explicit_reference(H, W, T, K, radius, jnp.asarray(Y),
                                        _jax_state(d))
    np.testing.assert_allclose(got["A"].reshape(K, -1).T, np.asarray(Ad2),
                               atol=2e-4)
    np.testing.assert_allclose(got["C_raw"], np.asarray(C_raw), atol=2e-3)
    np.testing.assert_allclose(got["C"], np.asarray(c), atol=5e-3)


def test_split_projection_iteration_matches_fused(problem):
    H, W, T, K, radius, Y, d = problem
    st = step_state_from_numpy(d, device="cpu")
    Yt = torch.tensor(Y)
    ref = tstep.make_update_step(None, H, W, T, radius=radius, n_hals=1)(
        Yt, st)
    proj = tstep.make_bg_projection(None, H, W, T, radius=radius)
    iterate = tstep.make_hals_iteration(None, H, W, T, radius=radius,
                                        n_hals=1)
    Ysig = proj(Yt, st)
    out = iterate(Ysig, st)
    for k in ("A", "C", "C_raw", "S"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   getattr(ref, k).numpy(), atol=1e-6)
    # a second iterate on the same projection keeps B frozen at st
    out2 = iterate(Ysig, out)
    _, Craw_ref, _ = _explicit_reference(
        H, W, T, K, radius, jnp.asarray(Y), _jax_state(_np(out)),
        st_bg=_jax_state(d))
    np.testing.assert_allclose(out2.C_raw.numpy(), np.asarray(Craw_ref),
                               atol=4e-3)


def test_chained_block_matches_sequential_calls(problem):
    H, W, T, K, radius, Y, d = problem
    proj = tstep.make_bg_projection(None, H, W, T, radius=radius)
    it1 = tstep.make_hals_iteration(None, H, W, T, radius=radius, n_hals=1)
    it3 = tstep.make_hals_iteration(None, H, W, T, radius=radius, n_hals=1,
                                    chain=3)
    st = step_state_from_numpy(d, device="cpu")
    Ysig = proj(torch.tensor(Y), st)
    ref = st
    for _ in range(3):
        ref = it1(Ysig, ref)
    out = it3(Ysig, st)
    np.testing.assert_allclose(out.A.numpy(), ref.A.numpy(), atol=1e-5)
    np.testing.assert_allclose(out.C.numpy(), ref.C.numpy(), atol=1e-4)
    np.testing.assert_allclose(out.S.numpy(), ref.S.numpy(), atol=1e-4)


def test_bf16_grams_match_f32_and_jax(problem):
    """``gram_dtype="bfloat16"`` tracks the f32 step at
    ``test_bf16_grams_match_f32``'s bars, and the JAX bf16 step (which
    emulates bf16 operands on the CPU the same way) to f32 rounding."""
    H, W, T, K, radius, Y, d = problem
    st = step_state_from_numpy(d, device="cpu")
    f32 = tstep.make_update_step(None, H, W, T, radius=radius, n_hals=1,
                                 gram_dtype="float32")(torch.tensor(Y), st)
    bf16 = tstep.make_update_step(None, H, W, T, radius=radius, n_hals=1,
                                  gram_dtype="bfloat16")
    out = bf16(torch.tensor(Y), st)
    ra, rc = f32.A.numpy(), f32.C_raw.numpy()
    np.testing.assert_allclose(out.A.numpy(), ra,
                               atol=0.01 * np.abs(ra).max())
    np.testing.assert_allclose(out.C_raw.numpy(), rc,
                               atol=0.02 * np.abs(rc).max())
    assert tstep.make_bg_projection(None, H, W, T, radius,
                                    gram_dtype="bfloat16")(
        torch.tensor(Y), st).dtype == torch.bfloat16
    want = jstep.make_update_step(None, H, W, T, radius=radius, n_hals=1,
                                  gram_dtype="bfloat16")(jnp.asarray(Y),
                                                         _jax_state(d))
    np.testing.assert_allclose(out.A.numpy(), np.asarray(want.A), atol=2e-4)
    np.testing.assert_allclose(out.C_raw.numpy(), np.asarray(want.C_raw),
                               atol=2e-3)


def test_mxu_projection_tracks_exact(problem):
    """``mxu=True`` (bf16 bands, banded product) against the exact stencil
    path: the projection within bf16 rounding (2e-2 of the ring
    prediction's scale, ``tests/test_pallas_ring.py``), the step within the
    bf16-Gram bars."""
    H, W, T, K, radius, Y, d = problem
    st = step_state_from_numpy(d, device="cpu")
    Yt = torch.tensor(Y)
    exact = tstep.make_bg_projection(None, H, W, T, radius)(Yt, st)
    mxu = tstep.make_bg_projection(None, H, W, T, radius, mxu=True)(Yt, st)
    B = (Yt - exact).numpy()
    np.testing.assert_allclose((Yt - mxu).numpy() / np.abs(B).max(),
                               B / np.abs(B).max(), atol=2e-2)
    ref = tstep.make_update_step(None, H, W, T, radius=radius, n_hals=1)(
        Yt, st)
    out = tstep.make_update_step(None, H, W, T, radius=radius, n_hals=1,
                                 mxu=True)(Yt, st)
    ra, rc = ref.A.numpy(), ref.C_raw.numpy()
    np.testing.assert_allclose(out.A.numpy(), ra,
                               atol=0.01 * np.abs(ra).max())
    np.testing.assert_allclose(out.C_raw.numpy(), rc,
                               atol=0.02 * np.abs(rc).max())


def test_colored_iteration_matches_jax():
    """``tests/test_coloring.py::test_colored_iteration_matches_explicit``'s
    problem through both packages' ``colored=True`` iteration."""
    H = W = 32
    T, K, radius = 64, 12, 4
    rng = np.random.default_rng(5)
    Y = (rng.standard_normal((T, H, W)) * 0.1 + 1.0).astype(np.float32)
    d = _state_np(rng, H, W, T, K, radius, ring_w=np.float32(0.01),
                  cut=1e-3, margin=5)
    jproj = jstep.make_bg_projection(None, H, W, T, radius)
    jit = jstep.make_hals_iteration(None, H, W, T, radius, n_hals=1,
                                    colored=True, mask_dilate=2)
    want = jit(jproj(jnp.asarray(Y), _jax_state(d)), _jax_state(d))
    st = step_state_from_numpy(d, device="cpu")
    tproj = tstep.make_bg_projection(None, H, W, T, radius)
    tit = tstep.make_hals_iteration(None, H, W, T, radius, n_hals=1,
                                    colored=True, mask_dilate=2)
    got = tit(tproj(torch.tensor(Y), st), st)
    np.testing.assert_allclose(got.A.numpy(), np.asarray(want.A), atol=2e-4)
    np.testing.assert_allclose(got.C_raw.numpy(), np.asarray(want.C_raw),
                               atol=2e-3)
    np.testing.assert_array_equal(got.g.numpy(), d["g"])


def _bench_state(H, W, T, K, radius, seed):
    """``bench.py:100-125``'s synthetic state, as ``chip_smoke.py`` builds
    it: Gaussian footprints (sigma^2 = 9, cut at 1e-3), |N(0, 1)| traces,
    uniform ring weights 1/R."""
    R = ring_offsets(radius).shape[0]
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((T, H, W)) * 0.1 + 1.0).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.zeros((K, H, W), np.float32)
    for k in range(K):
        cy, cx = rng.uniform(10, H - 10), rng.uniform(10, W - 10)
        A[k] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    A[A < 1e-3] = 0.0
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    return Y, dict(A=A, C=C, C_raw=np.zeros((K, T), np.float32),
                   S=np.zeros((K, T), np.float32),
                   g=np.full((K,), 0.92, np.float32),
                   b0=np.ones((H, W), np.float32),
                   ring_w=np.full((H * W, R), 1.0 / R, np.float32),
                   ring_w0=np.zeros((H * W,), np.float32))


# ((H, W, T, K, radius, seed), step options): chip_smoke.py's phase-5b
# problem, and an odd field of view on which a footprint collapses and C
# climbs to ~3e5
_CONDITIONING = {
    "well": ((64, 64, 600, 16, 6, 3),
             dict(n_hals=1, chain=3, deconv_every=1, colored=True)),
    "ill": ((100, 72, 333, 37, 6, 5),
            dict(n_hals=2, chain=3, deconv_every=2, colored=True)),
}


@pytest.mark.parametrize("case", sorted(_CONDITIONING))
def test_step_drift_within_reference_rounding(case):
    """The port drifts from the JAX step by the order (at most 8x) of what a
    one-ulp change of Y moves the JAX step itself. On the well-conditioned
    problem that is far inside the chain-drift bar; on the ill-conditioned
    one a one-ulp change moves JAX's C by more than 0.1, so the bar cannot
    hold there between any two f32 implementations."""
    (H, W, T, K, radius, seed), kw = _CONDITIONING[case]
    Y, d = _bench_state(H, W, T, K, radius, seed)
    jax_step = jstep.make_update_step(None, H, W, T, radius=radius, **kw)
    keys = ("A", "C", "C_raw")

    def run_jax(Y_):
        out = jax_step(jnp.asarray(Y_), _jax_state(d))
        return {k: np.asarray(getattr(out, k)) for k in keys}

    want = run_jax(Y)
    moved = [run_jax(np.nextafter(Y, np.float32(to)))
             for to in (np.inf, -np.inf)]
    got = tstep.make_update_step(None, H, W, T, radius=radius, **kw)(
        torch.tensor(Y), step_state_from_numpy(d, device="cpu"))
    self_drift = {k: max(_drift(m[k], want[k]) for m in moved) for k in keys}
    for k in keys:
        port_drift = _drift(getattr(got, k).numpy(), want[k])
        assert port_drift <= 8 * self_drift[k], (k, port_drift, self_drift)
    if case == "well":
        assert self_drift["C"] <= 1e-4
        assert _drift(got.C.numpy(), want["C"]) <= 1e-3
    else:
        assert self_drift["C"] >= 0.1


@pytest.mark.parametrize("colored", [True, False])
def test_chain10_every5_drift_vs_jax(problem, colored):
    """The bench's chained variants (``chain=10, deconv_every=5``) drift
    from JAX by at most the chain-drift bar."""
    H, W, T, K, radius, Y, d = problem
    kw = dict(radius=radius, n_hals=1, chain=10, deconv_every=5,
              colored=colored)
    want = jstep.make_update_step(None, H, W, T, **kw)(jnp.asarray(Y),
                                                       _jax_state(d))
    got = tstep.make_update_step(None, H, W, T, **kw)(
        torch.tensor(Y), step_state_from_numpy(d, device="cpu"))
    assert _drift(got.C.numpy(), np.asarray(want.C)) <= 1e-3
    assert _drift(got.A.numpy(), np.asarray(want.A)) <= 1e-3
    np.testing.assert_allclose(got.S.numpy(), np.asarray(want.S), atol=5e-3)


def _rows_problem(seed, K=20, d=300, T=150):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((K, d))).astype(np.float32)
    A[rng.random((K, d)) < 0.6] = 0.0
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    Y = (A.T @ C + 0.1 * rng.standard_normal((d, T))).astype(np.float32)
    return rng, A, C, Y


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("K,block", [(20, 16), (13, 8), (5, 16)])
def test_block_grid_spatial_matches_xla(masked, K, block):
    """The block-grid K1 plain version (rows in order, ``block`` a step)
    against the JAX XLA sweeps (``use_pallas=False``)."""
    rng, A, C, Y = _rows_problem(K, K=K)
    Cc = C - C.mean(1, keepdims=True)
    U = (Cc @ Y.T).astype(np.float32)                     # (K, d)
    V = (Cc @ Cc.T).astype(np.float32)
    A0 = np.maximum(A * (1 + 0.3 * rng.standard_normal(A.shape)), 0)
    A0 = A0.astype(np.float32)
    mask = (A0 > 0) | (rng.random(A0.shape) < 0.3) if masked else None
    want = np.asarray(jhals.hals_spatial_sweeps_rows(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(A0),
        mask=None if mask is None else jnp.asarray(mask), n_iter=3,
        block=block, use_pallas=False))
    got = hals_sweeps_reference(
        torch.tensor(U), torch.tensor(V), torch.tensor(A0), torch.ones(K),
        block_grid_schedule(K, block, "cpu"),
        mask=None if mask is None else torch.tensor(mask), n_iter=3,
        block=block, relu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("K,block", [(20, 16), (13, 8)])
def test_block_grid_temporal_matches_xla(K, block):
    rng, A, C, Y = _rows_problem(100 + K, K=K)
    U = (A @ Y).astype(np.float32)                        # (K, T)
    V = (A @ A.T).astype(np.float32)
    C0 = (C + 0.1 * rng.standard_normal(C.shape)).astype(np.float32)
    active = rng.random(K) > 0.2
    want = np.asarray(jhals.hals_temporal_sweeps(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0), n_iter=3,
        active=jnp.asarray(active), use_pallas=False, block=block))
    got = hals_sweeps_reference(
        torch.tensor(U), torch.tensor(V), torch.tensor(C0),
        torch.tensor(active), block_grid_schedule(K, block, "cpu"), n_iter=3,
        block=block, relu=False).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("K,block", [(20, 16), (13, 8), (5, 16), (1, 64)])
def test_block_grid_schedule_matches_pallas_grid(K, block):
    """The port's block grid is the grid the Pallas kernel builds itself when
    it is given no schedule (``pallas_hals.py:302-310``): handed the port's
    schedule, the kernel (interpret mode) returns the same bits, and the
    plain K1 on that schedule agrees with it at 2e-5."""
    rng, A, C, Y = _rows_problem(200 + K, K=K, T=130)
    U = (A @ Y).astype(np.float32)                        # (K, T)
    V = (A @ A.T).astype(np.float32)
    C0 = (C + 0.1 * rng.standard_normal(C.shape)).astype(np.float32)
    sched = block_grid_schedule(K, block, "cpu")

    def run(**kw):
        return np.asarray(hals_sweeps_rows_pallas(
            jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0),
            gate=jnp.ones(K), n_iter=2, block=block, relu=False,
            interpret=True, **kw))

    own = run()
    np.testing.assert_array_equal(
        run(schedule=tuple(jnp.asarray(x.numpy()) for x in sched)), own)
    got = hals_sweeps_reference(
        torch.tensor(U), torch.tensor(V), torch.tensor(C0), torch.ones(K),
        sched, n_iter=2, block=block, relu=False).numpy()
    np.testing.assert_allclose(got, own, rtol=2e-5, atol=2e-5)


def test_mesh_raises_and_state_roundtrip(problem):
    """A mesh that H does not divide over, and mxu=True with a mesh, raise
    a ValueError (the mesh branch itself: tests/test_torch_mesh*.py)."""
    H, W, T, K, radius, Y, d = problem
    for build in (tstep.make_bg_projection, tstep.make_hals_iteration,
                  tstep.make_update_step):
        with pytest.raises(ValueError, match=f"H = {H}"):
            build(SimpleNamespace(n_patch=3, n_frame=1), H, W, T, radius)
        with pytest.raises(ValueError, match="mxu"):
            build(SimpleNamespace(n_patch=2, n_frame=2), H, W, T, radius,
                  mxu=True)
    back = step_state_to_numpy(step_state_from_numpy(d, device="cpu"))
    assert sorted(back) == sorted(d)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
