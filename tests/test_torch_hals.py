"""HALS sweeps in the PyTorch port vs the JAX package.

The port's HALS kernel runs here as its plain PyTorch version (CPU
tensors). It is held against the JAX kernel it replaces
(``hals_sweeps_rows_pallas`` in interpret mode) at rtol/atol 2e-5, and
against the float64 sequential Gauss-Seidel oracle of
``tests/test_pallas_hals.py`` at 2e-4, for the spatial (relu + mask) and
temporal (gate) calls with the colored class schedule; at 2e-5 (1 + |x|)
across the schedules the CUDA kernel tells apart (free class steps, the
in-order block grid, the overflow fallback that mixes both; K from 1 to
192, d from 50 to 3050, gate zeros, mask on and off); the full
``hals_spatial``/``hals_temporal`` updates against the JAX functions with
``colored=True``, the only order the port runs. The identity the CUDA
kernel's compacted body rests on (a masked call, column tile by column
tile, equals the same sweeps on only the tile's active rows, each step cut
to them) is held on the plain version at 1e-5 (1 + |x|); and the kernel
names stay readable by the benchmark's ``kernels_ms``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.metrics.kernels_ms import stems
from cnmf_e_tpu.ops import coloring as jax_coloring
from cnmf_e_tpu.ops import hals as jax_hals
from cnmf_e_tpu.ops.pallas_hals import hals_sweeps_rows_pallas
from cnmf_e_tpu_torch import cuda_build
from cnmf_e_tpu_torch.ops import coloring, hals_kernels
from cnmf_e_tpu_torch.ops.hals import hals_spatial, hals_temporal
from cnmf_e_tpu_torch.ops.hals_kernels import (_rows_per_step, _step_rows,
                                               block_grid_schedule,
                                               hals_sweeps_reference)
from tests.test_pallas_hals import _gs_oracle

torch.set_num_threads(1)


def _blobs(rng, K, H, W, sig=2.0):
    cy, cx = rng.uniform(0, H, K), rng.uniform(0, W, K)
    yy, xx = np.mgrid[0:H, 0:W]
    A = np.exp(-((yy[None] - cy[:, None, None]) ** 2
                 + (xx[None] - cx[:, None, None]) ** 2) / (2 * sig ** 2))
    return np.where(A > 0.05, A, 0.0).astype(np.float32)


def _spatial_problem(seed, K=20, H=24, W=24, T=120):
    rng = np.random.default_rng(seed)
    A = _blobs(rng, K, H, W)
    C = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    Y = (A.reshape(K, -1).T @ C
         + 0.1 * rng.standard_normal((H * W, T))).astype(np.float32)
    A0 = np.maximum(A * (1 + 0.3 * rng.standard_normal(A.shape)), 0)
    dil = np.zeros_like(A0, bool)
    sup = A0 > 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dil |= np.roll(np.roll(sup, dy, 1), dx, 2)
    mask = dil.reshape(K, -1)
    Cc = C - C.mean(1, keepdims=True)
    U = (Y @ Cc.T).T.astype(np.float32)                     # (K, d)
    V = (Cc @ Cc.T).astype(np.float32)
    return U, V, A0.reshape(K, -1).astype(np.float32), mask, Y, C


def _colored_rows(mask_or_adj, *arrays, adjacency=False):
    adj = (mask_or_adj if adjacency
           else np.asarray(jax_coloring.overlap_adjacency(
               jnp.asarray(mask_or_adj))))
    colors = np.asarray(jax_coloring.greedy_color(jnp.asarray(adj)))
    order = np.argsort(colors, kind="stable")
    sched = jax_coloring.class_step_schedule(jnp.asarray(colors[order]),
                                             block=64)
    return order, sched


def _sched_torch(sched):
    return tuple(torch.tensor(np.asarray(x)) for x in sched)


@pytest.mark.parametrize("seed", [0, 1])
def test_spatial_plain_matches_pallas_and_oracle(seed):
    U, V, X, mask, _, _ = _spatial_problem(seed)
    order, sched = _colored_rows(mask)
    U, X, mask = U[order], X[order], mask[order]
    V = V[order][:, order]
    K = X.shape[0]
    want = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        gate=jnp.ones(K), mask=jnp.asarray(mask), n_iter=4, block=64,
        relu=True, schedule=sched, interpret=True))
    got = hals_sweeps_reference(
        torch.tensor(U), torch.tensor(V), torch.tensor(X), torch.ones(K),
        _sched_torch(sched), mask=torch.tensor(mask), n_iter=4, block=64,
        relu=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    oracle = _gs_oracle(U.T, V, np.where(mask, X, 0).T, n_iter=4,
                        relu=True, mask=mask.T).T
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_temporal_plain_matches_pallas_and_oracle(seed):
    rng = np.random.default_rng(10 + seed)
    K, H, W, T = 16, 20, 20, 150
    A = _blobs(rng, K, H, W).reshape(K, -1)
    Y = rng.standard_normal((H * W, T)).astype(np.float32)
    C0 = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    U = (A @ Y).astype(np.float32)
    V = (A @ A.T).astype(np.float32)
    gate = rng.random(K) > 0.2
    adj = (V != 0) & ~np.eye(K, dtype=bool)
    order, sched = _colored_rows(adj, adjacency=True)
    U, C0, gate = U[order], C0[order], gate[order]
    V = V[order][:, order]
    want = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(C0),
        gate=jnp.asarray(gate), n_iter=4, block=64, relu=False,
        schedule=sched, interpret=True))
    got = hals_sweeps_reference(
        torch.tensor(U), torch.tensor(V), torch.tensor(C0),
        torch.tensor(gate), n_iter=4, block=64, relu=False,
        schedule=_sched_torch(sched)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    oracle = _gs_oracle(U.T, V, C0.T, n_iter=4, relu=False, gate=gate).T
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


def test_overflowing_schedule_falls_back_to_block_grid():
    """More classes than the step capacity: the fallback schedule (plain
    blocks, free only where no class boundary crosses) still solves
    exactly."""
    U, V, X, mask, _, _ = _spatial_problem(3)
    K = X.shape[0]
    colors = np.arange(K, dtype=np.int32)            # every row its class
    sched_j = jax_coloring.class_step_schedule(jnp.asarray(colors), block=8,
                                               n_cap=4)
    sched_t = coloring.class_step_schedule(torch.tensor(colors), block=8,
                                           n_cap=4)
    for a, b in zip(sched_t, sched_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = hals_sweeps_reference(torch.tensor(U), torch.tensor(V),
                                torch.tensor(X), torch.ones(K), sched_t,
                                mask=torch.tensor(mask), n_iter=2, block=8,
                                relu=True).numpy()
    oracle = _gs_oracle(U.T, V, np.where(mask, X, 0).T, n_iter=2,
                        relu=True, mask=mask.T).T
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [4, 5])
def test_hals_spatial_colored_matches_jax(seed):
    _, _, X, mask, Y, C = _spatial_problem(seed)
    want = np.asarray(jax_hals.hals_spatial(
        jnp.asarray(Y), jnp.asarray(X.T), jnp.asarray(C),
        mask=jnp.asarray(mask.T), n_iter=5, colored=True))
    got = hals_spatial(torch.tensor(Y), torch.tensor(X.T), torch.tensor(C),
                       mask=torch.tensor(mask.T), n_iter=5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("all_active", [False, True])
def test_hals_temporal_matches_jax(all_active):
    rng = np.random.default_rng(5)
    K, H, W, T = 14, 20, 20, 130
    A = _blobs(rng, K, H, W).reshape(K, -1)
    Y = (A.T @ np.abs(rng.standard_normal((K, T)))
         + 0.1 * rng.standard_normal((H * W, T))).astype(np.float32)
    C0 = np.abs(rng.standard_normal((K, T))).astype(np.float32)
    active = rng.random(K) > (-1.0 if all_active else 0.2)
    Cj, aaj = jax_hals.hals_temporal(
        jnp.asarray(Y), jnp.asarray(A.T), jnp.asarray(C0), n_iter=4,
        active=jnp.asarray(active), colored=True)
    Ct, aat = hals_temporal(torch.tensor(Y), torch.tensor(A.T),
                            torch.tensor(C0), n_iter=4,
                            active=torch.tensor(active))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(aat.numpy(), np.asarray(aaj), rtol=1e-5)


@pytest.mark.parametrize("K,d,kind,masked,gate_zeros", [
    (1, 50, "coloured", True, False),
    (5, 2000, "block grid", False, True),
    (5, 3050, "coloured", True, True),
    (37, 3050, "overflow", True, True),
    (37, 50, "block grid", True, False),
    (192, 2000, "coloured", False, True),
    (192, 50, "overflow", True, False),
    (192, 3050, "block grid", False, False),
])
def test_plain_matches_pallas_across_schedules(K, d, kind, masked,
                                               gate_zeros):
    """The plain version against the JAX kernel in interpret mode at
    2e-5 (1 + |x|), on each schedule kind: class steps of up to 64 rows
    (free), the in-order block grid of 16 rows, and the overflow fallback,
    whose 8-row blocks are free only inside one class."""
    rng = np.random.default_rng(K * 31 + d)
    X = (np.maximum(rng.standard_normal((K, d)), 0)
         * (rng.random((K, d)) < 0.2)).astype(np.float32)
    mask = (rng.random((K, d)) < 0.3) | (X > 0) if masked else None
    F = rng.standard_normal((K, 32)).astype(np.float32)
    V = (F @ F.T / 32 + np.eye(K)).astype(np.float32)
    U = rng.standard_normal((K, d)).astype(np.float32)
    gate = np.ones(K, bool)
    if gate_zeros:
        gate[::3] = False
    relu = masked or kind == "overflow"
    if kind == "block grid":
        block, sched_j = 16, None
        sched_t = block_grid_schedule(K, block, torch.device("cpu"))
    else:
        block = 64 if kind == "coloured" else 8
        classes = (np.arange(K) * 3 // K if kind == "coloured"
                   else np.arange(K) // 12).astype(np.int32)
        sched_j = jax_coloring.class_step_schedule(
            jnp.asarray(classes), block=block,
            n_cap=2 if kind == "overflow" else None)
        sched_t = _sched_torch(sched_j)
        if kind == "overflow" and K > 24:
            free = np.asarray(sched_j[2])[:int(sched_j[3])]
            assert 0 < free.sum() < len(free)       # both kinds of step
    want = np.asarray(hals_sweeps_rows_pallas(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(X),
        gate=jnp.asarray(gate),
        mask=None if mask is None else jnp.asarray(mask), n_iter=3,
        block=block, relu=relu, schedule=sched_j, interpret=True))
    got = hals_sweeps_reference(
        torch.tensor(U), torch.tensor(V), torch.tensor(X),
        torch.tensor(gate), sched_t,
        mask=None if mask is None else torch.tensor(mask), n_iter=3,
        block=block, relu=relu).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def _tile_by_tile(U, V, X, gate, sched, mask, n_iter, block, TD):
    """The masked sweeps as the compacted body runs them: per tile of TD
    columns, the plain version on the rows whose mask touches the tile
    (ascending), with each schedule step cut to those rows; every other
    row 0."""
    K, d = X.shape
    steps = _step_rows(sched, K, _rows_per_step(K, block))
    out = torch.zeros_like(X)
    for t0 in range(0, d, TD):
        cols = slice(t0, min(t0 + TD, d))
        act = torch.nonzero(mask[:, cols].any(dim=1)).flatten()
        if len(act) == 0:
            continue
        sub = [(ia, ib, fr) for lo, hi, fr in steps
               for ia, ib in [(int(torch.searchsorted(act, lo)),
                               int(torch.searchsorted(act, max(hi, lo))))]
               if ia < ib]
        i32 = dict(dtype=torch.int32)
        sub_sched = (torch.tensor([s[0] for s in sub], **i32),
                     torch.tensor([s[1] for s in sub], **i32),
                     torch.tensor([s[2] for s in sub], **i32),
                     torch.tensor(len(sub), **i32))
        # block = the active-row count: one window holds them all, so a
        # step covers exactly [ia, ib)
        out[act, cols] = hals_sweeps_reference(
            U[act, cols], V[act][:, act], X[act, cols], gate[act],
            sub_sched, mask[act, cols], n_iter=n_iter, block=len(act),
            relu=True)
    return out


@pytest.mark.parametrize("TD,d,kind,gate_zeros", [
    (16, 117, "coloured", False),
    (64, 117, "coloured", True),
    (32, 117, "block grid", True),
    (64, 203, "mixed", True),
    (16, 203, "overlapping", True),
    (32, 300, "overlapping", False),
])
def test_masked_sweeps_equal_tile_by_tile_on_active_rows(TD, d, kind,
                                                        gate_zeros):
    """Column c of V_k X reads only column c of X, and a row whose mask
    misses a tile is 0 there before and after, so per tile only the
    active rows matter. Held on the coloured schedule (classes from the
    mask overlaps), the in-order block grid, the overflow schedule that
    mixes free and in-order 8-row steps, and free steps whose rows share
    mask pixels (classes that ignore the overlaps: the snapshot rule);
    with gate zeros and a row whose V_kk is 0; ragged last tiles."""
    K = 40
    rng = np.random.default_rng(TD * 1000 + d)
    # each row's support: a window of 12-28 columns and a few pixels
    mask = np.zeros((K, d), bool)
    for k in range(K):
        a = rng.integers(0, d - 12)
        mask[k, a:a + rng.integers(12, 29)] = True
        mask[k, rng.integers(0, d, 2)] = True
    X = (np.maximum(rng.standard_normal((K, d)), 0) * mask
         ).astype(np.float32)
    F = rng.standard_normal((K, 32)).astype(np.float32)
    V = (F @ F.T / 32 + np.eye(K)).astype(np.float32)
    U = (rng.standard_normal((K, d)) + 0.5).astype(np.float32)
    gate = np.ones(K, np.float32)
    if gate_zeros:
        gate[::3] = 0.0
        V[7, :] = V[:, 7] = 0.0                     # V_kk = 0: frozen
    if kind == "coloured":
        adj = coloring.overlap_adjacency(torch.tensor(mask))
        colors = coloring.greedy_color(adj)
        order = torch.argsort(colors, stable=True).numpy()
        U, V, X, mask, gate = (U[order], V[order][:, order], X[order],
                               mask[order], gate[order])
        block = 64
        sched = coloring.class_step_schedule(colors[order], block=block)
    elif kind == "block grid":
        block = 16
        sched = block_grid_schedule(K, block, torch.device("cpu"))
    elif kind == "mixed":
        block = 8
        sched = coloring.class_step_schedule(
            torch.arange(K, dtype=torch.int32) // 12, block=block, n_cap=2)
        free = sched[2][:int(sched[3])]
        assert 0 < int(free.sum()) < len(free)      # both kinds of step
    else:
        block = 64
        sched = coloring.class_step_schedule(
            (torch.arange(K) * 3 // K).to(torch.int32), block=block)
    args = [torch.tensor(a) for a in (U, V, X, gate)]
    want = hals_sweeps_reference(*args, sched, mask=torch.tensor(mask),
                                 n_iter=3, block=block, relu=True)
    got = _tile_by_tile(*args, sched, torch.tensor(mask), 3, block, TD)
    assert bool((want[~torch.tensor(mask)] == 0).all())
    assert bool(((got - want).abs() <= 1e-5 * (1 + want.abs())).all())
    if kind == "overlapping":
        # some free step holds rows that share a mask pixel
        K_ = len(mask)
        steps = _step_rows(sched, K_, _rows_per_step(K_, block))
        assert any(fr and (mask[lo:hi].sum(0) > 1).any()
                   for lo, hi, fr in steps)


def test_kernel_names_stay_readable_by_kernels_ms():
    """``kernels_ms`` matches device kernel names by substring against the
    stems of ``cuda_build.KERNELS`` and counts launches from ``LAUNCHES``:
    no stem may hold another, every kernel needs a count, and every
    kernel of csrc/ carries exactly one stem."""
    st = list(stems(cuda_build.KERNELS))
    assert [a for a in st for b in st if a != b and a in b] == []
    assert set(cuda_build.KERNELS) <= set(cuda_build.LAUNCHES)
    names = []
    for src in sorted(cuda_build.CSRC.glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+__launch_bounds__"
                            r"\([^)]*\)\s*(\w+)", src.read_text())
    assert len(names) >= 8
    assert [n for n in names if sum(s in n for s in st) != 1] == []


def test_compact_capacity_matches_the_kernel():
    """``hals_kernels.COMPACT_ROWS`` is the kernel's kCap: the capacity
    ``chip_smoke.py`` builds its at-capacity tile from."""
    src = (cuda_build.CSRC / "hals_sweeps.cu").read_text()
    cap = re.search(r"constexpr int kCap = (\d+);", src)
    assert cap and int(cap.group(1)) == hals_kernels.COMPACT_ROWS >= 64
