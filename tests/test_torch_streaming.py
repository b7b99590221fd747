"""``fit_streaming`` of the PyTorch port against the JAX package's.

Both packages stream the same simulated float16 store (48x48x600, blocks
of 200 frames, T below the 2304 past which the JAX package windows its
OASIS solve) on the CPU: the same neurons, footprints and traces matched
with correlation >= 0.99, equal QC tags. Each block program is held to its
JAX counterpart (rtol 1e-5), the block upload to the store's frames, and
each chunked branch, with its threshold lowered, to the unchunked fit.
``tests/test_torch_streaming_paths.py`` holds the ``init.ssub=2``, the
no-bootstrap and the resume paths.
"""

import dataclasses
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.io.store import MovieStore as JaxStore
from cnmf_e_tpu.models import streaming as jax_streaming
from cnmf_e_tpu.ops.ring import RingWeights as JaxRingWeights
from cnmf_e_tpu.utils.metrics import detection_f1
from cnmf_e_tpu.utils.simulate import simulate_movie_store
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.io.store import MovieStore, distribute_movie
from cnmf_e_tpu_torch.models import streaming
from cnmf_e_tpu_torch.models.qc import row_batches
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops.ring_kernels import ring_offsets
from cnmf_e_tpu_torch.utils.profiling import StageTimer

torch.set_num_threads(1)

STORE = dict(seed=3, H=48, W=48, T=600, K=7, gSig=2.5, sn=0.06,
             bg_strength=0.6, min_dist=12.0, spike_rate=0.04,
             frames_per_block=200)


def stream_params(**init):
    return CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=4,
                        **init),
        background=BackgroundParams(model="ring", ring_radius=7),
        merge=MergeParams(dmin=4.0))


def make_store(root):
    """The simulated store, once for each package (the JAX package's
    ``simulate_movie_store``; the port's copy writes the same bytes)."""
    simulate_movie_store(str(root), **STORE)
    return JaxStore(str(root)), MovieStore(str(root))


def fit_both(root, params, **kw):
    """(JAX state, port state) of fit_streaming on the store at ``root``,
    n_outer = 1 and a 300-frame init proxy unless ``kw`` says otherwise."""
    kw = dict(dict(n_outer=1, init_budget_frames=300), **kw)
    jstore, tstore = make_store(root)
    ref = jax_streaming.fit_streaming(jstore, params, **kw)
    port = streaming.fit_streaming(
        tstore, params_from_dict(dataclasses.asdict(params)),
        device="cpu", **kw)
    return ref, port


def assert_fits_match(ref, port):
    """Same n_active, footprints and traces matched slot by slot with
    correlation >= 0.99, equal tags."""
    n = int(port.n_active())
    assert n == int(ref.n_active()) > 0
    A_t = port.A[:n].numpy().reshape(n, -1)
    A_j = np.asarray(ref.A)[:n].reshape(n, -1)
    C_t, C_j = port.C[:n].numpy(), np.asarray(ref.C)[:n]
    assert C_t.shape == C_j.shape
    for k in range(n):
        assert np.corrcoef(A_t[k], A_j[k])[0, 1] >= 0.99, k
        assert np.corrcoef(C_t[k], C_j[k])[0, 1] >= 0.99, k
    np.testing.assert_array_equal(port.tags.numpy(), np.asarray(ref.tags))


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("stream")
    ref, port = fit_both(root / "store", stream_params())
    return root / "store", ref, port


def test_fit_streaming_matches_the_jax_package(fits):
    _, ref, port = fits
    assert port.C.shape[1] == STORE["T"]
    assert_fits_match(ref, port)


def test_fit_streaming_same_f1_against_ground_truth(fits):
    root, ref, port = fits
    gt = np.asarray(np.load(root / "ground_truth.npz")["A"], np.float32)
    n = int(port.n_active())
    f_t = detection_f1(port.A[:n].numpy(), gt)
    f_j = detection_f1(np.asarray(ref.A)[:n], gt)
    assert f_t["f1"] == f_j["f1"] >= 0.8


def test_fit_streaming_background_matches(fits):
    _, ref, port = fits
    np.testing.assert_allclose(port.b0.numpy(), np.asarray(ref.b0),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(port.W.w0.numpy(), np.asarray(ref.W.w0),
                               rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------------ #
# the chunked branches, each with its threshold lowered
# ------------------------------------------------------------------ #
LOWERED = {
    # 3 temporal solves; deconvolution in batches of 4 neurons and QC in
    # batches of 5 (both switch on past T_CHUNK, as does the post-spatial
    # snapshot)
    "frames": dict(T_CHUNK=250, DECONV_BYTES=600 * 4 * 4, DECONV_ALIGN=4,
                   QC_ROWS=5),
    # 5 spatial solves of 500 pixels (switch on past 2 * D_CHUNK)
    "pixels": dict(D_CHUNK=500),
}


def chunked_fit(root, lowered, snapshot_path=None):
    """The port's fit with the thresholds ``lowered``; returns (state,
    {stage: a copy of the snapshot as that stage wrote it}, its
    StageTimer)."""
    snaps = {}
    timer = StageTimer(device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        for name, value in lowered.items():
            mp.setattr(streaming, name, value)
        save = streaming._save_snapshot

        def keep_each(path, stage, *a, **kw):
            save(path, stage, *a, **kw)
            snaps[stage] = f"{path}.{stage}.npz"
            shutil.copy(path, snaps[stage])
        mp.setattr(streaming, "_save_snapshot", keep_each)
        state = streaming.fit_streaming(
            MovieStore(str(root)),
            params_from_dict(dataclasses.asdict(stream_params())),
            n_outer=1, init_budget_frames=300, device="cpu",
            snapshot_path=snapshot_path, timer=timer)
    return state, snaps, timer


@pytest.fixture(scope="module")
def frames_chunked(fits, tmp_path_factory):
    snap = str(tmp_path_factory.mktemp("chunked") / "snap.npz")
    return chunked_fit(fits[0], LOWERED["frames"], snap)


@pytest.mark.parametrize("lowered", sorted(LOWERED))
def test_chunked_branches_match_the_unchunked_fit(fits, request, lowered):
    _, _, port = fits
    chunked, _, timer = (request.getfixturevalue("frames_chunked")
                         if lowered == "frames"
                         else chunked_fit(fits[0], LOWERED[lowered]))
    # every stage timed once; a CPU fit uploads nothing
    assert timer.counts == dict.fromkeys(
        ("init", "noise", "bootstrap", "temporal", "ring_fit", "spatial",
         "qc_merge", "tags"), 1)
    n = int(port.n_active())
    assert int(chunked.n_active()) == n
    for k in ("A", "C", "C_raw", "S"):
        ref = getattr(port, k)[:n]
        np.testing.assert_allclose(getattr(chunked, k)[:n].numpy(),
                                   ref.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(ref.abs().max()),
                                   err_msg=k)
    np.testing.assert_array_equal(chunked.tags.numpy(), port.tags.numpy())


def test_resume_from_a_post_spatial_snapshot(fits, frames_chunked,
                                             tmp_path):
    """Past T_CHUNK the port writes a post-spatial snapshot (new A, traces,
    ring weights, b0, Ymean). Both packages resume it at QC/merge and
    agree."""
    jstore, tstore = JaxStore(str(fits[0])), MovieStore(str(fits[0]))
    _, snaps, _ = frames_chunked
    assert list(snaps) == ["init", "iter0_traces", "iter0_spatial", "iter0"]
    paths = [str(tmp_path / f"{who}.npz") for who in ("jax", "torch")]
    for p in paths:
        shutil.copy(snaps["iter0_spatial"], p)
    ref = jax_streaming.fit_streaming(jstore, stream_params(), n_outer=1,
                                      init_budget_frames=300,
                                      snapshot_path=paths[0])
    port = streaming.fit_streaming(
        tstore, params_from_dict(dataclasses.asdict(stream_params())),
        n_outer=1, init_budget_frames=300, snapshot_path=paths[1],
        device="cpu")
    assert_fits_match(ref, port)


def test_row_batches_are_near_equal_and_cover_every_row():
    for K, rows in ((2304, 640), (640, 640), (641, 640), (16, 4), (5, 64)):
        sl = row_batches(K, rows)
        sizes = [s.stop - s.start for s in sl]
        assert sl[0].start == 0 and sl[-1].stop == K
        assert all(a.stop == b.start for a, b in zip(sl, sl[1:]))
        assert max(sizes) <= rows and max(sizes) - min(sizes) <= max(sizes)
        # the JAX package's batch count and size
        Kb = -(-K // max(-(-K // rows), 1))
        assert sizes[0] == Kb


# ------------------------------------------------------------------ #
# block programs against the JAX package's (rtol 1e-5)
# ------------------------------------------------------------------ #
H, W, TB, K, RADIUS = 20, 24, 30, 5, 4


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(0)
    d = H * W
    R = ring_offsets(RADIUS).shape[0]
    return dict(
        Yb=(1.0 + rng.standard_normal((TB, H, W))).astype(np.float16),
        A_kd=np.clip(rng.standard_normal((K, d)), 0, None).astype(np.float32),
        C=np.abs(rng.standard_normal((K, TB))).astype(np.float32),
        b0=rng.random((H, W)).astype(np.float32),
        w=(0.02 * rng.standard_normal((d, R)) + 1.0 / R).astype(np.float32),
        w0=rng.standard_normal(d).astype(np.float32),
        U=rng.standard_normal((K, d)).astype(np.float32),
        Cg=rng.standard_normal((K, 11)).astype(np.float32))


def _close(ours, theirs):
    theirs = np.asarray(theirs)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5,
                               atol=1e-5 * max(np.abs(theirs).max(), 1.0))


def _t(x):
    return torch.as_tensor(x)


def test_block_temporal_U_raw(block):
    b = block
    ours = streaming._block_temporal_U_raw(_t(b["Yb"]), _t(b["A_kd"]))
    theirs = jax_streaming._block_temporal_U_raw(jnp.asarray(b["Yb"]),
                                                 jnp.asarray(b["A_kd"].T))
    for o, t in zip(ours, theirs):
        _close(o, t)


def test_ring_subtract_and_block_temporal_U_ring(block):
    b = block
    wt, jwt = (RingWeights(w=_t(b["w"]), w0=_t(b["w0"])),
               JaxRingWeights(w=jnp.asarray(b["w"]),
                              w0=jnp.asarray(b["w0"])))
    Yf = b["Yb"].astype(np.float32)
    _close(streaming._ring_subtract(_t(Yf), _t(b["A_kd"]), _t(b["C"]),
                                    _t(b["b0"]), wt, RADIUS, H, W),
           jax_streaming._ring_subtract(
               jnp.asarray(Yf), jnp.asarray(b["A_kd"].T),
               jnp.asarray(b["C"]), jnp.asarray(b["b0"]), jwt, RADIUS, H, W))
    _close(streaming._block_temporal_U_ring(
        _t(b["Yb"]), _t(b["A_kd"]), _t(b["C"]), _t(b["b0"]), wt, RADIUS, H,
        W),
        jax_streaming._block_temporal_U_ring(
            jnp.asarray(b["Yb"]), jnp.asarray(b["A_kd"].T),
            jnp.asarray(b["C"]), jnp.asarray(b["b0"]), jwt, RADIUS, H, W))


def test_block_spatial_U_accumulates_in_place(block):
    b = block
    U = _t(b["U"].copy())
    out = streaming._block_spatial_U(
        U, _t(b["Yb"]), _t(b["A_kd"]), _t(b["C"]), _t(b["b0"]),
        RingWeights(w=_t(b["w"]), w0=_t(b["w0"])), RADIUS, H, W)
    assert out.data_ptr() == U.data_ptr()
    theirs = jax_streaming._block_spatial_U(
        jnp.asarray(b["U"].T), jnp.asarray(b["Yb"]),
        jnp.asarray(b["A_kd"].T), jnp.asarray(b["C"]), jnp.asarray(b["b0"]),
        JaxRingWeights(w=jnp.asarray(b["w"]), w0=jnp.asarray(b["w0"])),
        RADIUS, H, W)
    _close(U, np.asarray(theirs).T)


@pytest.mark.parametrize("j0", [0, 3])
def test_block_Bf(block, j0):
    b = block
    Yb_s = b["Yb"][:8]
    Ymean = b["b0"] + 1.0
    _close(streaming._block_Bf(_t(Yb_s), _t(b["A_kd"]), _t(b["Cg"]),
                               _t(Ymean), j0),
           jax_streaming._block_Bf(jnp.asarray(Yb_s),
                                   jnp.asarray(b["A_kd"].T),
                                   jnp.asarray(b["Cg"]), jnp.asarray(Ymean),
                                   j0))


@pytest.mark.parametrize("t0,n,stride", [(0, 30, 7), (45, 30, 7),
                                         (64, 7, 1), (60, 20, 13)])
def test_interp_grid_traces(block, t0, n, stride):
    Cg = block["Cg"]
    _close(streaming._interp_grid_traces(_t(Cg), t0, n, stride),
           jax_streaming._interp_grid_traces(jnp.asarray(Cg), t0, n, stride))


# ------------------------------------------------------------------ #
# the block upload (CPU tensors: the store's frames as they are)
# ------------------------------------------------------------------ #
def test_prefetch_blocks_order_slicing_and_dtype(tmp_path):
    rng = np.random.default_rng(1)
    Y = rng.standard_normal((70, 8, 12)).astype(np.float16)
    root = tmp_path / "s"
    root.mkdir()
    for i in range(5):
        np.save(root / f"block_{i:05d}.npy", Y[16 * i:16 * (i + 1)])
    (root / "manifest.json").write_text(
        '{"shape": [70, 8, 12], "frames_per_block": 16, "source": '
        '"synthetic", "source_dtype": "float16"}')
    store = MovieStore(str(root))
    got = list(streaming._prefetch_blocks(store, "cpu"))
    assert [t0 for t0, _ in got] == [0, 16, 32, 48, 64]
    assert all(b.dtype == torch.float16 for _, b in got)
    np.testing.assert_array_equal(torch.cat([b for _, b in got]).numpy(), Y)
    got3 = list(streaming._prefetch_blocks(store, "cpu", sub_blocks=3))
    assert [t0 for t0, _ in got3] == sorted(t0 for t0, _ in got3)
    np.testing.assert_array_equal(torch.cat([b for _, b in got3]).numpy(), Y)
    stride = 5

    def slicer(t0, blk):
        return np.ascontiguousarray(blk[(-t0) % stride::stride])
    got_s = torch.cat([b for _, b in streaming._prefetch_blocks(
        store, "cpu", slicer=slicer)])
    np.testing.assert_array_equal(got_s.numpy(), Y[::stride])


def test_mesh_branch_is_not_ported(tmp_path):
    """The mesh branch is ported (tests/test_torch_mesh_streaming.py); a
    mesh that the store's H does not divide over raises a ValueError that
    names H."""
    np.save(str(tmp_path / "m.npy"), np.zeros((10, 5, 4), np.float32))
    store = distribute_movie(str(tmp_path / "m.npy"), str(tmp_path / "s"),
                             frames_per_block=5)
    with pytest.raises(ValueError, match="H = 5"):
        streaming.fit_streaming(
            store, mesh=SimpleNamespace(n_patch=2, n_frame=1, rank=0),
            device="cpu")
