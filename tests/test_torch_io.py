"""The port's data layer (``cnmf_e_tpu_torch/io``, ``checkpoint.py``,
``utils/profiling.py``) against the JAX package's.

Each case of ``tests/test_io.py`` runs through the port's copies, and the
files cross between the packages: a TIFF, AVI, movie store, export bundle
or ``RunLog`` snapshot written by one package is read by the other with
equal arrays. The h5py and cv2 cases skip where those packages are
missing, as ``test_io.py`` does.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

from cnmf_e_tpu.models.state import empty_state as jax_empty_state
from cnmf_e_tpu_torch.checkpoint import (RunLog, find_latest_run,
                                         restore_state)
from cnmf_e_tpu_torch.convert import state_from_numpy
from cnmf_e_tpu_torch.io.export import (load_results, save_results,
                                        save_results_mat, state_to_arrays)
from cnmf_e_tpu_torch.utils.profiling import (StageTimer, profiler_trace,
                                              timed)
from test_io import _write_tiff_compressed

torch.set_num_threads(1)

# (writer, reader): the port alone, then each way across
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


def _mod(pkg: str, name: str):
    return importlib.import_module(
        ("cnmf_e_tpu_torch." if pkg == "torch" else "cnmf_e_tpu.") + name)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_tiff_roundtrip(tmp_path, rng, writer, reader):
    movie = (rng.random((7, 33, 41)) * 1000).astype(np.uint16)
    p = str(tmp_path / "m.tif")
    _mod(writer, "io.tiff").write_tiff(p, movie)
    tiff = _mod(reader, "io.tiff")
    assert tiff.probe_tiff(p).shape == (7, 33, 41)
    np.testing.assert_array_equal(tiff.read_tiff(p), movie)
    np.testing.assert_array_equal(tiff.read_tiff(p, start=2, count=3),
                                  movie[2:5])


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_tiff_float32(tmp_path, rng, writer, reader):
    movie = rng.standard_normal((4, 16, 16)).astype(np.float32)
    p = str(tmp_path / "f.tif")
    _mod(writer, "io.tiff").write_tiff(p, movie)
    np.testing.assert_array_equal(_mod(reader, "io.tiff").read_tiff(p),
                                  movie)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_bigtiff_write_read_roundtrip(tmp_path, writer, reader):
    movie = np.random.default_rng(7).standard_normal(
        (5, 16, 20)).astype(np.float32)
    p = str(tmp_path / "big.tif")
    _mod(writer, "io.tiff").write_tiff(p, movie, bigtiff=True)
    with open(p, "rb") as f:
        assert f.read(4)[2] == 43            # BigTIFF magic
    tiff = _mod(reader, "io.tiff")
    assert tiff.probe_tiff(p).shape == (5, 16, 20)
    np.testing.assert_array_equal(tiff.read_tiff(p), movie)
    np.testing.assert_array_equal(tiff.read_tiff(p, 2, 2), movie[2:4])


@pytest.mark.parametrize("comp,strips,predictor", [
    (5, 2, 1), (8, 2, 1), (32773, 2, 1), (5, 3, 2)],
    ids=["lzw", "deflate", "packbits", "lzw_predictor"])
def test_tiff_compressed_roundtrip(tmp_path, comp, strips, predictor):
    """LZW / Deflate / PackBits, multi-strip, horizontal predictor: the
    port decodes them exactly, as the JAX reader does."""
    from cnmf_e_tpu.io.tiff import read_tiff as jax_read
    from cnmf_e_tpu_torch.io.tiff import read_tiff
    movie = np.random.default_rng(5).integers(
        0, 4000, (4, 30, 17)).astype(np.uint16)
    p = str(tmp_path / f"c{comp}.tif")
    _write_tiff_compressed(p, movie, comp, strips_per_frame=strips,
                           predictor=predictor)
    out = read_tiff(p)
    np.testing.assert_array_equal(out, movie)
    np.testing.assert_array_equal(out, jax_read(p))


def test_tiff_multistrip_uncompressed(tmp_path):
    from cnmf_e_tpu_torch.io.tiff import read_tiff
    movie = np.random.default_rng(6).standard_normal(
        (3, 25, 12)).astype(np.float32)
    p = str(tmp_path / "ms.tif")
    _write_tiff_compressed(p, movie, 1, strips_per_frame=4)
    np.testing.assert_array_equal(read_tiff(p), movie)


def test_hdf5_and_npy(tmp_path, rng):
    from cnmf_e_tpu_torch.io.movie import load_movie, probe_movie
    h5py = pytest.importorskip("h5py")
    movie = rng.standard_normal((9, 12, 15)).astype(np.float32)
    hp = str(tmp_path / "m.h5")
    with h5py.File(hp, "w") as f:
        f.create_dataset("mov", data=movie)
    assert probe_movie(hp)[0] == (9, 12, 15)
    np.testing.assert_allclose(load_movie(hp, 3, 4), movie[3:7])
    np_path = str(tmp_path / "m.npy")
    np.save(np_path, movie)
    assert probe_movie(np_path) == ((9, 12, 15), np.float32)
    np.testing.assert_array_equal(load_movie(np_path), movie)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_avi_roundtrip(tmp_path, rng, writer, reader):
    movie = (rng.random((5, 24, 31)) * 255).astype(np.uint8)
    p = str(tmp_path / "m.avi")
    _mod(writer, "io.avi").write_avi(p, movie)
    assert _mod(reader, "io.movie").probe_movie(p)[0] == (5, 24, 31)
    np.testing.assert_array_equal(_mod(reader, "io.avi").read_avi(p), movie)
    np.testing.assert_array_equal(
        _mod(reader, "io.movie").load_movie(p, 1, 2), movie[1:3])


def test_mjpeg_avi_decode(tmp_path):
    """An MJPEG AVI decodes per chunk with random access, frame for frame
    as the JAX reader decodes it."""
    cv2 = pytest.importorskip("cv2")
    from cnmf_e_tpu.io.avi import read_avi as jax_read
    from cnmf_e_tpu_torch.io.avi import probe_avi, read_avi
    rng = np.random.default_rng(8)
    H, W, T = 48, 64, 6
    base = rng.integers(60, 200, (H // 8, W // 8)).astype(np.uint8)
    movie = np.stack([
        np.clip(cv2.resize(base, (W, H), interpolation=cv2.INTER_CUBIC
                           ).astype(np.int16) + 5 * t, 0, 255
                ).astype(np.uint8) for t in range(T)])
    p = str(tmp_path / "m.avi")
    vw = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (W, H),
                         isColor=False)
    assert vw.isOpened()
    for t in range(T):
        vw.write(movie[t])
    vw.release()
    info = probe_avi(p)
    assert info.codec == "mjpeg" and info.shape == (T, H, W)
    out = read_avi(p)
    assert np.abs(out.astype(np.float64) - movie).mean() < 4.0
    np.testing.assert_array_equal(out, jax_read(p))
    np.testing.assert_array_equal(read_avi(p, 3, 2), out[3:5])


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_distribute_movie_and_store(tmp_path, rng, writer, reader):
    """A store written by one package opens in the other: the manifest,
    the blocks and the noise cache."""
    movie = rng.standard_normal((25, 10, 11)).astype(np.float32)
    src = str(tmp_path / "m.npy")
    np.save(src, movie)
    root = str(tmp_path / "store")
    w = _mod(writer, "io.store")
    w.distribute_movie(src, root, frames_per_block=10).save_noise(
        np.ones((10, 11)))
    r = _mod(reader, "io.store")
    store = r.MovieStore(root)
    assert store.shape == (25, 10, 11) and store.n_blocks() == 3
    np.testing.assert_array_equal(store.read_frames(8, 10), movie[8:18])
    np.testing.assert_array_equal(np.concatenate(list(store.iter_blocks())),
                                  movie)
    np.testing.assert_array_equal(store.load_noise(), np.ones((10, 11)))
    # the reader reuses the writer's store instead of rewriting it
    mtime = os.path.getmtime(os.path.join(root, "block_00000.npy"))
    again = r.distribute_movie(src, root, frames_per_block=10)
    assert again.shape == (25, 10, 11)
    assert os.path.getmtime(os.path.join(root, "block_00000.npy")) == mtime


def _state_dict(K=8, H=16, W=16, T=50, n=3):
    rng = np.random.default_rng(4)
    A = np.zeros((K, H, W), np.float32)
    A[:n, 4:8, 4:8] = rng.random((n, 4, 4)).astype(np.float32)
    C = np.zeros((K, T), np.float32)
    C[:n] = rng.random((n, T)).astype(np.float32)
    active = np.zeros(K, bool)
    active[:n] = True
    return dict(A=A, C=C, C_raw=C + 0.5, S=C * 0.1,
                g=np.full((K, 1), 0.9, np.float32),
                neuron_sn=np.arange(K, dtype=np.float32),
                b0=rng.random((H, W)).astype(np.float32),
                tags=np.arange(K, dtype=np.int32), active=active,
                ring_w=rng.random((H * W, 12)).astype(np.float32),
                ring_w0=rng.random(H * W).astype(np.float32))


def _jax_state(d):
    import jax.numpy as jnp
    from cnmf_e_tpu.ops.ring import RingWeights
    K, H, W = d["A"].shape
    st = jax_empty_state(K, H, W, d["C"].shape[1])
    return st.replace(**{k: jnp.asarray(d[k]) for k in
                         ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0",
                          "tags", "active")},
                      W=RingWeights(w=jnp.asarray(d["ring_w"]),
                                    w0=jnp.asarray(d["ring_w0"])))


def test_export_roundtrip_and_keys_match_the_jax_package(tmp_path):
    from cnmf_e_tpu.io.export import load_results as jax_load
    from cnmf_e_tpu.io.export import state_to_arrays as jax_arrays
    d = _state_dict()
    st = state_from_numpy(d, device="cpu")
    ours, theirs = state_to_arrays(st), jax_arrays(_jax_state(d))
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    p = save_results(str(tmp_path / "res"), st)
    data = load_results(p)
    assert data["A"].shape == (3, 16, 16) and data["C"].shape == (3, 50)
    for k, v in jax_load(p).items():
        np.testing.assert_array_equal(data[k], v, err_msg=k)
    import scipy.io
    mat = scipy.io.loadmat(save_results_mat(str(tmp_path / "res"), st))
    assert mat["A"].shape == (256, 3)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_runlog_snapshot_restores_across_packages(tmp_path, writer,
                                                  reader):
    """A RunLog snapshot written by one package restores in the other with
    equal arrays: how state crosses between the two."""
    from cnmf_e_tpu.config import CNMFEParams as JaxParams
    from cnmf_e_tpu_torch.config import CNMFEParams
    d = _state_dict()
    ck = _mod(writer, "checkpoint")
    if writer == "torch":
        log = ck.RunLog(str(tmp_path), params=CNMFEParams.preset_1p())
        p = log.snapshot("init", state_from_numpy(d, device="cpu"))
    else:
        log = ck.RunLog(str(tmp_path), params=JaxParams.preset_1p())
        p = log.snapshot("init", _jax_state(d))
    log.log("hello")
    assert log.latest_snapshot() == p
    with open(os.path.join(log.dir, "params.json")) as f:
        assert json.load(f) == json.loads(CNMFEParams.preset_1p().to_json())
    if reader == "torch":
        st = restore_state(p, K_max=16, H=16, W=16, T=50, device="cpu")
        got = {k: getattr(st, k).numpy() for k in
               ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0", "active")}
        got.update(ring_w=st.W.w.numpy(), ring_w0=st.W.w0.numpy())
    else:
        st = _mod("jax", "checkpoint").restore_state(p, K_max=16, H=16, W=16,
                                                     T=50)
        got = {k: np.asarray(getattr(st, k)) for k in
               ("A", "C", "C_raw", "S", "g", "neuron_sn", "b0", "active")}
        got.update(ring_w=np.asarray(st.W.w), ring_w0=np.asarray(st.W.w0))
    n = int(d["active"].sum())
    assert got["A"].shape == (16, 16, 16) and got["active"].sum() == n
    for k in ("A", "C", "C_raw", "S", "g", "neuron_sn"):
        np.testing.assert_array_equal(got[k][:n], d[k][:n], err_msg=k)
        # free slots as empty_state leaves them
        free = np.float32(0.9 if k == "g" else 0.0)
        np.testing.assert_array_equal(got[k][n:], free, err_msg=k)
    for k in ("b0", "ring_w", "ring_w0"):
        np.testing.assert_array_equal(got[k], d[k], err_msg=k)
    with open(log.log_path) as f:
        text = f.read()
    assert "hello" in text and "snapshot" in text


def test_restore_state_refuses_a_snapshot_over_capacity(tmp_path):
    p = save_results(str(tmp_path / "s"), state_from_numpy(
        _state_dict(), device="cpu"))
    with pytest.raises(ValueError, match="capacity"):
        restore_state(p, K_max=2, H=16, W=16, T=50, device="cpu")


def test_find_latest_run(tmp_path):
    assert find_latest_run(str(tmp_path)) is None
    RunLog(str(tmp_path), run_name="RUN_20200101_000000")
    b = RunLog(str(tmp_path), run_name="RUN_20210101_000000")
    assert find_latest_run(str(tmp_path)) == b.dir


def test_stage_timer_sums_stages_and_added_times():
    timer = StageTimer(device="cpu")
    for _ in range(2):
        with timer.stage("noise"):
            torch.ones(3).sum()
    with timer.stage("merge"):
        pass
    timer.add("upload", 0.25, count=3, nbytes=1000)
    assert timer.counts == {"noise": 2, "merge": 1, "upload": 3}
    assert timer.times["upload"] == 0.25 and timer.bytes["upload"] == 1000
    assert all(v >= 0 for v in timer.times.values())
    assert "noise" in timer.report()


def test_timed_without_a_timer_and_profiler_trace(tmp_path):
    with timed(None, "noise"):
        pass
    with profiler_trace(str(tmp_path / "tr"), device="cpu"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_fit_run_log_resume_and_timer(tmp_path):
    """CNMFE.fit writes the JAX package's stage snapshots and logs, times
    the JAX package's stage names, and resumes from its own snapshot."""
    from cnmf_e_tpu_torch.config import (BackgroundParams, CNMFEParams,
                                         InitParams)
    from cnmf_e_tpu_torch.models.pipeline import CNMFE
    from cnmf_e_tpu_torch.utils.simulate import simulate_movie
    gt = simulate_movie(seed=2, H=24, W=24, T=120, K=3, gSig=2.0, sn=0.05,
                        min_dist=8.0, spike_rate=0.05)
    p = CNMFEParams(init=InitParams(gSig=2.0, gSiz=7, max_neurons=6,
                                    seeds_per_round=4, max_rounds=2),
                    background=BackgroundParams(ring_radius=5, ssub=2))
    log = RunLog(str(tmp_path), params=p)
    timer = StageTimer(device="cpu")
    st = CNMFE(p, device="cpu").fit(gt.Y, n_outer=1, run_log=log,
                                    timer=timer)
    snaps = sorted(os.listdir(log.dir))
    assert any("_init_" in s for s in snaps)
    assert any("_final_" in s for s in snaps)
    assert set(timer.times) == {"scrub", "noise", "init", "merge",
                                "background", "residual_pick", "spatial",
                                "temporal", "qc"}
    st2 = CNMFE(p, device="cpu").fit(gt.Y, n_outer=1,
                                     resume_from=log.latest_snapshot())
    assert abs(int(st2.n_active()) - int(st.n_active())) <= 1
    with open(log.log_path) as f:
        assert "init:" in f.read()
