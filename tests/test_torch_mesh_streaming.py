"""``fit_streaming(mesh=...)`` of the port on a 2 x 2 mesh of gloo ranks.

``tests/test_streaming.py::test_streaming_mesh_shard_count_invariant``'s
store (48x48x600, blocks of 200 frames) and parameters: the mesh fit is
held to the port's single-process fit and to the JAX package's
single-device fit at that test's tolerances (equal n_active, A atol 5e-4,
C atol 5e-3 max(|C|, 1)). In the same spawn the fit runs again with
``T_CHUNK`` and ``QC_ROWS`` lowered for that run alone, so that the
temporal solve chunks its frames and the QC batches each rank's whole
traces, held at the same bars to the port's single-process fit with the
same constants; and the fit with an init proxy whose frames do not
divide over 'frame', or whose rows do not pool alone, raises a
ValueError naming ``init_budget_frames`` or ``init.ssub``. No rank calls
an object collective of torch.distributed, and no module of the port
pickles state. Two pieces of the mesh branch are checked in this process
too: the ring fit of a slab with a halo of rows against the fit of the
whole field of view, and the block upload of one rank's frames and rows.
The spawn has a 240 s deadline and every process group a 60 s timeout.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from cnmf_e_tpu.config import (BackgroundParams, CNMFEParams, InitParams,
                               MergeParams)
from cnmf_e_tpu.io.store import MovieStore as JaxStore
from cnmf_e_tpu.io.store import distribute_movie
from cnmf_e_tpu.models.streaming import fit_streaming as jax_fit_streaming
from cnmf_e_tpu.utils.simulate import simulate_movie
from cnmf_e_tpu_torch.convert import params_from_dict
from cnmf_e_tpu_torch.io.store import MovieStore
from cnmf_e_tpu_torch.models import streaming
from cnmf_e_tpu_torch.ops.ring import fit_ring_weights
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

FIT = dict(n_outer=2, init_budget_frames=300)
# T_CHUNK below T = 600 (each rank's 300 frames solve in chunks of 200 and
# 100) and QC_ROWS below K_max = 16 (one process tags 4 batches of 4, a
# patch rank its 8 whole traces in 2 batches of 4)
CHUNKS = dict(T_CHUNK=200, QC_ROWS=5)
# (name, params fields, fit keywords) of each indivisible init proxy:
# T = 600 at init_budget_frames = 70 is tsub = 9, 67 proxy frames; 24
# rows a patch rank at init.ssub = 5
PROXY_GUARDS = [("init_budget_frames", {}, dict(n_outer=1,
                                                init_budget_frames=70)),
                ("init.ssub", {"init.ssub": 5}, dict(n_outer=1))]


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """(mesh, port single, JAX single) fits of the store, as
    (n_active, A, C) of the active slots."""
    root = tmp_path_factory.mktemp("mesh_stream")
    gt = simulate_movie(seed=63, H=48, W=48, T=600, K=6, gSig=2.5,
                        sn=0.08, bg_strength=0.7, min_dist=12.0,
                        spike_rate=0.04)
    np.save(str(root / "m.npy"), gt.Y)
    distribute_movie(str(root / "m.npy"), str(root / "store"),
                     frames_per_block=200)
    params = CNMFEParams(
        init=InitParams(gSig=2.5, gSiz=8, min_corr=0.8, min_pnr=8.0,
                        max_neurons=16, seeds_per_round=8, max_rounds=4),
        background=BackgroundParams(model="ring", ring_radius=7),
        merge=MergeParams(dmin=4.0))
    pd = dataclasses.asdict(params)
    store = str(root / "store")
    ranks = spawn(_selftest.cases, 2, 2, device="cpu", args=([
        ("fit", "stream_case", (store, pd, FIT)),
        ("chunked", "stream_case", (store, pd, FIT, CHUNKS)),
        ("guards", "stream_guard_cases", (store, pd, PROXY_GUARDS))],),
        timeout=240, pg_timeout=60)
    port = streaming.fit_streaming(MovieStore(store), params_from_dict(pd),
                                   device="cpu", **FIT)
    saved = {k: getattr(streaming, k) for k in CHUNKS}
    try:
        for k, v in CHUNKS.items():
            setattr(streaming, k, v)
        chunked = streaming.fit_streaming(MovieStore(store),
                                          params_from_dict(pd),
                                          device="cpu", **FIT)
    finally:
        for k, v in saved.items():
            setattr(streaming, k, v)
    ref = jax_fit_streaming(JaxStore(store), params, **FIT)

    def active(A, C, act):
        n = int(act.sum())
        return n, (A * act[:, None, None])[:n], C[:n]

    def numpy_active(st):
        return active(st["A"], st["C"], st["active"])
    return dict(
        ranks=ranks,
        mesh=numpy_active(ranks[0]["fit"]["state"]),
        mesh_chunked=numpy_active(ranks[0]["chunked"]["state"]),
        port=active(port.A.numpy(), port.C.numpy(), port.active.numpy()),
        port_chunked=active(chunked.A.numpy(), chunked.C.numpy(),
                            chunked.active.numpy()),
        jax=active(np.asarray(ref.A), np.asarray(ref.C),
                   np.asarray(ref.active)))


def _held(got, want):
    n_m, A_m, C_m = got
    n_s, A_s, C_s = want
    assert n_m == n_s > 0
    np.testing.assert_allclose(A_m, A_s, atol=5e-4)
    np.testing.assert_allclose(C_m, C_s,
                               atol=5e-3 * max(np.abs(C_s).max(), 1.0))


@pytest.mark.parametrize("against", ["port", "jax"])
def test_streaming_mesh_matches_single_device(fits, against):
    _held(fits["mesh"], fits[against])


def test_streaming_mesh_qc_past_t_chunk(fits):
    """With T_CHUNK and QC_ROWS lowered, the mesh fit (frame-chunked
    temporal solves, the QC batching each patch rank's whole traces) is
    held to the single-process fit with the same constants."""
    _held(fits["mesh_chunked"], fits["port_chunked"])


def test_streaming_mesh_sends_no_pickled_state(fits):
    """No rank called an object collective of torch.distributed, in
    either fit."""
    for r in fits["ranks"]:
        assert r["fit"]["broadcasts"] == 0
        assert r["chunked"]["broadcasts"] == 0


def test_no_module_of_the_port_pickles_state():
    """No module of the port imports pickle or calls a collective of
    picklable objects: the mesh paths send tensors only. The spawn
    helper (``parallel/launch.py``) hands a run's arguments and results
    by file, and ``parallel/_selftest.py`` names the object collectives
    to count their calls."""
    root = pathlib.Path(streaming.__file__).parents[1]
    pattern = re.compile(r"\bimport pickle\b|\bpickle\.|broadcast_object|"
                         r"_object_list\b|\ball_gather_object\b|"
                         r"\bgather_object\b")
    skip = {root / "parallel" / "_selftest.py"}
    found = [f"{path.relative_to(root)}:{i}"
             for path in sorted(root.rglob("*.py")) if path not in skip
             for i, line in enumerate(path.read_text().splitlines(), 1)
             if pattern.search(line)]
    assert not found, found


@pytest.mark.parametrize("name", [n for n, _, _ in PROXY_GUARDS])
def test_indivisible_init_proxy_raises(fits, name):
    """The mesh init's proxy frames or pooled rows do not divide: every
    rank raises a ValueError naming the option that sets them."""
    for r in fits["ranks"]:
        msg = r["guards"][name]
        assert msg is not None and name in msg, msg


@pytest.mark.parametrize("p", [0, 1, 2])
def test_ring_fit_of_a_slab_with_halo(p):
    """The weights of a 12-row slab fitted from its rows plus a halo of
    the ring's reach, the halo zero outside the field of view, equal the
    whole field of view's fit at those pixels."""
    H, W, radius = 36, 20, 4
    reach = radius
    rng = np.random.default_rng(p)
    Bf = torch.tensor(rng.standard_normal((200, H, W)).astype(np.float32))
    full = fit_ring_weights(Bf, H, W, radius)
    h0, h1 = 12 * p, 12 * (p + 1)
    lo, hi = h0 - reach, h1 + reach
    pad = torch.nn.functional.pad(Bf, (0, 0, max(-lo, 0), max(hi - H, 0)))
    slab = pad[:, lo + max(-lo, 0):hi + max(-lo, 0)]
    got = fit_ring_weights(slab, slab.shape[1], W, radius,
                           rows=(reach, reach + 12),
                           fov_rows=(max(-lo, 0), min(H - lo, slab.shape[1])))
    np.testing.assert_allclose(got.w.numpy(), full.w[h0 * W:h1 * W].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.w0.numpy(),
                               full.w0[h0 * W:h1 * W].numpy(),
                               rtol=1e-5, atol=1e-6)


def test_prefetch_blocks_of_one_rank(tmp_path):
    """One rank's frames [150, 330) and rows [4, 10), whole, in sub-blocks
    and strided, are the same frames of the store."""
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((400, 12, 8)).astype(np.float32)
    np.save(str(tmp_path / "m.npy"), Y)
    distribute_movie(str(tmp_path / "m.npy"), str(tmp_path / "s"),
                     frames_per_block=100)
    store = MovieStore(str(tmp_path / "s"))
    want = Y[150:330, 4:10]
    kw = dict(frames=(150, 330), rows=(4, 10))
    for sub in (1, 3):
        got = list(streaming._prefetch_blocks(store, "cpu", sub_blocks=sub,
                                              **kw))
        assert [t0 for t0, _ in got][0] == 150
        np.testing.assert_array_equal(torch.cat([b for _, b in got]), want)

    def slicer(t0, blk):
        return np.ascontiguousarray(blk[(-t0) % 7::7])
    got = torch.cat([b for _, b in streaming._prefetch_blocks(
        store, "cpu", slicer=slicer, **kw)])
    np.testing.assert_array_equal(got, Y[154:330:7, 4:10])
