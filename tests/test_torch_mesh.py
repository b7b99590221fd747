"""The port's (patch, frame) mesh on gloo ranks against the JAX package.

One spawn of 4 x 2 CPU ranks (``cnmf_e_tpu_torch.parallel.launch.spawn``,
rank bodies in ``cnmf_e_tpu_torch/parallel/_selftest.py``) runs every case
of this file: the update step and the coloured step on
``tests/test_sharding.py``'s problem, held to the JAX single-device step
and to the JAX step on its own 4 x 2 mesh at that file's tolerances (A
atol 2e-4, C and S 2e-3); the sharded ring apply with a halo that spans
two slabs; each rank's block against JAX's ``devices_indices_map``; the
multi-host ingest of ``tests/test_multihost.py`` (a direct load, a ragged
T, the step on the ingested movie); and the ValueErrors of indivisible
shapes and ``mxu=True``. The spawn has a 120 s deadline and every
process group a 60 s timeout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from cnmf_e_tpu.io.store import distribute_movie
from cnmf_e_tpu.ops.ring import ring_offsets
from cnmf_e_tpu.parallel.mesh import make_mesh
from cnmf_e_tpu.parallel.step import StepState, make_update_step
from cnmf_e_tpu_torch.models.state import RingWeights
from cnmf_e_tpu_torch.ops.ring import apply_ring
from cnmf_e_tpu_torch.parallel import _selftest
from cnmf_e_tpu_torch.parallel.launch import spawn
from cnmf_e_tpu_torch.parallel.multihost import init_distributed

N_PATCH, N_FRAME = 4, 2
H, W, T, K, RADIUS = 32, 16, 128, 8, 3          # tests/test_sharding.py
HALO = dict(H=16, W=12, T=6, radius=6)          # 4-row slabs, 6-row halo
INGEST = dict(T=100, H=16, W=32, K=4, radius=3)  # tests/test_multihost.py


def _step_inputs(colored: bool):
    """``tests/test_sharding.py``'s movie and state (its rng fixture's
    draws, in its order); the coloured case keeps compact supports."""
    rng = np.random.default_rng(0)
    R = ring_offsets(RADIUS).shape[0]
    Y = (rng.standard_normal((T, H, W)) * 0.1 + 1.0).astype(np.float32)
    A = np.abs(rng.standard_normal((K, H, W))).astype(np.float32)
    if colored:
        A = np.where(A > 0.5, A, 0.0).astype(np.float32)
    d = dict(A=A, C=np.abs(rng.standard_normal((K, T))).astype(np.float32),
             C_raw=np.zeros((K, T), np.float32),
             S=np.zeros((K, T), np.float32),
             g=np.full((K,), 0.9, np.float32),
             b0=np.zeros((H, W), np.float32),
             ring_w=np.full((H * W, R), 0.01, np.float32),
             ring_w0=np.zeros((H * W,), np.float32))
    return Y, d


def _halo_inputs():
    rng = np.random.default_rng(4)
    h, w, t, r = HALO["H"], HALO["W"], HALO["T"], HALO["radius"]
    R = ring_offsets(r).shape[0]
    return (rng.standard_normal((t, h, w)).astype(np.float32),
            rng.standard_normal((h * w, R)).astype(np.float32),
            rng.standard_normal((h * w,)).astype(np.float32))


def _store(root, T_):
    rng = np.random.default_rng(7)
    Y = rng.standard_normal((T_, INGEST["H"], INGEST["W"])).astype(np.float32)
    np.save(str(root / "mov.npy"), Y)
    distribute_movie(str(root / "mov.npy"), str(root / "store"),
                     frames_per_block=30)
    return Y, str(root / "store")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one 4 x 2 mesh of gloo ranks; rank r's values."""
    Y_ingest, root = _store(tmp_path_factory.mktemp("ingest"), INGEST["T"])
    Y_ragged, root_ragged = _store(tmp_path_factory.mktemp("ragged"), 99)
    X, w, w0 = _halo_inputs()
    jobs = [(name, "step_cases", (*_step_inputs(colored), H, W, T, RADIUS,
                                  [(name, dict(n_hals=1, colored=colored))]))
            for name, colored in (("plain", False), ("colored", True))]
    jobs += [("halo", "halo_case", (X, w, w0, HALO["H"], HALO["W"],
                                    HALO["radius"])),
             ("layout", "layout_case", (T, H)),
             ("guards", "guard_cases", (H, W, T, K, RADIUS)),
             ("ingest", "ingest_case", (root, INGEST["K"],
                                        INGEST["radius"])),
             ("ragged", "ingest_case", (root_ragged, INGEST["K"],
                                        INGEST["radius"]))]
    out = spawn(_selftest.cases, N_PATCH, N_FRAME, device="cpu",
                args=(jobs,), timeout=120, pg_timeout=60)
    return dict(out=out, ingest=Y_ingest, ragged=Y_ragged,
                halo=(X, w, w0))


def _jax_state(d, put=None):
    specs = dict(A=P(None, "patch", None), C=P(None, "frame"),
                 C_raw=P(None, "frame"), S=P(None, "frame"), g=P(),
                 b0=P("patch", None), ring_w=P("patch", None),
                 ring_w0=P("patch"))
    return StepState(**{k: (jnp.asarray(v) if put is None
                            else put(jnp.asarray(v), specs[k]))
                        for k, v in d.items()})


@pytest.mark.parametrize("name", ["plain", "colored"])
def test_step_matches_jax_single_device_and_mesh(ranks, name):
    colored = name == "colored"
    Y, d = _step_inputs(colored)
    got = ranks["out"][0][name][name]
    single = make_update_step(None, H, W, T, radius=RADIUS, n_hals=1,
                              colored=colored)(jnp.asarray(Y), _jax_state(d))
    mesh = make_mesh(n_patch=N_PATCH, n_frame=N_FRAME)
    put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    sharded = make_update_step(mesh, H, W, T, radius=RADIUS, n_hals=1,
                               colored=colored)(
        put(jnp.asarray(Y), P("frame", "patch", None)), _jax_state(d, put))
    for ref in (single, sharded):
        np.testing.assert_allclose(got["A"], np.asarray(ref.A), atol=2e-4)
        np.testing.assert_allclose(got["C"], np.asarray(ref.C), atol=2e-3)
        np.testing.assert_allclose(got["S"], np.asarray(ref.S), atol=2e-3)
    # every rank gathered the same state
    for r in ranks["out"][1:]:
        for k, v in got.items():
            np.testing.assert_array_equal(r[name][name][k], v)


def test_ring_halo_past_one_neighbour_is_exact(ranks):
    """H = 16 over 4 patch ranks is 4 rows a slab and the radius-6 ring
    reaches 6 rows: each halo spans two slabs. The sharded apply equals
    the one-device apply bit for bit on the CPU (the same taps, summed in
    the same order)."""
    X, w, w0 = ranks["halo"]
    want = apply_ring(RingWeights(w=torch.tensor(w), w0=torch.tensor(w0)),
                      torch.tensor(X), HALO["H"], HALO["W"],
                      HALO["radius"]).numpy()
    np.testing.assert_array_equal(ranks["out"][0]["halo"], want)


def test_rank_blocks_match_the_jax_layout(ranks):
    """Rank r's frames and rows are the block that JAX's (frame, patch)
    movie sharding gives device r of the same mesh shape."""
    mesh = make_mesh(n_patch=N_PATCH, n_frame=N_FRAME)
    idx = NamedSharding(mesh, P("frame", "patch", None)).devices_indices_map(
        (T, H, W))
    for dev, (ts, hs, _) in idx.items():
        frames, rows = ranks["out"][dev.id]["layout"]
        assert frames == (ts.start, ts.stop)
        assert rows == (hs.start, hs.stop)


def test_init_distributed_single_process_noop():
    assert init_distributed() == 0


def test_frame_ranges_cover_all_frames(ranks):
    got = sorted({r["ingest"]["range"] for r in ranks["out"]})
    assert got == [(0, 50), (50, 100)]


def test_load_sharded_movie_matches_direct_load(ranks):
    Y = ranks["ingest"]
    h = INGEST["H"] // N_PATCH
    for rank, r in enumerate(ranks["out"]):
        p, f = rank % N_PATCH, rank // N_PATCH
        (lo, hi) = r["ingest"]["range"]
        assert lo == f * 50
        np.testing.assert_allclose(r["ingest"]["block"],
                                   Y[lo:hi, p * h:(p + 1) * h], rtol=1e-6)


def test_load_sharded_movie_pads_ragged_T(ranks):
    """T = 99 over 2 frame ranks: shards of 50, the last frame a zero
    pad."""
    Y = ranks["ragged"]
    h = INGEST["H"] // N_PATCH
    for rank, r in enumerate(ranks["out"]):
        p, f = rank % N_PATCH, rank // N_PATCH
        block = r["ragged"]["block"]
        lo, hi = r["ragged"]["range"]
        assert block.shape == (50, h, INGEST["W"])
        np.testing.assert_allclose(block[:hi - lo],
                                   Y[lo:hi, p * h:(p + 1) * h], rtol=1e-6)
        assert not block[hi - lo:].any()
        assert (lo, hi) == ((0, 50) if f == 0 else (50, 99))


def test_sharded_movie_feeds_update_step(ranks):
    C = ranks["out"][0]["ingest"]["C"]
    assert C.shape == (INGEST["K"], INGEST["T"])
    assert np.isfinite(C).all()


@pytest.mark.parametrize("what", ["H", "T", "K", "mxu"])
def test_mesh_guards_raise_value_errors(ranks, what):
    """Indivisible H, T and K raise a ValueError that names the
    dimension, as JAX's ``device_put`` refuses them; ``mxu=True`` takes
    no mesh."""
    msg = ranks["out"][0]["guards"][what]
    assert msg is not None
    assert msg.startswith(f"{what} = ") if what != "mxu" else "mxu" in msg
