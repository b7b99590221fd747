"""The resident mesh (``parallel/launch.py::ResidentMesh``) on a 2 x 2
mesh of gloo ranks on the CPU, one spawn for the module (rank bodies in
``tests/resident_bodies.py``; every call has a 60 s deadline and every
collective a 30 s timeout):

  * set-up ships rank 0's tensors: each rank keeps its own block of a
    scattered movie, and a broadcast scalar and bool image arrive whole;
  * a rank keeps its blocks between calls;
  * each collective of ``comm`` is a span (``comm.all_reduce``,
    ``comm.all_gather``, ``comm.halo_rows``, ``comm.traces_to_neurons``,
    ``comm.traces_to_frames``) whose edges pair and nest, and
    ``comm.STATS`` counts its calls and bytes by kind; without a mesh
    no span opens;
  * a rank's exception, a worker's or rank 0's own (on a second mesh,
    of two ranks), is raised in the caller and ends every rank, and a
    call after the mesh has closed raises.
"""

import numpy as np
import pytest
import torch

import resident_bodies as bodies
from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.launch import ResidentMesh, backend_for
from cnmf_e_tpu_torch.utils.profiling import paired_spans

torch.set_num_threads(1)

T, H, W = 8, 8, 6


@pytest.fixture(scope="module")
def mesh():
    m = ResidentMesh(2, 2, device="cpu", timeout=60.0, pg_timeout=30.0)
    yield m
    m.close()


@pytest.fixture(scope="module")
def movie():
    return torch.as_tensor(np.random.default_rng(7).random((T, H, W)),
                           dtype=torch.float32)


@pytest.fixture(scope="module")
def shipped(mesh, movie):
    return mesh.call(bodies.ship, x=movie)


def test_the_backend_follows_the_cards(monkeypatch):
    assert backend_for("cpu", 4) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert backend_for("cuda", 4) == "nccl"
    assert backend_for("cuda", 2) == "nccl"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert backend_for("cuda", 4) == "gloo"


def test_rank_0_is_the_caller(mesh, shipped):
    assert mesh.backend == "gloo" and len(mesh.alive()) == 3
    assert shipped["rank"] == 0 and mesh.mesh.rank == 0


def test_scatter_ships_each_rank_its_block(shipped, movie):
    assert torch.equal(shipped["full"], movie)
    # rank 0's block: frames [0, T/2), rows [0, H/2)
    assert torch.equal(shipped["blk"], movie[:T // 2, :H // 2])
    assert shipped["blk"].is_contiguous()


def test_broadcast_ships_whole_tensors(shipped, movie):
    assert shipped["one"].shape == () and float(shipped["one"]) == \
        float(movie[0, 0, 0])
    assert shipped["mask"].dtype == torch.bool
    assert torch.equal(shipped["mask"], movie[0] > 0.5)


def test_ranks_keep_their_blocks_between_calls(mesh, shipped, movie):
    assert torch.equal(mesh.call(bodies.kept), movie)


def test_collectives_are_spans_and_counted_by_kind(mesh, shipped):
    spans, stats = mesh.call(bodies.collectives)
    names = [s[0] for s in spans]
    assert set(names) == {"comm.all_reduce", "comm.all_gather",
                          "comm.halo_rows", "comm.traces_to_neurons",
                          "comm.traces_to_frames"}
    assert names.count("comm.all_reduce") == 1
    assert names.count("comm.all_gather") == 3
    # every gather lies inside the exchange that made it
    outer = [s for s in spans if s[0] != "comm.all_gather"
             and s[0] != "comm.all_reduce"]
    for name, a, b, _ in spans:
        if name == "comm.all_gather":
            assert any(o[1] <= a and b <= o[2] for o in outer)
    kinds = stats["kinds"]
    assert set(kinds) == {"all_reduce", "all_gather"}
    assert kinds["all_reduce"]["calls"] == 1
    assert kinds["all_reduce"]["bytes"] == (H // 2) * W * 4
    assert kinds["all_gather"]["calls"] == 3
    assert stats["calls"] == 4
    assert stats["bytes"] == sum(k["bytes"] for k in kinds.values())
    # the halo's edge rows (2 x 2 rows of the T/2 frames), the rank's 2
    # of 4 traces over its T/2 frames, its 2 whole traces' T/2 frames
    assert kinds["all_gather"]["bytes"] == 4 * (
        2 * (T // 2) * 2 * W + 2 * (T // 2) + 2 * (T // 2))


def test_no_span_without_a_mesh():
    x = torch.ones(5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        comm.psum(x, None, "frame")
        comm.traces_to_neurons(x[None], None)
        comm.traces_to_frames(x[None], 5, None)
    events = [(e.name, e.time_range.start, e.time_range.end, e.thread)
              for e in prof.events()]
    assert paired_spans(events) == []


def test_a_ranks_exception_ends_the_mesh(mesh, shipped):
    """The module's mesh does not outlive it."""
    with pytest.raises(RuntimeError, match="planted on rank 2"):
        mesh.call(bodies.fail_on, 2)
    assert mesh.alive() == []
    with pytest.raises(RuntimeError, match="closed"):
        mesh.call(bodies.kept)
    mesh.close()                        # again: nothing to do


def test_rank_0s_exception_ends_the_workers():
    """Rank 0 raises while its worker waits for it in a collective (after
    the module's mesh has ended: a process is in one group at a time)."""
    two = ResidentMesh(1, 2, device="cpu", timeout=60.0, pg_timeout=30.0)
    assert len(two.alive()) == 1
    with pytest.raises(ValueError, match="planted on rank 0"):
        two.call(bodies.fail_on, 0)
    assert two.alive() == []
    with pytest.raises(RuntimeError, match="closed"):
        two.call(bodies.fail_on, 0)
