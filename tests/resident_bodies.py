"""Rank bodies for ``tests/test_torch_resident_mesh.py``: functions that
``ResidentMesh.call`` runs on every rank, importable by name (the
workers import this module afresh, so it imports only torch and the
port)."""

import torch

from cnmf_e_tpu_torch.parallel import comm
from cnmf_e_tpu_torch.parallel.launch import broadcast, scatter
from cnmf_e_tpu_torch.parallel.mesh import gather_movie, shard_movie
from cnmf_e_tpu_torch.utils.profiling import paired_spans

KEPT = {}


def ship(mesh, x=None):
    """Rank 0's movie ``x`` scattered (each rank keeps its block), a
    scalar and a bool image broadcast; the blocks gathered back, and the
    rank's view of each."""
    blk = scatter(x, shard_movie, mesh)
    KEPT["blk"] = blk
    one = broadcast(None if x is None else x[0, 0, 0], mesh)
    mask = broadcast(None if x is None else x[0] > 0.5, mesh)
    return {"full": gather_movie(blk, mesh), "blk": blk.clone(),
            "one": one, "mask": mask, "rank": mesh.rank}


def kept(mesh):
    """The block this rank kept from :func:`ship`, gathered whole."""
    return gather_movie(KEPT["blk"], mesh)


def collectives(mesh):
    """Every collective of ``comm`` once on this rank's block, under a
    profiler: (paired spans, ``comm.STATS``)."""
    blk = KEPT["blk"]
    comm.reset_stats()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        comm.psum(blk.sum(dim=0), mesh, "frame")
        comm.halo_rows(blk, 2, mesh)
        C = blk.reshape(blk.shape[0], -1)[:, :4].T.contiguous()  # (4, T/f)
        whole = comm.traces_to_neurons(C, mesh)
        comm.traces_to_frames(whole, blk.shape[0] * mesh.n_frame, mesh)
    events = [(e.name, e.time_range.start, e.time_range.end, e.thread)
              for e in prof.events()]
    return paired_spans(events), {"kinds": dict(comm.STATS["kinds"]),
                                  "calls": comm.STATS["calls"],
                                  "bytes": comm.STATS["bytes"]}


def fail_on(mesh, rank):
    """Raise on ``rank``; the others wait for it in a collective."""
    if mesh.rank == rank:
        raise ValueError(f"planted on rank {rank}")
    comm.psum(torch.ones(3, device=mesh.device), mesh, "patch")
    comm.psum(torch.ones(3, device=mesh.device), mesh, "frame")
