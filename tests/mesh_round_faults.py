"""Faults of the mesh cell's round (``benchmark/entries/mesh_round.py``),
planted on every rank of its resident mesh: rank bodies for
``tests/test_torch_mesh_round.py``, importable by name (the workers
import this module afresh, so it imports only torch, the port and the
entry).

Each fault is one a mesh can have and one process cannot:

  * ``ring_halo_left_out``: the ring background's halo exchange gives
    zeros in place of the patch neighbours' rows (the outlier clamp, the
    fit and the subtracted background alike);
  * ``frame_psum_skipped``: the spatial update's product ``C Y^T`` is
    not summed over 'frame', so each rank fits its footprints on its own
    frames' product;

and three the one-card cells plant too, made on the mesh's blocks:

  * ``state_unchanged``: the round returns its start state;
  * ``one_footprint_altered``: neuron 0's footprint 1.5 times larger
    after the round;
  * ``spikes_altered``: every spike 1% larger after the round.
"""

import torch

from benchmark.entries import mesh_round as entry
from cnmf_e_tpu_torch.ops import hals, ring
from cnmf_e_tpu_torch.parallel import comm

FAULTS = ("ring_halo_left_out", "frame_psum_skipped", "state_unchanged",
          "one_footprint_altered", "spikes_altered")


class _Comm:
    """``comm`` as a module sees it, with some functions replaced."""

    def __init__(self, **replaced):
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(comm, name)


def _no_halo(x, r, mesh, edge="zeros"):
    """The slab with ``r`` rows of zeros above and below it, and no
    exchange."""
    z = torch.zeros_like(x[..., :1, :]).expand(
        x.shape[:-2] + (r, x.shape[-1]))
    return torch.cat([z, x, z], dim=-2)


def _no_frame_psum_of_products(x, mesh, axis):
    """``comm.psum``, except that a (K, pixels) product is left as this
    rank's over 'frame'."""
    if axis == "frame" and x.dim() == 2 and x.shape[0] != x.shape[1]:
        return x
    return comm.psum(x, mesh, axis)


def faulty_round(mesh, fault: str) -> None:
    """One round on this rank's blocks with ``fault``, kept as the last
    state (``entry._gather`` reads it); the modules are restored after."""
    planted = {"ring_halo_left_out": (ring, _Comm(halo_rows=_no_halo)),
               "frame_psum_skipped": (
                   hals, _Comm(psum=_no_frame_psum_of_products))}
    module, fake = planted.get(fault, (None, None))
    if module is not None:
        module.comm = fake
    try:
        if fault == "state_unchanged":
            entry._HELD["last"] = entry._HELD["st0"]
            return
        st = entry._round(mesh)
        if fault == "one_footprint_altered":
            A = st.A.clone()
            A[0] *= 1.5
            entry._HELD["last"] = st.replace(A=A)
        elif fault == "spikes_altered":
            entry._HELD["last"] = st.replace(S=st.S * 1.01)
    finally:
        if module is not None:
            module.comm = comm
