"""The (patch, frame) mesh of ``torch.distributed`` ranks and the layout
of the model on it (port of ``cnmf_e_tpu/parallel/mesh.py``).

Layout contract (``cnmf_e_tpu/parallel/mesh.py:1-11``); every rank holds
one block:

  Y (T, H, W)   : T over 'frame', H over 'patch'    — the movie
  A (K, H, W)   : H over 'patch', replicated over 'frame'
  C/S (K, T)    : T over 'frame'; resharded to K over 'patch' with whole
                  traces for the deconvolution (``comm.traces_to_neurons``)
  b0 (H, W)     : H over 'patch'
  ring w (d, R) : d over 'patch' (d = H W row-major, so an H slab is a
                  contiguous d slab)
  g (K,)        : replicated

The 'frame' axis varies slowest over the ranks: rank = f n_patch + p, as
``mesh.py:26-37`` lays the devices out, so the ranks of one host share a
frame shard and split the patch axis. ``shard_*`` cut a rank's block out
of a full array; ``gather_*`` assemble the full array on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from cnmf_e_tpu_torch.parallel import comm


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a (patch, frame) mesh: the ``DeviceMesh`` of
    shape (n_frame, n_patch) named ("frame", "patch"), its two process
    groups, this rank's coordinates and its device."""
    device_mesh: DeviceMesh
    patch_group: object
    frame_group: object
    n_patch: int
    n_frame: int
    p: int
    f: int
    device: torch.device

    @property
    def rank(self) -> int:
        return self.f * self.n_patch + self.p

    def group(self, axis: str):
        return {"patch": self.patch_group, "frame": self.frame_group}[axis]

    def rows(self, H: int) -> Tuple[int, int]:
        """This rank's rows [h0, h1) of an H-row field of view."""
        return _block("H", H, self.n_patch, self.p)

    def frames(self, T: int) -> Tuple[int, int]:
        """This rank's frames [t0, t1) of T."""
        return _block("T", T, self.n_frame, self.f)

    def neurons(self, K: int) -> Tuple[int, int]:
        """This patch rank's neuron rows [k0, k1) of K, for the
        deconvolution's whole traces."""
        return _block("K", K, self.n_patch, self.p)


def _block(name: str, n: int, parts: int, i: int) -> Tuple[int, int]:
    if n % parts:
        axis = "frame" if name == "T" else "patch"
        raise ValueError(f"{name} = {n} is not divisible by the {parts} "
                         f"ranks of the '{axis}' axis")
    m = n // parts
    return i * m, (i + 1) * m


def check_divisible(mesh, **dims) -> None:
    """Raise a ValueError naming the first of ``dims`` (H, T or K) that
    does not divide over its mesh axis; nothing without a mesh."""
    if mesh is None:
        return
    for name, n in dims.items():
        _block(name, n, mesh.n_frame if name == "T" else mesh.n_patch, 0)


def make_mesh(n_patch: int = 0, n_frame: int = 1, device="cuda") -> Mesh:
    """Build the (patch, frame) mesh over the ranks of the initialised
    default process group (``launch.spawn`` or
    ``multihost.init_distributed``). ``n_patch=0`` uses every rank:
    n_patch = world size / n_frame. ``device``: the card (``"cuda"``, the
    rank's own card when the host has several) unless the caller passes
    ``"cpu"``."""
    world = dist.get_world_size()
    if n_patch <= 0:
        n_patch = world // n_frame
    if n_patch * n_frame != world:
        raise ValueError(f"a {n_patch} x {n_frame} mesh needs "
                         f"{n_patch * n_frame} ranks, the group has {world}")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # the DeviceMesh's device type is its backend's: gloo's groups are the
    # host's, also when the tensors they carry live on the card
    dm = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                    torch.arange(world).reshape(n_frame, n_patch),
                    mesh_dim_names=("frame", "patch"))
    f, p = dm.get_coordinate()
    return Mesh(device_mesh=dm, patch_group=dm.get_group("patch"),
                frame_group=dm.get_group("frame"), n_patch=n_patch,
                n_frame=n_frame, p=p, f=f, device=device)


def _tensor(x, mesh: Mesh) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    return torch.as_tensor(np.ascontiguousarray(x), device=mesh.device)


def shard_movie(Y, mesh: Mesh) -> torch.Tensor:
    """This rank's (T/frame, H/patch, W) block of a (T, H, W) movie."""
    t0, t1 = mesh.frames(Y.shape[0])
    h0, h1 = mesh.rows(Y.shape[1])
    return _tensor(Y[t0:t1, h0:h1], mesh)


def shard_footprints(A, mesh: Mesh) -> torch.Tensor:
    """This rank's (K, H/patch, W) rows of (K, H, W) footprints."""
    h0, h1 = mesh.rows(A.shape[1])
    return _tensor(A[:, h0:h1], mesh)


def shard_traces(C, mesh: Mesh) -> torch.Tensor:
    """This rank's (K, T/frame) frames of (K, T) traces."""
    t0, t1 = mesh.frames(C.shape[1])
    return _tensor(C[:, t0:t1], mesh)


def shard_image(x, mesh: Mesh) -> torch.Tensor:
    """This rank's part of an image split on its first axis over 'patch':
    rows of an (H, W) image, or pixels of a (d, ...) per-pixel array."""
    i0, i1 = mesh.rows(x.shape[0])
    return _tensor(x[i0:i1], mesh)


def gather_movie(Y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The full (T, H, W) movie from every rank's block."""
    return comm.all_gather_cat(comm.all_gather_cat(Y, 1, mesh.patch_group),
                               0, mesh.frame_group)


def gather_footprints(A: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return comm.all_gather_cat(A, 1, mesh.patch_group)


def gather_traces(C: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return comm.all_gather_cat(C, 1, mesh.frame_group)


def gather_image(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return comm.all_gather_cat(x, 0, mesh.patch_group)
