"""DF/F extraction (port of ``cnmf_e_tpu/models/dff.py``).

Reference: ``extract_DF_F_endoscope`` (``Sources2D.m:540-570``): project
the background movie onto each (normalized) footprint to get the
per-neuron baseline fluorescence, take its median / running percentile as
F0, and divide the traces.

``torch.quantile`` refuses inputs past 2^24 elements, which the running
percentile's (K, T, window) windows and a long session's (K, T) baseline
both pass, so the quantiles here sort and interpolate themselves, with the
``"linear"`` rule of ``jnp.quantile``.

``mesh``: :func:`extract_dff` on this rank's blocks: the
footprint-projected background is summed over 'patch', F0 is taken on
whole traces (K / n_patch of them a patch rank,
``comm.traces_to_neurons``) and goes back to the rank's frames.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cnmf_e_tpu_torch.config import CNMFEParams
from cnmf_e_tpu_torch.models.background import background_of
from cnmf_e_tpu_torch.models.state import CNMFEState
from cnmf_e_tpu_torch.parallel import comm

# elements of sorted windows held at once by running_percentile (with the
# sort's int64 indices, 12 bytes each: 384 MiB)
SORT_ELEMS = 1 << 25


def quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile (0 <= q <= 1) along the last axis, keeping it as
    size 1: position (n - 1) q of the sorted values, interpolated between
    its floor and ceil as ``jnp.quantile`` does."""
    n = x.shape[-1]
    pos = (n - 1) * q
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    w = pos - lo
    xs = torch.sort(x, dim=-1).values
    return xs[..., lo:lo + 1] * (1.0 - w) + xs[..., hi:hi + 1] * w


def running_percentile(x: torch.Tensor, window: int, q: float
                       ) -> torch.Tensor:
    """Centered running percentile along the last axis: the ``q``-th
    percentile of the ``window`` samples starting ``window // 2`` before
    each one, the edges padded with the edge values (reference:
    ``utilities/running_percentile.m``). Rows are sorted in chunks of at
    most :data:`SORT_ELEMS` window elements."""
    shape = x.shape
    T = shape[-1]
    half = window // 2
    rows = x.reshape(-1, T)
    xp = F.pad(rows[None], (half, half), mode="replicate")[0]
    step = max(SORT_ELEMS // (T * window), 1)
    out = torch.empty_like(rows)
    for r in range(0, rows.shape[0], step):
        frames = xp[r:r + step].unfold(-1, window, 1)[:, :T]
        out[r:r + step] = quantile(frames, q / 100.0)[..., 0]
    return out.reshape(shape)


def _normalized_footprints(state: CNMFEState, mesh=None) -> torch.Tensor:
    A = state.masked_A().reshape(state.K_max, -1)
    norm = comm.psum((A * A).sum(dim=1), mesh, "patch")
    return A / torch.clamp(norm, min=1e-12)[:, None]


def _baseline(Ybg: torch.Tensor, window: Optional[int],
              prctile: float) -> torch.Tensor:
    """F0 of whole traces: the whole-session percentile, or the running
    one."""
    if window is None or window >= Ybg.shape[-1]:
        return quantile(Ybg, prctile / 100.0)
    return running_percentile(Ybg, window, prctile)


def _divide(state: CNMFEState, Ybg: torch.Tensor, window: Optional[int],
            prctile: float, F0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F0 over every slot (whole-session or running percentile, unless
    given), then C / F0 and C_raw / F0 with inactive rows zero."""
    if F0 is None:
        F0 = _baseline(Ybg, window, prctile)
    F0 = torch.clamp(F0, min=1e-12)
    act = state.active[:, None]
    return (torch.where(act, state.C / F0, 0.0),
            torch.where(act, state.C_raw / F0, 0.0), F0)


def _mode_baseline(Ybg: torch.Tensor) -> torch.Tensor:
    """Per trace, the mode of its distribution by the Botev diffusion KDE
    (``ops/kde.py``, on the host), as a (K, 1) column."""
    from cnmf_e_tpu_torch.ops.kde import mode_baseline
    return torch.tensor([[mode_baseline(row)]
                         for row in Ybg.cpu().numpy()],
                        dtype=Ybg.dtype, device=Ybg.device)


def extract_dff(Y: torch.Tensor, state: CNMFEState, params: CNMFEParams,
                window: Optional[int] = None, prctile: float = 50.0,
                baseline: str = "percentile", mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (C_df, C_raw_df, F0). Y: (T, H, W) raw movie on the state's
    device.

    F0 is per neuron: the percentile of the footprint-projected background
    (whole-session if ``window`` is None, else a running percentile).
    ``baseline="mode"`` instead takes the mode of the fluorescence
    distribution by the Botev diffusion KDE, the reference
    ``extract_DF_F.m`` path (``ops/kde.py``, on the host).

    ``mesh``: Y and the state are this rank's blocks, and C_df, C_raw_df
    and a running F0 its frames (a whole-session F0 is (K, 1) on every
    rank)."""
    T = Y.shape[0]
    B = background_of(Y, state, params, mesh=mesh)
    Ybg = comm.psum(_normalized_footprints(state, mesh)
                    @ B.reshape(T, -1).T, mesh, "patch")         # (K, T)
    Ybg = comm.traces_to_neurons(Ybg, mesh)
    F0 = (_mode_baseline(Ybg) if baseline == "mode"
          else _baseline(Ybg, window, prctile))
    if mesh is not None:
        F0 = (comm.all_gather_cat(F0, 0, mesh.patch_group)
              if F0.shape[-1] == 1 else
              comm.traces_to_frames(F0, F0.shape[-1], mesh))
    return _divide(state, None, window, prctile, F0)


def extract_dff_batches(blocks, batch_states, final_state: CNMFEState,
                        params: CNMFEParams, window: Optional[int] = None,
                        prctile: float = 50.0
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """DF/F for batch-mode results: the footprint-projected background is
    accumulated block by block (each block with its own batch's background
    model), then F0 is the whole-session percentile, as in the in-memory
    path.

    ``blocks``: the batches' (T_b, H, W) arrays (numpy, such as a
    MovieStore's memmapped blocks, or tensors); each is uploaded to the
    final state's device and dropped after its projection, so one block is
    resident at a time. ``final_state`` holds the concatenated traces
    (from ``fit_batches``)."""
    dev = final_state.A.device
    An = _normalized_footprints(final_state)
    parts = []
    for Yb, st_b in zip(blocks, batch_states):
        Yb = torch.as_tensor(Yb, device=dev).to(torch.float32)
        B = background_of(Yb, st_b, params)
        parts.append(An @ B.reshape(Yb.shape[0], -1).T)
        del Yb, B
    return _divide(final_state, torch.cat(parts, dim=-1), window, prctile)
