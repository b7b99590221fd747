"""Model state for the CNMF-E factorization (port of
``cnmf_e_tpu/models/state.py``).

A dataclass of tensors in place of the JAX package's frozen pytree, with
the same fixed-capacity neuron slots (``K_max``) and ``active`` validity
mask. Update functions return new states with ``replace`` and never write
into the tensors of the state they were given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class RingWeights:
    """Per-pixel ring weights (d, R) plus intercept (d,), flattened pixels."""
    w: torch.Tensor
    w0: torch.Tensor


@dataclass
class CNMFEState:
    """Factorization state: Y ~= A C + B, B from the ring model or the
    low-rank (svd/nmf) one."""

    A: torch.Tensor            # (K_max, H, W) spatial footprints (>= 0)
    C: torch.Tensor            # (K_max, T) denoised traces
    C_raw: torch.Tensor        # (K_max, T) raw traces (pre-deconvolution)
    S: torch.Tensor            # (K_max, T) deconvolved spikes
    active: torch.Tensor       # (K_max,) bool validity mask
    g: torch.Tensor            # (K_max, p) AR coefficients per neuron
    neuron_sn: torch.Tensor    # (K_max,) per-trace noise sigma
    b0: torch.Tensor           # (H, W) constant background
    # ring background (1p): per-pixel ring weights; None for low-rank mode
    W: Optional[RingWeights] = None
    # low-rank background (2p): B = b f + b0
    b: Optional[torch.Tensor] = None      # (rank, H, W)
    f: Optional[torch.Tensor] = None      # (rank, T)
    tags: Optional[torch.Tensor] = None   # (K_max,) int32 QC bitmask

    def replace(self, **kw) -> "CNMFEState":
        return dataclasses.replace(self, **kw)

    @property
    def K_max(self) -> int:
        return self.A.shape[0]

    def n_active(self) -> torch.Tensor:
        return self.active.sum()

    def masked_A(self) -> torch.Tensor:
        return self.A * self.active[:, None, None]

    def masked_C(self) -> torch.Tensor:
        return self.C * self.active[:, None]


def empty_state(K_max: int, H: int, W: int, T: int, p: int = 1,
                device=None) -> CNMFEState:
    f32 = dict(dtype=torch.float32, device=device)
    return CNMFEState(
        A=torch.zeros((K_max, H, W), **f32),
        C=torch.zeros((K_max, T), **f32),
        C_raw=torch.zeros((K_max, T), **f32),
        S=torch.zeros((K_max, T), **f32),
        active=torch.zeros((K_max,), dtype=torch.bool, device=device),
        g=torch.full((K_max, p), 0.9, **f32),
        neuron_sn=torch.zeros((K_max,), **f32),
        b0=torch.zeros((H, W), **f32),
        tags=torch.zeros((K_max,), dtype=torch.int32, device=device),
    )


def compact(state: CNMFEState) -> CNMFEState:
    """Move active neurons to the front slots (stable order)."""
    active = state.active
    perm = torch.cat([torch.nonzero(active).flatten(),
                      torch.nonzero(~active).flatten()])
    return state.replace(
        A=state.A[perm], C=state.C[perm], C_raw=state.C_raw[perm],
        S=state.S[perm], active=state.active[perm], g=state.g[perm],
        neuron_sn=state.neuron_sn[perm],
        tags=None if state.tags is None else state.tags[perm])
