"""The numbers that decide ``correct``: how far the program's round lies
from the plain reference's round on the same inputs.

Every number is a relative error. A per-row number measures each row
(a footprint, a trace, a frame of background) against the larger of
that row's reference norm and the median row's, so that rows the
reference leaves near zero do not divide by zero; ``_med`` is the median
over the rows, ``_max`` the largest. ``_fro`` is the whole array's
Frobenius error against the reference's norm.

The background is judged by what it predicts: the background each side's
outputs give on a sample of frames (``B``), computed by the reference's
own code from the round's start footprints and traces; its fluctuating
part (``Bdyn``) is measured against the reference's background less its
mean over those frames. The ring weights and b0, and the svd's b and f
(each component's sign aligned to the reference's), are measured
directly as well.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

INF = math.inf


def malformed(P, R) -> bool:
    """An output missing, or not shaped as the reference's."""
    return not isinstance(P, torch.Tensor) or tuple(P.shape) != tuple(
        R.shape)


def guarded(fn: Callable[[], torch.Tensor]) -> Optional[torch.Tensor]:
    """``fn()``, or None where the program's outputs are malformed so that
    the reference's code cannot read them."""
    try:
        return fn()
    except (AttributeError, TypeError, ValueError, IndexError,
            RuntimeError):
        return None


def _rows(P: torch.Tensor, R: torch.Tensor, tag: str) -> Dict[str, float]:
    if malformed(P, R):
        return {f"{tag}_{s}": INF for s in ("med", "max", "fro")}
    P = P.reshape(P.shape[0], -1).to(torch.float64)
    R = R.reshape(R.shape[0], -1).to(P.device, torch.float64)
    err = torch.linalg.vector_norm(P - R, dim=1)
    nr = torch.linalg.vector_norm(R, dim=1)
    den = torch.clamp(torch.maximum(nr, nr.median()), min=1e-30)
    rel = err / den
    tot = float(torch.linalg.vector_norm(R))
    return {f"{tag}_med": float(rel.median()), f"{tag}_max": float(rel.max()),
            f"{tag}_fro": float(torch.linalg.vector_norm(P - R))
            / max(tot, 1e-30)}


def _fro(P: torch.Tensor, R: torch.Tensor) -> float:
    if malformed(P, R):
        return INF
    P = P.to(torch.float64)
    R = R.to(P.device, torch.float64)
    return float(torch.linalg.vector_norm(P - R)) / max(
        float(torch.linalg.vector_norm(R)), 1e-30)


def numbers(prog: dict, ref: dict, B_prog: torch.Tensor,
            B_ref: torch.Tensor) -> Dict[str, float]:
    """Every candidate number of a round: ``prog`` and ``ref`` as
    :func:`references.update_round.run_round` returns them, ``B_prog``
    and ``B_ref`` the backgrounds they predict on the sampled frames. An
    output that is missing or misshapen reads infinite."""
    out = {}
    out.update(_rows(B_prog, B_ref, "B"))
    mean = B_ref.mean(dim=0, keepdim=True)
    out.update(_rows(None if B_prog is None else B_prog - mean,
                     B_ref - mean, "Bdyn"))
    if "w" in ref:
        out["w_fro"] = _fro(prog.get("w"), ref["w"])
        out["w0_fro"] = _fro(prog.get("w0"), ref["w0"])
    elif malformed(prog.get("f"), ref["f"]) \
            or malformed(prog.get("b"), ref["b"]):
        out["b_fro"] = out["f_fro"] = INF
    else:
        sign = torch.sign((prog["f"] * ref["f"].to(prog["f"].device)
                           ).sum(dim=1))
        sign = torch.where(sign == 0, 1.0, sign)
        out["b_fro"] = _fro(prog["b"] * sign[:, None, None], ref["b"])
        out["f_fro"] = _fro(prog["f"] * sign[:, None], ref["f"])
    out["b0_fro"] = _fro(prog.get("b0"), ref["b0"])
    for k in ("A", "C_raw", "C", "S"):
        out.update(_rows(prog.get(k), ref[k], k))
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """(correct, the compared numbers with their limits). A number that
    is not finite fails."""
    checks = {k: {"value": nums[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
