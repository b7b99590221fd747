"""The three OASIS AR(1) kernels of the divide-and-conquer solve, their
plain PyTorch versions, the one-call solve, and the dispatch (port of
``cnmf_e_tpu/ops/pallas_oasis.py``).

  * :func:`oasis_chunk_pools`  pass 1: the sample-level pool stack on every
    length-L chunk of every trace (replaces ``_oasis_pools_pallas``);
  * :func:`oasis_pool_merge`   pass 2: push the chunk pool lists in order
    and resolve violations across chunks (replaces ``_pool_merge_pallas``);
  * :func:`oasis_reconstruct`  pools -> (c, s) (replaces
    ``_reconstruct_pallas``);
  * :func:`oasis_solve`        y -> (c, s): the three in one call (replaces
    ``oasis_ar1_pallas_dc``).

CUDA tensors launch the kernels in ``csrc/oasis.cu``; CPU tensors run the
``*_reference`` versions, which execute the same per-lane algorithm in
lockstep over lanes. Pool arrays hold (v, w, t0, len) per slot; slots at or
past a lane's count hold (0, 1, 0, 0).

On the card the first two are bound by serial chains of dependent pushes
and merges, not by their few MB of bytes (the note at the head of
``csrc/oasis.cu``):

  * pass 1 runs one thread per (trace, chunk) lane in 32-lane CTAs, its
    stack slot-major (one bank or one 128-byte line per slot row) and its
    top two pools in registers. The stack lives in shared memory for
    chunks of up to ``K2_SMEM_MAX_L`` samples and in a global scratch past
    that, which the wrapper allocates;
  * pass 2 runs one warp per trace. Pass 1 leaves no two adjacent pools of
    a chunk violating each other, so once a pushed pool of a chunk does not
    merge, the rest of that chunk's list is appended untested. Its input
    must therefore be pass 1's output. The plain version pushes every pool
    and so checks the shortcut rather than assuming it;
  * the reconstruction runs a thread a sample: a CTA finds its tile's
    pools by a search over the sorted starts and stages them in shared
    memory.

The solve entry launches the three back to back with no host work between
them. Its pass 1 forms its own input from y (:func:`pass1_input`'s
arithmetic) and ends each trace's last chunk at T instead of padding it;
the padding's pools never merge, so c and s on [0, T) are those of the
chain on :func:`pass1_input`'s output, bit for bit.

Every kernel writes every output element, so the wrappers allocate with
``torch.empty``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from cnmf_e_tpu_torch.cuda_build import check_cuda, launch, load_library

Pools = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
              torch.Tensor]

_f32, _i32 = torch.float32, torch.int32
OASIS_KERNELS = ("oasis_chunk_pools", "oasis_pool_merge", "oasis_reconstruct")
# pass 1 keeps three L-slot stacks of 32 lanes in one CTA's shared memory
# up to this chunk length (Hopper gives a CTA 232,448 bytes); past it they
# live in a global scratch (csrc/oasis.cu: kSmemOptin, kK2SmemMaxL)
K2_SMEM_MAX_L = 232448 // (3 * 32 * 4)
# the reconstruction's CTA: K4_THREADS threads write K4_TILE samples of one
# trace (csrc/oasis.cu: kReconThreads, kReconTile)
K4_THREADS, K4_TILE = 256, 512


def _logg(g: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(g, min=1e-10))


def _check_shapes(*pairs) -> None:
    for t, shape in pairs:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"expected shape {tuple(shape)}, got "
                             f"{tuple(t.shape)}")


def _empty_pools(shape, device):
    return (torch.zeros(shape, dtype=_f32, device=device),
            torch.ones(shape, dtype=_f32, device=device),
            torch.zeros(shape, dtype=_i32, device=device),
            torch.zeros(shape, dtype=_i32, device=device))


def _uninit_pools(shape, device):
    """Pool arrays for a kernel that writes every slot."""
    return tuple(torch.empty(shape, dtype=dt, device=device)
                 for dt in (_f32, _f32, _i32, _i32))


# --------------------------------------------------------------------- #
# plain versions: one stack per lane, all lanes in lockstep
# --------------------------------------------------------------------- #
def _merge_top(v, w, ln, n, logg, smin, cand):
    """Merge the top two pools of lanes ``cand`` while they violate. CPU
    tensors run through NumPy views of their memory: the same float32
    arithmetic and torch's exp on the same lengths, so the same bits, at a
    fraction of torch's per-call cost on a few dozen lanes."""
    if v.device.type == "cpu":
        v, w, ln, n, logg, smin, cand = (
            x.numpy() for x in (v, w, ln, n, logg, smin, cand))

        def clamp0(x):
            return np.maximum(x, x.dtype.type(0))

        def exp(x):
            return torch.exp(torch.from_numpy(x)).numpy()

        def f32(x):
            return x.astype(np.float32)
    else:
        def clamp0(x):
            return torch.clamp(x, min=0)

        def f32(x):
            return x.to(_f32)
        exp = torch.exp
    while len(cand):
        nl = n[cand]
        p = clamp0(nl - 2)
        q = clamp0(nl - 1)
        gl = exp(logg[cand] * f32(ln[cand, p]))
        vp = clamp0(v[cand, p] / w[cand, p])
        vq = v[cand, q] / w[cand, q]
        viol = (nl >= 2) & (vq < vp * gl + smin[cand])
        cand, p, q, gl = cand[viol], p[viol], q[viol], gl[viol]
        v[cand, p] = v[cand, p] + v[cand, q] * gl
        w[cand, p] = w[cand, p] + w[cand, q] * gl * gl
        ln[cand, p] = ln[cand, p] + ln[cand, q]
        n[cand] -= 1


def _clear_unused(v, w, ts, ln, n):
    unused = torch.arange(v.shape[1], device=v.device)[None, :] >= n[:, None]
    v[unused] = 0.0
    w[unused] = 1.0
    ts[unused] = 0
    ln[unused] = 0


def oasis_chunk_pools_reference(vinit: torch.Tensor, g: torch.Tensor,
                                smin: torch.Tensor, L: int) -> Pools:
    K, T = vinit.shape
    nc = T // L
    N = K * nc
    y = vinit.reshape(N, L)
    logg = _logg(g).repeat_interleave(nc)
    sm = smin.repeat_interleave(nc)
    v, w, ts, ln = _empty_pools((N, L), vinit.device)
    n = torch.zeros(N, dtype=torch.long, device=vinit.device)
    lanes = torch.arange(N, device=vinit.device)
    t_off = (lanes % nc) * L
    for t in range(L):
        v[lanes, n] = y[:, t]
        w[lanes, n] = 1.0
        ts[lanes, n] = (t_off + t).to(_i32)
        ln[lanes, n] = 1
        n += 1
        _merge_top(v, w, ln, n, logg, sm, lanes)
    _clear_unused(v, w, ts, ln, n)
    return (v.reshape(K, nc, L), w.reshape(K, nc, L), ts.reshape(K, nc, L),
            ln.reshape(K, nc, L), n.to(_i32).reshape(K, nc))


def oasis_pool_merge_reference(v0, w0, ts0, l0, n_in, g, smin) -> Pools:
    K, nc, L = v0.shape
    dev = v0.device
    v, w, ts, ln = _empty_pools((K, nc * L), dev)
    n = torch.zeros(K, dtype=torch.long, device=dev)
    logg = _logg(g)
    lanes = torch.arange(K, device=dev)
    for c in range(nc):
        m = n_in[:, c].long()
        for i in range(int(m.max()) if K else 0):
            live = lanes[i < m]
            nl = n[live]
            v[live, nl] = v0[live, c, i]
            w[live, nl] = w0[live, c, i]
            ts[live, nl] = ts0[live, c, i]
            ln[live, nl] = l0[live, c, i]
            n[live] += 1
            _merge_top(v, w, ln, n, logg, smin, live)
    _clear_unused(v, w, ts, ln, n)
    return v, w, ts, ln, n.to(_i32)


def oasis_reconstruct_reference(v, w, ts, ln, n, g, T: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    K, P = v.shape
    dev = v.device
    logg = _logg(g)[:, None]
    # pools that start at or past T (pass 1's padding) do not reach [0, T)
    valid = (torch.arange(P, device=dev)[None, :] < n[:, None]) & (ts < T)
    starts = torch.where(valid, ts, 0).long()
    is_start = torch.zeros((K, T), dtype=torch.long, device=dev)
    is_start.scatter_reduce_(1, starts, valid.long(), reduce="amax")
    is_start[:, 0] = 1
    seg = torch.cumsum(is_start, dim=1) - 1
    pool_val = torch.clamp(v / torch.clamp(w, min=1e-20), min=0.0)
    tgrid = torch.arange(T, device=dev)[None, :]
    t0 = torch.gather(ts.long(), 1, seg)
    val = torch.gather(pool_val, 1, seg)
    c = val * torch.exp(logg * (tgrid - t0).to(_f32))
    c_prev = torch.cat([torch.zeros((K, 1), dtype=_f32, device=dev),
                        c[:, :-1]], dim=1)
    s = torch.where((is_start == 1) & (tgrid > 0),
                    c - g[:, None] * c_prev, 0.0)
    return c, s


def pass1_input(y: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
                L: int) -> torch.Tensor:
    """The lambda-adjusted traces that pass 1 takes: y (K, T) float32 and
    g, lam (K,) -> (K, Tp), Tp the multiple of L at or above T."""
    K, T = y.shape
    vinit = y - lam[:, None] * (1.0 - g[:, None])
    vinit[:, T - 1] = y[:, T - 1] - lam
    Tp = -(-T // L) * L
    if Tp != T:
        # strictly increasing pad samples, far above the trace: they never
        # merge, so the real pools (and the last real sample's y - lam)
        # are untouched
        big = vinit.abs().max() * 2.0 + 1e6
        ramp = 1.0 + torch.arange(Tp - T, dtype=torch.float32,
                                  device=y.device)
        vinit = torch.cat([vinit, (big * ramp)[None, :].expand(K, -1)],
                          dim=1)
    return vinit.contiguous()


def oasis_solve_reference(y, g, lam, smin, L: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chain: :func:`pass1_input`, then the three plain
    versions."""
    pools = oasis_chunk_pools_reference(pass1_input(y, g, lam, L), g, smin,
                                        L)
    v, w, ts, ln, n = oasis_pool_merge_reference(*pools, g, smin)
    return oasis_reconstruct_reference(v, w, ts, ln, n, g, y.shape[1])


# --------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------- #
def oasis_chunk_pools(vinit: torch.Tensor, g: torch.Tensor,
                      smin: torch.Tensor, L: int) -> Pools:
    """Pass 1. vinit: (K, T) lambda-adjusted traces with T a multiple of
    L; g, smin: (K,). Returns pools v, w, t0, len (K, T // L, L) with
    trace-global start times, and counts n (K, T // L) int32."""
    K, T = vinit.shape
    if T % L:
        raise ValueError(f"T={T} is not a multiple of L={L}")
    if not vinit.is_cuda:
        return oasis_chunk_pools_reference(vinit, g, smin, L)
    check_cuda(vinit, g, smin, dtypes=(_f32, _f32, _f32))
    _check_shapes((g, (K,)), (smin, (K,)))
    nc = T // L
    v, w, ts, ln = _uninit_pools((K, nc, L), vinit.device)
    n = torch.empty((K, nc), dtype=_i32, device=vinit.device)
    launch("oasis_chunk_pools", vinit.device, vinit, g, smin, K, nc, L,
           k2_scratch(K * nc, L, vinit.device), v, w, ts, ln, n)
    return v, w, ts, ln, n


def k2_scratch(lanes: int, L: int, device) -> Optional[torch.Tensor]:
    """Pass 1's global stacks, three [L][32] stacks of floats a warp, for a
    chunk whose stacks do not fit one CTA's shared memory; else None (the
    shared-memory body)."""
    if L <= K2_SMEM_MAX_L:
        return None
    return torch.empty(-(-lanes // 32) * 3 * L * 32, dtype=_f32,
                       device=device)


def oasis_pool_merge(v0, w0, ts0, l0, n_in, g, smin) -> Pools:
    """Pass 2. Chunk-major pool lists (K, nc, L) with counts n_in (K, nc),
    as pass 1 left them -> merged pools (K, nc * L) packed from slot 0,
    counts n (K,)."""
    if not v0.is_cuda:
        return oasis_pool_merge_reference(v0, w0, ts0, l0, n_in, g, smin)
    check_cuda(v0, w0, ts0, l0, n_in, g, smin,
               dtypes=(_f32, _f32, _i32, _i32, _i32, _f32, _f32))
    K, nc, L = v0.shape
    _check_shapes((w0, v0.shape), (ts0, v0.shape), (l0, v0.shape),
                  (n_in, (K, nc)), (g, (K,)), (smin, (K,)))
    v, w, ts, ln = _uninit_pools((K, nc * L), v0.device)
    n = torch.empty((K,), dtype=_i32, device=v0.device)
    launch("oasis_pool_merge", v0.device, v0, w0, ts0, l0, n_in, g, smin,
           K, nc, L, v, w, ts, ln, n)
    return v, w, ts, ln, n


def oasis_reconstruct(v, w, ts, ln, n, g, T: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pools (K, P) covering [0, T) -> c, s (K, T):
    c[t] = max(v/w, 0) g^(t - t0) on [t0, t0 + len), and
    s[t0] = c[t0] - g c[t0 - 1] at every pool start 0 < t0 < T; pools that
    start at or past T are ignored."""
    if not v.is_cuda:
        return oasis_reconstruct_reference(v, w, ts, ln, n, g, T)
    check_cuda(v, w, ts, ln, n, g,
               dtypes=(_f32, _f32, _i32, _i32, _i32, _f32))
    K, P = v.shape
    _check_shapes((w, v.shape), (ts, v.shape), (ln, v.shape), (n, (K,)),
                  (g, (K,)))
    c = torch.empty((K, T), dtype=_f32, device=v.device)
    s = torch.empty((K, T), dtype=_f32, device=v.device)
    launch("oasis_reconstruct", v.device, v, w, ts, n, g, K, P, T, c, s)
    return c, s


@functools.lru_cache(maxsize=64)
def _solve_workspace(K: int, T: int, L: int) -> int:
    """Bytes of the solve's workspace, from the layout in csrc/oasis.cu."""
    return int(load_library().oasis_solve_workspace(K, T, L))


def oasis_solve(y: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
                smin: torch.Tensor, L: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole solve: y (K, T) float32, g, lam, smin (K,) -> c, s (K, T),
    in chunks of L. CUDA tensors: one C entry launches pass 1 (forming
    its input from y and lam; the last chunk ends at T), pass 2 and the
    reconstruction on the current stream, its pools in one workspace.
    CPU tensors: the plain chain, :func:`oasis_solve_reference`."""
    if not y.is_cuda:
        return oasis_solve_reference(y, g, lam, smin, L)
    check_cuda(y, g, lam, smin, dtypes=(_f32, _f32, _f32, _f32))
    K, T = y.shape
    _check_shapes((g, (K,)), (lam, (K,)), (smin, (K,)))
    ws = torch.empty(_solve_workspace(K, T, L), dtype=torch.uint8,
                     device=y.device)
    c = torch.empty((K, T), dtype=_f32, device=y.device)
    s = torch.empty((K, T), dtype=_f32, device=y.device)
    launch(OASIS_KERNELS, y.device, y, g, lam, smin, K, T, L, ws, c, s,
           entry="oasis_solve_launch")
    return c, s
