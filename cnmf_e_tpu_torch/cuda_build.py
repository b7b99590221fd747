"""Build, load and launch-count the package's CUDA kernels.

The kernels live in ``csrc/*.cu`` behind ``extern "C"`` launchers that take
raw device pointers, sizes and a ``cudaStream_t``. At first use each source
is compiled by its own ``nvcc -c`` (all started together; no PyTorch
headers, so the build takes seconds) for ``sm_90a``, and the objects are
linked by ``nvcc -shared`` into ``csrc/_build/``, under a file lock and
named by a hash of the sources and flags, then loaded with ``ctypes``.
A failed build raises; nothing falls back to another implementation.

``LAUNCHES`` counts, per kernel, the launches the wrappers made; each
wrapper adds one right after its launch succeeds (the OASIS solve entry,
which launches three kernels, one to each; the masked HALS entry, which
launches two, two to ``hals_sweeps``). ``ENTRY_CALLS`` counts the calls of
each C entry point. ``device_counters`` holds int64 tensors that kernels
add to on the device (the HALS compacted body's tile counts);
``reset_launch_counts`` zeroes them with the host counts.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("hals_sweeps.cu", "oasis.cu", "ring_stencil.cu",
           "ring_banded.cu")
# no --use_fast_math: the HALS mask sentinel (-1e30) and the 1e-12 / 1e-20
# clamps rely on IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

KERNELS = ("hals_sweeps", "oasis_chunk_pools", "oasis_pool_merge",
           "oasis_reconstruct", "ring_stencil", "ring_banded_flat",
           "ring_banded_htw")
LAUNCHES = {name: 0 for name in KERNELS}
# calls of each C entry point, beside the per-kernel counts
ENTRY_CALLS: dict = {}
# (name, device) -> int64 tensor that kernels add to on that device
_COUNTERS: dict = {}

_lock = threading.Lock()
_lib = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # U, V, X, out, mask, gate, starts, ends, free, n_steps, K, d, n_iter,
    # relu, B, TD, KC, stream
    "hals_sweeps_launch": [_P] * 10 + [_I] * 7 + [_P],
    # U, V, X, out, mask, gate, starts, ends, free, n_steps, work, stats, K,
    # d, n_iter, B, TD, KC, n_sm, stream
    "hals_sweeps_masked_launch": [_P] * 12 + [_I] * 7 + [_P],
    # vinit, g, smin, K, nc, L, scratch, v, w, ts, ln, n, stream
    "oasis_chunk_pools_launch": [_P] * 3 + [_I] * 3 + [_P] * 6 + [_P],
    # v0, w0, ts0, l0, n_in, g, smin, K, nc, L, v, w, ts, ln, n, stream
    "oasis_pool_merge_launch": [_P] * 7 + [_I] * 3 + [_P] * 5 + [_P],
    # v, w, ts, n, g, K, P, T, c, s, stream
    "oasis_reconstruct_launch": [_P] * 5 + [_I] * 3 + [_P] * 2 + [_P],
    # y, g, lam, smin, K, T, L, workspace, c, s, stream
    "oasis_solve_launch": [_P] * 4 + [_I] * 3 + [_P] * 3 + [_P],
    # K, T, L -> bytes
    "oasis_solve_workspace": [_I] * 3,
    # K6's two bodies, both counted as ring_stencil:
    # X, wt, w0, out, T, H, W, radius, TT, stream
    "ring_stencil_regs_launch": [_P] * 4 + [_I] * 5 + [_P],
    # X, wt, w0, dy, dx, out, T, H, W, R, mr, HT, WT, TT, stream
    "ring_stencil_smem_launch": [_P] * 6 + [_I] * 8 + [_P],
    # X, bands, w0, kstart, koff, out, T, H, W, D, stream
    "ring_banded_flat_launch": [_P] * 6 + [_I] * 4 + [_P],
    "ring_banded_htw_launch": [_P] * 6 + [_I] * 4 + [_P],
}
_RESTYPES = {"oasis_solve_workspace": ctypes.c_longlong}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    ENTRY_CALLS.clear()
    with _lock:
        for t in _COUNTERS.values():
            t.zero_()


def device_counters(name: str, device, n: int):
    """The (n,) int64 counters ``name`` on ``device``, made as zeros on
    first use; kernels add to them, and reading them synchronises."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        t = _COUNTERS.get((name, device))
        if t is None:
            t = torch.zeros(n, dtype=torch.int64, device=device)
            _COUNTERS[(name, device)] = t
        return t


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _build(so_path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if so_path.exists():
            return
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o")
                for s in SOURCES]
        t0 = time.perf_counter()
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                              str(CSRC / s)] for s, o in zip(SOURCES, objs))]
        logs = []
        try:
            for cmd, proc in procs:
                out = proc.communicate()[0]
                logs.append(out)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                       f"{' '.join(cmd)}\n{out}")
        finally:
            for _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        for o in objs:
            o.unlink()
        os.replace(tmp, so_path)
        build_info.update(seconds=time.perf_counter() - t0,
                          log="".join(logs) + res.stdout + res.stderr)


def load_library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for s in SOURCES:
            h.update((CSRC / s).read_bytes())
        so_path = BUILD_DIR / f"libcnmfe_kernels_{h.hexdigest()[:16]}.so"
        if not so_path.exists():
            _build(so_path)
        lib = ctypes.CDLL(str(so_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        lib.cnmfe_error_string.argtypes = [ctypes.c_int]
        lib.cnmfe_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def launch(kernel: str | tuple, device, *args,
           entry: str | None = None) -> None:
    """Call ``entry`` (by default ``<kernel>_launch``) on ``device``'s
    current stream; raise on a CUDA error; count one launch of ``kernel``,
    or of each kernel of a tuple that ``entry`` launches. Tensor arguments
    pass as their data pointers."""
    import torch
    lib = load_library()
    entry = entry or f"{kernel}_launch"
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        msg = lib.cnmfe_error_string(err).decode()
        raise RuntimeError(f"{entry} failed: CUDA error {err} ({msg})")
    for name in (kernel,) if isinstance(kernel, str) else kernel:
        LAUNCHES[name] += 1
    ENTRY_CALLS[entry] = ENTRY_CALLS.get(entry, 0) + 1


def check_cuda(*tensors, dtypes) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype
    on one device."""
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != dt:
            raise ValueError(f"expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected contiguous tensors")
