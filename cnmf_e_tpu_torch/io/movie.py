"""Movie loading dispatch (a copy of ``cnmf_e_tpu/io/movie.py``; reference:
``smod_bigread2.m``, ``get_data_dimension.m``).

Supported containers: TIFF (incl. ImageJ contiguous stacks), HDF5 (.h5/.hdf5
and v7.3 .mat), NumPy (.npy), and AVI (raw/uncompressed and MJPEG via the
pure-python reader in :mod:`cnmf_e_tpu_torch.io.avi`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from cnmf_e_tpu_torch.io.tiff import probe_tiff, read_tiff


def _h5_main_dataset(h5file):
    """Find the largest 3-D dataset in an HDF5 file."""
    import h5py
    best = None

    def visit(name, obj):
        nonlocal best
        if isinstance(obj, h5py.Dataset) and obj.ndim == 3:
            if best is None or obj.size > h5file[best].size:
                best = name

    h5file.visititems(visit)
    if best is None:
        raise ValueError("no 3-D dataset found in HDF5 file")
    return best


def probe_movie(path: str, dataset: Optional[str] = None
                ) -> Tuple[Tuple[int, int, int], np.dtype]:
    """Return ((T, H, W), dtype) without reading pixel data."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        info = probe_tiff(path)
        return info.shape, info.dtype
    if ext in (".h5", ".hdf5", ".mat"):
        import h5py
        with h5py.File(path, "r") as f:
            ds = f[dataset or _h5_main_dataset(f)]
            return tuple(ds.shape), ds.dtype
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        return tuple(arr.shape), arr.dtype
    if ext == ".avi":
        from cnmf_e_tpu_torch.io.avi import probe_avi
        info = probe_avi(path)
        return info.shape, info.dtype
    raise ValueError(f"unknown movie format {ext!r}")


def load_movie(path: str, start: int = 0, count: Optional[int] = None,
               dataset: Optional[str] = None) -> np.ndarray:
    """Load frames [start, start+count) as a (T, H, W) float32 array."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        return read_tiff(path, start, count).astype(np.float32)
    if ext in (".h5", ".hdf5", ".mat"):
        import h5py
        with h5py.File(path, "r") as f:
            ds = f[dataset or _h5_main_dataset(f)]
            stop = ds.shape[0] if count is None else start + count
            return np.asarray(ds[start:stop], np.float32)
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r")
        stop = arr.shape[0] if count is None else start + count
        return np.asarray(arr[start:stop], np.float32)
    if ext == ".avi":
        from cnmf_e_tpu_torch.io.avi import read_avi
        return read_avi(path, start, count).astype(np.float32)
    raise ValueError(f"unknown movie format {ext!r}")
