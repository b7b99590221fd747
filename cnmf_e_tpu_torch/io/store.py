"""Chunked movie store: the ``distribute_data`` equivalent (a copy of
``cnmf_e_tpu/io/store.py``, with the same on-disk layout).

The store's jobs are (1) one-pass RAM-bounded ingest from the container
format, (2) a frame-blocked chunk layout for streaming and batch mode, and
(3) the cached per-pixel noise (the reference caches sn in the data file
too, ``Sources2D.m:247-256``). Chunks are plain ``block_%05d.npy`` files
beside a ``manifest.json`` and an optional ``sn_pix.npy``; a store written
by either package opens in the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from cnmf_e_tpu_torch.io.movie import load_movie, probe_movie


@dataclass
class MovieStore:
    """Frame-blocked movie store on disk."""

    root: str

    @property
    def manifest(self) -> dict:
        if not hasattr(self, "_manifest"):
            with open(os.path.join(self.root, "manifest.json")) as f:
                self._manifest = json.load(f)
        return self._manifest

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.manifest["shape"])

    @property
    def frames_per_block(self) -> int:
        return self.manifest["frames_per_block"]

    def _block_path(self, i: int) -> str:
        return os.path.join(self.root, f"block_{i:05d}.npy")

    def n_blocks(self) -> int:
        T = self.shape[0]
        return -(-T // self.frames_per_block)

    def read_block(self, i: int) -> np.ndarray:
        return np.load(self._block_path(i), mmap_mode="r")

    def read_frames(self, start: int, count: int) -> np.ndarray:
        """Assemble an arbitrary frame range from blocks."""
        T, H, W = self.shape
        count = min(count, T - start)
        out = np.empty((count, H, W), np.float32)
        fpb = self.frames_per_block
        done = 0
        while done < count:
            t = start + done
            blk, off = divmod(t, fpb)
            data = self.read_block(blk)
            n = min(count - done, data.shape[0] - off)
            out[done:done + n] = data[off:off + n]
            done += n
        return out

    def iter_blocks(self) -> Iterator[np.ndarray]:
        for i in range(self.n_blocks()):
            yield np.asarray(self.read_block(i), np.float32)

    def iter_blocks_raw(self) -> Iterator[np.ndarray]:
        """Blocks in their stored dtype (float16 for the simulated scale
        store), as memmaps."""
        for i in range(self.n_blocks()):
            yield self.read_block(i)

    # cached per-pixel noise map (analog of sn caching in the data file)
    def load_noise(self) -> Optional[np.ndarray]:
        p = os.path.join(self.root, "sn_pix.npy")
        return np.load(p) if os.path.exists(p) else None

    def save_noise(self, sn: np.ndarray) -> None:
        np.save(os.path.join(self.root, "sn_pix.npy"), np.asarray(sn))


def distribute_movie(src: str, out_dir: str, frames_per_block: int = 1000,
                     dataset: Optional[str] = None,
                     max_ram_frames: int = 2000,
                     overwrite: bool = False) -> MovieStore:
    """One-pass, RAM-bounded ingest of a movie file into a MovieStore.

    Reuses an existing store when the layout matches (the reference reuses
    its distributed file the same way, ``distribute_data.m:119-126``).
    """
    man_path = os.path.join(out_dir, "manifest.json")
    shape, dtype = probe_movie(src, dataset=dataset)
    if os.path.exists(man_path) and not overwrite:
        store = MovieStore(out_dir)
        if (tuple(store.shape) == tuple(shape)
                and store.frames_per_block == frames_per_block):
            return store
    os.makedirs(out_dir, exist_ok=True)
    T, H, W = shape
    n_blocks = -(-T // frames_per_block)
    for b in range(n_blocks):
        t0 = b * frames_per_block
        n = min(frames_per_block, T - t0)
        chunk = np.empty((n, H, W), np.float32)
        done = 0
        while done < n:
            take = min(max_ram_frames, n - done)
            chunk[done:done + take] = load_movie(src, t0 + done, take,
                                                 dataset=dataset)
            done += take
        np.save(os.path.join(out_dir, f"block_{b:05d}.npy"), chunk)
    with open(man_path, "w") as f:
        json.dump({"shape": [T, H, W], "frames_per_block": frames_per_block,
                   "source": os.path.abspath(src),
                   "source_dtype": str(dtype)}, f)
    return MovieStore(out_dir)
