"""Minimal RIFF/AVI reader for grayscale movies; a copy of
``cnmf_e_tpu/io/avi.py``, so that the port stands alone.

Reference reads AVI via VideoReader (``smod_bigread2.m``). Natively
supported: raw cases acquisition tools emit — 'DIB '/raw (BI_RGB) 8/16-bit
frames, and 'Y800'/'GREY' fourccs. MJPEG ('MJPG') is supported through a
per-chunk JPEG decode (every MJPEG frame is a standalone JPEG; the RIFF
index built here keeps random access) via cv2 or PIL when available.
Other codecs raise with a clear message.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class AviInfo:
    shape: Tuple[int, int, int]          # (T, H, W)
    dtype: np.dtype
    frame_offsets: List[int]             # offsets of 'movi' data chunks
    frame_sizes: List[int]
    bits: int
    upside_down: bool                    # BMP rows bottom-up
    codec: str = "raw"                   # {"raw", "mjpeg"}


def _decode_jpeg_gray(buf: bytes) -> np.ndarray:
    """Decode one JPEG to grayscale via cv2 (preferred) or PIL."""
    try:
        import cv2
        arr = np.frombuffer(buf, np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError("cv2 could not decode MJPEG frame")
        return img
    except ImportError:
        pass
    try:
        import io as _io
        from PIL import Image
        return np.asarray(Image.open(_io.BytesIO(buf)).convert("L"))
    except ImportError as e:
        raise NotImplementedError(
            "MJPEG AVI needs cv2 or PIL for the JPEG decode; neither is "
            "importable — convert to TIFF/HDF5 first") from e


def _read_chunks(f, end, depth=0):
    """Yield (fourcc, size, data_offset) of chunks until ``end``."""
    while f.tell() + 8 <= end:
        hdr = f.read(8)
        if len(hdr) < 8:
            return
        fourcc, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        data_off = f.tell()
        yield fourcc, size, data_off
        f.seek(data_off + size + (size & 1))


def probe_avi(path: str) -> AviInfo:
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"AVI ":
            raise ValueError("not an AVI file")
        file_end = 8 + struct.unpack("<I", riff[4:8])[0]

        H = W = bits = 0
        compression = 0
        frame_offsets: List[int] = []
        frame_sizes: List[int] = []

        def walk(end):
            nonlocal H, W, bits, compression
            for fourcc, size, off in _read_chunks(f, end):
                if fourcc == b"LIST":
                    list_type = f.read(4) if f.seek(off) or True else b""
                    inner_end = off + size
                    if list_type in (b"hdrl", b"strl", b"movi"):
                        if list_type == b"movi":
                            f.seek(off + 4)
                            for fc, sz, do in _read_chunks(f, inner_end):
                                if fc[2:4] in (b"db", b"dc") and sz > 0:
                                    frame_offsets.append(do)
                                    frame_sizes.append(sz)
                        else:
                            f.seek(off + 4)
                            walk(inner_end)
                elif fourcc == b"strf" and H == 0:
                    f.seek(off)
                    bmih = f.read(min(size, 40))
                    W = struct.unpack("<i", bmih[4:8])[0]
                    H_raw = struct.unpack("<i", bmih[8:12])[0]
                    H = abs(H_raw)
                    bits = struct.unpack("<H", bmih[14:16])[0]
                    compression = struct.unpack("<I", bmih[16:20])[0]
                f.seek(off + size + (size & 1))

        f.seek(12)
        walk(file_end)

        # BI_RGB (0) or raw grayscale fourccs
        GREY = {0, struct.unpack("<I", b"Y800")[0],
                struct.unpack("<I", b"GREY")[0],
                struct.unpack("<I", b"DIB ")[0]}
        MJPG = {struct.unpack("<I", b"MJPG")[0],
                struct.unpack("<I", b"mjpg")[0]}
        if compression in MJPG:
            codec = "mjpeg"
        elif compression in GREY:
            codec = "raw"
        else:
            raise NotImplementedError(
                f"compressed AVI (fourcc {compression:#x}) not supported; "
                "convert to TIFF/HDF5 first")
        if not frame_offsets:
            raise ValueError("no video frames found in AVI")
        dtype = np.uint16 if bits == 16 and codec == "raw" else np.uint8
        return AviInfo((len(frame_offsets), H, W), dtype, frame_offsets,
                       frame_sizes, bits, upside_down=(codec == "raw"),
                       codec=codec)


def read_avi(path: str, start: int = 0, count: Optional[int] = None
             ) -> np.ndarray:
    info = probe_avi(path)
    T, H, W = info.shape
    if count is None:
        count = T - start
    count = min(count, T - start)
    itemsize = np.dtype(info.dtype).itemsize
    # BMP rows pad to 4-byte boundaries
    row_bytes = (W * itemsize * 8 // 8 + 3) & ~3 if info.bits == 8 else \
        (W * itemsize + 3) & ~3
    out = np.empty((count, H, W), info.dtype)
    with open(path, "rb") as f:
        for i in range(count):
            off = info.frame_offsets[start + i]
            sz = info.frame_sizes[start + i]
            f.seek(off)
            raw = f.read(sz)
            if info.codec == "mjpeg":
                img = _decode_jpeg_gray(raw)
                out[i] = img[:H, :W]
                continue
            if sz >= row_bytes * H:
                frame = np.frombuffer(raw[:row_bytes * H], np.uint8)
                frame = frame.reshape(H, row_bytes)[:, :W * itemsize]
                frame = frame.view(info.dtype)[:, :W]
            else:  # tightly packed
                frame = np.frombuffer(raw[:H * W * itemsize],
                                      info.dtype).reshape(H, W)
            out[i] = frame[::-1] if info.upside_down else frame
    return out


def write_avi(path: str, movie: np.ndarray, fps: int = 10) -> None:
    """Write (T, H, W) uint8 as an uncompressed grayscale AVI (8-bit DIB
    with a grayscale palette), mostly for tests and quick viewing."""
    movie = np.asarray(movie)
    if movie.dtype != np.uint8:
        lo, hi = movie.min(), movie.max()
        movie = ((movie - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    T, H, W = movie.shape
    row_bytes = (W + 3) & ~3
    frame_bytes = row_bytes * H

    def chunk(fourcc, payload):
        pad = b"\0" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    avih = struct.pack("<14I", 1000000 // fps, frame_bytes * fps, 0, 0x10,
                       T, 0, 1, frame_bytes, W, H, 0, 0, 0, 0)
    strh = (b"vids" + b"DIB " + struct.pack("<I", 0)
            + struct.pack("<HHIIIIIIIII", 0, 0, 0, 0, 1, fps, 0, T,
                          frame_bytes, 0, 0) + struct.pack("<4H", 0, 0,
                                                           W, H))
    palette = b"".join(struct.pack("<BBBB", i, i, i, 0) for i in range(256))
    strf = struct.pack("<IiiHHIIiiII", 40, W, H, 1, 8, 0, frame_bytes,
                       0, 0, 256, 0) + palette
    strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh)
                 + chunk(b"strf", strf))
    hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl)

    frames = b""
    for t in range(T):
        img = movie[t][::-1]  # bottom-up
        if row_bytes != W:
            img = np.pad(img, ((0, 0), (0, row_bytes - W)))
        frames += chunk(b"00db", img.tobytes())
    movi = chunk(b"LIST", b"movi" + frames)
    riff = b"AVI " + hdrl + movi
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)
