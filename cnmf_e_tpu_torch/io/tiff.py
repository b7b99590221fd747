"""Minimal pure-numpy TIFF stack reader (no external deps); a copy of
``cnmf_e_tpu/io/tiff.py``, so that the port stands alone.

Covers the formats the reference reads with ``smod_bigread2.m`` /
``get_data_dimension.m``: classic multi-page grayscale TIFF and ImageJ's
"fake-bigtiff" (one IFD + ``images=N`` in the ImageDescription, frames laid
out contiguously after the first strip), real BigTIFF (magic 43), and the
compressed variants acquisition software emits: LZW (5), Deflate (8/32946)
and PackBits (32773), each with the optional horizontal differencing
predictor (tag 317 = 2), and multi-strip frames. Supports uint8/16/32 and
float32, little- and big-endian.
"""

from __future__ import annotations

import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

_TAG_WIDTH = 256
_TAG_HEIGHT = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_DESCRIPTION = 270
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PREDICTOR = 317
_TAG_SAMPLE_FORMAT = 339

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q"}

_COMP_NONE = 1
_COMP_LZW = 5
_COMP_DEFLATE = 8
_COMP_DEFLATE_OLD = 32946
_COMP_PACKBITS = 32773


@dataclass
class FramePlan:
    """Strip layout of one frame: parallel (offset, nbytes) lists."""
    offsets: Tuple[int, ...]
    counts: Tuple[int, ...]


@dataclass
class TiffInfo:
    shape: Tuple[int, int, int]     # (T, H, W)
    dtype: np.dtype
    # per-frame (offset, nbytes) when every frame is contiguous+raw
    frame_offsets: List[int]
    frame_nbytes: int
    byteorder: str                  # '<' or '>'
    imagej_contiguous: bool
    compression: int = _COMP_NONE
    predictor: int = 1
    rows_per_strip: int = 0
    # general path: per-frame strip plans (set when compression != 1 or
    # frames are multi-strip)
    frames: Optional[List[FramePlan]] = None


def _read_ifd(f, offset, bo, big):
    """Read one IFD; returns (tags dict, next_ifd_offset)."""
    if big:
        n = struct.unpack(bo + "Q", f.read(8))[0] if f.seek(offset) or True \
            else 0
        entry_size, count_fmt = 20, "Q"
    else:
        f.seek(offset)
        n = struct.unpack(bo + "H", f.read(2))[0]
        entry_size, count_fmt = 12, "I"
    tags = {}
    for _ in range(n):
        data = f.read(entry_size)
        if big:
            tag, typ = struct.unpack(bo + "HH", data[:4])
            cnt = struct.unpack(bo + "Q", data[4:12])[0]
            val_bytes = data[12:20]
        else:
            tag, typ = struct.unpack(bo + "HH", data[:4])
            cnt = struct.unpack(bo + "I", data[4:8])[0]
            val_bytes = data[8:12]
        size = _TYPE_SIZE.get(typ, 1) * cnt
        inline_cap = 8 if big else 4
        if size <= inline_cap:
            raw = val_bytes[:size]
        else:
            ptr = struct.unpack(bo + ("Q" if big else "I"), val_bytes)[0]
            here = f.tell()
            f.seek(ptr)
            raw = f.read(size)
            f.seek(here)
        if typ in _TYPE_FMT:
            fmt = _TYPE_FMT[typ]
            vals = struct.unpack(bo + fmt * cnt, raw)
            tags[tag] = vals if cnt > 1 else (vals[0],)
        elif typ == 2:  # ascii
            tags[tag] = raw.split(b"\0")[0].decode("latin1")
    nxt = struct.unpack(bo + ("Q" if big else "I"),
                        f.read(8 if big else 4))[0]
    return tags, nxt


def probe_tiff(path: str) -> TiffInfo:
    """Parse headers only (cheap, like ``get_data_dimension.m:11-45``)."""
    with open(path, "rb") as f:
        hdr = f.read(8)
        bo = "<" if hdr[:2] == b"II" else ">"
        magic = struct.unpack(bo + "H", hdr[2:4])[0]
        big = magic == 43
        if big:
            f.seek(8)
            first_ifd = struct.unpack(bo + "Q", f.read(8))[0]
        else:
            first_ifd = struct.unpack(bo + "I", hdr[4:8])[0]

        tags, nxt = _read_ifd(f, first_ifd, bo, big)
        H = tags[_TAG_HEIGHT][0]
        W = tags[_TAG_WIDTH][0]
        bits = tags.get(_TAG_BITS, (8,))[0]
        fmt = tags.get(_TAG_SAMPLE_FORMAT, (1,))[0]
        comp = tags.get(_TAG_COMPRESSION, (_COMP_NONE,))[0]
        pred = tags.get(_TAG_PREDICTOR, (1,))[0]
        rps = tags.get(_TAG_ROWS_PER_STRIP, (H,))[0]
        if comp not in (_COMP_NONE, _COMP_LZW, _COMP_DEFLATE,
                        _COMP_DEFLATE_OLD, _COMP_PACKBITS):
            raise ValueError(f"unsupported TIFF compression {comp}")
        kind = {1: "u", 2: "i", 3: "f"}[fmt]
        dtype = np.dtype(f"{bo}{kind}{bits // 8}")

        desc = tags.get(_TAG_DESCRIPTION, "")
        m = re.search(r"images=(\d+)", desc or "")
        offsets0 = tags[_TAG_STRIP_OFFSETS]
        counts0 = tags.get(_TAG_STRIP_COUNTS,
                           (H * W * (bits // 8),) * len(offsets0))
        frame_nbytes = H * W * (bits // 8)

        if m and nxt == 0 and comp == _COMP_NONE and len(offsets0) == 1:
            # ImageJ contiguous stack: frames follow the first strip
            T = int(m.group(1))
            return TiffInfo((T, H, W), dtype,
                            [offsets0[0] + i * frame_nbytes
                             for i in range(T)],
                            frame_nbytes, bo, True)

        # classic multi-IFD: walk the chain, keeping every strip
        plans = [FramePlan(tuple(offsets0), tuple(counts0))]
        while nxt:
            tags_i, nxt = _read_ifd(f, nxt, bo, big)
            offs = tags_i[_TAG_STRIP_OFFSETS]
            cnts = tags_i.get(_TAG_STRIP_COUNTS,
                              (frame_nbytes,) * len(offs))
            plans.append(FramePlan(tuple(offs), tuple(cnts)))
        T = len(plans)
        simple = comp == _COMP_NONE and all(len(p.offsets) == 1
                                            for p in plans)
        return TiffInfo(
            (T, H, W), dtype,
            [p.offsets[0] for p in plans] if simple else [],
            frame_nbytes, bo, False, compression=comp, predictor=pred,
            rows_per_strip=rps,
            frames=None if simple else plans)


def _decode_strip(raw: bytes, comp: int) -> bytes:
    if comp == _COMP_NONE:
        return raw
    if comp in (_COMP_DEFLATE, _COMP_DEFLATE_OLD):
        return zlib.decompress(raw)
    if comp == _COMP_PACKBITS:
        return _packbits_decode(raw)
    if comp == _COMP_LZW:
        return _lzw_decode(raw)
    raise ValueError(f"unsupported TIFF compression {comp}")


def _packbits_decode(raw: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(raw)
    while i < n:
        h = raw[i]
        i += 1
        if h < 128:
            out += raw[i:i + h + 1]
            i += h + 1
        elif h > 128:
            out += raw[i:i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def _lzw_decode(raw: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first bit packing, 9->12 bit codes with early
    change, ClearCode 256, EOI 257)."""
    CLEAR, EOI = 256, 257
    data = np.frombuffer(raw, np.uint8)
    # bit reader state
    out = bytearray()
    table: List[bytes] = []

    def reset_table():
        nonlocal table
        table = [bytes([i]) for i in range(256)] + [b"", b""]

    reset_table()
    bitpos = 0
    nbits = 9
    total_bits = len(data) * 8
    prev: Optional[bytes] = None
    while bitpos + nbits <= total_bits:
        byte0 = bitpos >> 3
        # read up to 3 bytes covering the code
        chunk = int.from_bytes(raw[byte0:byte0 + 3].ljust(3, b"\0"), "big")
        shift = 24 - nbits - (bitpos & 7)
        code = (chunk >> shift) & ((1 << nbits) - 1)
        bitpos += nbits
        if code == EOI:
            break
        if code == CLEAR:
            reset_table()
            nbits = 9
            prev = None
            continue
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        # TIFF early change: the encoder widens when its next free code is
        # 2^n - 1; the decoder's table lags one insert behind, so widen at
        # 2^n - 2
        if len(table) >= (1 << nbits) - 2 and nbits < 12:
            nbits += 1
    return bytes(out)


def _undo_predictor(frame: np.ndarray, predictor: int) -> np.ndarray:
    if predictor == 2:
        # horizontal differencing: integrate along rows in the integer type
        return np.cumsum(frame, axis=-1, dtype=frame.dtype)
    return frame


def _read_frame_general(f, info: TiffInfo, i: int) -> np.ndarray:
    T, H, W = info.shape
    plan = info.frames[i]
    parts = []
    for off, cnt in zip(plan.offsets, plan.counts):
        f.seek(off)
        parts.append(_decode_strip(f.read(cnt), info.compression))
    buf = b"".join(parts)[:info.frame_nbytes]
    frame = np.frombuffer(buf, info.dtype).reshape(H, W)
    return _undo_predictor(frame, info.predictor)


def read_tiff(path: str, start: int = 0, count: Optional[int] = None
              ) -> np.ndarray:
    """Read ``count`` frames starting at ``start``. Returns (T, H, W)."""
    info = probe_tiff(path)
    T, H, W = info.shape
    if count is None:
        count = T - start
    count = min(count, T - start)
    out = np.empty((count, H, W), info.dtype)
    with open(path, "rb") as f:
        if info.imagej_contiguous:
            f.seek(info.frame_offsets[start])
            data = f.read(info.frame_nbytes * count)
            out[:] = np.frombuffer(data, info.dtype).reshape(count, H, W)
        elif info.frames is None:
            for i in range(count):
                f.seek(info.frame_offsets[start + i])
                out[i] = np.frombuffer(f.read(info.frame_nbytes),
                                       info.dtype).reshape(H, W)
        else:
            for i in range(count):
                out[i] = _read_frame_general(f, info, start + i)
    return out


def write_tiff(path: str, movie: np.ndarray,
               bigtiff: Optional[bool] = None) -> None:
    """Write a (T, H, W) stack as a little-endian multi-IFD TIFF
    (reference: ``utilities/writeTiff.m``). Supports u8/u16/f32.

    ``bigtiff``: force the BigTIFF (magic 43, 64-bit offsets) layout; by
    default it switches on automatically when the file would cross the
    classic 4 GB offset limit.
    """
    movie = np.ascontiguousarray(movie)
    T, H, W = movie.shape
    dt = movie.dtype
    if dt == np.float64:
        movie = movie.astype(np.float32)
        dt = movie.dtype
    bits = dt.itemsize * 8
    fmt = {"u": 1, "i": 2, "f": 3}[dt.kind]
    frame_nbytes = H * W * dt.itemsize
    if bigtiff is None:
        bigtiff = 16 + T * (8 + 9 * 20 + 8) + T * frame_nbytes >= 2**32 - 16

    if not bigtiff:
        n_tags = 9
        ifd_size = 2 + n_tags * 12 + 4
        with open(path, "wb") as f:
            f.write(b"II*\x00")
            f.write(struct.pack("<I", 8))
            data_base = 8 + T * ifd_size

            def tag(t, typ, cnt, val):
                return struct.pack("<HHI4s", t, typ, cnt,
                                   struct.pack("<I", val))

            for i in range(T):
                entries = [
                    tag(_TAG_WIDTH, 4, 1, W),
                    tag(_TAG_HEIGHT, 4, 1, H),
                    tag(_TAG_BITS, 3, 1, bits),
                    tag(_TAG_COMPRESSION, 3, 1, 1),
                    tag(262, 3, 1, 1),  # photometric: BlackIsZero
                    tag(_TAG_STRIP_OFFSETS, 4, 1,
                        data_base + i * frame_nbytes),
                    tag(_TAG_ROWS_PER_STRIP, 4, 1, H),
                    tag(_TAG_STRIP_COUNTS, 4, 1, frame_nbytes),
                    tag(_TAG_SAMPLE_FORMAT, 3, 1, fmt),
                ]
                nxt = 8 + (i + 1) * ifd_size if i + 1 < T else 0
                f.write(struct.pack("<H", n_tags) + b"".join(entries)
                        + struct.pack("<I", nxt))
            f.write(movie.astype(dt.newbyteorder("<")).tobytes())
        return

    # ---- BigTIFF: 16-byte header, 64-bit counts/offsets --------------- #
    n_tags = 9
    ifd_size = 8 + n_tags * 20 + 8
    with open(path, "wb") as f:
        f.write(b"II+\x00")                       # magic 43
        f.write(struct.pack("<HH", 8, 0))          # offset size 8, pad
        f.write(struct.pack("<Q", 16))             # first IFD at 16
        data_base = 16 + T * ifd_size

        def btag(t, typ, cnt, val):
            return struct.pack("<HHQ8s", t, typ, cnt,
                               struct.pack("<Q", val))

        for i in range(T):
            entries = [
                btag(_TAG_WIDTH, 4, 1, W),
                btag(_TAG_HEIGHT, 4, 1, H),
                btag(_TAG_BITS, 3, 1, bits),
                btag(_TAG_COMPRESSION, 3, 1, 1),
                btag(262, 3, 1, 1),
                btag(_TAG_STRIP_OFFSETS, 16, 1,
                     data_base + i * frame_nbytes),
                btag(_TAG_ROWS_PER_STRIP, 4, 1, H),
                btag(_TAG_STRIP_COUNTS, 16, 1, frame_nbytes),
                btag(_TAG_SAMPLE_FORMAT, 3, 1, fmt),
            ]
            nxt = 16 + (i + 1) * ifd_size if i + 1 < T else 0
            f.write(struct.pack("<Q", n_tags) + b"".join(entries)
                    + struct.pack("<Q", nxt))
        f.write(movie.astype(dt.newbyteorder("<")).tobytes())
