"""Frozen copy of the port's utils/png.py: the encoder
serves scenes/procgen.py, the decoder the reference's ingest.

PNG encode/decode with only the standard library and numpy.

The ingest path needs PNG in two places: the procedural scenes embed
their textures as PNG images (utils/procgen.py, utils/fixtures.py) and
the loader decodes them again (utils/gltf.py); the CLI writes its image
as PNG (utils/image_io.py). This module covers exactly that subset, so
the port runs where no imaging library is installed:

- write: 8-bit RGB or RGBA, non-interlaced, every row with the "Up"
  filter (type 2), zlib-compressed into one IDAT chunk;
- read: 8-bit RGB or RGBA, non-interlaced, any of the five row filters
  (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), as other encoders write.

Anything else (palette, grey, 16-bit, interlaced) raises ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}   # channels -> PNG color type
_CHANNELS = {2: 3, 6: 4}      # PNG color type -> channels


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3|4] uint8 -> PNG bytes, compressed at zlib's level."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [H, W, 3|4] uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]              # uint8 wraps mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def _unfilter_sequential(ft: int, line: bytes, prev: bytes,
                         bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on its left
    neighbour's decoded value, so these run byte by byte."""
    out = bytearray(line)
    n = len(out)
    for i in range(n):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ft == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            if pa <= pb and pa <= pc:
                pred = a
            elif pb <= pc:
                pred = b
            else:
                pred = c
            out[i] = (out[i] + pred) & 0xFF
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3|4] uint8 (the file's own channel count)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    off = 8
    hdr = None
    idat = []
    while off + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, off)
        body = data[off + 8: off + 8 + length]
        off += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type "
                         f"{ctype}, interlace {interlace} (only 8-bit "
                         f"non-interlaced RGB/RGBA)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong length")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = int(raw[y, 0])
        line = raw[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ft == 2:
            cur = line + prev
        elif ft in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(
                ft, line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ft} in row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, bpp)
