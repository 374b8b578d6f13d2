"""8-bit grayscale PNG read and write with the standard library only.

The port needs no Pillow.  ``write_png_gray`` writes 8-bit grayscale with
filter 0 on every row.  ``read_png_gray`` reads non-interlaced 8-bit
grayscale, RGB and RGBA images with any of the five row filters, and
converts colour to L as Pillow's ``convert("L")`` does (ITU-R 601-2
luma in 16-bit fixed point; alpha is ignored).  Anything else raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}   # colour type -> samples per pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_gray(img: np.ndarray) -> bytes:
    """uint8 [H, W] -> PNG bytes (grayscale, 8 bits, filter 0)."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"need a uint8 [H, W] image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape
    raw = np.zeros((h, w + 1), np.uint8)   # a filter-type byte per row
    raw[:, 1:] = img
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters -> uint8 [h, stride]."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(data, np.uint8)[:h * (stride + 1)].reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1)
        elif ftype == 2:      # Up
            cur = line + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.tolist()
            up = prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                c = up[x - bpp] if x >= bpp else 0
                pred = (a + up[x]) >> 1 if ftype == 3 else _paeth(a, up[x], c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        prev = cur & 0xFF
        out[y] = prev
    return out


def read_png_gray(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] grayscale."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
            f"interlace {interlace} (8-bit non-interlaced L, RGB or RGBA "
            "only)")
    ch = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ch == 1:
        return px[:, :, 0]
    rgb = px[:, :, :3].astype(np.uint32)
    luma = (rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
            + rgb[:, :, 2] * 7471 + 0x8000) >> 16
    return luma.astype(np.uint8)
