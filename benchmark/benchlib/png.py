"""A plain PNG reader for the served views: 8-bit greyscale, RGB or RGBA,
not interlaced, every row filter (PNG specification, section 9)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth_row(raw: np.ndarray, up: np.ndarray, bpp: int) -> np.ndarray:
    out = np.zeros(len(raw), np.int32)
    r, u = raw.astype(np.int32), up.astype(np.int32)
    for i in range(0, len(raw), bpp):
        a = out[i - bpp:i] if i else np.zeros(bpp, np.int32)
        c = u[i - bpp:i] if i else np.zeros(bpp, np.int32)
        b = u[i:i + bpp]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out[i:i + bpp] = (r[i:i + bpp] + pred) & 0xFF
    return out


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 in the file's channel order."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    bpp = CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        f, row = raw[y, 0], raw[y, 1:]
        if f == 0:
            cur = row.copy()
        elif f == 1:
            cur = row.copy()
            for i in range(bpp, stride, bpp):
                cur[i:i + bpp] = cur[i:i + bpp] + cur[i - bpp:i]
        elif f == 2:
            cur = row + prev
        elif f == 3:
            cur = np.zeros(stride, np.uint8)
            for i in range(0, stride, bpp):
                left = cur[i - bpp:i].astype(np.int32) if i else 0
                avg = (left + prev[i:i + bpp].astype(np.int32)) // 2
                cur[i:i + bpp] = (row[i:i + bpp] + avg) & 0xFF
        elif f == 4:
            cur = _paeth_row(row, prev, bpp).astype(np.uint8)
        else:
            raise ValueError(f"row {y}: filter {f}")
        out[y] = cur
        prev = cur
    return out.reshape(height, width, bpp)
