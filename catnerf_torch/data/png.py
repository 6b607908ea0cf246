"""PNG reading and writing in numpy and zlib, in place of OpenCV; the row
filters are undone by the port's native library (`native/src/png.cpp`).

The Replica loader reads its frames with `cv2.imread` (ref:
src/dataset.py:105-109; the JAX package's data/replica.py:111-115), and the
machine the port runs on has no OpenCV. These readers return what OpenCV
returns, byte for byte:

- `imread_unchanged(path)`: `cv2.imread(path, cv2.IMREAD_UNCHANGED)`:
  grey (H, W), colour (H, W, 3) in BGR order, with alpha (H, W, 4) BGRA,
  uint8 or uint16 as the file's bit depth; a palette file expanded to BGR
  (BGRA where it has a tRNS chunk).
- `imread_color(path)`: `cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)`:
  always (H, W, 3) uint8 RGB; grey replicated into the three channels,
  alpha dropped, 16-bit samples cut to their high byte (libpng's
  `png_set_strip_16`, which OpenCV uses).

Supported: bit depths 8 and 16 (16-bit samples big-endian on disk), colour
types 0 (grey), 2 (RGB), 3 (palette, 8-bit) and 6 (RGBA), the five row
filters. Anything else raises ValueError with the file's name, never a
wrong image: interlaced (Adam7) files, other bit depths, grey with alpha,
a bad signature or CRC.

`imwrite(path, img)` writes uint8 or uint16 grey, BGR or BGRA arrays (the
channel order of `cv2.imwrite`), each row with the filter libpng's
adaptive choice gives it, as the files of a recorded dataset have them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from catnerf_torch.native.lib import geomlib

SIGNATURE = b"\x89PNG\r\n\x1a\n"
GREY, RGB, PALETTE, RGBA = 0, 2, 3, 6
CHANNELS = {GREY: 1, RGB: 3, PALETTE: 1, RGBA: 4}


def _chunks(path: str, data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: chunk {kind!r} is truncated or its "
                             f"CRC is wrong")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(path: str, raw: bytes, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """The five PNG row filters undone: (height, row_bytes) uint8."""
    stride = row_bytes + 1
    if len(raw) < height * stride:
        raise ValueError(f"{path}: image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * stride).reshape(height,
                                                                 stride)
    try:
        return geomlib.png_unfilter(rows, bpp)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _decode(path: str):
    """(samples (H, W, C) uint8|uint16 in the file's channel order,
    colour type, palette, tRNS body)."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or no IDAT chunk")
    width, height, depth, ctype, method, filt_method, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG files are not "
                         f"supported")
    if method or filt_method:
        raise ValueError(f"{path}: unknown compression or filter method")
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: colour type {ctype} is not supported")
    if depth not in (8, 16) or (ctype == PALETTE and depth != 8):
        raise ValueError(f"{path}: bit depth {depth} is not supported for "
                         f"colour type {ctype}")
    if ctype == PALETTE and palette is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    channels = CHANNELS[ctype]
    bpp = channels * depth // 8
    raw = _unfilter(path, zlib.decompress(b"".join(idat)), height,
                    width * bpp, bpp)
    if depth == 16:
        img = raw.view(">u2").astype(np.uint16)
    else:
        img = raw
    return img.reshape(height, width, channels), ctype, palette, trns


def _expand_palette(path: str, idx: np.ndarray, palette: np.ndarray,
                    trns: bytes | None) -> np.ndarray:
    """Palette indices (H, W) -> RGB, or RGBA where there is a tRNS."""
    if int(idx.max(initial=0)) >= len(palette):
        raise ValueError(f"{path}: palette index out of range")
    rgb = palette[idx]
    if trns is None:
        return rgb
    alpha = np.full(len(palette), 255, np.uint8)
    t = np.frombuffer(trns, np.uint8)[:len(palette)]
    alpha[:len(t)] = t
    return np.concatenate([rgb, alpha[idx][..., None]], axis=-1)


def _trns_alpha(img: np.ndarray, trns: bytes) -> np.ndarray:
    """The alpha channel a tRNS chunk gives a grey or RGB image: 0 where
    the pixel equals the transparent colour, else the sample maximum."""
    key = np.frombuffer(trns, ">u2").astype(np.int64)
    hit = (img.astype(np.int64) == key[:img.shape[-1]]).all(-1)
    top = np.iinfo(img.dtype).max
    return np.where(hit, 0, top).astype(img.dtype)[..., None]


def imread_unchanged(path: str) -> np.ndarray:
    """`cv2.imread(path, cv2.IMREAD_UNCHANGED)` (see module docstring)."""
    img, ctype, palette, trns = _decode(path)
    if ctype == GREY:
        return img[..., 0].copy()
    if ctype == PALETTE:
        img = _expand_palette(path, img[..., 0], palette, trns)
    elif ctype == RGB and trns is not None:
        img = np.concatenate([img, _trns_alpha(img, trns)], axis=-1)
    order = [2, 1, 0, 3][:img.shape[-1]]
    return np.ascontiguousarray(img[..., order])


def imread_color(path: str) -> np.ndarray:
    """`cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)` (see module
    docstring): (H, W, 3) uint8 RGB."""
    img, ctype, palette, _ = _decode(path)
    if ctype == PALETTE:
        img = _expand_palette(path, img[..., 0], palette, None)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if ctype == GREY:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_rows(data: np.ndarray, bpp: int) -> np.ndarray:
    """(H, row_bytes) uint8 -> (H, 1 + row_bytes): each row filtered and
    led by its filter byte, the filter whose bytes, read as signed, have
    the least sum of magnitudes (libpng's adaptive choice)."""
    x = data.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth])
    cand = (cand & 0xFF).astype(np.uint8)
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1)
    pick = cost.argmin(0)
    rows = cand[pick, np.arange(len(x))]
    return np.concatenate([pick.astype(np.uint8)[:, None], rows], axis=1)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 or uint16 image: (H, W) grey, (H, W, 3) BGR or
    (H, W, 4) BGRA, as `cv2.imwrite` takes it, its rows filtered
    adaptively (`_filter_rows`)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: PNG samples are uint8 or uint16, not "
                         f"{img.dtype}")
    if img.ndim == 2:
        ctype, samples = GREY, img[..., None]
    elif img.ndim == 3 and img.shape[-1] in (3, 4):
        ctype = RGB if img.shape[-1] == 3 else RGBA
        samples = img[..., [2, 1, 0, 3][:img.shape[-1]]]
    else:
        raise ValueError(f"{path}: cannot write an image of shape "
                         f"{img.shape}")
    height, width, channels = samples.shape
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(samples.astype(f">u{img.dtype.itemsize}"))
    raw = _filter_rows(rows.view(np.uint8).reshape(height, -1),
                       channels * img.dtype.itemsize)
    header = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + _chunk(b"IEND", b""))
