"""JPEG reading and writing in place of OpenCV, by the port's native
library (`native/src/jpeg.cpp`).

The ScanNet loader reads its colour frames with `cv2.imread` (ref:
src/dataset.py:303-304; the JAX package's data/scannet.py:137-138), and the
machine the port runs on has no OpenCV. `imread(path)` returns what
`cv2.imread(path)` returns, byte for byte: (H, W, 3) uint8 in BGR order,
a grey file's samples in all three channels. It decodes baseline and
extended-Huffman files (8-bit, grey or YCbCr, sampling factors up to 2 x 2,
restart markers) as libjpeg-turbo does with its defaults: the integer
islow inverse DCT, fancy upsampling and its fixed-point colour tables.
Anything else raises ValueError with the file's name, never a wrong
image: progressive, lossless or arithmetic-coded files, 12-bit samples,
CMYK, YCCK or RGB-coded files, a height defined by DNL, an EXIF
orientation other than 1 (which `cv2.imread` would apply).

`imencode(img, quality)` gives the bytes of a baseline JPEG file of a
uint8 BGR image (YCbCr, 4:2:0 sampling, the standard tables scaled by
quality, as libjpeg scales them), and `imwrite(path, img, quality)`
writes them; they serve the ScanNet layout writer
(`data/scannet.write_scannet_layout`).
"""

from __future__ import annotations

import numpy as np

from catnerf_torch.native.lib import geomlib


def imdecode(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`cv2.imdecode(data, cv2.IMREAD_COLOR)` of a JPEG file's bytes:
    (H, W, 3) uint8 BGR; `path` names the file in errors."""
    try:
        return geomlib.jpeg_decode(bytes(data))
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def imread(path: str) -> np.ndarray:
    """`cv2.imread(path)` of a JPEG file: (H, W, 3) uint8 BGR."""
    with open(path, "rb") as f:
        return imdecode(f.read(), path)


def imencode(img: np.ndarray, quality: int = 95) -> bytes:
    """The bytes of a baseline JPEG file of a uint8 (H, W, 3) BGR image
    at `quality` (1-100)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"cannot write a {img.dtype} image of shape "
                         f"{img.shape} as a JPEG (uint8 BGR)")
    return geomlib.jpeg_encode(img, quality)


def imwrite(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write `imencode(img, quality)` to `path`, as `cv2.imwrite(path, img,
    [cv2.IMWRITE_JPEG_QUALITY, quality])` does."""
    try:
        data = imencode(img, quality)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    with open(path, "wb") as f:
        f.write(data)
