"""Image-space transforms (ref: src/image_transforms.py:5-60): a copy of
the JAX package's `data/transforms.py`, with OpenCV's resampling done in
numpy (the machine the port runs on has no OpenCV):

- `resize_linear(img, (W, H))`: `cv2.resize(img, (W, H),
  interpolation=cv2.INTER_LINEAR)` of a uint8 image, bit for bit as
  OpenCV's x86 build computes it (the ScanNet loader's colour resize);
- `resize_nearest(img, (W, H))`: `cv2.INTER_NEAREST`, bit for bit (the
  loader's masks);
- `Undistort`: `cv2.initUndistortRectifyMap` (plumb bob, CV_32FC1 maps)
  and `cv2.remap` with INTER_LINEAR and a zero border, of uint8 images.
  The maps are computed in float64 as OpenCV computes them, but the
  camera matrix is inverted by numpy rather than by OpenCV's SVD, so a
  map may differ from OpenCV's by a float32 rounding: held to 1e-3 pixel.
  The image is held to 1 level, on at most 1e-4 of its pixels
  (tests/test_torch_transforms.py).
"""

from __future__ import annotations

import numpy as np


def depth_scale(depth: np.ndarray, scale: float) -> np.ndarray:
    """Raw depth units -> meters (ref: src/image_transforms.py:5-17)."""
    return depth.astype(np.float32) * scale


def depth_filter(depth: np.ndarray, max_depth: float) -> np.ndarray:
    """Zero out far depth (ref: src/image_transforms.py:20-30)."""
    out = depth.copy()
    out[out > max_depth] = 0.0
    return out


def bgr_to_rgb(image: np.ndarray) -> np.ndarray:
    """(ref: src/image_transforms.py:33-40)."""
    return image[..., ::-1].copy()


# OpenCV's resize: 11-bit interpolation coefficients
# (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def _linear_taps(src: int, dst: int, clamp_weights: bool):
    """OpenCV's resizeGeneric coefficients along one axis: source taps
    (i0, i1) and 11-bit weights (w0, w1) of each destination index. The
    position is float32 ((d + 0.5) * scale - 0.5, in float64 then
    rounded); along x a position outside the source takes the edge
    sample's weight alone, along y only the rows are clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale
         - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = (f - i.astype(np.float32)).astype(np.float32)
    if clamp_weights:
        low = i < 0
        frac[low] = 0.0
        i[low] = 0
        high = i >= src - 1
        frac[high] = 0.0
        i[high] = src - 1
    w0 = np.rint((np.float32(1.0) - frac) * np.float32(_COEF_SCALE))
    w1 = np.rint(frac * np.float32(_COEF_SCALE))
    return (np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1),
            w0.astype(np.int64), w1.astype(np.int64))


def resize_linear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)` of a uint8
    (H, W) or (H, W, C) image; size is (W, H) as OpenCV takes it. The
    identity copies; an exact halving is OpenCV's INTER_AREA (the mean of
    each 2 x 2, rounded half up); else the horizontal pass is exact in
    11-bit fixed point and the vertical pass rounds as OpenCV's vector
    code does: (((S0 >> 4) * b0 >> 16) + ((S1 >> 4) * b1 >> 16) + 2) >> 2."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_linear takes uint8 images, not {img.dtype}")
    W, H = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    src = img.astype(np.int64).reshape(h, w, -1)
    if (2 * W, 2 * H) == (w, h):
        s = (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2]
             + src[1::2, 1::2] + 2) >> 2
        return s.astype(np.uint8).reshape((H, W) + img.shape[2:])
    x0, x1, a0, a1 = _linear_taps(w, W, clamp_weights=True)
    y0, y1, b0, b1 = _linear_taps(h, H, clamp_weights=False)
    rows = (src[:, x0] * a0[None, :, None]
            + src[:, x1] * a1[None, :, None])
    s0 = rows[y0] >> 4
    s1 = rows[y1] >> 4
    v = (((s0 * b0[:, None, None]) >> 16)
         + ((s1 * b1[:, None, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape(
        (H, W) + img.shape[2:])


def resize_nearest(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)`: the
    source index floor(d * src / dst) (the ratio in float64 as OpenCV
    takes it), clamped; any dtype, (H, W) or (H, W, C)."""
    img = np.asarray(img)
    W, H = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    sx = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w))).astype(
        np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h))).astype(
        np.int64), h - 1)
    return np.ascontiguousarray(img[sy][:, sx])


def undistort_rectify_map(K: np.ndarray, distortion: np.ndarray,
                          width: int, height: int):
    """`cv2.initUndistortRectifyMap(K, distortion, np.eye(3), K, (width,
    height), cv2.CV_32FC1)`: (map_x, map_y), each (height, width) float32,
    for the plumb-bob model (k1, k2, p1, p2[, k3[, k4, k5, k6]]). Each row
    steps its homogeneous coordinate by K^-1's first column, summed left to
    right in float64 as OpenCV sums it."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    d = np.zeros(8)
    dist = np.asarray(distortion, np.float64).ravel()
    if dist.size not in (4, 5, 8):
        raise ValueError(f"plumb-bob distortion has 4, 5 or 8 "
                         f"coefficients, not {dist.size}")
    d[:dist.size] = dist
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    ir = np.linalg.inv(K).ravel()
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    i = np.arange(height, dtype=np.float64)[:, None]
    steps = np.empty((height, width))

    def running(start, step):
        steps[:, 0:1] = start
        steps[:, 1:] = step
        return np.cumsum(steps, axis=1)

    _x = running(i * ir[1] + ir[2], ir[0])
    _y = running(i * ir[4] + ir[5], ir[3])
    _w = running(i * ir[7] + ir[8], ir[6])
    w = 1.0 / _w
    x = _x * w
    y = _y * w
    x2 = x * x
    y2 = y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = fx * xd + u0
    v = fy * yd + v0
    return u.astype(np.float32), v.astype(np.float32)


def remap_linear(img: np.ndarray, map_x: np.ndarray,
                 map_y: np.ndarray) -> np.ndarray:
    """`cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)` of a uint8 image
    with OpenCV's default zero border: the four taps around each map
    point (taps outside the image zero), weighted in float32 by the map's
    fractional parts, ((1-ax) v00 + ax v01)(1-ay) + ((1-ax) v10 + ax v11) ay,
    rounded half to even. OpenCV's vector code fuses some of these
    products into FMAs, so a value that lands on a rounding boundary may
    round the other way: within 1 level, held in
    tests/test_torch_transforms.py."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"remap_linear takes uint8 images, not {img.dtype}")
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1)
    mx = np.asarray(map_x, np.float32)
    my = np.asarray(map_y, np.float32)
    x0 = np.floor(mx).astype(np.int64)
    y0 = np.floor(my).astype(np.int64)
    ax = (mx - x0.astype(np.float32))[..., None]
    ay = (my - y0.astype(np.float32))[..., None]

    def tap(dx, dy):
        xx, yy = x0 + dx, y0 + dy
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(inside[..., None], v, 0).astype(np.float32)

    one = np.float32(1.0)
    top = (one - ax) * tap(0, 0) + ax * tap(1, 0)
    bottom = (one - ax) * tap(0, 1) + ax * tap(1, 1)
    out = np.rint(top * (one - ay) + bottom * ay)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        mx.shape + img.shape[2:])


class Undistort:
    """Plumb-bob undistortion via a precomputed rectify map
    (ref: src/image_transforms.py:43-59; unused in the reference's shipped
    configs but part of its transform surface): `undistort_rectify_map`
    once, `remap_linear` a frame."""

    def __init__(self, K: np.ndarray, distortion: np.ndarray,
                 width: int, height: int):
        self.map1, self.map2 = undistort_rectify_map(K, distortion, width,
                                                     height)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return remap_linear(image, self.map1, self.map2)
