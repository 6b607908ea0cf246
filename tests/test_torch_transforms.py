"""The port's resampling (`catnerf_torch/data/transforms.py`) against
OpenCV: `resize_linear` and `resize_nearest` against `cv2.resize` bit for
bit, on several sizes up and down, ScanNet's 1296 x 968 -> 640 x 480, an
exact halving and the identity; `Undistort` against
`cv2.initUndistortRectifyMap` + `cv2.remap`, its maps within MAP_TOL
pixels and its images within one level on at most REMAP_SHARE of the
pixels; and the depth transforms against the JAX package's."""

from __future__ import annotations

import cv2
import numpy as np
import pytest

from catnerf_torch.data import transforms as T
from catnerf_tpu.data import transforms as J

MAP_TOL = 1e-3       # pixels
REMAP_SHARE = 1e-4   # of the pixels, each within one level

SIZES = [((1296, 968), (640, 480)), ((97, 73), (160, 120)),
         ((160, 120), (97, 73)), ((128, 96), (64, 48)), ((64, 48), (64, 48)),
         ((7, 5), (30, 20)), ((1, 5), (4, 9)), ((200, 150), (133, 151)),
         ((31, 17), (29, 19))]


@pytest.mark.parametrize("src,dst", SIZES,
                         ids=[f"{s[0]}x{s[1]}-{d[0]}x{d[1]}" for s, d in SIZES])
def test_resizes_are_cv2s_bit_for_bit(src, dst):
    rng = np.random.default_rng(src[0] * 1000 + dst[0])
    (w, h) = src
    for shape in ((h, w, 3), (h, w)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ours = T.resize_linear(img, dst)
        theirs = cv2.resize(img, dst, interpolation=cv2.INTER_LINEAR)
        assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
        mask = rng.integers(0, 65535, (h, w), dtype=np.uint16)
        np.testing.assert_array_equal(
            T.resize_nearest(mask, dst),
            cv2.resize(mask, dst, interpolation=cv2.INTER_NEAREST))


def test_resize_linear_takes_uint8_only():
    with pytest.raises(ValueError, match="uint8"):
        T.resize_linear(np.zeros((4, 4), np.uint16), (2, 2))


K = np.array([[577.6, 0.0, 318.9], [0.0, 578.7, 242.7], [0.0, 0.0, 1.0]])
DISTORTIONS = {"k5": [0.1, -0.25, 0.001, -0.002, 0.05],
               "k4": [-0.3, 0.1, 0.0005, 0.0003],
               "k8": [0.1, -0.2, 0.001, 0.002, 0.01, 0.02, -0.01, 0.005]}


@pytest.mark.parametrize("name", sorted(DISTORTIONS))
def test_undistort_is_cv2s_within_its_bounds(name):
    dist = np.array(DISTORTIONS[name])
    ours = T.Undistort(K, dist, 640, 480)
    m1, m2 = cv2.initUndistortRectifyMap(K, dist, np.eye(3), K, (640, 480),
                                         cv2.CV_32FC1)
    assert ours.map1.dtype == np.float32 and ours.map1.shape == m1.shape
    assert np.abs(ours.map1 - m1).max() <= MAP_TOL
    assert np.abs(ours.map2 - m2).max() <= MAP_TOL
    rng = np.random.default_rng(len(name))
    for shape in ((480, 640, 3), (480, 640)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        diff = np.abs(ours(img).astype(int)
                      - cv2.remap(img, m1, m2, cv2.INTER_LINEAR))
        assert diff.max() <= 1
        assert (diff > 0).mean() <= REMAP_SHARE


def test_depth_transforms_are_the_jax_packages():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 9000, (12, 9)).astype(np.uint16)
    for fn, args in ((T.depth_scale, (1 / 1000.0,)),):
        np.testing.assert_array_equal(fn(raw, *args),
                                      getattr(J, fn.__name__)(raw, *args))
    d = T.depth_scale(raw, 1 / 1000.0)
    np.testing.assert_array_equal(T.depth_filter(d, 6.0),
                                  J.depth_filter(d, 6.0))
    img = rng.integers(0, 256, (5, 4, 3), dtype=np.uint8)
    np.testing.assert_array_equal(T.bgr_to_rgb(img), J.bgr_to_rgb(img))
