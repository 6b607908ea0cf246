"""The port's geometric segmentation (`catnerf_torch/geometry/
segmentation.py`) against the JAX package's, bit for bit on the CPU: the
normals, the label map, the segment masks and their order, and the
refined masks, for 1 and 3 propagation rounds, on the frames of a
synthetic scene (160 x 120, seed 0) and on a depth map of nested segments
(a raised box with a hole, an island in the hole), whose filled segments
overlap, so that the order of the segments decides the refined masks;
and `connected_components` against `cv2.connectedComponents` directly."""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_fill_holes

from catnerf_torch.geometry import segmentation as T
from catnerf_tpu.data.synthetic import make_scene
from catnerf_tpu.geometry import segmentation as J

torch.set_num_threads(1)

SCENE = dict(n_frames=3, width=160, height=120, n_categories=3,
             insts_per_cat=2, seed=0)


def _scene_frames():
    scene = make_scene(**SCENE)
    cam = scene.cam
    for fid in sorted(scene.sample_dict):
        s = scene.sample_dict[fid]
        yield (f"frame{fid}", s["image"].transpose(1, 0, 2),
               s["depth"].transpose(1, 0).astype(np.float32),
               s["obj_mask"].transpose(1, 0).astype(np.int32) + 1,
               (cam.fx, cam.fy, cam.cx, cam.cy), 500)


def _nested():
    H, W = 120, 160
    depth = np.full((H, W), 2.0, np.float32)
    depth[20:100, 30:130] = 1.6       # a raised box
    depth[40:80, 60:100] = 2.0        # a hole through it to the wall
    depth[50:70, 70:90] = 1.7         # an island in the hole
    inst = np.full((H, W), 4, np.int32)
    inst[20:100, 30:130] = 1
    inst[40:80, 60:100] = 2
    inst[50:70, 70:90] = 3
    f = 120.0
    return ("nested", np.zeros((H, W, 3), np.uint8), depth, inst,
            (f, f, W / 2 - 0.5, H / 2 - 0.5), 100)


FRAMES = list(_scene_frames()) + [_nested()]


@pytest.mark.parametrize("rounds", [1, 3])
@pytest.mark.parametrize("case", range(len(FRAMES)),
                         ids=[f[0] for f in FRAMES])
def test_segmentation_and_refinement_are_bitwise(case, rounds):
    _, rgb, depth, inst, (fx, fy, cx, cy), min_px = FRAMES[case]
    jn, jl, jsegs = J.geometry_segmentation(
        rgb, depth, fx, fy, cx, cy, min_segment_px=min_px,
        propagation_rounds=rounds)
    tn, tl, tsegs = T.geometry_segmentation(
        rgb, depth, fx, fy, cx, cy, min_segment_px=min_px,
        propagation_rounds=rounds, device="cpu")
    for ours, theirs in ((tn, jn), (tl, jl)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)
    assert len(tsegs) == len(jsegs) > 0
    for ours, theirs in zip(tsegs, jsegs):
        np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(T.refine_inst_data(inst, tsegs),
                                  J.refine_inst_data(inst, jsegs))


def test_the_nested_segments_overlap_once_filled():
    """The fixture that makes the segments' order matter: filled, the
    outer segments cover the inner ones, and refining in the reverse
    order gives other masks."""
    _, rgb, depth, inst, (fx, fy, cx, cy), min_px = _nested()
    _, _, segs = T.geometry_segmentation(rgb, depth, fx, fy, cx, cy,
                                         min_segment_px=min_px, device="cpu")
    filled = [binary_fill_holes(s) for s in segs]
    assert any((a & b).any() for i, a in enumerate(filled)
               for b in filled[i + 1:])
    assert not np.array_equal(T.refine_inst_data(inst, segs),
                              T.refine_inst_data(inst, segs[::-1]))


def test_connected_components_number_as_cv2():
    """scipy's partition renumbered in block-raster order equals
    cv2.connectedComponents(connectivity=8) on random masks of several
    sizes and densities (plain raster order would not)."""
    rng = np.random.default_rng(0)
    raster_differs = 0
    for k in range(40):
        H, W = (int(v) for v in rng.integers(7, 240, 2))
        blur = cv2.GaussianBlur(rng.random((H, W)).astype(np.float32),
                                (0, 0), float(rng.uniform(0.6, 3.0)))
        m = (blur > np.quantile(blur, rng.uniform(0.3, 0.7))).astype(
            np.uint8)
        n, cc = cv2.connectedComponents(m, connectivity=8)
        ours = T.connected_components(m)
        assert ours.dtype == cc.dtype
        np.testing.assert_array_equal(ours, cc)
        from scipy.ndimage import label

        raster, _ = label(m, structure=np.ones((3, 3)))
        raster_differs += not np.array_equal(raster, cc)
    assert raster_differs > 0
    empty = np.zeros((5, 6), np.uint8)
    np.testing.assert_array_equal(T.connected_components(empty),
                                  cv2.connectedComponents(empty)[1])
