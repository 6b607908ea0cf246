"""Geometric segmentation for ScanNet instance-mask refinement: the port
of the JAX package's `geometry/segmentation.py`.

Parity target: `geometry_segmentation` / `refine_inst_data`
(ref: src/utils.py:561-721). Depth-discontinuity + surface-convexity edge
detection, contour labeling, edge-pixel label propagation by 3D proximity,
small-segment rejection; refined masks assign each geometric segment to the
instance with the highest overlap.

Operates in standard (H, W) image layout internally (cv2 convention); the
caller transposes at the boundary like the reference does
(ref: src/dataset.py:404-407).

Where the JAX package calls OpenCV, the port runs PyTorch operators on
`device` (the card unless named): the discontinuity map (3 x 3 erode and
dilate), the 24 convexity offsets (single-tap 5 x 5 `filter2D`s with
BORDER_REFLECT_101, which are exact shifts and differences), the open and
close, the edge map, the shifted-window propagation rounds and the
small-segment drop. OpenCV's borders are kept: erode's constant border is
+inf and dilate's -inf, so a border never wins. Every float32 sum over the
three channels is written out in numpy's order, (x0 + x1) + x2, and every
division and comparison takes float32 operands (no scalar reciprocal), so
the maps equal the JAX package's bit for bit on any device
(tests/test_torch_segmentation.py; the card against the CPU in
chip_smoke.py's phase 16). The normals come from the geometry library's
`estimate_normals` on the host (as the JAX package's), the connected
components from scipy on the host (`connected_components`) and the hole
filling of `refine_inst_data` from scipy's `binary_fill_holes`.

The seconds of each part go to the `segmentation` phase timings
(`utils.phase_timings("segmentation")`): `normals`, `image` (the device
stages, their copies to and from the device included), `components` and
`fill`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from catnerf_torch.native.lib import geomlib
from catnerf_torch.utils import phase_timer, resolve_device


def _unproject_hw(depth_hw: np.ndarray, fx, fy, cx, cy) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) camera-frame point map (0 where invalid)."""
    H, W = depth_hw.shape
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    x = (u - cx) / fx * depth_hw
    y = (v - cy) / fy * depth_hw
    return np.stack([x, y, depth_hw], axis=-1)


def connected_components(edge_u8: np.ndarray) -> np.ndarray:
    """`cv2.connectedComponents(edge_u8, connectivity=8)[1]`: int32 labels,
    0 off the edge pixels. scipy's 8-connected `label` gives the same
    partition; OpenCV numbers the components by the first 2 x 2 block of
    each in block-raster order (block row, then block column), so they are
    renumbered so. Checked against OpenCV 5.0.0 on 280 random masks of
    60 x 80 to 480 x 640 pixels with no mismatch (plain raster order
    mismatched on all 200 tried); tests/test_torch_segmentation.py holds
    it against cv2. Two components never share a 2 x 2 block, since any
    two of its pixels are 8-neighbours."""
    from scipy.ndimage import label

    lab, n = label(edge_u8 != 0, structure=np.ones((3, 3), bool))
    if n == 0:
        return lab.astype(np.int32)
    H, W = lab.shape
    rows, cols = np.nonzero(lab)
    key = (rows // 2) * ((W + 1) // 2) + cols // 2
    first = np.full(n + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, lab[rows, cols], key)
    renumber = np.zeros(n + 1, np.int32)
    renumber[1 + np.argsort(first[1:], kind="stable")] = np.arange(
        1, n + 1, dtype=np.int32)
    return renumber[lab]


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum over the last axis of 3 in numpy's order."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _erode3(x: torch.Tensor) -> torch.Tensor:
    """cv2.erode with a 3 x 3 rectangle: the border never wins."""
    return -F.max_pool2d(-x[None, None], 3, stride=1, padding=1)[0, 0]


def _dilate3(x: torch.Tensor) -> torch.Tensor:
    """cv2.dilate with a 3 x 3 rectangle: the border never wins."""
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _edge_map(depth: torch.Tensor, points: torch.Tensor,
              normals: torch.Tensor, th_convex: float) -> torch.Tensor:
    """The edge map (H, W) uint8 of the JAX package's
    geometry_segmentation (ref: src/utils.py:575-617): convex, continuous
    surface."""
    dev = depth.device
    zero = _f32(0.0, dev)
    valid = depth > 0
    # depth discontinuities (ref: src/utils.py:575-583)
    erosion = depth - _erode3(depth)
    dilatation = _dilate3(depth) - depth
    ratio = torch.where(valid, torch.maximum(erosion, dilatation)
                        / torch.where(valid, depth, _f32(1.0, dev)), zero)
    discontinuity = (ratio > _f32(0.01, dev)).to(torch.float32)

    # convexity over the 5 x 5 offsets (ref: src/utils.py:586-604): each
    # filter2D kernel is +1 at the offset and -1 at the centre, BORDER_
    # REFLECT_101, so it is the shifted map less the map
    H, W = depth.shape
    pp = F.pad(points.permute(2, 0, 1)[None], (2, 2, 2, 2),
               mode="reflect")[0].permute(1, 2, 0)
    nn_ = F.pad(normals.permute(2, 0, 1)[None], (2, 2, 2, 2),
                mode="reflect")[0].permute(1, 2, 0)
    neg_normals = -normals
    threshold = _f32(-0.0005, dev)
    one = _f32(1.0, dev)
    min_convexity = torch.full_like(depth, 10.0)
    for i in range(25):
        if i == 12:
            continue
        ky, kx = i // 5, i % 5
        difference = pp[ky:ky + H, kx:kx + W] - points
        dot = _sum3(difference * neg_normals)
        convexity = (dot > threshold).to(torch.float32)
        concavity = one - convexity
        shifted = nn_[ky:ky + H, kx:kx + W]
        nproj = _sum3(normals * shifted) * concavity
        min_convexity = torch.minimum(min_convexity, convexity + nproj)

    convex = (min_convexity > _f32(th_convex, dev)).to(torch.float32)
    convex = _dilate3(_erode3(convex))            # MORPH_OPEN
    convex = torch.where(depth == 0, zero, convex)
    # edge map (ref: src/utils.py:613-617)
    disc_closed = _erode3(_dilate3(discontinuity))  # MORPH_CLOSE
    edge = torch.clamp(convex - disc_closed, min=0.0)
    edge = torch.where(depth == 0, zero, edge)
    return edge.to(torch.uint8)


def _propagate(labels: torch.Tensor, points: torch.Tensor,
               unlabeled: torch.Tensor, rounds: int) -> torch.Tensor:
    """The label propagation of the JAX package (ref: src/utils.py:
    643-671): each round sources only the previous round's labels and
    takes, shift by shift over the 9 x 9 window, the closer labelled
    neighbour within 5 cm; stops after a round that changed nothing."""
    H, W = labels.shape
    dev = labels.device
    min_dists = torch.full((H, W), 0.05, dtype=torch.float32, device=dev)
    padded_pts = F.pad(points.permute(2, 0, 1)[None], (4, 4, 4, 4))[0] \
        .permute(1, 2, 0)
    for _ in range(max(1, rounds)):
        padded_lab = F.pad(labels[None, None], (4, 4, 4, 4),
                           value=-1)[0, 0]
        changed = torch.zeros((), dtype=torch.bool, device=dev)
        for dy in range(-4, 5):
            for dx in range(-4, 5):
                if dx == 0 and dy == 0:
                    continue
                shifted_labels = padded_lab[4 + dy:4 + dy + H,
                                            4 + dx:4 + dx + W]
                diff = points - padded_pts[4 + dy:4 + dy + H,
                                           4 + dx:4 + dx + W]
                dists = torch.sqrt(_sum3(diff * diff))
                take = unlabeled & (shifted_labels >= 0) & (dists < min_dists)
                labels = torch.where(take, shifted_labels, labels)
                min_dists = torch.where(take, dists, min_dists)
                changed = changed | take.any()
        if not bool(changed):
            break
    return labels


def host_normals(depth: np.ndarray, fx, fy, cx, cy):
    """(depth float32, the camera-frame point map (H, W, 3) float32, 0
    where the depth is, the normal image (H, W, 3) float32) of a frame:
    the normals of the valid points by the geometry library's
    `estimate_normals` (radius 0.1, 100 neighbours), turned to face the
    camera (ref: src/utils.py:563-572), on the host."""
    with phase_timer("segmentation", "normals"):
        depth = np.asarray(depth, np.float32)
        valid_mask = depth > 0
        depth_map = _unproject_hw(depth, fx, fy, cx, cy)
        depth_map[~valid_mask] = 0
        pts = depth_map[valid_mask].reshape(-1, 3)
        normal_image = np.zeros_like(depth_map)
        if len(pts) >= 3:
            normals = geomlib.estimate_normals(pts, radius=0.1, max_nn=100)
            normals = np.where(normals[:, 2:] > 0, -normals, normals)
            normal_image[valid_mask] = normals
    return depth, depth_map, normal_image


def segment(depth: np.ndarray, depth_map: np.ndarray,
            normal_image: np.ndarray, min_segment_px: int = 500,
            th_convex: float = 0.9, propagation_rounds: int = 3,
            device=None):
    """(label_map, segment_masks) of a frame from `host_normals`'
    outputs: the image stages on `device` (the card unless named), the
    connected components on the host (ref: src/utils.py:575-694)."""
    dev = resolve_device(device)
    with phase_timer("segmentation", "image"):
        d = torch.from_numpy(depth).to(dev)
        P = torch.from_numpy(depth_map).to(dev)
        N = torch.from_numpy(normal_image).to(dev)
        edge = _edge_map(d, P, N, th_convex)
        edge_u8 = edge.cpu().numpy()

    # connected-component labels of the edge regions
    # (the reference uses findContours hierarchies, ref: src/utils.py:620-641;
    # connected components give the same segment partition of edge pixels)
    with phase_timer("segmentation", "components"):
        cc = connected_components(edge_u8)

    with phase_timer("segmentation", "image"):
        labels = torch.from_numpy(cc.astype(np.int32) - 1).to(dev)
        labels = torch.where(edge == 0, torch.full_like(labels, -1), labels)
        # propagate labels to nearby non-edge pixels by 3D proximity
        # (ref: src/utils.py:643-671); see the JAX package's module for
        # the rounds' default
        unlabeled = (edge == 0) & (d > 0)
        labels = _propagate(labels, P, unlabeled, propagation_rounds)
        # drop small segments (ref: src/utils.py:676-692)
        n = int(cc.max())
        index = (labels + 1).long()
        counts = torch.bincount(index.reshape(-1), minlength=n + 1)
        small = counts < min_segment_px
        small[0] = False
        labels = torch.where(small[index], torch.full_like(labels, -1),
                             labels)
        output_labels = labels.cpu().numpy()
        counts = counts.cpu().numpy()
        segment_masks = [output_labels == lab for lab in range(n)
                         if counts[lab + 1] >= min_segment_px]
    return output_labels, segment_masks


def geometry_segmentation(rgb: np.ndarray, depth: np.ndarray, fx, fy, cx, cy,
                          min_segment_px: int = 500,
                          th_convex: float = 0.9,
                          propagation_rounds: int = 3, device=None):
    """Returns (normal_image, label_map, segment_masks) for an (H, W) frame
    (ref: src/utils.py:561-694), numpy arrays as the JAX package's: the
    normals (H, W, 3) float32, the labels (H, W) int32 (-1 unlabelled),
    the masks of the kept segments (H, W) bool in label order. The image
    stages run on `device` (the card unless named): `host_normals`, then
    `segment`."""
    depth, depth_map, normal_image = host_normals(depth, fx, fy, cx, cy)
    output_labels, segment_masks = segment(
        depth, depth_map, normal_image, min_segment_px, th_convex,
        propagation_rounds, device)
    return normal_image, output_labels, segment_masks


def refine_inst_data(inst_data: np.ndarray, segment_masks: list[np.ndarray],
                     threshold: float = 0.7) -> np.ndarray:
    """Assign each geometric segment to the instance with > threshold overlap
    (ref: src/utils.py:696-721); the seconds go to the `segmentation`
    phase timings as `fill`."""
    from scipy.ndimage import binary_fill_holes

    with phase_timer("segmentation", "fill"):
        refined = np.zeros_like(inst_data)
        obj_ids = [i for i in np.unique(inst_data) if i not in (0, -1)]
        if not obj_ids:
            return refined
        for seg in segment_masks:
            seg = binary_fill_holes(seg)
            seg_sum = seg.sum()
            if seg_sum == 0:
                continue
            rates = np.array([
                (seg & (inst_data == oid)).sum() / seg_sum for oid in obj_ids
            ])
            if rates.max() > threshold:
                refined[seg] = obj_ids[int(np.argmax(rates))]
        return refined
