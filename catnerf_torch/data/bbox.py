"""2D bounding-box helpers (ref: src/utils.py:30-78)."""

from __future__ import annotations

import numpy as np


def enlarge_bbox(bbox, scale: float, w: int, h: int):
    """Symmetric margin enlargement, clipped to the image
    (ref: src/utils.py:30-51). bbox = [min_x, min_y, max_x, max_y].
    Returns None when the box is degenerate."""
    assert scale >= 0
    min_x, min_y, max_x, max_y = bbox
    margin_x = int(0.5 * scale * (max_x - min_x))
    margin_y = int(0.5 * scale * (max_y - min_y))
    if margin_x == 0 or margin_y == 0:
        return None
    min_x = int(np.clip(min_x - margin_x, 0, w - 1))
    min_y = int(np.clip(min_y - margin_y, 0, h - 1))
    max_x = int(np.clip(max_x + margin_x, 0, w - 1))
    max_y = int(np.clip(max_y + margin_y, 0, h - 1))
    return [min_x, min_y, max_x, max_y]


def mask_bbox(mask: np.ndarray):
    """Tight bbox of a boolean mask (vectorized equivalent of
    get_bbox2d_batch for a single mask, ref: src/utils.py:69-78).
    Returns (rmin, rmax, cmin, cmax) or None for an empty mask."""
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    if not rows.any():
        return None
    rmin, rmax = np.argmax(rows), mask.shape[0] - np.argmax(rows[::-1])
    cmin, cmax = np.argmax(cols), mask.shape[1] - np.argmax(cols[::-1])
    return int(rmin), int(rmax), int(cmin), int(cmax)
