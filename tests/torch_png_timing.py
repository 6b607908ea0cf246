"""Seconds of the port's PNG reader (`catnerf_torch/data/png.py`) beside
OpenCV's, on one frame of a Replica layout at room0's 1,200 x 680
(`make_scene(n_frames=1, width=1200, height=680, n_categories=3,
insts_per_cat=2, seed=1)`): its four files (rgb, depth, semantic_instance,
semantic_class) written by cv2 (which filters every row with Sub) and by
the port's writer (libpng's adaptive filter choice). Every read is checked against cv2's,
byte for byte, and timed as the median of REPEAT reads. CPU only: the
machine with the card has no OpenCV.

    python tests/torch_png_timing.py
"""

from __future__ import annotations

import json
import statistics
import sys
import tempfile
import time
import zlib
from pathlib import Path

import cv2
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from catnerf_torch.data import png  # noqa: E402
from catnerf_torch.data.synthetic import make_scene  # noqa: E402

REPEAT = 5


def frame_files(scene) -> dict:
    """The four images of the scene's first frame as the layout writes
    them (data/replica.write_replica_layout): (H, W) arrays, BGR colour."""
    s = scene.sample_dict[sorted(scene.sample_dict)[0]]
    inst = s["obj_mask"].T.copy()
    inst[inst < 0] = 0
    cls = np.full_like(inst, 5)
    for obj in scene.spheres:
        cls[inst == obj.inst_id] = obj.cls_id
    rgb = s["image"].transpose(1, 0, 2)[..., ::-1]
    return {"rgb": np.ascontiguousarray(rgb),
            "depth": np.round(s["depth"].T * 1000.0).astype(np.uint16),
            "semantic_instance": inst.astype(np.uint16),
            "semantic_class": cls.astype(np.uint16)}


def filters_of(path: str) -> list[int]:
    data = Path(path).read_bytes()
    idat = b"".join(b for k, b in png._chunks(path, data) if k == b"IDAT")
    (h,) = np.frombuffer(data[20:24], ">u4")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    return np.bincount(rows[:, 0], minlength=5).tolist()


def median_s(fn) -> float:
    times = []
    for _ in range(REPEAT):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> None:
    scene = make_scene(n_frames=1, width=1200, height=680, n_categories=3,
                       insts_per_cat=2, seed=1)
    images = frame_files(scene)
    root = Path(tempfile.mkdtemp(prefix="png_timing_"))
    writers = {"cv2": cv2.imwrite, "adaptive": png.imwrite}
    result = {}
    for wname, write in writers.items():
        row = {}
        for name, im in images.items():
            path = str(root / f"{wname}_{name}.png")
            write(path, im)
            ours = png.imread_color if name == "rgb" else \
                png.imread_unchanged
            want = (cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
                    if name == "rgb" else
                    cv2.imread(path, cv2.IMREAD_UNCHANGED))
            got = ours(path)
            assert got.dtype == want.dtype and np.array_equal(got, want), \
                (wname, name)
            theirs = ((lambda: cv2.imread(path)) if name == "rgb" else
                      (lambda: cv2.imread(path, cv2.IMREAD_UNCHANGED)))
            row[name] = {"port_s": median_s(lambda: ours(path)),
                         "cv2_s": median_s(theirs),
                         "filters": filters_of(path)}
        row["frame_port_s"] = sum(r["port_s"] for r in row.values())
        row["frame_cv2_s"] = sum(r["cv2_s"] for r in row.values()
                                 if isinstance(r, dict))
        result[wname] = row
    print(json.dumps(result))


if __name__ == "__main__":
    main()
