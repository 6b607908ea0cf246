"""Replica dataset loader.

Parity target: `Replica` (ref: src/dataset.py:26-186). Loads all frames
eagerly (RGB / depth / instance / class pngs + traj_w_c.txt), builds the
per-instance `inst_dict[cls][inst]['frame_info']` with enlarged 2D bboxes,
remaps undefined classes to inst_id + 1000, filters background semantic
classes, and triggers/caches the registration preprocessing.

Everything uses the reference's transposed (W, H) image convention.

A copy of the JAX package's `data/replica.py` that reads its PNGs with
`data/png.py` in place of OpenCV (byte for byte what `cv2.imread` returns)
and runs the registration's device stages on the card unless `device`
names another. The seconds of reading the frames go to the `registration`
phase timings as `frames`.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np

from catnerf_torch.config import Config
from catnerf_torch.data import png, transforms
from catnerf_torch.data.bbox import enlarge_bbox, mask_bbox
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.utils import phase_timer

# background semantic classes (ref: src/dataset.py:59)
BACKGROUND_CLS_LIST = [5, 12, 30, 31, 40, 60, 92, 93, 95, 97, 98, 79]
BBOX_SCALE = 0.2  # (ref: src/dataset.py:61)
CLS_ID_UNDEFINED = 1000  # (ref: src/dataset.py:98)


def registration_cache_path(root_dir: str, frame_stride: int) -> str:
    """Registration cache file, keyed by the keyframe stride it was built
    under. frame_info frame ids baked into the cache change meaning with
    `frame_stride` (Replica keeps raw ids so a strided run would miss them;
    ScanNet renumbers kept frames contiguously so a stale cache would
    silently point every bbox at the wrong physical frame) — so a cache
    from one stride must never be consumed under another. stride=1 keeps
    the reference's name (ref: src/dataset.py:87-88) for cache interop."""
    name = ("inst_dict.pkl" if frame_stride == 1
            else f"inst_dict_stride{frame_stride}.pkl")
    return os.path.join(root_dir, name)


class Replica:
    def __init__(self, cfg: Config, run_registration: bool = True,
                 device=None):
        self.name = "replica"
        self.root_dir = cfg.dataset_dir
        self.cfg = cfg
        if not os.path.isdir(self.root_dir):
            raise FileNotFoundError(
                f"Replica dataset not found at {self.root_dir!r} (from the "
                "config's dataset.path, resolved against the CWD / config "
                "dir) — expected the reference layout with traj_w_c.txt, "
                "rgb/, depth/, semantic_instance/, semantic_class/; see "
                "MIGRATION.md")
        traj = np.loadtxt(os.path.join(self.root_dir, "traj_w_c.txt"),
                          delimiter=" ").reshape(-1, 4, 4)
        self.Twc = traj
        self.cam = CameraInfo.from_config(cfg)
        self.n_img = len(os.listdir(os.path.join(self.root_dir, "depth")))

        self.inst_dict: dict = {}
        self.sample_dict: dict = {}
        # the registration's template scores (None: not registered here)
        self.template_counts: dict | None = None
        with phase_timer("registration", "frames"):
            self.get_all_frames()

        result_file = registration_cache_path(self.root_dir, cfg.frame_stride)
        if cfg.load_registration_result and os.path.exists(result_file):
            # tolerant reader: a REFERENCE-preprocessed cache (with pickled
            # open3d OBB objects, ref: src/dataset.py:87-88) loads without
            # open3d; unrecoverable bounds are recomputed from the frames
            from catnerf_torch.data.interop import (
                load_reference_inst_dict, repair_inst_dict)

            self.inst_dict = load_reference_inst_dict(result_file)
            n = repair_inst_dict(self.inst_dict, self.sample_dict, self.cam,
                                 name=self.name)
            if n:
                print(f"recomputed {n} bounds from reference cache")
        elif run_registration:
            from catnerf_torch.geometry.registration import run_registration

            self.template_counts = run_registration(
                self.inst_dict, self.sample_dict, self.cam, cfg,
                name=self.name, device=device)
            for cls_id in self.inst_dict:
                if cls_id == 0:
                    self.inst_dict[0].pop("pcs", None)
                else:
                    for inst in self.inst_dict[cls_id].values():
                        inst.pop("pcs", None)
                        inst.pop("pcs_rgb", None)
            with open(result_file, "wb") as f:
                pickle.dump(self.inst_dict, f)

    def get_all_frames(self) -> None:
        t1 = time.time()
        # frame_stride: in-loader keyframe subsampling; the reference makes
        # users pre-select 1-in-10 frames on disk by hand (ref: README.md:34)
        for idx in range(0, self.n_img, self.cfg.frame_stride):
            rgb_file = os.path.join(self.root_dir, "rgb", f"rgb_{idx}.png")
            depth_file = os.path.join(self.root_dir, "depth", f"depth_{idx}.png")
            inst_file = os.path.join(self.root_dir, "semantic_instance",
                                     f"semantic_instance_{idx}.png")
            obj_file = os.path.join(self.root_dir, "semantic_class",
                                    f"semantic_class_{idx}.png")

            # transposed (W, H) layout (ref: src/dataset.py:105-109)
            depth = png.imread_unchanged(depth_file).astype(
                np.float32).transpose(1, 0)
            image = png.imread_color(rgb_file).transpose(1, 0, 2)
            obj = png.imread_unchanged(obj_file).astype(np.int32).transpose(
                1, 0)
            inst = png.imread_unchanged(inst_file).astype(np.int32).transpose(
                1, 0)

            obj_presence = np.zeros_like(obj)
            cls_list, inst_list, batch_masks = [], [], []
            for inst_id in np.unique(inst):
                inst_mask = inst == inst_id
                sem_cls = np.unique(obj[inst_mask])
                assert sem_cls.shape[0] == 1, (
                    f"instance {inst_id} spans semantic classes {sem_cls}"
                )
                sem_cls = int(sem_cls[0])
                if sem_cls in BACKGROUND_CLS_LIST:
                    continue
                batch_masks.append(inst_mask)
                if sem_cls == 0 and inst_id != 0:
                    # undefined class -> unique pseudo-class
                    # (ref: src/dataset.py:129-130)
                    cls_list.append(int(inst_id) + CLS_ID_UNDEFINED)
                else:
                    cls_list.append(sem_cls)
                inst_list.append(int(inst_id))

            for i, mask in enumerate(batch_masks):
                bb = mask_bbox(mask)
                if bb is None:
                    continue
                rmin, rmax, cmin, cmax = bb
                if rmax - rmin <= 10 or cmax - cmin <= 10:
                    # too small (ref: src/dataset.py:139-143)
                    continue
                enlarged = enlarge_bbox([cmin, rmin, cmax, rmax], BBOX_SCALE,
                                        w=obj.shape[1], h=obj.shape[0])
                if enlarged is None:
                    continue
                sem_cls = cls_list[i]
                inst_id = inst_list[i]
                obj_presence[mask] = 1
                bbox = np.array([enlarged[1], enlarged[3],
                                 enlarged[0], enlarged[2]])  # [w0,w1,h0,h1]
                self.inst_dict.setdefault(sem_cls, {}).setdefault(
                    inst_id, {"frame_info": []}
                )["frame_info"].append({"frame": idx, "bbox": bbox})

            inst[obj_presence == 0] = 0  # background (ref: src/dataset.py:158)

            if idx == 0:
                self.inst_dict[0] = {"frame_info": []}
            self.inst_dict[0]["frame_info"].append({
                "frame": idx,
                "bbox": np.array([0, inst.shape[0], 0, inst.shape[1]]),
            })

            depth = transforms.depth_filter(
                transforms.depth_scale(depth, self.cfg.depth_scale),
                self.cfg.max_depth)

            self.sample_dict[idx] = {
                "image": image, "depth": depth, "obj_mask": inst,
                "T": self.Twc[idx], "frame_id": idx,
            }
        print(f"get_all_frames took {time.time() - t1:.1f}s "
              f"({len(self.sample_dict)} of {self.n_img} frames, "
              f"stride {self.cfg.frame_stride})")

    def __len__(self) -> int:
        return len(self.sample_dict)

    def __getitem__(self, idx: int):
        # positional over KEPT frames: sample_dict keys stay raw frame ids
        # (frame_info references them), so under frame_stride>1 the keys
        # are sparse and `for i in range(len(data)): data[i]` would KeyError
        # on the raw-id dict
        return self.sample_dict[self.frame_ids[idx]]

    @property
    def frame_ids(self) -> list[int]:
        return sorted(self.sample_dict)


def get_dataset(cfg: Config, run_registration: bool = True, device=None):
    """(ref: src/dataset.py:16-24)."""
    if cfg.dataset_format == "Replica":
        return Replica(cfg, run_registration=run_registration, device=device)
    if cfg.dataset_format == "ScanNet":
        from catnerf_torch.data.scannet import ScanNet

        return ScanNet(cfg, run_registration=run_registration, device=device)
    raise ValueError(f"Dataset format {cfg.dataset_format} not found")


# the semantic class the layout writer gives non-object pixels (one of
# BACKGROUND_CLS_LIST)
LAYOUT_BG_CLS = 5


def write_replica_layout(scene, out_dir: str, depth_scale: float) -> None:
    """Write a synthetic scene (`data/synthetic.make_scene`) in the
    reference's Replica layout (rgb/, depth/, semantic_instance/,
    semantic_class/ PNGs and traj_w_c.txt), as the JAX package's tests do
    (tests/test_replica_fixture.py::write_replica_layout), with
    `data/png.py` in place of OpenCV (its rows filtered adaptively, as
    libpng writes a recorded dataset's): depth in units of `depth_scale`
    (uint16), instance and class ids as uint16, the unknown id (-1) as 0,
    non-object pixels of class LAYOUT_BG_CLS."""
    for sub in ("rgb", "depth", "semantic_instance", "semantic_class"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    poses = []
    for idx in sorted(scene.sample_dict.keys()):
        s = scene.sample_dict[idx]
        # the scene's arrays are (W, H); the files are (H, W)
        image_hw = s["image"].transpose(1, 0, 2)  # RGB
        depth_hw = s["depth"].transpose(1, 0)
        inst_hw = s["obj_mask"].transpose(1, 0).copy()
        inst_hw[inst_hw < 0] = 0  # the layout has no 'unknown' id
        cls_hw = np.full_like(inst_hw, LAYOUT_BG_CLS)
        for obj in scene.spheres:
            cls_hw[inst_hw == obj.inst_id] = obj.cls_id
        png.imwrite(os.path.join(out_dir, "rgb", f"rgb_{idx}.png"),
                    np.ascontiguousarray(image_hw[..., ::-1]))
        png.imwrite(os.path.join(out_dir, "depth", f"depth_{idx}.png"),
                    np.round(depth_hw / depth_scale).astype(np.uint16))
        png.imwrite(os.path.join(out_dir, "semantic_instance",
                                 f"semantic_instance_{idx}.png"),
                    inst_hw.astype(np.uint16))
        png.imwrite(os.path.join(out_dir, "semantic_class",
                                 f"semantic_class_{idx}.png"),
                    cls_hw.astype(np.uint16))
        poses.append(np.asarray(s["T"]).reshape(-1))
    np.savetxt(os.path.join(out_dir, "traj_w_c.txt"), np.stack(poses),
               delimiter=" ")
