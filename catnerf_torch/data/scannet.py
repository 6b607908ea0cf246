"""ScanNet dataset loader.

Parity target: `ScanNet` (ref: src/dataset.py:188-439). Real-world RGB-D:
jpg color resized to depth resolution, edge crop (mw), inf-pose frame
skipping, instance ids shifted +1, background class filtering, optional
geometric-segmentation mask refinement with on-disk caching, per-object
point-cloud accumulation during load.

A copy of the JAX package's `data/scannet.py` that reads its frames with
`data/jpeg.py` and `data/png.py` and resamples them with
`data/transforms.py` in place of OpenCV (each byte for byte what OpenCV
gives), runs the segmentation's image stages and the registration's
device stages on the card unless `device` names another, and writes its
caches under the same names and in the same formats (`instance-refined/`
and `instance-disputed/` `.npy`, `inst_to_cls/` pickles, `inst_dict.pkl`),
so that the caches either package writes read in the other. The seconds
of reading the frames go to the `registration` phase timings as `frames`;
within them, the `scannet` phase timings hold `decode` (the JPEG and PNG
reads), `resize` and `refine` (segmentation and refinement, split further
in the `segmentation` timings).

`write_scannet_layout` writes a synthetic scene in the layout.
"""

from __future__ import annotations

import glob
import os
import pickle
import time

import numpy as np

from catnerf_torch.config import Config
from catnerf_torch.data import jpeg, png, transforms
from catnerf_torch.data.bbox import enlarge_bbox, mask_bbox
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.utils import phase_timer

# (ref: src/dataset.py:242)
BACKGROUND_CLS_LIST = [-1, 0, 1, 3, 16, 41, 232, 21, 161, 128, 21]
BBOX_SCALE = 0.2
# the layout writer's class ids: the scene's + LAYOUT_CLS_OFFSET, clear of
# BACKGROUND_CLS_LIST (as tests/test_scannet_fixture.py's CLS_OFFSET)
LAYOUT_CLS_OFFSET = 50
# the layout writer's JPEG quality (as tests/test_scannet_fixture.py's)
LAYOUT_JPEG_QUALITY = 98


def _sorted_paths(root: str, sub: str, ext: str) -> list[str]:
    return sorted(glob.glob(os.path.join(root, sub, f"*.{ext}")),
                  key=lambda x: int(os.path.basename(x).split(".")[0]))


class ScanNet:
    def __init__(self, cfg: Config, run_registration: bool = True,
                 device=None):
        self.name = "scannet"
        self.root_dir = cfg.dataset_dir
        self.cfg = cfg
        self.device = device
        self._warned_stale_cache = False
        # the registration's template scores (None: not registered here)
        self.template_counts: dict | None = None
        # ScanNet configs carry no fx/fy (ref: src/cfg.py:38-43): resolve
        # intrinsics from the dataset HERE, overriding whatever the config
        # parser probed — if the file is missing, training with silently
        # inherited Replica-default intrinsics would produce garbage rays
        # with no error, so make it fatal.
        intr_path = os.path.join(self.root_dir, "intrinsic",
                                 "intrinsic_depth.txt")
        if os.path.exists(intr_path):
            vals = np.loadtxt(intr_path).reshape(4, 4)
            cfg.fx, cfg.fy = float(vals[0, 0]), float(vals[1, 1])
            cfg.cx, cfg.cy = float(vals[0, 2]), float(vals[1, 2])
        elif not getattr(cfg, "_intrinsics_from_config", False):
            raise FileNotFoundError(
                f"ScanNet intrinsics not found at {intr_path} and the "
                "config carries no fx/fy — refusing to run with default "
                "intrinsics")
        self.cam = CameraInfo.from_config(cfg)

        self.color_paths = _sorted_paths(self.root_dir, "color", "jpg")
        self.depth_paths = _sorted_paths(self.root_dir, "depth", "png")
        self.raw_inst_paths = _sorted_paths(self.root_dir, "instance-filt", "png")
        self.raw_sem_paths = _sorted_paths(self.root_dir, "label-filt", "png")
        if cfg.use_refined_mask:
            os.makedirs(os.path.join(self.root_dir, "instance-refined"), exist_ok=True)
            os.makedirs(os.path.join(self.root_dir, "instance-disputed"), exist_ok=True)
            os.makedirs(os.path.join(self.root_dir, "inst_to_cls"), exist_ok=True)

        self.poses = self._load_poses(os.path.join(self.root_dir, "pose"))
        self.n_img = len(self.color_paths)
        self.edge = cfg.mw

        self.inst_dict: dict = {}
        self.sample_dict: dict = {}
        with phase_timer("registration", "frames"):
            self.get_all_frames()

        from catnerf_torch.data.replica import registration_cache_path

        result_file = registration_cache_path(self.root_dir, cfg.frame_stride)
        if cfg.load_registration_result and os.path.exists(result_file):
            # tolerant reader for reference-preprocessed caches (see
            # data/interop.py); ScanNet clouds come from TSDF so missing
            # bounds are recomputed from unprojected frames as a fallback
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

    def _load_poses(self, path: str) -> list[np.ndarray]:
        """(ref: src/dataset.py:421-433)."""
        poses = []
        for p in sorted(glob.glob(os.path.join(path, "*.txt")),
                        key=lambda x: int(os.path.basename(x)[:-4])):
            poses.append(np.loadtxt(p).reshape(4, 4))
        return poses

    def get_all_frames(self) -> None:
        t1 = time.time()
        reduce = 0
        if len(self.poses) < self.n_img:
            raise FileNotFoundError(
                f"ScanNet layout needs one pose per frame: found "
                f"{len(self.poses)} poses under {self.root_dir}/pose for "
                f"{self.n_img} frames")
        # frame_stride: in-loader keyframe subsampling; the reference makes
        # users pre-select 1-in-10 frames on disk by hand (ref: README.md:34)
        for index in range(0, self.n_img, self.cfg.frame_stride):
            # contiguous index over KEPT frames (inf-pose frames and strided-
            # over frames leave no hole, ref: src/dataset.py:296-300)
            index_reduced = len(self.sample_dict)
            T = self.poses[index]
            if np.any(np.isinf(T)):
                # (ref: src/dataset.py:296-300)
                reduce += 1
                continue

            with phase_timer("scannet", "decode"):
                color = jpeg.imread(self.color_paths[index])
                color = np.ascontiguousarray(color[..., ::-1])  # BGR -> RGB
                depth = png.imread_unchanged(
                    self.depth_paths[index]).astype(np.float32)
            depth = np.nan_to_num(depth, nan=0.0)
            H, W = depth.shape
            with phase_timer("scannet", "resize"):
                color = transforms.resize_linear(color, (W, H))

            if self.edge:
                e = self.edge
                color = color[e:-e, e:-e]
                depth = depth[e:-e, e:-e]
            depth = transforms.depth_filter(
                transforms.depth_scale(depth, self.cfg.depth_scale),
                self.cfg.max_depth)

            # Cache paths derive from the RAW mask filenames — never from a
            # positional index into the sorted cache directory, which
            # misaligns every frame after one skipped for an inf pose
            # (the cache-building run writes no file for skipped frames).
            inst_path = sem_path = ""
            if self.cfg.load_refined_mask and len(self.raw_inst_paths) > index:
                ib = os.path.splitext(
                    os.path.basename(self.raw_inst_paths[index]))[0]
                sb = os.path.splitext(
                    os.path.basename(self.raw_sem_paths[index]))[0]
                inst_path = os.path.join(self.root_dir, "instance-refined",
                                         ib + ".npy")
                sem_path = os.path.join(self.root_dir, "inst_to_cls",
                                        sb + ".pkl")
            claimed_mask = None  # supervision-only unknown pixels

            if (self.cfg.load_refined_mask and os.path.exists(inst_path)
                    and os.path.exists(sem_path)):
                inst_data = np.load(inst_path)
                with open(sem_path, "rb") as f:
                    inst_to_cls = pickle.load(f)
                claimed_path = os.path.join(
                    self.root_dir, "instance-disputed",
                    os.path.basename(inst_path))
                if os.path.exists(claimed_path):
                    claimed_mask = np.load(claimed_path)
                # The cache bakes in the unknown-pixel semantics it was
                # written under; re-apply the CURRENT flag so a cached run
                # honors cfg.refined_mask_unknown (e.g. a strict-parity
                # re-run with the flag off must not inherit -1 labels).
                if not self.cfg.refined_mask_unknown:
                    inst_data = np.where(inst_data == -1, 0, inst_data)
                    claimed_mask = None
                elif (inst_data == -1).sum() == 0 and claimed_mask is None \
                        and not self._warned_stale_cache:
                    self._warned_stale_cache = True
                    print("WARNING: refined-mask cache was written without "
                          "unknown-pixel marking (refined_mask_unknown was "
                          "false); delete instance-refined/ to rebuild "
                          "with the current setting")
            else:
                inst_path = self.raw_inst_paths[index]
                sem_path = self.raw_sem_paths[index]
                with phase_timer("scannet", "decode"):
                    inst_data = png.imread_unchanged(inst_path)
                    sem_data = png.imread_unchanged(sem_path)
                with phase_timer("scannet", "resize"):
                    inst_data = transforms.resize_nearest(
                        inst_data, (W, H)).astype(np.int32)
                    sem_data = transforms.resize_nearest(sem_data, (W, H))
                if self.edge:
                    e = self.edge
                    inst_data = inst_data[e:-e, e:-e]
                    sem_data = sem_data[e:-e, e:-e]
                inst_data += 1  # 0 reserved for background

                inst_to_cls = {0: 0}
                for inst_id in np.unique(inst_data):
                    inst_mask = inst_data == inst_id
                    sem_cls = np.unique(sem_data[inst_mask])
                    assert sem_cls.shape[0] == 1
                    sem_cls = int(sem_cls[0])
                    if sem_cls in BACKGROUND_CLS_LIST:
                        inst_data[inst_mask] = 0
                        continue
                    inst_to_cls[int(inst_id)] = sem_cls

                if self.cfg.use_refined_mask:
                    from catnerf_torch.geometry.segmentation import (
                        geometry_segmentation, refine_inst_data)

                    with phase_timer("scannet", "refine"):
                        _, _, segment_masks = geometry_segmentation(
                            color, depth, self.cam.fx, self.cam.fy,
                            self.cam.cx, self.cam.cy,
                            propagation_rounds=self.cfg.seg_propagation_rounds,
                            device=self.device)
                        raw_inst = inst_data
                        inst_data = refine_inst_data(inst_data, segment_masks)
                    if self.cfg.refined_mask_unknown:
                        # Pixels whose raw foreground label the geometric
                        # refinement DROPPED are ambiguous, not observed-
                        # empty; the reference hard-labels them background
                        # (ref: src/utils.py:696-721 zero-init), which
                        # trains the object's field to be empty exactly
                        # where the mask eroded (measured 20-25% pixel loss
                        # on small objects -> 90% completion ratio on the
                        # ScanNet gate). Mark them unknown (-1 -> pixel
                        # state 2), excluding them from opacity
                        # supervision for every model.
                        disputed = (raw_inst > 0) & (inst_data == 0)
                        inst_data = inst_data.copy()
                        inst_data[disputed] = -1
                        # The converse disagreement — refinement CLAIMS a
                        # pixel the raw mask labels background — is voided
                        # in SUPERVISION ONLY (claimed_mask below): those
                        # pixels plant wrong-depth surfaces on the object
                        # (~2.5% wall pixels -> 90% ratio on the small
                        # ScanNet-gate spheres), but dropping them from
                        # the per-object point clouds perturbs
                        # registration into flipping candidates on
                        # low-overlap categories, so clouds and bboxes
                        # keep the refined claim.
                        claimed_mask = (raw_inst == 0) & (inst_data > 0)
                    np.save(os.path.join(
                        self.root_dir, "instance-refined",
                        os.path.basename(inst_path)[:-4] + ".npy"), inst_data)
                    if claimed_mask is not None:
                        np.save(os.path.join(
                            self.root_dir, "instance-disputed",
                            os.path.basename(inst_path)[:-4] + ".npy"),
                            claimed_mask)
                    with open(os.path.join(
                            self.root_dir, "inst_to_cls",
                            os.path.basename(sem_path)[:-4] + ".pkl"), "wb") as f:
                        pickle.dump(inst_to_cls, f)

            # bboxes over refined ids (ref: src/dataset.py:368-383)
            for obj_id in np.unique(inst_data):
                if obj_id <= 0 or obj_id not in inst_to_cls:
                    # -1 = ambiguous (refinement-dropped) stays unknown
                    if obj_id > 0 and obj_id not in inst_to_cls:
                        inst_data[inst_data == obj_id] = 0
                    continue
                mask = inst_data == obj_id
                bb = mask_bbox(mask)
                if bb is None:
                    inst_data[mask] = 0
                    continue
                rmin, rmax, cmin, cmax = bb  # r: H axis, c: W axis (H,W layout)
                enlarged = enlarge_bbox([cmin, rmin, cmax, rmax], BBOX_SCALE,
                                        w=inst_data.shape[1],
                                        h=inst_data.shape[0])
                if enlarged is None:
                    inst_data[mask] = 0
                    continue
                sem_cls = inst_to_cls[int(obj_id)]
                # store [w0, w1, h0, h1] in transposed (W, H) convention:
                # W axis = image x = columns here
                bbox = np.array([enlarged[0], enlarged[2],
                                 enlarged[1], enlarged[3]])
                self.inst_dict.setdefault(sem_cls, {}).setdefault(
                    int(obj_id), {"frame_info": []}
                )["frame_info"].append({"frame": index_reduced, "bbox": bbox})

            # accumulate per-object world point clouds
            # (ref: src/dataset.py:385-400); clouds are gathered as
            # per-frame lists and concatenated once after the frame loop —
            # per-frame np.concatenate is O(F^2) in total points
            depth_wh = depth.transpose(1, 0)
            inst_wh = inst_data.transpose(1, 0)
            for obj_id in np.unique(inst_data):
                if obj_id == 0:
                    continue
                sem_cls = inst_to_cls.get(int(obj_id))
                if sem_cls is None or int(obj_id) not in self.inst_dict.get(sem_cls, {}):
                    continue
                d = np.where(inst_wh == obj_id, depth_wh, 0.0)
                pts = self.cam.unproject_depth(d, T)
                info = self.inst_dict[sem_cls][int(obj_id)]
                info.setdefault("_pcs_parts", []).append(pts)

            if index_reduced == 0:
                self.inst_dict[0] = {"frame_info": []}
            self.inst_dict[0]["frame_info"].append({
                "frame": index_reduced,
                "bbox": np.array([0, inst_wh.shape[0], 0, inst_wh.shape[1]]),
            })

            # supervision mask: refined-claimed pixels the raw mask
            # contradicts become unknown (-1 -> pixel state 2) for ray
            # supervision only; clouds/bboxes above keep the claim so
            # registration inputs are untouched
            sup_wh = inst_wh
            if claimed_mask is not None and claimed_mask.any():
                sup = inst_data.copy()
                sup[claimed_mask & (inst_data > 0)] = -1
                sup_wh = sup.transpose(1, 0)

            self.sample_dict[index_reduced] = {
                "image": color.transpose(1, 0, 2),
                "depth": depth_wh,
                "obj_mask": sup_wh,
                "T": T,
                "frame_id": index_reduced,
            }

        # finalize per-object clouds (one concatenate per object)
        for cls_id, objs in self.inst_dict.items():
            if cls_id == 0:
                continue
            for info in objs.values():
                parts = info.pop("_pcs_parts", None)
                if parts:
                    info["pcs"] = np.concatenate(parts)

        total = self.n_img
        self.n_img = len(self.sample_dict)
        print(f"get_all_frames took {time.time() - t1:.1f}s "
              f"({self.n_img} of {total} frames kept, "
              f"{reduce} inf-pose skipped, stride {self.cfg.frame_stride})")

    def __len__(self) -> int:
        return self.n_img

    def __getitem__(self, idx: int):
        return self.sample_dict[idx]


def write_scannet_layout(scene, out_dir: str, depth_scale: float,
                         color_size: tuple[int, int] | None = None) -> None:
    """Write a synthetic scene (`data/synthetic.make_scene`) in the
    ScanNet layout (color/ JPEGs, depth/, instance-filt/ and label-filt/
    PNGs, pose/ and intrinsic/intrinsic_depth.txt), as the JAX package's
    tests do (tests/test_scannet_fixture.py::write_scannet_layout), with
    `data/jpeg.py` and `data/png.py` in place of OpenCV: colour at JPEG
    quality LAYOUT_JPEG_QUALITY, depth in units of `depth_scale` (uint16),
    raw instance ids 0-based (the unknown id -1 as 0), class ids the
    scene's + LAYOUT_CLS_OFFSET and 0 (background) elsewhere. color_size
    (W, H): the colour is written at that size (resized with
    `transforms.resize_linear`), as a real sequence's 1296 x 968 colour
    beside its 640 x 480 depth."""
    for sub in ("color", "depth", "instance-filt", "label-filt", "pose",
                "intrinsic"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    for idx in sorted(scene.sample_dict.keys()):
        s = scene.sample_dict[idx]
        image_hw = s["image"].transpose(1, 0, 2)  # RGB
        depth_hw = s["depth"].transpose(1, 0)
        inst_hw = s["obj_mask"].transpose(1, 0).copy()
        inst_hw[inst_hw < 0] = 0
        sem_hw = np.zeros_like(inst_hw)  # 0 = ScanNet background class
        for sp in scene.spheres:
            sem_hw[inst_hw == sp.inst_id] = sp.cls_id + LAYOUT_CLS_OFFSET
        bgr = np.ascontiguousarray(image_hw[..., ::-1])
        if color_size is not None:
            bgr = transforms.resize_linear(bgr, color_size)
        jpeg.imwrite(os.path.join(out_dir, "color", f"{idx}.jpg"), bgr,
                     LAYOUT_JPEG_QUALITY)
        png.imwrite(os.path.join(out_dir, "depth", f"{idx}.png"),
                    np.round(depth_hw / depth_scale).astype(np.uint16))
        # raw instances are 0-based on disk; the loader shifts by +1
        png.imwrite(os.path.join(out_dir, "instance-filt", f"{idx}.png"),
                    inst_hw.astype(np.uint16))
        png.imwrite(os.path.join(out_dir, "label-filt", f"{idx}.png"),
                    sem_hw.astype(np.uint16))
        np.savetxt(os.path.join(out_dir, "pose", f"{idx}.txt"),
                   np.asarray(s["T"]))
    K = np.eye(4)
    K[0, 0], K[1, 1] = scene.cam.fx, scene.cam.fy
    K[0, 2], K[1, 2] = scene.cam.cx, scene.cam.cy
    np.savetxt(os.path.join(out_dir, "intrinsic", "intrinsic_depth.txt"), K)
