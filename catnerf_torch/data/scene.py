"""Scene ray buffers + per-step batch assembly.

A numpy copy of the JAX package's `data/scene.py`: the buffers are seeded
the same way (`cfg.seed + cls_id`), so the ray buffers and host batches are
byte-equal to the JAX package's (tests/test_torch_data.py).

Parity target: `sceneCategory` (ref: src/scene_cateogries.py:100-597).
Each category flattens every instance's 2D-bbox crops across all frames into
one shuffled ray buffer. Differences from the reference, by design:

* Ray origins/directions in the target frame (canonical object frame for
  multi-instance categories, world frame for single-instance and background)
  are precomputed at buffer build. The reference stores per-ray 4x4 T_CO and
  re-inverts it every step (src/scene_cateogries.py:380-386) even though
  object poses are fixed during training — hoisting it removes a matrix
  inverse from the hot path and shrinks the buffer.
* RGB is stored uint8 in the host buffers (4x smaller resident store);
  the float32 /255 conversion happens at batch assembly on the host
  (next_batch below; the device-store fast path likewise converts once
  at pack time, device_buffer._pack_rows).
* The epoch-shuffle cursor semantics are preserved exactly: buffers are
  shuffled at build, a cursor walks them sequentially, and a full reshuffle
  happens once no further full window of n samples remains (ref:
  src/scene_cateogries.py:251-261, 438-449).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.ops.sim3 import sim3_to_tensor_np
from catnerf_torch.utils import phase_add


@dataclasses.dataclass
class OrientedBBox:
    """Oriented bounding box (replaces reference BoundingBox,
    ref: src/utils.py:16-22)."""

    center: np.ndarray  # (3,)
    R: np.ndarray       # (3, 3)
    extent: np.ndarray  # (3,)

    def corners(self) -> np.ndarray:
        signs = np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        )
        return self.center + (signs * self.extent / 2.0) @ self.R.T


@dataclasses.dataclass
class InstanceInfo:
    """Per-instance registration artifact (the `inst_dict` contract,
    ref: src/dataset.py:153-156, src/category_registration.py:268-311)."""

    inst_id: int
    frame_info: list[dict]           # [{'frame': int, 'bbox': (w0, w1, h0, h1)}]
    T_obj: np.ndarray | None = None  # sim(3) object->world
    bbox3d: OrientedBBox | None = None


class RayBuffer:
    """Flat shuffled ray store with epoch-cursor sampling."""

    def __init__(self, arrays: dict[str, np.ndarray], rng: np.random.Generator):
        n = arrays["depth"].shape[0]
        assert all(a.shape[0] == n for a in arrays.values())
        self.arrays = arrays
        self.n = n
        self.rng = rng
        self.cursor = 0
        self._shuffle()

    def _shuffle(self) -> None:
        perm = self.rng.permutation(self.n)
        self.arrays = {k: v[perm] for k, v in self.arrays.items()}

    def sample(self, n: int) -> dict[str, np.ndarray]:
        """Sequential slice of n rays; reshuffles when the post-slice
        cursor satisfies cursor >= len - n — i.e. ALSO when exactly n
        rays remain, the reference's `>=` semantics verbatim
        (src/scene_cateogries.py:439). Do NOT 'fix' this to serve the
        last full window: it would change the seeded sampling trajectory
        and break both golden loss-curve pins."""
        if n > self.n:
            # Tiny scenes/tests: sample with replacement.
            idx = self.rng.integers(0, self.n, size=n)
            return {k: v[idx] for k, v in self.arrays.items()}
        out = {k: v[self.cursor:self.cursor + n] for k, v in self.arrays.items()}
        self.cursor += n
        if self.cursor >= self.n - n:
            self._shuffle()
            self.cursor = 0
        return out


def _pixel_states(obj_mask_crop: np.ndarray, this_id: int) -> np.ndarray:
    """0=other, 1=this object, 2=unknown (ref: src/scene_cateogries.py:202-204)."""
    state = np.zeros(obj_mask_crop.shape, dtype=np.uint8)
    state[obj_mask_crop == this_id] = 1
    state[obj_mask_crop == -1] = 2
    return state


def build_instance_ray_arrays(frame_info: list, sample_dict: dict, cam,
                              this_id: int, pose_fn) -> dict:
    """Flattened bbox-crop ray arrays for ONE instance — the single copy of
    the crop/pixel-state/ray-rotation recipe (ref:
    src/scene_cateogries.py:24-35,141-216) shared by the category buffer
    build, per-object field pretraining (geometry/field_pretrain.py), and
    test-time instance fitting (the JAX package's fit.py).

    pose_fn maps a frame's T_WC (4,4 float64) to the (R, t) that carries
    cached camera-frame dirs into the target frame: world (R, t straight
    from T_WC), cloud-centered world (t shifted), or canonical object
    (inv(T_obj) @ T_WC — R then carries the 1/s sim(3) factor while depth
    stays metric).

    Outputs are PREALLOCATED and filled per frame (bit-identical to a
    list+concatenate: slice assignment performs the same round-to-nearest
    downcasts) — concatenates would re-copy every array once."""
    t0 = time.perf_counter()
    bboxes = [tuple(int(v) for v in fi["bbox"]) for fi in frame_info]
    sizes = [(w1 - w0) * (h1 - h0) for w0, w1, h0, h1 in bboxes]
    n_total = int(sum(sizes))
    origins = np.empty((n_total, 3), np.float32)
    dirs_a = np.empty((n_total, 3), np.float32)
    rgb_a = np.empty((n_total, 3), np.uint8)
    state_a = np.empty((n_total,), np.uint8)
    depth_a = np.empty((n_total,), np.float32)
    off = 0
    for fi, (w0, w1, h0, h1), n_px in zip(frame_info, bboxes, sizes):
        sample = sample_dict[fi["frame"]]
        R, t = pose_fn(np.asarray(sample["T"], dtype=np.float64))
        crop_dirs = cam.rays_dir_cache[w0:w1, h0:h1].reshape(-1, 3)
        sl = slice(off, off + n_px)
        dirs_a[sl] = crop_dirs @ R.T
        origins[sl] = t
        rgb_a[sl] = sample["image"][w0:w1, h0:h1].reshape(-1, 3)
        state_a[sl] = _pixel_states(sample["obj_mask"][w0:w1, h0:h1],
                                    this_id).reshape(-1)
        depth_a[sl] = sample["depth"][w0:w1, h0:h1].reshape(-1)
        off += n_px
    phase_add("session", "ray_build", time.perf_counter() - t0)
    return {
        "origins": origins,
        "dirs": dirs_a,
        "rgb": rgb_a,
        "state": state_a,
        "depth": depth_a,
    }


class CategoryScene:
    """One category's ray buffer + static metadata (ref: sceneCategory)."""

    def __init__(self, cfg: Config, cls_id: int, inst_dict: dict,
                 sample_dict: dict, cam: CameraInfo,
                 rng: np.random.Generator | None = None):
        self.cls_id = cls_id
        self.cfg = cfg
        self.is_background = cls_id == 0
        rng = rng if rng is not None else np.random.default_rng(cfg.seed + cls_id)

        if self.is_background:
            self.obj_ids = [0]
            self.bound = inst_dict.get("bbox3D")
            instances = {0: InstanceInfo(0, inst_dict["frame_info"])}
        else:
            self.obj_ids = list(inst_dict.keys())
            instances = {
                i: InstanceInfo(
                    i, info["frame_info"], info.get("T_obj"), info.get("bbox3D")
                )
                for i, info in inst_dict.items()
            }
        self.inst_id_to_index = {iid: k for k, iid in enumerate(self.obj_ids)}
        self.n_obj = len(self.obj_ids)
        # Single-instance categories and background train in world frame
        # (ref: src/scene_cateogries.py:374-386).
        self.world_frame = self.is_background or self.n_obj == 1

        self.extent_dict: dict[int, np.ndarray] = {}
        self.object_tensor_dict: dict[int, np.ndarray] = {}
        self.bound_dict: dict[int, OrientedBBox] = {}
        # retained so that test-time fitting (fit.ingest_new_instance) can
        # rebuild each trained instance's world cloud as the registration
        # target
        self.frame_info_dict: dict[int, list[dict]] = {}
        if not self.is_background:
            for iid in self.obj_ids:
                info = instances[iid]
                self.frame_info_dict[iid] = info.frame_info
                if info.bbox3d is not None:
                    self.extent_dict[iid] = np.asarray(info.bbox3d.extent)
                    self.bound_dict[iid] = info.bbox3d
                else:
                    self.extent_dict[iid] = np.array([2.0, 2.0, 2.0])
                if info.T_obj is not None:
                    self.object_tensor_dict[iid] = sim3_to_tensor_np(info.T_obj)

        self.buffer = self._build_buffer(instances, sample_dict, cam, rng)

    def _build_buffer(self, instances: dict[int, InstanceInfo], sample_dict: dict,
                      cam: CameraInfo, rng: np.random.Generator) -> RayBuffer:
        per_inst, idx_all = [], []
        for iid, info in instances.items():
            if self.world_frame:
                pose_fn = lambda T_wc: (T_wc[:3, :3], T_wc[:3, 3])  # noqa: E731
            else:
                # T_CO = inv(T_WC) @ T_obj; rays go through inv(T_CO)
                # = inv(T_obj) @ T_WC (ref: src/scene_cateogries.py:24-35,
                # 235-238). inv(T_obj) carries the 1/s sim(3) factor.
                T_obj_inv = np.linalg.inv(info.T_obj)

                def pose_fn(T_wc, T_obj_inv=T_obj_inv):
                    T_oc = T_obj_inv @ T_wc
                    return T_oc[:3, :3], T_oc[:3, 3]

            this_id = iid if not self.is_background else 0
            arrays_i = build_instance_ray_arrays(
                info.frame_info, sample_dict, cam, this_id, pose_fn)
            per_inst.append(arrays_i)
            idx_all.append(np.full((arrays_i["depth"].shape[0],),
                                   self.inst_id_to_index[iid],
                                   dtype=np.int32))

        arrays = {k: np.concatenate([a[k] for a in per_inst])
                  for k in per_inst[0]}
        arrays["obj_idx"] = np.concatenate(idx_all)
        cap = (self.cfg.max_store_rays_bg if self.is_background
               else self.cfg.max_store_rays_per_cat)
        n = arrays["depth"].shape[0]
        t_sub = time.perf_counter()
        if cap and n > cap:
            # Stratified subsample per instance (config.py max_store_rays_*:
            # bounds the device/host ray store at large scene scale; 0 =
            # keep all). A uniform draw over the concatenated buffer could
            # drop a small instance's rays entirely under a tight cap,
            # leaving that object silently untrained — instead each
            # instance keeps a share proportional to its ray count, with a
            # floor of 1 ray per instance that has any.
            obj = arrays["obj_idx"]
            uniq, counts = np.unique(obj, return_counts=True)
            quota = np.maximum(
                1, np.minimum(counts,
                              np.floor(counts * cap / n).astype(np.int64)))
            # exact apportionment: spread flooring's leftover slots ONE at
            # a time across strata with headroom (descending headroom) so
            # no single stratum absorbs the whole remainder; trim
            # floor-of-1 overshoot the same way from the largest strata
            while quota.sum() < cap and np.any(counts > quota):
                for i in np.argsort(quota - counts):  # descending headroom
                    if quota.sum() >= cap:
                        break
                    if counts[i] > quota[i]:
                        quota[i] += 1
            while quota.sum() > cap and quota.max() > 1:
                for i in np.argsort(-quota):
                    if quota.sum() <= cap:
                        break
                    if quota[i] > 1:
                        quota[i] -= 1
            parts = []
            for u, q in zip(uniq, quota):
                rows = np.where(obj == u)[0]
                parts.append(rng.choice(rows, min(int(q), len(rows)),
                                        replace=False))
            sel = np.sort(np.concatenate(parts))
            arrays = {k: a[sel] for k, a in arrays.items()}
            phase_add("session", "store_cap_subsample",
                      time.perf_counter() - t_sub)
        t_shuf = time.perf_counter()
        buf = RayBuffer(arrays, rng)
        phase_add("session", "buffer_shuffle", time.perf_counter() - t_shuf)
        return buf

    def sample(self, n: int) -> dict[str, np.ndarray]:
        return self.buffer.sample(n)


class SceneBatcher:
    """Assembles the fixed-shape per-step batches for the train step
    (ref: the per-iteration gather+stack loop, train.py:113-150)."""

    def __init__(self, categories: list[CategoryScene],
                 background: CategoryScene | None):
        assert all(not c.is_background for c in categories)
        self.categories = categories
        self.background = background

    @property
    def n_cls(self) -> int:
        return len(self.categories)

    @property
    def n_objs_per_cls(self) -> list[int]:
        return [c.n_obj for c in self.categories]

    def rays_per_category(self, n_per_optim: int) -> int:
        """n_objs_total * n_per_optim // n_cls (ref: train.py:92-96)."""
        n_objs = sum(self.n_objs_per_cls)
        return max(1, n_objs * n_per_optim // max(1, self.n_cls))

    def next_batch(self, n_per_cls: int, n_bg: int):
        """Returns (cat_arrays: dict of stacked (n_cls, r, ...) numpy arrays,
        bg_arrays: dict or None)."""
        samples = [c.sample(n_per_cls) for c in self.categories]
        cat = {
            "rgbs": np.stack([s["rgb"] for s in samples]).astype(np.float32) / 255.0,
            "states": np.stack([s["state"] for s in samples]).astype(np.int32),
            "depth": np.stack([s["depth"] for s in samples]),
            "origins": np.stack([s["origins"] for s in samples]),
            "dirs": np.stack([s["dirs"] for s in samples]),
            "obj_indices": np.stack([s["obj_idx"] for s in samples]),
        }
        bg = None
        if self.background is not None:
            s = self.background.sample(n_bg)
            bg = {
                "rgbs": s["rgb"].astype(np.float32) / 255.0,
                "states": s["state"].astype(np.int32),
                "depth": s["depth"],
                "origins": s["origins"],
                "dirs": s["dirs"],
            }
        return cat, bg
