"""Synthetic RGB-D scene generator (a numpy copy of the JAX package's
`data/synthetic.py`; the same seed gives the same scene).

Analytic ray-cast scenes (colored spheres inside a box room) emitting the
same `inst_dict` / `sample_dict` contract as the real dataset loaders
(ref: src/dataset.py:93-180). Used by tests, the end-to-end smoke run, and
`bench.py` — the reference has no equivalent (it has no tests at all,
SURVEY.md §4), so shapes/conventions follow the Replica loader.

Conventions (matching the reference):
  images/depth/masks use the transposed (W, H) layout; depth is z-depth in
  meters; obj_mask holds instance ids with 0 = background, -1 = unknown.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from catnerf_torch.data.bbox import enlarge_bbox, mask_bbox
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.scene import OrientedBBox


@dataclasses.dataclass
class Sphere:
    center: np.ndarray
    radius: float
    color: np.ndarray  # (3,) in [0, 1]
    inst_id: int
    cls_id: int

    # --- shared shape interface (see _PosedShape below) -------------------
    @property
    def R(self) -> np.ndarray:
        return np.eye(3)

    @property
    def object_extent(self) -> np.ndarray:
        return np.full(3, 2.0 * self.radius)

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        return np.linalg.norm(pts - self.center, axis=-1) - self.radius

    def sdf_obj(self, p: np.ndarray) -> np.ndarray:
        return np.linalg.norm(p, axis=-1) - self.radius

    def ray_cast(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        return _ray_sphere(origins, dirs, self.center, self.radius)

    def normal(self, pts: np.ndarray) -> np.ndarray:
        return (pts - self.center) / self.radius

    def texture(self, pts: np.ndarray) -> np.ndarray:
        return np.ones(pts.shape[:-1])

    def gt_T_obj(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] *= self.radius  # sim(3) scale = max(extent)/2
        T[:3, 3] = self.center
        return T

    def gt_bbox3d(self) -> "OrientedBBox":
        return OrientedBBox(center=np.asarray(self.center, np.float64).copy(),
                            R=np.eye(3), extent=np.full(3, 2 * self.radius))


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-to-world pose with +z forward (OpenCV convention)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


def _ray_sphere(origins, dirs, center, radius):
    """Smallest positive t with origins + t*dirs on the sphere; inf if none.
    dirs need not be normalized (t stays in z-depth units when dir_z == 1
    only if dirs are camera rays rotated to world — we solve in world frame
    with unnormalized dirs so t is the camera z-depth)."""
    oc = origins - center
    a = np.sum(dirs * dirs, axis=-1)
    b = 2.0 * np.sum(oc * dirs, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    disc = b * b - 4 * a * c
    hit = disc >= 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t0 = (-b - sq) / (2 * a)
    t1 = (-b + sq) / (2 * a)
    t = np.where(t0 > 1e-6, t0, t1)
    return np.where(hit & (t > 1e-6), t, np.inf)


def _rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """Z-up yaw (about y), then pitch (about x), then roll (about z)."""
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


def _sdf_box(p: np.ndarray, half: np.ndarray) -> np.ndarray:
    d = np.abs(p) - half
    outside = np.linalg.norm(np.maximum(d, 0.0), axis=-1)
    inside = np.minimum(np.max(d, axis=-1), 0.0)
    return outside + inside


@dataclasses.dataclass
class _PosedShape:
    """Posed analytic shape with a real (non-identity) rotation.

    Subclasses define geometry in the OBJECT frame in metric units via
    `sdf_obj`; the world pose is (R, center). Unlike `Sphere`, these
    families have no continuous rotational symmetry, so end-to-end gates
    built from them CAN observe rotation-registration error. Ray casting is bounding-sphere-culled dense marching +
    bisection (the SDFs only need correct signs, not exact distances)."""

    center: np.ndarray
    R: np.ndarray
    color: np.ndarray
    inst_id: int
    cls_id: int

    def sdf_obj(self, p: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @property
    def object_extent(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def bound_radius(self) -> float:
        return 0.5 * float(np.linalg.norm(self.object_extent)) + 0.02

    def sdf(self, pts: np.ndarray) -> np.ndarray:
        return self.sdf_obj((pts - self.center) @ self.R)

    def normal(self, pts: np.ndarray) -> np.ndarray:
        eps = 1e-4
        g = np.stack([
            self.sdf(pts + eps * np.eye(3)[i]) - self.sdf(pts - eps * np.eye(3)[i])
            for i in range(3)
        ], axis=-1)
        return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)

    def texture(self, pts: np.ndarray) -> np.ndarray:
        """Object-frame checker modulation so per-instance texture latents
        have real work to do on asymmetric scenes (albedo multiplier)."""
        p = (pts - self.center) @ self.R
        cells = np.floor(p / 0.09).sum(axis=-1)
        return 0.78 + 0.22 * (np.mod(cells, 2.0))

    def ray_cast(self, origins: np.ndarray, dirs: np.ndarray,
                 n_steps: int = 96, n_bisect: int = 28) -> np.ndarray:
        t_out = np.full(origins.shape[0], np.inf)
        oc = origins - self.center
        a = np.sum(dirs * dirs, axis=-1)
        b = 2.0 * np.sum(oc * dirs, axis=-1)
        c = np.sum(oc * oc, axis=-1) - self.bound_radius ** 2
        disc = b * b - 4 * a * c
        hit = disc > 0
        if not hit.any():
            return t_out
        sq = np.sqrt(disc[hit])
        t0 = (-b[hit] - sq) / (2 * a[hit])
        t1 = (-b[hit] + sq) / (2 * a[hit])
        t_lo, t_hi = np.maximum(t0, 1e-6), t1
        ok = t_hi > t_lo
        if not ok.any():
            return t_out
        idx = np.where(hit)[0][ok]
        o, d = origins[idx], dirs[idx]
        t_lo, t_hi = t_lo[ok], t_hi[ok]
        ts = t_lo[:, None] + (t_hi - t_lo)[:, None] * \
            np.linspace(0.0, 1.0, n_steps)[None, :]
        pts = o[:, None, :] + d[:, None, :] * ts[..., None]
        inside = self.sdf(pts.reshape(-1, 3)).reshape(len(idx), n_steps) <= 0
        any_h = inside.any(axis=1)
        if not any_h.any():
            return t_out
        first = np.argmax(inside, axis=1)
        rows = np.where(any_h)[0]
        f = first[rows]
        # f == 0: the sample at the bounding-sphere entry t_lo is already
        # inside the object. With the ray origin outside the bounding
        # sphere (cameras always are) sdf(origin) > 0, so the crossing
        # lies in (0, t_lo] — bisect from the origin instead of silently
        # dropping the hit. An origin INSIDE the sphere breaks that
        # bracket assumption; guard loudly.
        zero = f == 0
        if zero.any() and np.any(c[idx[rows[zero]]] < 0):
            raise ValueError(
                "ray_cast: ray origin inside the bounding sphere with the "
                "first sample already inside the object — place cameras "
                "outside the object bounds")
        lo = np.where(zero, 1e-6, ts[rows, np.maximum(f - 1, 0)])
        hi = ts[rows, f]
        o2, d2 = o[rows], d[rows]
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            v = self.sdf(o2 + d2 * mid[:, None])
            ins = v <= 0
            hi = np.where(ins, mid, hi)
            lo = np.where(ins, lo, mid)
        t_out[idx[rows]] = 0.5 * (lo + hi)
        return t_out

    def gt_T_obj(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.R * (float(np.max(self.object_extent)) / 2.0)
        T[:3, 3] = self.center
        return T

    def gt_bbox3d(self) -> OrientedBBox:
        return OrientedBBox(center=np.asarray(self.center, np.float64).copy(),
                            R=np.asarray(self.R, np.float64).copy(),
                            extent=np.asarray(self.object_extent, np.float64))

    def symmetry_rotations(self) -> list[np.ndarray]:
        """Proper rotations mapping the object-frame GEOMETRY onto itself
        (texture excluded — geometric registration cannot see texture).
        Used by diag_registration to reduce rotation error modulo shape
        symmetry."""
        return [np.eye(3)]


@dataclasses.dataclass
class Ellipsoid(_PosedShape):
    """Tri-axial ellipsoid (distinct semi-axes): only discrete 180-degree
    symmetries remain, and the checker texture breaks even those."""

    radii: np.ndarray = None  # (3,) metric semi-axes

    def symmetry_rotations(self) -> list[np.ndarray]:
        # D2: identity + the three 180-degree axis flips (det +1).
        return [np.diag(d) for d in
                ([1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1])]

    def sdf_obj(self, p: np.ndarray) -> np.ndarray:
        k = np.linalg.norm(p / self.radii, axis=-1)
        return (k - 1.0) * float(np.min(self.radii))

    @property
    def object_extent(self) -> np.ndarray:
        return 2.0 * np.asarray(self.radii)


@dataclasses.dataclass
class SphereBlob(_PosedShape):
    """Union of K spheres with distinct radii at non-collinear offsets —
    no rotational symmetry at all (the 'two-lobe union' family)."""

    offsets: np.ndarray = None  # (K, 3) object-frame member centers
    radii: np.ndarray = None    # (K,)

    def sdf_obj(self, p: np.ndarray) -> np.ndarray:
        d = np.linalg.norm(p[..., None, :] - self.offsets, axis=-1) - self.radii
        return d.min(axis=-1)

    @property
    def object_extent(self) -> np.ndarray:
        lo = (self.offsets - self.radii[:, None]).min(axis=0)
        hi = (self.offsets + self.radii[:, None]).max(axis=0)
        return hi - lo


@dataclasses.dataclass
class NotchedBox(_PosedShape):
    """Box with a corner notch cut out (CSG difference): sharp edges,
    concavity, and zero mirror symmetry."""

    half: np.ndarray = None          # (3,) distinct half-extents
    notch_center: np.ndarray = None  # object-frame notch box center
    notch_half: np.ndarray = None

    def sdf_obj(self, p: np.ndarray) -> np.ndarray:
        return np.maximum(_sdf_box(p, self.half),
                          -_sdf_box(p - self.notch_center, self.notch_half))

    @property
    def object_extent(self) -> np.ndarray:
        return 2.0 * np.asarray(self.half)


def _ray_box_interior(origins, dirs, box_min, box_max):
    """t of the farthest plane intersection inside the box (room walls seen
    from inside)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t_min_planes = (box_min - origins) / dirs
        t_max_planes = (box_max - origins) / dirs
    t_far = np.maximum(t_min_planes, t_max_planes)
    return np.min(t_far, axis=-1)


@dataclasses.dataclass
class SyntheticScene:
    inst_dict: dict
    sample_dict: dict
    cam: CameraInfo
    spheres: list  # all shape instances (Sphere and/or _PosedShape); the
    #                field name predates the asymmetric families

    @property
    def objects(self) -> list:
        return self.spheres


def _make_asym_shape(fam: str, rng: np.random.Generator, center: np.ndarray,
                     color: np.ndarray, inst_id: int, cls_id: int,
                     k: int, size_factor: float):
    """One asymmetric instance with a real random rotation and per-instance
    shape variation (k is the instance index within the category)."""
    R = _rotation(rng.uniform(0, 2 * np.pi), rng.uniform(-0.5, 0.5),
                  rng.uniform(-0.4, 0.4))
    grow = (1.0 + 0.18 * k) * size_factor
    if fam == "ellipsoid":
        radii = np.array([0.30, 0.21, 0.14]) * grow * \
            rng.uniform(0.9, 1.1, 3)
        return Ellipsoid(center, R, color, inst_id, cls_id, radii=radii)
    if fam == "blob":
        offsets = (np.array([[0.14, 0.0, 0.0],
                             [-0.12, 0.10, 0.02],
                             [0.0, -0.08, -0.13]])
                   + rng.uniform(-0.02, 0.02, (3, 3))) * grow
        radii = np.array([0.20, 0.145, 0.105]) * grow * \
            rng.uniform(0.92, 1.08, 3)
        # recenter so the object-frame bbox is centered at the origin
        lo = (offsets - radii[:, None]).min(axis=0)
        hi = (offsets + radii[:, None]).max(axis=0)
        offsets = offsets - (lo + hi) / 2.0
        return SphereBlob(center, R, color, inst_id, cls_id,
                          offsets=offsets, radii=radii)
    if fam == "box":
        half = np.array([0.26, 0.19, 0.14]) * grow * rng.uniform(0.9, 1.1, 3)
        # notch box overlapping one corner
        notch_half = half * np.array([0.55, 0.5, 0.65])
        notch_center = half * np.array([0.9, 0.85, 0.95])
        return NotchedBox(center, R, color, inst_id, cls_id, half=half,
                          notch_center=notch_center, notch_half=notch_half)
    raise ValueError(f"unknown shape family {fam!r}")


_FAMILY_CYCLES = {
    "sphere": ["sphere"],
    "asym": ["ellipsoid", "blob", "box"],
    "mixed": ["sphere", "ellipsoid", "blob", "box"],
}


def make_scene(n_frames: int = 6, width: int = 80, height: int = 60,
               n_categories: int = 2, insts_per_cat: int = 2,
               seed: int = 0, unknown_band: bool = True,
               shape_family: str = "sphere") -> SyntheticScene:
    """Build a synthetic scene: `n_categories` object categories with
    `insts_per_cat` instances each inside a 6x6x3 m room, cameras orbiting
    the center.

    shape_family: "sphere" (default; rotation-invariant, the original
    gate scenes), "asym" (ellipsoid/blob/notched-box cycle — every
    instance has a real random rotation, so registration rotation error is
    observable end-to-end), or "mixed" (spheres + the asymmetric families).
    """
    rng = np.random.default_rng(seed)
    fx = fy = 0.8 * width
    cam = CameraInfo(width, height, fx, fy, (width - 1) / 2.0, (height - 1) / 2.0)

    box_min = np.array([-3.0, -1.5, -3.0])
    box_max = np.array([3.0, 1.5, 3.0])

    families = _FAMILY_CYCLES[shape_family]
    spheres: list = []
    inst_id = 1
    # keep crowded rings non-overlapping: ring spacing is 2*pi*1.5/total, so
    # shrink radii once the default sizes would swallow neighbours
    total = n_categories * insts_per_cat
    size_factor = min(1.0, 6.0 / total)
    for c in range(n_categories):
        cls_id = 80 + c
        fam = families[c % len(families)]
        base_radius = (0.3 + 0.1 * c) * size_factor
        for k in range(insts_per_cat):
            # interleave categories around the ring (k-major) so instances
            # of the same category sit apart and large spheres don't occlude
            # each other from the orbiting cameras
            ang = (2 * np.pi * (k * n_categories + c)
                   / (n_categories * insts_per_cat))
            center = np.array([1.5 * np.cos(ang), 0.0, 1.5 * np.sin(ang)])
            color = rng.uniform(0.2, 1.0, 3)
            if fam == "sphere":
                spheres.append(Sphere(center, base_radius * (1 + 0.2 * k),
                                      color, inst_id, cls_id))
            else:
                spheres.append(_make_asym_shape(
                    fam, rng, center, color, inst_id, cls_id, k,
                    size_factor * (1.0 + 0.25 * c)))
            inst_id += 1

    wall_colors = rng.uniform(0.3, 0.8, (6, 3))
    light_dir = np.array([0.3, -0.8, 0.5])
    light_dir /= np.linalg.norm(light_dir)

    inst_dict: dict = {}
    sample_dict: dict = {}
    dirs_cache = cam.rays_dir_cache.reshape(-1, 3)

    for f in range(n_frames):
        ang = 2 * np.pi * f / n_frames
        # orbit with varying elevation/radius so object surfaces are seen
        # from above AND below (a single fixed-height ring leaves bottoms
        # unobserved and bounds reconstruction accuracy)
        h = 1.1 * np.sin(2.0 * ang + 0.7)
        r = 2.4 - 0.3 * np.cos(3.0 * ang)
        eye = np.array([r * np.cos(ang), h, r * np.sin(ang)])
        T_wc = look_at(eye, np.zeros(3))
        R, t = T_wc[:3, :3], T_wc[:3, 3]
        dirs_w = dirs_cache @ R.T
        origins = np.broadcast_to(t, dirs_w.shape)

        t_best = _ray_box_interior(origins, dirs_w, box_min, box_max)
        inst_map = np.zeros(dirs_w.shape[0], dtype=np.int32)
        cls_map = np.zeros(dirs_w.shape[0], dtype=np.int32)
        for s in spheres:
            ts = s.ray_cast(origins, dirs_w)
            closer = ts < t_best
            t_best = np.where(closer, ts, t_best)
            inst_map = np.where(closer, s.inst_id, inst_map)
            cls_map = np.where(closer, s.cls_id, cls_map)

        pts = origins + t_best[:, None] * dirs_w
        rgb = np.empty((dirs_w.shape[0], 3))
        # walls: color by dominant hit axis, mild distance shading
        axis = np.argmax(
            np.stack([
                np.minimum(np.abs(pts[:, i] - box_min[i]),
                           np.abs(pts[:, i] - box_max[i]))
                for i in range(3)
            ], -1) * -1, axis=-1)
        rgb = wall_colors[axis] * (0.7 + 0.3 / (1 + 0.1 * t_best[:, None]))
        for s in spheres:
            m = inst_map == s.inst_id
            normal = s.normal(pts[m])
            shade = 0.4 + 0.6 * np.clip(-normal @ light_dir, 0, 1)
            rgb[m] = s.color * (shade * s.texture(pts[m]))[:, None]

        image = (np.clip(rgb, 0, 1) * 255).astype(np.uint8).reshape(width, height, 3)
        depth = t_best.astype(np.float32).reshape(width, height)
        obj_mask = inst_map.reshape(width, height)

        if unknown_band:
            # thin unknown band at object silhouettes (state 2 in buffers)
            edge = np.zeros_like(obj_mask, dtype=bool)
            om = obj_mask
            edge[1:] |= om[1:] != om[:-1]
            edge[:, 1:] |= om[:, 1:] != om[:, :-1]
            obj_mask = np.where(edge & (om > 0), -1, om)

        sample_dict[f] = {"image": image, "depth": depth, "obj_mask": obj_mask,
                          "T": T_wc, "frame_id": f}

        # per-instance frame_info with enlarged 2D bboxes
        # (ref: src/dataset.py:135-156)
        for s in spheres:
            mask = inst_map.reshape(width, height) == s.inst_id
            bb = mask_bbox(mask)
            if bb is None:
                continue
            rmin, rmax, cmin, cmax = bb  # r: width axis, c: height axis
            if rmax - rmin <= 2 or cmax - cmin <= 2:
                continue
            enlarged = enlarge_bbox([cmin, rmin, cmax, rmax], 0.2,
                                    w=height, h=width)
            if enlarged is None:
                # tiny projection: keep the tight box (the reference drops
                # such crops, but synthetic tests need every instance)
                enlarged = [cmin, rmin, cmax, rmax]
            # stored as [w0, w1, h0, h1] (ref: src/dataset.py:152)
            bbox = np.array([enlarged[1], enlarged[3], enlarged[0], enlarged[2]])
            inst_dict.setdefault(s.cls_id, {}).setdefault(
                s.inst_id, {"frame_info": []}
            )["frame_info"].append({"frame": f, "bbox": bbox})

        inst_dict.setdefault(0, {"frame_info": []})["frame_info"].append(
            {"frame": f, "bbox": np.array([0, width, 0, height])}
        )

    # registration artifacts: known ground-truth object poses
    for s in spheres:
        if s.cls_id in inst_dict and s.inst_id in inst_dict[s.cls_id]:
            info = inst_dict[s.cls_id][s.inst_id]
            info["T_obj"] = s.gt_T_obj()
            info["bbox3D"] = s.gt_bbox3d()

    room_center = (box_min + box_max) / 2
    inst_dict[0]["bbox3D"] = OrientedBBox(
        center=room_center, R=np.eye(3), extent=(box_max - box_min)
    )

    return SyntheticScene(inst_dict=inst_dict, sample_dict=sample_dict,
                          cam=cam, spheres=spheres)
