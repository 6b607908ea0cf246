"""The benchmark's scene generator: analytic spheres in a box room, seen
by cameras orbiting its centre, as RGB-D frames with instance masks.

A copy of the contract of the program's `data/synthetic.make_scene`
(its spheres on several rings where one would crowd them), ray cast on
the device in float64: the same `inst_dict` / `sample_dict`
that the dataset loaders give (images, depths and masks in the (W, H)
layout, depth as z-depth in metres, 0 background and -1 unknown in the
mask; per instance its frames' enlarged 2D boxes, its sim(3) pose and its
3D box), at the camera the configuration states. The seed sets the
colours of the spheres and walls; the geometry, and so every count of
rays, is the same for every seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Box3D:
    """An oriented 3D box: what a loader's `bbox3D` holds."""

    center: np.ndarray
    R: np.ndarray
    extent: np.ndarray

    def corners(self) -> np.ndarray:
        signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                          for z in (-1, 1)])
        return self.center + (signs * self.extent / 2.0) @ self.R.T


@dataclasses.dataclass
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float

    def grid(self, device) -> torch.Tensor:
        """[W, H, 3] float32 camera-frame ray directions with z = 1 (the
        loaders' ray cache, ref: src/scene_cateogries.py:600-611)."""
        w = (torch.arange(self.width, dtype=torch.float32, device=device)
             - self.cx) / self.fx
        h = (torch.arange(self.height, dtype=torch.float32, device=device)
             - self.cy) / self.fy
        d = torch.ones(self.width, self.height, 3, dtype=torch.float32,
                       device=device)
        d[:, :, 0] = w[:, None]
        d[:, :, 1] = h[None, :]
        return d

    def dirs(self, device) -> torch.Tensor:
        """grid() as [W * H, 3] float64."""
        return self.grid(device).reshape(-1, 3).double()


def look_at(eye: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """Camera-to-world pose looking at the origin, +z forward."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


def enlarge_bbox(bbox, scale: float, w: int, h: int):
    """[min_x, min_y, max_x, max_y] grown by scale / 2 of its size on each
    side and clipped to the image; None when a margin rounds to 0."""
    min_x, min_y, max_x, max_y = bbox
    mx = int(0.5 * scale * (max_x - min_x))
    my = int(0.5 * scale * (max_y - min_y))
    if mx == 0 or my == 0:
        return None
    return [int(np.clip(min_x - mx, 0, w - 1)),
            int(np.clip(min_y - my, 0, h - 1)),
            int(np.clip(max_x + mx, 0, w - 1)),
            int(np.clip(max_y + my, 0, h - 1))]


RING_RADIUS = 1.5
PER_RING = 14


def spheres(n_categories: int, insts_per_cat: int, rng: np.random.Generator):
    """(centres [S, 3], radii [S], colours [S, 3], instance ids, category
    ids): the categories interleaved around rings of radius 1.5 m, at most
    14 objects a ring, the rings stacked between 0.8 m below and above the
    room's centre; radii grow with the category and the instance, scaled
    so that no two neighbours touch."""
    total = n_categories * insts_per_cat
    n_rings = -(-total // PER_RING)
    per_ring = -(-total // n_rings)
    spacing = 2 * np.pi * RING_RADIUS / per_ring
    largest = (0.3 + 0.1 * (n_categories - 1)) * (1 + 0.2 * (insts_per_cat - 1))
    size = min(1.0, 0.45 * spacing / largest)
    heights = np.linspace(-0.8, 0.8, n_rings) if n_rings > 1 else [0.0]
    centers, radii, colors, inst, cls = [], [], [], [], []
    for c in range(n_categories):
        for k in range(insts_per_cat):
            i = k * n_categories + c
            ang = 2 * np.pi * (i // n_rings) / per_ring
            centers.append([RING_RADIUS * np.cos(ang), heights[i % n_rings],
                            RING_RADIUS * np.sin(ang)])
            radii.append((0.3 + 0.1 * c) * size * (1 + 0.2 * k))
            colors.append(rng.uniform(0.2, 1.0, 3))
            inst.append(len(inst) + 1)
            cls.append(80 + c)
    return (np.array(centers), np.array(radii), np.array(colors),
            np.array(inst), np.array(cls))


def _box_bounds(mask_ids: torch.Tensor, n: int):
    """For ids 0..n-1 in mask_ids [W, H]: which ids occur, and the
    half-open extent of each along both axes."""
    W, H = mask_ids.shape
    dev = mask_ids.device
    rows = torch.zeros(n, W, dtype=torch.bool, device=dev)
    cols = torch.zeros(n, H, dtype=torch.bool, device=dev)
    wi = torch.arange(W, device=dev)[:, None].expand(W, H)
    hi = torch.arange(H, device=dev)[None, :].expand(W, H)
    rows[mask_ids.reshape(-1), wi.reshape(-1)] = True
    cols[mask_ids.reshape(-1), hi.reshape(-1)] = True

    def extent(a):
        L = a.shape[1]
        idx = torch.arange(L, device=dev)
        lo = torch.where(a, idx, L).amin(1)
        hi_ = torch.where(a, idx, -1).amax(1) + 1
        return lo, hi_

    r0, r1 = extent(rows)
    c0, c1 = extent(cols)
    present = rows.any(1)
    return [t.cpu().numpy() for t in (present, r0, r1, c0, c1)]


def make_scene(scene: dict, cam: Camera, seed: int, device) -> tuple:
    """(inst_dict, sample_dict) of `scene` (the configuration file's
    "scene" group: frames, categories, insts_per_cat, room_min, room_max)
    at camera `cam`, from `seed`."""
    rng = np.random.default_rng(seed)
    centers, radii, colors, inst_ids, cls_ids = spheres(
        scene["categories"], scene["insts_per_cat"], rng)
    wall_colors = rng.uniform(0.3, 0.8, (6, 3))
    light = np.array([0.3, -0.8, 0.5])
    light /= np.linalg.norm(light)
    box_min = np.asarray(scene["room_min"], np.float64)
    box_max = np.asarray(scene["room_max"], np.float64)

    def dev(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=device)

    C, Rd, Col, Wc = dev(centers), dev(radii), dev(colors), dev(wall_colors)
    L, bmin, bmax = dev(light), dev(box_min), dev(box_max)
    ids = torch.as_tensor(inst_ids, device=device)
    dirs_c = cam.dirs(device)
    W, H = cam.width, cam.height
    n_frames = scene["frames"]
    inst_dict: dict = {}
    sample_dict: dict = {}
    for f in range(n_frames):
        ang = 2 * np.pi * f / n_frames
        eye = np.array([(2.4 - 0.3 * np.cos(3 * ang)) * np.cos(ang),
                        1.1 * np.sin(2 * ang + 0.7),
                        (2.4 - 0.3 * np.cos(3 * ang)) * np.sin(ang)])
        T_wc = look_at(eye)
        Rw, t = dev(T_wc[:3, :3]), dev(T_wc[:3, 3])
        d = dirs_c @ Rw.T
        # the far wall: the nearest exit plane of the room
        t_wall = torch.maximum((bmin - t) / d, (bmax - t) / d).amin(-1)
        # the nearest sphere in front of the camera
        oc = t - C
        a = (d * d).sum(-1, keepdim=True)
        b = 2.0 * d @ oc.T
        c = (oc * oc).sum(-1) - Rd ** 2
        disc = b * b - 4 * a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0 = (-b - sq) / (2 * a)
        t1 = (-b + sq) / (2 * a)
        ts = torch.where(t0 > 1e-6, t0, t1)
        ts = torch.where((disc >= 0) & (ts > 1e-6), ts, math.inf)
        t_sph, k = ts.min(-1)
        on_sphere = t_sph < t_wall
        t_best = torch.where(on_sphere, t_sph, t_wall)
        inst_map = torch.where(on_sphere, ids[k], 0)
        pts = t + t_best[:, None] * d
        axis = torch.stack([torch.minimum((pts[:, i] - bmin[i]).abs(),
                                          (pts[:, i] - bmax[i]).abs())
                            for i in range(3)], -1).argmin(-1)
        rgb = Wc[axis] * (0.7 + 0.3 / (1 + 0.1 * t_best[:, None]))
        normal = (pts - C[k]) / Rd[k][:, None]
        shade = 0.4 + 0.6 * torch.clamp(-(normal @ L), 0, 1)
        rgb = torch.where(on_sphere[:, None], Col[k] * shade[:, None], rgb)

        image = (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).reshape(W, H, 3)
        om = inst_map.reshape(W, H).to(torch.int32)
        edge = torch.zeros_like(om, dtype=torch.bool)
        edge[1:] |= om[1:] != om[:-1]
        edge[:, 1:] |= om[:, 1:] != om[:, :-1]
        masked = torch.where(edge & (om > 0), -1, om)
        sample_dict[f] = {
            "image": image.cpu().numpy(),
            "depth": t_best.float().reshape(W, H).cpu().numpy(),
            "obj_mask": masked.cpu().numpy(), "T": T_wc, "frame_id": f}

        present, r0, r1, c0, c1 = _box_bounds(om.long(), len(inst_ids) + 1)
        for iid, cid in zip(inst_ids, cls_ids):
            if not present[iid]:
                continue
            rmin, rmax, cmin, cmax = r0[iid], r1[iid], c0[iid], c1[iid]
            if rmax - rmin <= 2 or cmax - cmin <= 2:
                continue
            e = enlarge_bbox([cmin, rmin, cmax, rmax], 0.2, w=H, h=W)
            if e is None:
                e = [cmin, rmin, cmax, rmax]
            inst_dict.setdefault(int(cid), {}).setdefault(
                int(iid), {"frame_info": []})["frame_info"].append(
                {"frame": f, "bbox": np.array([e[1], e[3], e[0], e[2]])})
        inst_dict.setdefault(0, {"frame_info": []})["frame_info"].append(
            {"frame": f, "bbox": np.array([0, W, 0, H])})

    for iid, cid, cen, r in zip(inst_ids, cls_ids, centers, radii):
        info = inst_dict.get(int(cid), {}).get(int(iid))
        if info is None:
            continue
        T = np.eye(4)
        T[:3, :3] *= r
        T[:3, 3] = cen
        info["T_obj"] = T
        info["bbox3D"] = Box3D(cen.copy(), np.eye(3), np.full(3, 2 * r))
    inst_dict[0]["bbox3D"] = Box3D((box_min + box_max) / 2, np.eye(3),
                                   box_max - box_min)
    return inst_dict, sample_dict
