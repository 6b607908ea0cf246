"""Grid evaluation (on the session's device) + iso-surface mesh extraction
(host, C++).

The port's counterpart of the JAX package's `mesher/meshing.py`. Parity
targets: `Trainer.meshing` / `Trainer.eval_points` (ref:
src/trainer.py:62-151) and the training script's mesh-export loop (ref:
train.py:214-243). The host half (space carving on the host, the interior
fill, adaptive bounds, marching cubes, mesh_field/mesh_object/mesh_scene)
is a copy. The device
half evaluates the fields through the XLA-path modules (`models/`), as the
JAX package does, in PyTorch operators on the device: float32 throughout,
whatever `cfg.bf16_activations` says, with no autograd and no TF32. The
grid lives on the device as a unit cube cached per (dim, device); each
slab of it (at most 262,144 points) is placed by a 12-float affine,
evaluated (occupancy only: no colour branch), carved against the training
views and quantised to uint8 there, so that only uint8 occupancy, the
seen mask and uint8 vertex colours come back. Every slab is enqueued
before the first is read back.
"""

from __future__ import annotations

import threading as _threading
import time as _time

import numpy as np
import torch

from catnerf_torch.config import Config
from catnerf_torch.mesher.mesh import TriMesh
from catnerf_torch.models import codenerf, embedding, occupancy
from catnerf_torch.native.lib import geomlib
from catnerf_torch.ops import render as render_ops
from catnerf_torch.ops.sim3 import tensor_to_se3_np


# bound_extent margins (ref: src/trainer.py:31-34)
BOUND_EXTENT_BG = 0.995
BOUND_EXTENT_OBJ = 0.9

# ---------------------------------------------------------------------------
# Mesh-all phase attribution: cumulative wall time per phase across
# mesh_field/mesh_scene calls, so the dominant phase is measured, not
# guessed.
# ---------------------------------------------------------------------------

MESH_TIMINGS: dict[str, float] = {}
_TIMINGS_LOCK = _threading.Lock()
#: (grid_dim, is_background, carve) keys already evaluated once — the
#: first call of each is attributed separately (it pays the device's
#: first-use costs: the allocator's first blocks, the matmul handles)
_GRID_PROGS_SEEN: set = set()


def _t_add(phase: str, dt: float) -> None:
    with _TIMINGS_LOCK:
        MESH_TIMINGS[phase] = MESH_TIMINGS.get(phase, 0.0) + dt


def reset_mesh_timings() -> None:
    with _TIMINGS_LOCK:
        MESH_TIMINGS.clear()
        _GRID_PROGS_SEEN.clear()


def mesh_timings() -> dict[str, float]:
    with _TIMINGS_LOCK:
        return {k: round(v, 2) for k, v in sorted(MESH_TIMINGS.items())}


def space_carve_mask(points_w: np.ndarray, depths: np.ndarray,
                     T_wc: np.ndarray, cam, margin: float,
                     stride: int = 1) -> np.ndarray:
    """Seen-empty mask over world points: a point is provably free space if
    any training view's ray through it terminates beyond it (its camera
    depth < observed depth - margin). Crust-supervised fields carry
    spurious occupancy in never-supervised space (the reference's meshes
    contain the same artifacts); this removes exactly the part the data
    contradicts. depths: (n_frames, W, H) in the (W, H) layout."""
    pts = np.asarray(points_w, np.float32)
    seen = np.zeros(len(pts), bool)
    W, H = depths.shape[1], depths.shape[2]
    for i in range(0, len(depths), stride):
        T = T_wc[i]
        Rcw = T[:3, :3].T
        pc = (pts - T[:3, 3]) @ Rcw.T
        z = pc[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = (cam.fx * pc[:, 0] / z + cam.cx)
            py = (cam.fy * pc[:, 1] / z + cam.cy)
        ok = (z > 0.05) & (px >= 0) & (px <= W - 1) & (py >= 0) & (py <= H - 1)
        if not ok.any():
            continue
        ix = np.clip(np.round(px[ok]).astype(np.int32), 0, W - 1)
        iy = np.clip(np.round(py[ok]).astype(np.int32), 0, H - 1)
        obs = depths[i][ix, iy]
        hit = (obs > 0) & (z[ok] < obs - margin)
        idx = np.nonzero(ok)[0][hit]
        seen[idx] = True
    return seen


def _fill_unobservable_interior(occ3: np.ndarray,
                                observed_free: np.ndarray | None = None
                                ) -> np.ndarray:
    """Raise interior empty voxels above the iso level so marching cubes
    extracts only the outer surface. Two passes: binary_fill_holes for
    closed crusts, plus an axis visual-hull pass (empty voxels occluded by
    solid in >= 4 of 6 axis directions) that still works when the crust has
    holes in never-observed regions, where fill_holes leaks and spurious
    inner shells survive.

    observed_free: voxels some training view directly observed as empty
    (the space-carve mask) — these are NEVER filled: a genuinely observed
    concavity (an open bowl's interior) is blocked on >= 5 axes and would
    otherwise be clobbered back to solid, undoing the carve.

    The mask is computed in C++ (geomlib.interior_cavity_mask — one
    border flood fill + six directional sweeps); the JAX package keeps the
    scipy+numpy original as its equivalence oracle."""
    cavity = geomlib.interior_cavity_mask(occ3 > 0.5, observed_free,
                                          min_blocked=4)
    if cavity.any():
        occ3 = np.where(cavity, np.float32(0.51), occ3)
    return occ3


def _full_f32(device: torch.device) -> None:
    """The mesher's products run in full float32: on a CUDA device TF32
    is turned off, as the training session does."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def field_chunk_fn(*, is_background: bool, scale: float, max_deg: int,
                   want_color: bool):
    """THE per-tile field evaluator — (pe, fc, sc, tc, pts [chunk, 3]) ->
    occ [chunk] (+ rgb) — shared by the grid slabs and eval_points.
    float32 throughout (no act_dtype). want_color=False skips the color
    branch entirely."""
    if is_background:
        def fn(pe, fc, sc, tc, pts):
            emb = embedding.apply(pe, pts, scale=scale, max_deg=max_deg)
            alpha, rgb = occupancy.apply(fc, emb, do_color=want_color)
            occ = render_ops.occupancy_activation(alpha[..., 0])
            return (occ, rgb) if want_color else occ
    else:
        def fn(pe, fc, sc, tc, pts):
            emb = embedding.apply(pe, pts, scale=scale, max_deg=max_deg)
            sigma, rgb = codenerf.apply(fc, emb, sc, tc,
                                        do_color=want_color)
            occ = render_ops.occupancy_activation(sigma[..., 0])
            return (occ, rgb) if want_color else occ
    return fn


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    """round(clip(x, 0, 1) * 255) as uint8, on x's device."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def _pad_to_chunks(points: np.ndarray, chunk: int):
    n = len(points)
    n_pad = (-n) % chunk
    if n_pad:
        points = np.concatenate([points, np.zeros((n_pad, 3), points.dtype)])
    return points, n


#: Tail-tile pad sizes for eval_points (ascending; the final tile of a
#: query pads to the smallest bucket that holds it, full tiles always run
#: at `chunk`), so the distinct tile shapes are bounded by the bucket set
#: rather than by the number of distinct query lengths.
_TAIL_BUCKETS = (4096, 16384, 65536)


def _tile_plan(n: int, chunk: int) -> list[tuple[int, int]]:
    """[(n_valid, padded_size), ...] covering n points: full `chunk` tiles
    plus one bucket-padded tail."""
    plan = []
    off = 0
    while n - off >= chunk:
        plan.append((chunk, chunk))
        off += chunk
    tail = n - off
    if tail or not plan:
        size = next((b for b in _TAIL_BUCKETS if b >= tail and b < chunk),
                    chunk)
        plan.append((tail, size))
    return plan


# ---------------------------------------------------------------------------
# Device-resident grid evaluation. The UNIT grid lives on the device
# (cached per grid_dim); each attempt ships only the 12-float affine, and
# space carving runs in the same slab evaluation (a loop over the carve
# views), so the only per-attempt downloads are uint8 occupancy and the
# seen mask.
# ---------------------------------------------------------------------------

_UNIT_GRID_CACHE: dict[tuple[int, torch.device], torch.Tensor] = {}
_GRID_LOCK = _threading.Lock()


def _unit_grid(dim: int, device: torch.device) -> torch.Tensor:
    """[-1, 1]^3 grid [dim^3, 3] (ij-order, matching the host meshgrid
    layout), resident on `device`, built once per (dim, device). The JAX
    package pads it to a whole number of slabs so that one compiled
    program serves every dim; eager PyTorch compiles nothing, so the port
    evaluates no padding: the last slab is the shorter one."""
    key = (dim, torch.device(device))
    with _GRID_LOCK:
        hit = _UNIT_GRID_CACHE.get(key)
        if hit is None:
            t = np.linspace(-1.0, 1.0, dim, dtype=np.float32)
            gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
            pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
            hit = _UNIT_GRID_CACHE[key] = torch.from_numpy(pts).to(device)
    return hit


def _carve_tile(pts_w, depths, T_wc, K, margin):
    """Seen-empty mask for one tile of world points, over every carve view
    (same rules as the host space_carve_mask). depths (n, W, H), T_wc
    (n, 4, 4), K = [fx, fy, cx, cy] and margin, float32 on pts_w's
    device."""
    W, H = depths.shape[1], depths.shape[2]
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    seen = torch.zeros(pts_w.shape[0], dtype=torch.bool, device=pts_w.device)
    for T, depth in zip(T_wc, depths):
        pc = (pts_w - T[:3, 3]) @ T[:3, :3]  # (p - t) @ Rcw.T, Rcw = R.T
        z = pc[:, 2]
        safe_z = torch.where(z.abs() > 1e-6, z, 1.0)
        px = fx * pc[:, 0] / safe_z + cx
        py = fy * pc[:, 1] / safe_z + cy
        ok = (z > 0.05) & (px >= 0) & (px <= W - 1) & \
             (py >= 0) & (py <= H - 1)
        ix = torch.clamp(torch.round(torch.where(ok, px, 0.0)).to(
            torch.int32), 0, W - 1)
        iy = torch.clamp(torch.round(torch.where(ok, py, 0.0)).to(
            torch.int32), 0, H - 1)
        obs = depth[ix, iy]
        seen |= ok & (obs > 0) & (z < obs - margin)
    return seen


@torch.no_grad()
def _eval_grid_slab(pe, fc, sc, tc, slab, scale3, Tg_R, Tg_t,
                    Tw_R, Tw_t, depths, T_wc, K, margin, *,
                    is_background, scale, max_deg, carve):
    """(occ_u8, seen_empty) for ONE slab of the affine-placed unit grid,
    on the slab's device. pts = (slab * scale3) @ Tg_R.T + Tg_t;
    carve projects pts through Tw (grid->world) into every view.

    Occupancy is quantised to uint8 before the download: marching cubes
    only interpolates the 0.5 crossing — half a quantum (1/510) of
    iso-position error vs a 4x smaller transfer."""
    fn = field_chunk_fn(is_background=is_background, scale=scale,
                        max_deg=max_deg, want_color=False)
    pts = (slab * scale3) @ Tg_R.T + Tg_t
    occ = fn(pe, fc, sc, tc, pts)
    if carve:
        pts_w = pts @ Tw_R.T + Tw_t
        seen = _carve_tile(pts_w, depths, T_wc, K, margin)
        occ = torch.where(seen, 0.0, occ)
    else:
        seen = torch.zeros(pts.shape[0], dtype=torch.bool,
                           device=pts.device)
    return _to_u8(occ), seen


def host_grid_points(grid_dim: int, scale_np: np.ndarray,
                     transform_np: np.ndarray) -> np.ndarray:
    """Host mirror of the device grid placement (ij-order [-1,1]^3 cube,
    per-axis scale, then the 4x4 affine) — used by tests stubbing
    `_grid_occ_seen` with analytic fields."""
    t = np.linspace(-1.0, 1.0, grid_dim, dtype=np.float32)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    pts = (np.stack([gx, gy, gz], -1).reshape(-1, 3)
           * np.asarray(scale_np, np.float32))
    return (pts @ transform_np[:3, :3].T
            + transform_np[:3, 3]).astype(np.float32)


def _device_of(params: dict) -> torch.device:
    return params["pe"].B.device


def _grid_slabs(params, cfg, shape_code, texture_code, *, grid_dim,
                scale_np, transform_np, world_transform, carve,
                is_background, voxel_w, chunk, pick=None):
    """[(occ_u8, seen_empty)] of the slabs `chunk` points long of one
    affine grid placement, on the params' device, each enqueued before any
    is read back: every slab, or those whose index `pick` takes (the
    sharded mesher's, parallel/grid_eval.py: the same slabs, so the same
    products)."""
    dev = _device_of(params)
    _full_f32(dev)
    grid_unit = _unit_grid(grid_dim, dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    if carve is not None:
        depths, T_wc, cam = carve
        depths_t, twc_t = f32(depths), f32(T_wc)
        K = f32([cam.fx, cam.fy, cam.cx, cam.cy])
        Tw = (np.asarray(world_transform, np.float32)
              if world_transform is not None
              else np.eye(4, dtype=np.float32))
    else:
        depths_t = twc_t = K = None
        Tw = np.eye(4, dtype=np.float32)
    sc_t = f32(shape_code) if shape_code is not None else None
    tc_t = f32(texture_code) if texture_code is not None else None
    args = (f32(scale_np), f32(transform_np[:3, :3]),
            f32(transform_np[:3, 3]), f32(Tw[:3, :3]), f32(Tw[:3, 3]),
            depths_t, twc_t, K, f32(3.0 * voxel_w))
    return [
        _eval_grid_slab(
            params["pe"], params["fc"], sc_t, tc_t, slab, *args,
            is_background=is_background,
            scale=cfg.bg_scale if is_background else cfg.obj_scale,
            max_deg=cfg.n_unidir_funcs, carve=carve is not None)
        for i, slab in enumerate(grid_unit.split(chunk))
        if pick is None or pick(i)]


def _grid_timing(grid_dim, is_background, carve, t0) -> None:
    dt = _time.time() - t0
    _t_add("grid_eval", dt)
    prog_key = (grid_dim, is_background, carve is not None)
    with _TIMINGS_LOCK:
        first = prog_key not in _GRID_PROGS_SEEN
        _GRID_PROGS_SEEN.add(prog_key)
    _t_add(f"grid_eval.dim{grid_dim}" + (".first" if first else ""), dt)


def _grid_occ_seen(params, cfg, shape_code, texture_code, *, grid_dim,
                   scale_np, transform_np, world_transform, carve,
                   is_background, voxel_w, chunk):
    """THE grid-evaluation seam of mesh_field: (occ [dim^3],
    seen_empty [dim^3] | None) for one affine grid placement, evaluated on
    the params' device. Module-level so tests can stub the whole
    evaluation with an analytic field."""
    t0 = _time.time()
    outs = _grid_slabs(params, cfg, shape_code, texture_code,
                       grid_dim=grid_dim, scale_np=scale_np,
                       transform_np=transform_np,
                       world_transform=world_transform, carve=carve,
                       is_background=is_background, voxel_w=voxel_w,
                       chunk=chunk)
    occ = torch.cat([o for o, _ in outs]).cpu().numpy().astype(
        np.float32) / 255.0
    seen_empty = (torch.cat([s for _, s in outs]).cpu().numpy()
                  if carve is not None else None)
    _grid_timing(grid_dim, is_background, carve, t0)
    return occ, seen_empty


def _eval_tiles(points: np.ndarray, params: dict, cfg: Config,
                shape_code, texture_code, *, is_background: bool,
                chunk: int, want_color: bool, color_u8: bool, pick=None):
    """[(n_valid, occ, rgb | None)] of eval_points' tiles (`_tile_plan`),
    on the params' device, every tile enqueued before any is read back:
    every tile, or those whose index `pick` takes."""
    dev = _device_of(params)
    _full_f32(dev)
    pts_np = np.asarray(points, np.float32)
    sc = tc = None
    if not is_background:
        sc = torch.as_tensor(np.asarray(shape_code, np.float32), device=dev)
        tc = torch.as_tensor(np.asarray(texture_code, np.float32),
                             device=dev)
    fn = field_chunk_fn(is_background=is_background,
                        scale=cfg.bg_scale if is_background
                        else cfg.obj_scale,
                        max_deg=cfg.n_unidir_funcs, want_color=want_color)
    # full tiles at `chunk` and one tail padded to a _TAIL_BUCKETS size
    parts, off = [], 0
    for i, (n_valid, size) in enumerate(_tile_plan(len(pts_np), chunk)):
        if pick is None or pick(i):
            tile, _ = _pad_to_chunks(pts_np[off:off + n_valid], size)
            out = fn(params["pe"], params["fc"], sc, tc,
                     torch.from_numpy(tile).to(dev))
            occ, rgb = out if want_color else (out, None)
            if color_u8 and rgb is not None:
                rgb = _to_u8(rgb)
            parts.append((n_valid, occ, rgb))
        off += n_valid
    return parts


@torch.no_grad()
def eval_points(points: np.ndarray, params: dict, cfg: Config,
                shape_code=None, texture_code=None, *, is_background: bool,
                chunk: int = 262144, want_color: bool = True,
                want_occ: bool = True, color_u8: bool = False,
                device_mesh=None):
    """(occ, color) at arbitrary 3D points, in tiles on the params' device
    (ref: src/trainer.py:125-151). want_color=False skips the color branch
    and its download; want_occ=False computes occupancy but skips its
    download (the vertex-color re-query discards it); color_u8 quantizes
    colors to uint8 on the device (the mesh wants uint8 anyway — a 4x
    smaller transfer). device_mesh: a DeviceMesh of more than one process
    (every rank calls this) spreads the tiles over its processes and
    gathers the results (parallel/grid_eval.py; bitwise the same)."""
    if device_mesh is not None and device_mesh.size() > 1:
        from catnerf_torch.parallel.grid_eval import eval_points_sharded

        return eval_points_sharded(
            points, params, cfg, device_mesh, shape_code, texture_code,
            is_background=is_background, chunk=chunk, want_color=want_color,
            want_occ=want_occ, color_u8=color_u8)
    n = len(points)
    parts = _eval_tiles(points, params, cfg, shape_code, texture_code,
                        is_background=is_background, chunk=chunk,
                        want_color=want_color, color_u8=color_u8)
    occ = (torch.cat([o[:m] for m, o, _ in parts]).cpu().numpy()[:n]
           if want_occ else None)
    rgb = (torch.cat([r[:m] for m, _, r in parts]).cpu().numpy()[:n]
           if want_color else None)
    return occ, rgb


def adaptive_grid_dim(extent, live_voxel_size: float, grid_dim_max: int) -> int:
    """min(max_extent // live_voxel + 1, grid_dim) (ref: train.py:220,229),
    rounded UP to a multiple of 32 so objects of similar size share one
    grid shape (the extra resolution only refines the mesh)."""
    dim = int(np.minimum(np.max(extent) // live_voxel_size + 1, grid_dim_max))
    return int(min(-(-dim // 32) * 32, grid_dim_max))


def mesh_field(params: dict, cfg: Config, *, grid_dim: int,
               is_background: bool, shape_code=None, texture_code=None,
               bound=None, extent=None, extent_canon=None, carve=None,
               world_transform=None, device_mesh=None) -> TriMesh | None:
    """Extract one object's colored mesh (ref: src/trainer.py:62-123).

    Two layouts, as in the reference:
      * `bound` (OrientedBBox) given — background / single-instance
        categories: the grid lives in world frame via the OBB transform.
      * `extent` given — multi-instance categories: the grid lives in the
        normalized canonical object frame (extent / max(extent/2)).
    Returns the mesh in the same frame as the grid; the caller applies the
    sim(3) object->world transform for multi-instance categories
    (ref: train.py:233-243).

    Adaptive bounds (cfg.mesh_adaptive_bounds; the reference clips): OBB
    extents come from *observed* point clouds, so unobserved parts of an
    object can fall outside the eval grid and get clipped from the mesh.
    When the extracted iso-surface touches a grid boundary face, that
    side's bound grows 30% and the grid re-evaluates (up to 3 times) until
    the surface is enclosed.

    Space carving (cfg.mesh_space_carving): `carve` =
    (depths (n, W, H), T_wc (n, 4, 4), cam) marks grid voxels that any
    training view observed to be free space and zeroes their occupancy —
    removing spurious never-supervised occupancy before extraction.
    `world_transform` (sim(3)) maps the grid frame to world for carving
    when the grid is canonical (multi-instance categories).

    device_mesh: a DeviceMesh of more than one process (every rank calls
    this) spreads the grid's slabs and the colour re-query's tiles over
    its processes (parallel/grid_eval.py); every rank gets the mesh.
    """
    grid_occ_seen = _grid_occ_seen
    if device_mesh is not None and device_mesh.size() > 1:
        import functools

        from catnerf_torch.parallel.grid_eval import grid_occ_seen_sharded

        grid_occ_seen = functools.partial(grid_occ_seen_sharded,
                                          device_mesh=device_mesh)
    occ_range = (-1.0, 1.0)
    range_dist = occ_range[1] - occ_range[0]
    bound_extent = BOUND_EXTENT_BG if is_background else BOUND_EXTENT_OBJ

    if bound is not None:
        base_extent = np.asarray(bound.extent, np.float64)
        R = np.asarray(bound.R, np.float64)
        center = np.asarray(bound.center, np.float64)
    elif extent_canon is not None:
        # category-union canonical box (cfg.mesh_category_extent): RAW
        # canonical units, deliberately NOT re-normalized — a member whose
        # canonical cloud extends past the instance's own unit-normalized
        # box (blind-spot coverage by a better-observed member) must grow
        # the grid, which extent / max(extent/2) would undo.
        base_extent = np.asarray(extent_canon, np.float64)
        R = None
        center = np.zeros(3)
    else:
        assert extent is not None
        base_extent = (np.asarray(extent, np.float64)
                       / np.max(np.asarray(extent) / 2.0))
        R = None
        center = np.zeros(3)

    lo = -base_extent / (range_dist * bound_extent)  # per-axis box bounds in
    hi = -lo                                         # the grid's local frame
    max_grow = 3 if (cfg.mesh_adaptive_bounds and not is_background) else 0

    chunk = 262144
    do_carve = carve is not None and not is_background
    if world_transform is not None:
        ws = abs(np.linalg.det(world_transform[:3, :3])) ** (1 / 3)
    else:
        ws = 1.0

    for attempt in range(max_grow + 1):
        scale_np = (hi - lo) / 2.0
        offset = (hi + lo) / 2.0
        transform_np = np.eye(4, dtype=np.float32)
        transform_np[:3, :3] = R if R is not None else np.eye(3)
        transform_np[:3, 3] = center + (R @ offset if R is not None else offset)
        voxel_w = float(np.max(scale_np)) * 2.0 / (grid_dim - 1) * ws
        occ, seen_empty = grid_occ_seen(
            params, cfg, shape_code, texture_code, grid_dim=grid_dim,
            scale_np=scale_np, transform_np=transform_np,
            world_transform=world_transform,
            carve=carve if do_carve else None,
            is_background=is_background, voxel_w=voxel_w, chunk=chunk)
        if seen_empty is not None:
            occ = np.where(seen_empty, np.float32(0.0), occ)
        if occ.max() <= 0.5:  # nothing to extract anywhere in the grid
            return None
        if occ.min() >= 0.5:
            # grid lies entirely INSIDE the object (OBB from sparse
            # observed points can under-bound badly): this is exactly the
            # case adaptive growth exists for — grow every side instead of
            # giving up before the boundary-face check can run
            if attempt == max_grow:
                return None
            pad = 0.3 * (hi - lo)
            lo -= pad
            hi += pad
            continue
        occ3 = occ.reshape(grid_dim, grid_dim, grid_dim)
        seen_empty3 = (seen_empty.reshape(occ3.shape)
                       if seen_empty is not None else None)
        if attempt == max_grow:
            break
        # boundary-face occupancy -> grow that side by 30%
        faces = [(0, 0, occ3[0]), (0, 1, occ3[-1]),
                 (1, 0, occ3[:, 0]), (1, 1, occ3[:, -1]),
                 (2, 0, occ3[:, :, 0]), (2, 1, occ3[:, :, -1])]
        grew = False
        for axis, side, face in faces:
            if (face > 0.5).any():
                pad = 0.3 * (hi[axis] - lo[axis])
                if side == 0:
                    lo[axis] -= pad
                else:
                    hi[axis] += pad
                grew = True
        if not grew:
            break

    if R is None:
        # canonical-frame path: keep transform only if the box moved
        if np.allclose((hi + lo), 0.0):
            transform_np = None
    if cfg.mesh_fill_interior and not is_background:
        # vMAP-style fields are supervised only in a crust around observed
        # surfaces; deep inside an object the occupancy decays below the 0.5
        # level again and marching cubes extracts a spurious INNER shell
        # (the reference has the same artifact). Raise interior empty
        # regions above the level; the outer crossing band keeps its exact
        # values, so subvoxel interpolation is unaffected.
        t0 = _time.time()
        occ3 = _fill_unobservable_interior(occ3, observed_free=seen_empty3)
        _t_add("fill_interior", _time.time() - t0)

    t0 = _time.time()
    out = geomlib.marching_cubes(occ3, 0.5,
                                 method=getattr(cfg, "mesh_method", "mc"))
    _t_add("marching_cubes", _time.time() - t0)
    if out is None:
        return None
    verts, tris = out
    mesh = TriMesh(verts.astype(np.float64) / (grid_dim - 1), tris)

    # [0,1] -> [-1,1] -> model frame (ref: src/trainer.py:102-109)
    mesh.apply_translation([-0.5, -0.5, -0.5])
    mesh.apply_scale(2.0)
    mesh.apply_scale(scale_np)
    if transform_np is not None:
        mesh.apply_transform(transform_np)

    # vertex colors by re-query (ref: src/trainer.py:111-121); occupancy
    # is computed but not downloaded, colors come back uint8 (the mesh
    # stores uint8)
    t0 = _time.time()
    _, color = eval_points(mesh.vertices.astype(np.float32), params, cfg,
                           shape_code, texture_code,
                           is_background=is_background,
                           want_occ=False, color_u8=True,
                           device_mesh=device_mesh)
    mesh.vertex_colors = color
    _t_add("vertex_color", _time.time() - t0)
    return mesh


def build_carve_views(session):
    """Carve-view tuple (depths, T_wc, cam) from the session's training
    views, or None when cfg.mesh_space_carving is off / no views exist."""
    cfg = session.cfg
    if not (cfg.mesh_space_carving and getattr(session, "sample_dict", None)):
        return None
    frames = sorted(session.sample_dict.keys())
    # subsample views: carving converges quickly with a handful
    frames = frames[:: max(1, len(frames) // 12)]
    depths = np.stack(
        [np.asarray(session.sample_dict[f]["depth"]) for f in frames])
    T_wc = np.stack(
        [np.asarray(session.sample_dict[f]["T"]) for f in frames])
    return (depths, T_wc, session.cam)


def mesh_object(session, obj_id: int, *, carve="auto", device_mesh=None):
    """Mesh ONE object (obj_id 0 = background) in SCENE frame — the
    per-object body of mesh_scene. Returns a TriMesh or None (marching
    failure / missing bound). carve='auto' derives the space-carving views
    from the session; pass a prebuilt tuple (or None) when meshing many
    objects. device_mesh: see mesh_field."""
    cfg = session.cfg
    if carve == "auto":
        carve = build_carve_views(session)

    if obj_id == 0:
        if session.background is None or session.background.bound is None:
            return None
        bound = session.background.bound
        dim = adaptive_grid_dim(bound.extent, cfg.live_voxel_size,
                                cfg.grid_dim)
        return mesh_field(session.background_params(), cfg, grid_dim=dim,
                          is_background=True, bound=bound,
                          device_mesh=device_mesh)

    for cls_id, cat in zip(session.cls_ids, session.categories):
        if obj_id in cat.inst_id_to_index:
            break
    else:
        raise KeyError(f"unknown object id {obj_id}")
    params = session.category_params(cls_id)
    multi = cat.n_obj > 1
    k = cat.inst_id_to_index[obj_id]
    sc = params["shape_codes"][k].cpu().numpy()
    tc = params["texture_codes"][k].cpu().numpy()
    if multi:
        extent = cat.extent_dict[obj_id]
        extent_canon = None
        if getattr(cfg, "mesh_category_extent", False):
            # category-union canonical extent: members share the canonical
            # frame, so a better-observed member's canonical box covers a
            # rim-eroded member's blind spots
            exts = []
            for oid in cat.obj_ids:
                e = cat.extent_dict.get(oid)
                t = cat.object_tensor_dict.get(oid)
                if e is not None and t is not None and float(t[0]) > 0:
                    exts.append(np.asarray(e, np.float64) / float(t[0]))
            if len(exts) > 1:
                extent_canon = np.max(exts, axis=0)
        # the union box is larger than the instance's own normalized box
        # (max component 2.0); scale the adaptive dim by that growth so
        # the voxel size in world units is preserved
        growth = (float(np.max(extent_canon)) / 2.0
                  if extent_canon is not None else 1.0)
        dim = adaptive_grid_dim(np.asarray(extent) * max(1.0, growth),
                                cfg.live_voxel_size, cfg.grid_dim)
        obj_tensor = cat.object_tensor_dict[obj_id]
        T_world = tensor_to_se3_np(obj_tensor[1:])
        T_world = T_world.copy()
        T_world[:3, :3] *= float(obj_tensor[0])  # sim(3) scale
        mesh = mesh_field(params, cfg, grid_dim=dim,
                          is_background=False, shape_code=sc,
                          texture_code=tc, extent=extent,
                          extent_canon=extent_canon,
                          carve=carve, world_transform=T_world,
                          device_mesh=device_mesh)
        if mesh is not None:
            # canonical -> scene: sim(3) scale then rigid transform
            # (ref: train.py:233-243)
            mesh.apply_scale(float(obj_tensor[0]))
            mesh.apply_transform(tensor_to_se3_np(obj_tensor[1:]))
        return mesh
    bound = cat.bound_dict.get(obj_id)
    if bound is None:
        return None
    dim = adaptive_grid_dim(bound.extent, cfg.live_voxel_size, cfg.grid_dim)
    return mesh_field(params, cfg, grid_dim=dim, is_background=False,
                      shape_code=sc, texture_code=tc, bound=bound,
                      carve=carve, device_mesh=device_mesh)


def mesh_scene(session, out_dir: str, iteration: int,
               only_objects: list[int] | None = None,
               device_mesh=None) -> dict[int, str]:
    """Mesh every object + background and export .obj files in scene frame
    (ref: train.py:214-243). Returns {obj_id or 0: path}.
    only_objects: restrict to these obj ids (background 0 included only if
    listed). Only rank 0 of a process group writes the files.
    device_mesh: a DeviceMesh of more than one process (every rank calls
    this, and every rank gets the paths) spreads each grid and colour
    evaluation over its processes (parallel/grid_eval.py; the same
    bytes), the objects meshed one after another. A sharded session's
    categories are gathered to every rank first."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from catnerf_torch.parallel import mesh as pmesh

    sharded = device_mesh is not None and device_mesh.size() > 1
    write = pmesh.is_main()
    if getattr(session, "shard", None) is not None:
        session.full_params()  # the gather, on every rank, before meshing
    if write:
        os.makedirs(out_dir, exist_ok=True)
    written: dict[int, str] = {}
    carve = build_carve_views(session)

    obj_ids = [0] + [obj_id for cat in session.categories
                     for obj_id in cat.obj_ids]
    if only_objects is not None:
        obj_ids = [o for o in obj_ids if o in set(only_objects)]

    def one(obj_id):
        mesh = mesh_object(session, obj_id, carve=carve,
                           device_mesh=device_mesh)
        if mesh is None:
            return obj_id, None
        path = os.path.join(out_dir,
                            f"iteration_{iteration}_obj{obj_id}.obj")
        if write:
            t0 = _time.time()
            mesh.export(path)
            _t_add("export", _time.time() - t0)
        return obj_id, path

    # Two objects in flight: the device grid evaluation of object k+1
    # overlaps the host phases (interior fill, marching cubes, export) of
    # object k — the device's work from both threads runs in order on its
    # stream, and the C++/numpy phases release the GIL for their bulk.
    # Sequential when sharded: the ranks' collectives run in one order.
    if len(obj_ids) > 1 and not sharded:
        with ThreadPoolExecutor(max_workers=2) as pool:
            results = list(pool.map(one, obj_ids))
    else:
        results = [one(o) for o in obj_ids]
    for obj_id, path in results:
        if path is None:
            if obj_id != 0 and write:
                print(f"mesh failed obj {obj_id}")
            continue
        written[obj_id] = path
    if sharded:
        pmesh.barrier()  # the files are written when any rank returns
    return written
