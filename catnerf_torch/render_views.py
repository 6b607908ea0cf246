"""Novel-view RGB-D rendering from trained fields.

The port's counterpart of the JAX package's `render_views.py`. A
capability the reference does not ship (its only visual output is mesh
export, ref: src/trainer.py:62-123): ray-march the trained category /
background fields from arbitrary camera poses and emit RGB, depth and
opacity images, with the UniSurf compositing math the loss trains against
(ops/render.py, ref: src/render_rays.py:25-50).

A render runs on the device of the fields it is given (the session's):
the ray grid is built there from the camera's ray directions (cached per
camera and device), the fields are evaluated through the XLA-path modules
(`models/`), as the JAX package's render programs do, in float32 whatever
`act_dtype` the session trained with, with no autograd and no TF32, and
composited there; the host uploads a 4x4 pose and downloads one image.
The points are built and evaluated a tile of whole rays at a time (about
`chunk` points) and each tile is composited at once, so no tensor of the
whole view's points lives on the device: the pixels are those of the JAX
package's padded point tiles, since the fields are pointwise and the
composite runs along each ray. In the whole-scene composite each object
field runs on the points inside its own box only, and on a CUDA device
that part of a tile replays a CUDA graph (`_scene_tile`).

CLI: python -m catnerf_torch.render_views --logdir <dir> [--synthetic |
--config <json>] [--out <dir>] [--n-views 8] [--width 320 --height 240]
[--scene] [--device cpu]
Renders an orbit around every object (canonical frame for multi-instance
categories, world frame otherwise) plus the background from dataset camera
poses when available; --scene adds composited whole-scene views.
"""

from __future__ import annotations

import functools
import gc
import os
import threading

import numpy as np
import torch

from catnerf_torch import tracing
from catnerf_torch.config import Config
from catnerf_torch.data import png
from catnerf_torch.data.camera import CameraInfo, ray_dirs_cache
from catnerf_torch.mesher.meshing import (_device_of, _full_f32,
                                          field_chunk_fn)
from catnerf_torch.models import codenerf, embedding, occupancy
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.layers import Linear
from catnerf_torch.ops import render as render_ops
from catnerf_torch.ops.sim3 import tensor_to_se3_np

def look_at(eye, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """Camera-to-target-frame pose: z forward (towards target), matching the
    pipeline's z-depth ray convention (data/camera.py)."""
    eye = np.asarray(eye, np.float64)
    z = np.asarray(target, np.float64) - eye
    z = z / (np.linalg.norm(z) + 1e-12)
    up = np.asarray(up, np.float64)
    if abs(np.dot(z, up)) > 0.999:  # degenerate: looking along up
        up = np.array([0.0, 1.0, 0.0]) if abs(z[2]) > 0.9 else np.array(
            [0.0, 0.0, 1.0])
    x = np.cross(z, up)
    x = x / (np.linalg.norm(x) + 1e-12)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T.astype(np.float32)


def orbit_eye(az_rad: float, el_rad: float, radius: float,
              center=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera position on a sphere around `center` (single definition of
    the azimuth/elevation convention for the CLI and the HTTP server)."""
    return np.asarray(center, np.float64) + radius * np.array(
        [np.cos(az_rad) * np.cos(el_rad),
         np.sin(az_rad) * np.cos(el_rad),
         np.sin(el_rad)])


def orbit_frame(extent, radius: float | None = None):
    """(radius, near, far) framing an object of `extent` from an orbit
    camera — one copy of the 2.2x/1.3x framing recipe."""
    half_diag = 0.5 * float(np.linalg.norm(np.asarray(extent)))
    r = radius if radius is not None else 2.2 * half_diag
    near = max(0.05 * r, r - 1.3 * half_diag)
    far = r + 1.3 * half_diag
    return r, near, far


def orbit_poses(n: int, radius: float, center=(0.0, 0.0, 0.0),
                elevation_deg: float = 25.0) -> list[np.ndarray]:
    """n camera poses on a circle of `radius` around `center`, looking in."""
    el = np.deg2rad(elevation_deg)
    return [look_at(orbit_eye(2.0 * np.pi * i / n, el, radius, center),
                    center) for i in range(n)]


def default_orbit_cam(width: int, height: int) -> CameraInfo:
    """The synthetic orbit camera: f = 0.9*max(w, h), centered principal
    point — the single copy of the recipe for the render CLIs, the edit
    CLI, and the HTTP server."""
    f = 0.9 * max(width, height)
    return CameraInfo(width, height, f, f, width / 2.0, height / 2.0)


def scene_far(session) -> float:
    """Far plane covering the whole scene: 1.2x the background OBB
    diagonal, or 8 m when there is no background bound (single copy of the
    heuristic for the CLIs and the server)."""
    bound = (session.background.bound if session.background is not None
             else None)
    if bound is None:
        return 8.0
    return 1.2 * float(np.linalg.norm(np.asarray(bound.extent)))


def spread_frames(frames: list, n: int) -> list:
    """Up to n frames spread evenly over a sorted frame list."""
    step = max(1, len(frames) // max(1, n))
    return frames[::step][:n]


def _composite(occ: np.ndarray, rgb: np.ndarray, z: np.ndarray):
    """UniSurf occupancy -> termination -> composite (numpy mirror of
    ops/render.py, ref: src/render_rays.py:25-50). occ [..., B],
    rgb [..., B, 3], z [B]."""
    free = np.concatenate(
        [np.ones_like(occ[..., :1]), 1.0 - occ[..., :-1] + 1e-10], axis=-1)
    term = occ * np.cumprod(free, axis=-1)
    img = (term[..., None] * rgb).sum(-2)
    depth = (term * z).sum(-1)
    alpha = term.sum(-1)
    return img, depth, alpha


# ---------------------------------------------------------------------------
# The render on the fields' device: the ray grid, tiles of whole rays, the
# composite.
# ---------------------------------------------------------------------------

_DIRS_CACHE: dict = {}
_DIRS_LOCK = threading.Lock()


def _dirs(cam: CameraInfo, device: torch.device) -> torch.Tensor:
    """The camera's ray directions [W * H, 3] (z = 1, W-major), on
    `device`, built once per (camera, device)."""
    key = (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy,
           torch.device(device))
    with _DIRS_LOCK:
        hit = _DIRS_CACHE.get(key)
        if hit is None:
            dirs = ray_dirs_cache(cam.width, cam.height, cam.fx, cam.fy,
                                  cam.cx, cam.cy).reshape(-1, 3)
            hit = _DIRS_CACHE[key] = torch.from_numpy(dirs).to(device)
    return hit


def _f32(x, device) -> torch.Tensor:
    """x (a tensor on any device, or array-like) as float32 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _render_rays(tile_fn, cam: CameraInfo, T, near: float, far: float,
                 n_bins: int, chunk: int, device: torch.device,
                 device_mesh=None):
    """(rgb [W, H, 3], depth [W, H], alpha [W, H]) as numpy: the world ray
    grid of pose T (dirs @ R.T, bin midpoints of linspace(near, far,
    n_bins + 1)), `tile_fn(pts [n, 3]) -> (occ [n], rgb [n, 3])` over
    tiles of whole rays (about `chunk` points each), each tile composited
    with ops/render's termination. device_mesh: a DeviceMesh of more than
    one process (every rank calls this) spreads the tiles over its
    processes (tile i to rank i mod their count, parallel/grid_eval.py)
    and gathers only the tiles' pixels; every rank gets the image, the
    unsharded one bit for bit. Tracing: each tile is the span render.tile
    (the counters render.tiles, render.points), the copy-out render.sync
    (render.syncs), after which the tiles' device reads settle."""
    T = _f32(T, device)
    dirs = _dirs(cam, device) @ T[:3, :3].T
    near, far = _f32(near, device), _f32(far, device)
    edges = near + (far - near) * torch.linspace(0.0, 1.0, n_bins + 1,
                                                 device=device)
    z = 0.5 * (edges[:-1] + edges[1:])
    rays = max(1, chunk // n_bins)
    sharded = device_mesh is not None and device_mesh.size() > 1
    if sharded:
        n, r = device_mesh.size(), device_mesh.get_rank()
    parts = []
    for i, d in enumerate(dirs.split(rays)):
        if sharded and i % n != r:
            continue
        with tracing.span("render.tile"):
            tracing.count("render.tiles")
            tracing.count("render.points", d.shape[0] * n_bins)
            pts = T[:3, 3] + d[:, None, :] * z[None, :, None]
            occ, rgb = tile_fn(pts.reshape(-1, 3))
            term = render_ops.occupancy_to_termination(
                occ.reshape(-1, n_bins))
            parts.append(((term[..., None]
                           * rgb.reshape(-1, n_bins, 3)).sum(-2),
                          (term * z).sum(-1), term.sum(-1)))
    shape = (cam.width, cam.height)
    if not sharded:
        with tracing.span("render.sync"), tracing.settle():
            tracing.count("render.syncs")
            return tuple(torch.cat(x).reshape(*shape, *tail).cpu().numpy()
                         for x, tail in zip(zip(*parts), ((3,), (), ())))
    from catnerf_torch.parallel.grid_eval import _in_order

    with tracing.span("render.sync"), tracing.settle():
        tracing.count("render.syncs")
        host = [tuple(x.cpu().numpy() for x in p) for p in parts]
    tiles = _in_order(host, device_mesh)
    return tuple(np.concatenate(x).reshape(*shape, *tail)
                 for x, tail in zip(zip(*tiles), ((3,), (), ())))


@torch.inference_mode()
def render_view(params: dict, cfg: Config, T: np.ndarray, cam: CameraInfo,
                *, near: float, far: float, shape_code=None,
                texture_code=None, is_background: bool = False,
                n_bins: int = 96, chunk: int = 262144, mask_box=None):
    """Render one view on the params' device. T: camera-to-field-frame
    pose (field frame = canonical object frame, or world for
    background/single-instance).

    mask_box: optional (A_m [3,3], b_m [3], half [3]) — occupancy is
    zeroed where |A_m x + b_m| > half in the FIELD frame (the same
    OBB/extent rule the scene composite and the mesh grid apply; object
    fields are untrained outside their box). None = no mask.

    Returns (rgb [W, H, 3] in [0,1], depth [W, H], alpha [W, H]) as numpy,
    in the pipeline's transposed (W, H) layout."""
    dev = _device_of(params)
    _full_f32(dev)
    fn = field_chunk_fn(is_background=is_background,
                        scale=cfg.bg_scale if is_background
                        else cfg.obj_scale,
                        max_deg=cfg.n_unidir_funcs, want_color=True)
    sc = tc = None
    if not is_background:
        sc, tc = _f32(shape_code, dev), _f32(texture_code, dev)
    if mask_box is not None:
        mA, mb, mh = (_f32(v, dev) for v in mask_box)

    def tile_fn(p):
        occ, rgb = fn(params["pe"], params["fc"], sc, tc, p)
        if mask_box is not None:
            occ = occ * ((p @ mA.T + mb).abs() <= mh).all(-1)
        return occ, rgb

    return _render_rays(tile_fn, cam, T, near, far, n_bins, chunk, dev)


def instance_mask_box(session, cls_id: int, obj_ids: list[int],
                      margin: float = 1.3):
    """(A_m, b_m, half) for render_view's field-frame OBB/extent mask,
    covering every instance in obj_ids (donors of an edit must not be
    clipped): canonical axis-aligned box for multi-instance categories,
    the world-frame OBB otherwise. None when a single-instance object has
    no bound. Mirrors the per-object mask of the scene composite
    (render_scene_view)."""
    cat = session.categories[session.cls_ids.index(cls_id)]
    eye3 = np.eye(3, dtype=np.float32)
    zero3 = np.zeros(3, np.float32)
    if cat.n_obj > 1:
        halfs = []
        for oid in obj_ids:
            s = max(float(cat.object_tensor_dict[oid][0]), 1e-9)
            halfs.append(margin * np.asarray(cat.extent_dict[oid]) / (2 * s))
        return eye3, zero3, np.max(np.stack(halfs), 0).astype(np.float32)
    bound = cat.bound_dict.get(obj_ids[0])
    if bound is None:
        return None
    Rb = np.asarray(bound.R, np.float32)
    return (Rb.T, -Rb.T @ np.asarray(bound.center, np.float32),
            (0.5 * margin * np.asarray(bound.extent)).astype(np.float32))


def _save(out_dir: str, name: str, img: np.ndarray, depth: np.ndarray,
          alpha: np.ndarray) -> None:
    os.makedirs(out_dir, exist_ok=True)
    # (W, H) layout -> standard (H, W) image, RGB -> BGR
    bgr = (np.clip(img, 0, 1).transpose(1, 0, 2) * 255).astype(
        np.uint8)[..., ::-1]
    png.imwrite(os.path.join(out_dir, f"{name}_rgb.png"), bgr)
    d16 = np.clip(depth.T * 1000.0, 0, 65535).astype(np.uint16)  # mm
    png.imwrite(os.path.join(out_dir, f"{name}_depth.png"), d16)
    png.imwrite(os.path.join(out_dir, f"{name}_alpha.png"),
                (np.clip(alpha.T, 0, 1) * 255).astype(np.uint8))


def instance_frame(session, cls_id: int, obj_ids: list[int]):
    """(extent, center) framing the given instances of one category in its
    render frame — canonical (origin-centered, extent de-scaled by the
    sim(3) s) for multi-instance categories, the world-frame OBB otherwise.
    The single copy of the framing recipe for orbits, edits, and fits; the
    extent is the per-axis max over obj_ids so jointly framed instances
    (code donors) are not clipped. Returns None when a single-instance
    object has no bound (degenerate hull at dataset build)."""
    cat = session.categories[session.cls_ids.index(cls_id)]
    if cat.n_obj > 1:
        extents = []
        for oid in obj_ids:
            s = float(cat.object_tensor_dict[oid][0])
            extents.append(np.asarray(cat.extent_dict[oid]) / max(s, 1e-9))
        return np.max(np.stack(extents), axis=0), np.zeros(3)
    bound = cat.bound_dict.get(obj_ids[0])
    if bound is None:
        return None
    return np.asarray(bound.extent), np.asarray(bound.center)


def render_session_orbits(session, out_dir: str, *, n_views: int = 8,
                          width: int = 320, height: int = 240,
                          n_bins: int = 96) -> list[str]:
    """Orbit renders of every object + background views from up to
    `n_views` dataset poses. Returns written basenames."""
    cfg = session.cfg
    cam = default_orbit_cam(width, height)
    written: list[str] = []

    for cls_id, cat in zip(session.cls_ids, session.categories):
        params = session.category_params(cls_id)
        for obj_id in cat.obj_ids:
            k = cat.inst_id_to_index[obj_id]
            sc = params["shape_codes"][k]
            tc = params["texture_codes"][k]
            fr = instance_frame(session, cls_id, [obj_id])
            if fr is None:
                continue
            extent, center = fr
            mask = instance_mask_box(session, cls_id, [obj_id])
            radius, near, far = orbit_frame(extent)
            for v, T in enumerate(orbit_poses(n_views, radius, center)):
                img, depth, alpha = render_view(
                    params, cfg, T, cam, near=near, far=far, shape_code=sc,
                    texture_code=tc, n_bins=n_bins, mask_box=mask)
                name = f"obj{obj_id}_view{v:02d}"
                _save(out_dir, name, img, depth, alpha)
                written.append(name)

    bg_params = session.background_params()
    if bg_params is not None and getattr(session, "sample_dict", None):
        far = scene_far(session)
        for v, fr in enumerate(
                spread_frames(sorted(session.sample_dict.keys()), n_views)):
            T = np.asarray(session.sample_dict[fr]["T"], np.float32)
            img, depth, alpha = render_view(
                bg_params, cfg, T, cam, near=0.05, far=far,
                is_background=True, n_bins=n_bins)
            name = f"bg_frame{fr}_view{v:02d}"
            _save(out_dir, name, img, depth, alpha)
            written.append(name)
    return written


# ---------------------------------------------------------------------------
# The whole-scene composite
# ---------------------------------------------------------------------------

#: Rows of one slot of the scene composite's object ensemble (`_scene_tile`):
#: a slot holds one object's points, so a tile runs each object on its own
#: box's points and at most SLOT_ROWS - 1 pad rows. Timed on the H100
#: against other sizes (PERF.md, section 6).
SLOT_ROWS = 128


def _fc_rows(fc: CodeNeRF, idx: torch.Tensor, skip: str = "") -> CodeNeRF:
    """The rows `idx` of the stacked CodeNeRF layers of fc, leaving out
    the layers whose name holds `skip` (when given)."""
    def rows(layer):
        return Linear(layer.w.detach()[idx], layer.b.detach()[idx])

    return CodeNeRF({
        name: ([rows(m) for m in layer]
               if isinstance(layer, torch.nn.ModuleList) else rows(layer))
        for name, layer in fc.named_children()
        if not (skip and skip in name)})


def _slot_fields(fields: dict, owner: torch.Tensor):
    """(A, b, pe, fc, shape_inj, texture_inj) of each slot's object, with
    a leading slot axis: the staged rows gathered by `owner` [S]. The
    codes are projected on the objects first (project-then-gather,
    codenerf.project_codes), so the latent layers are not gathered."""
    shape_inj, texture_inj = codenerf.project_codes(
        fields["fc"], fields["sc"][:, None], fields["tc"][:, None])
    return (fields["A"][owner], fields["b"][owner],
            UniDirsEmbed(fields["pe"].B.detach()[owner]),
            _fc_rows(fields["fc"], owner, skip="latent"),
            shape_inj[owner], texture_inj[owner])


def _object_union(fields: dict, cfg: Config, n_slots: int, p: torch.Tensor,
                  mask: torch.Tensor, counts: torch.Tensor):
    """(prod(1 - occ_f) [n], sum(occ_f rgb_f) [n, 3], sum(occ_f) [n]) over
    the staged objects (`fields`: the staging's A, b, pe, fc, sc and tc)
    at points p [n, 3], each object field run only on the points its box
    mask [n_obj, n] holds (`counts` [n_obj] of them), in `n_slots`
    object-major slots of SLOT_ROWS rows: ceil(count / SLOT_ROWS) an
    object, in object order, then empty ones. A slot's rows are its
    object's points in point order; pad rows point at point 0 and are
    dropped. The slots run as one ensemble, each over its object's frame,
    parameters and codes (`_slot_fields`). Each hit's result goes to its
    own place of an [n_obj, n] buffer, zero elsewhere, over which the
    union reduces in object order, so two calls agree bit for bit. Sized
    on the host by `n_slots` alone: nothing here syncs, so a CUDA graph
    can hold it."""
    R = SLOT_ROWS
    n_obj, n = mask.shape
    dev = p.device
    per = (counts + R - 1) // R
    ends = torch.cumsum(per, 0)
    first = ends - per
    slot = torch.arange(n_slots, device=dev)
    owner = torch.searchsorted(ends, slot, right=True).clamp_(max=n_obj - 1)
    # a hit's row of the table: its object's first slot, then its rank
    # among the object's hits; every miss goes to one spare row at the end
    place = torch.where(mask, first[:, None] * R + mask.cumsum(1) - 1,
                        n_slots * R)
    rows = torch.zeros(n_slots * R + 1, dtype=torch.long, device=dev)
    rows.index_put_((place,), torch.arange(n, device=dev).expand(n_obj, n))
    rows = rows[:-1].view(n_slots, R)
    rank = ((slot - first[owner])[:, None] * R
            + torch.arange(R, device=dev))
    valid = rank < counts[owner][:, None]

    A, b, pe, fc, shape_inj, texture_inj = _slot_fields(fields, owner)
    x_e = p[rows] @ A.transpose(1, 2) + b[:, None]
    emb = embedding.apply(pe, x_e, scale=cfg.obj_scale,
                          max_deg=cfg.n_unidir_funcs)
    sigma, rgbs = codenerf.apply_with_injections(fc, emb, shape_inj,
                                                 texture_inj)
    occs = render_ops.occupancy_activation(sigma[..., 0])
    place = torch.where(valid, owner[:, None] * n + rows, n_obj * n)
    buf = torch.zeros(n_obj * n + 1, 4, device=dev)
    buf.index_put_((place,),
                   torch.cat([occs[..., None], occs[..., None] * rgbs], -1))
    buf = buf[:-1].view(n_obj, n, 4)
    return (torch.prod(1.0 - buf[..., 0], dim=0), buf[..., 1:].sum(0),
            buf[..., 0].sum(0))


class _Graphed:
    """`body()` (a tuple of tensors out) as a CUDA graph in the memory
    pool `pool`: the first call runs it eagerly on `stream`, then captures
    it there; every later call replays the capture on the current stream.
    Its inputs are the tensors that body reads, which the caller fills
    before each call. The outputs are static tensors that each replay
    overwrites, and that another graph of the pool may overwrite."""

    def __init__(self, body, stream: torch.cuda.Stream, pool):
        self.body = body
        self.stream = stream
        self.pool = pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: tuple = ()

    def __call__(self):
        if self.graph is not None:
            self.graph.replay()
            return self.outputs
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        # the collector must not free another graph during the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(self.stream):
                outputs = self.body()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool,
                                      stream=self.stream,
                                      capture_error_mode="thread_local"):
                    self.outputs = self.body()
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(self.stream)
        self.graph = graph
        return outputs


def _slot_bucket(n_slots: int) -> int:
    """n_slots rounded up to four steps an octave: at most a quarter more
    slots, and a few sizes (graphs) a view."""
    step = 1 << max(0, (n_slots - 1).bit_length() - 3)
    return -(-n_slots // step) * step


class _UnionGraphs:
    """One staging's CUDA graphs of `_object_union`, one per (tile size,
    bucket of slots, embedding), over one set of input tensors a tile
    size: captured on one side stream, in one memory pool, which holds
    about the largest graph since every replay runs on the stream after
    the one before. Kept in the staging (its key "graphs"), so they go
    with it. A staging whose fields were replaced (a copy of the dict)
    starts anew; a lock keeps two threads rendering one staging from
    replaying into each other's inputs and outputs."""

    FIELDS = ("A", "b", "pe", "fc", "sc", "tc")

    def __init__(self):
        self.lock = threading.Lock()
        self.stream = self.pool = None
        self.fields: tuple = ()
        self.inputs: dict = {}
        self.graphs: dict = {}

    def __call__(self, staged: dict, cfg: Config, n_slots: int,
                 p: torch.Tensor, mask: torch.Tensor, counts: torch.Tensor):
        """_object_union's three sums (copies of the graph's outputs), and
        the slots run: n_slots rounded up by `_slot_bucket` (the extra
        ones run pad rows)."""
        n_slots = _slot_bucket(n_slots)
        key = (p.shape[0], n_slots, SLOT_ROWS, cfg.obj_scale,
               cfg.n_unidir_funcs)
        fields = tuple(staged[k] for k in self.FIELDS)
        with self.lock:
            if (len(fields) != len(self.fields)
                    or any(a is not b for a, b in zip(fields, self.fields))):
                self.fields, self.inputs, self.graphs = fields, {}, {}
            if self.stream is None:
                self.stream = torch.cuda.Stream(p.device)
                self.pool = torch.cuda.graph_pool_handle()
            inputs = self.inputs.get(p.shape[0])
            if inputs is None:
                inputs = self.inputs[p.shape[0]] = tuple(
                    torch.empty_like(x) for x in (p, mask, counts))
            for static, x in zip(inputs, (p, mask, counts)):
                static.copy_(x)
            graph = self.graphs.get(key)
            if graph is None:
                graph = self.graphs[key] = _Graphed(functools.partial(
                    _object_union, dict(zip(self.FIELDS, fields)), cfg,
                    n_slots, *inputs), self.stream, self.pool)
            return tuple(x.clone() for x in graph()), n_slots


def _scene_tile(staged: dict, bg_params: dict | None, cfg: Config,
                p: torch.Tensor):
    """(occ [n], rgb [n, 3]) of the union of every staged object field and
    the background at world points p [n, 3]: occ = 1 - prod(1 - occ_f),
    rgb = sum(occ_f rgb_f) / sum(occ_f). Each object field runs only on
    the points inside its own box, in object-major slots
    (`_object_union`); every other pair of object and point has a masked
    occupancy of 0, which leaves the union's product at 1 and its sums at
    0, as the JAX package's evaluation of every point does. The
    per-object hit counts are the tile's one host read; the slots are
    sized from them. On a CUDA device the objects' work after that read
    runs as a replayed CUDA graph of the staging (`_UnionGraphs`):
    launched one by one, its ~100 operations would set the tile's pace on
    the host.

    Tracing: the spans render.objects (the box test, the span render.sync,
    the slots and the ensemble) and render.background, each timed on the
    device too; the counters render.syncs, render.object_hits (the box
    mask's true entries), render.object_slots (the slots run) and
    render.object_evals (the rows the ensemble runs: slots x
    SLOT_ROWS)."""
    one_minus = torch.ones_like(p[:, 0])
    csum = torch.zeros_like(p)
    wsum = torch.zeros_like(p[:, 0])
    with tracing.span("render.objects", device=p.device):
        x_m = p @ staged["Am"].transpose(1, 2) + staged["bm"][:, None]
        mask = (x_m.abs() <= staged["half"][:, None]).all(-1)
        counts = mask.sum(1)
        with tracing.span("render.sync"):
            tracing.count("render.syncs")
            hits = counts.tolist()
        n_slots = sum(-(-h // SLOT_ROWS) for h in hits)
        if n_slots and p.is_cuda:
            (one_minus, csum, wsum), n_slots = staged["graphs"](
                staged, cfg, n_slots, p, mask, counts)
        elif n_slots:
            one_minus, csum, wsum = _object_union(staged, cfg, n_slots, p,
                                                  mask, counts)
        tracing.count("render.object_hits", sum(hits))
        tracing.count("render.object_slots", n_slots)
        tracing.count("render.object_evals", n_slots * SLOT_ROWS)
    if bg_params is not None:
        with tracing.span("render.background", device=p.device):
            emb = embedding.apply(bg_params["pe"], p, scale=cfg.bg_scale,
                                  max_deg=cfg.n_unidir_funcs)
            sigma, rgb = occupancy.apply(bg_params["fc"], emb)
            occb = render_ops.occupancy_activation(sigma[..., 0])
            one_minus = one_minus * (1.0 - occb)
            csum = csum + occb[:, None] * rgb
            wsum = wsum + occb
    return 1.0 - one_minus, csum / torch.clamp(wsum[:, None], min=1e-8)


@torch.inference_mode()
def render_scene_view(session, T: np.ndarray, cam: CameraInfo, *,
                      near: float, far: float, n_bins: int = 64,
                      margin: float = 1.3, chunk: int = 131072,
                      device_mesh=None):
    """Composite ALL trained fields (every object + background) along shared
    world-frame rays into one RGB-D image, on the session's device.

    Per bin the fields merge as independent occupancies — union
    occ = 1 - prod(1 - occ_f), color = sum(occ_f * rgb_f) / sum(occ_f) —
    then composite along the ray with the training's shifted-cumprod math.
    Object fields are evaluated in their own frame (canonical via the
    inverse sim(3) for multi-instance categories, world otherwise) and
    masked to their OBB/extent box (fields are untrained garbage outside
    the region the mesh grid would evaluate); inside each tile every
    object field runs on the points inside its own box only, the objects
    as one ensemble over object-major slots (`_scene_tile`).
    device_mesh: a DeviceMesh of more than one process (every rank calls
    this; the JAX package's sharded composite): each rank composites its
    own tiles of whole rays and only their pixels are gathered; every rank
    gets the image, pixel-identical to the unsharded one.
    """
    if device_mesh is not None and not hasattr(device_mesh, "get_rank"):
        raise TypeError(f"device_mesh: a torch DeviceMesh "
                        f"(parallel.mesh.make_mesh), not {device_mesh!r}")
    cfg = session.cfg
    with tracing.span("render.stage"):
        staged = _stage_scene_fields(session, margin)

    bg_params = session.background_params()
    if staged is None:  # no renderable objects: background-only view
        if bg_params is None:
            raise ValueError("nothing to render: no objects with bounds "
                             "and no background field")
        return render_view(bg_params, cfg, T, cam, near=near, far=far,
                           is_background=True, n_bins=n_bins, chunk=chunk)
    dev = session.device
    _full_f32(dev)
    return _render_rays(
        lambda p: _scene_tile(staged, bg_params, cfg, p), cam, T, near,
        far, n_bins, chunk, dev, device_mesh=device_mesh)


def _stage_scene_fields(session, margin: float):
    """Every object field's rows of the stacked parameters, its codes, its
    frame and its mask box, stacked over the objects on the session's
    device for _scene_tile. Cached ON the session per (state version,
    margin): the inputs only change on training steps or adoption, and the
    stacking gathers copies of the parameters. (Stored as a session
    attribute — a global id(session)-keyed dict could alias a new session
    allocated at a dead one's address and would pin dead sessions'
    tensors.) Returns None when no object is renderable; else a dict of
    tensors with "n_obj" and "graphs", the staging's CUDA graphs of the
    object union (`_UnionGraphs`, empty until a CUDA render)."""
    # (step, adopted-count) covers every mutation path: training bumps
    # step (run_fast by k at once), adoption grows the adopted list (same
    # key rule as serve.py's /mesh cache); object ids are never reused
    version = (int(session.state.step), margin,
               len(getattr(session, "adopted_instances", [])))
    hit = getattr(session, "_scene_staging_cache", None)
    if hit is not None and hit[0] == version:
        return hit[1]

    eye3 = np.eye(3, dtype=np.float32)
    zero3 = np.zeros(3, np.float32)
    cls_idx, inst_idx, As, bs, Ams, bms, halfs = ([] for _ in range(7))
    for i, cat in enumerate(session.categories):
        multi = cat.n_obj > 1
        for obj_id in cat.obj_ids:
            k = cat.inst_id_to_index[obj_id]
            if multi:
                obj_tensor = cat.object_tensor_dict[obj_id]
                s = max(float(obj_tensor[0]), 1e-9)
                T_ow = tensor_to_se3_np(obj_tensor[1:])  # canonical->world
                A = (T_ow[:3, :3].T / s).astype(np.float32)
                b = (-T_ow[:3, :3].T @ T_ow[:3, 3] / s).astype(np.float32)
                half = (margin * np.asarray(cat.extent_dict[obj_id])
                        / (2 * s)).astype(np.float32)
                A_m, b_m = A, b
            else:
                bound = cat.bound_dict.get(obj_id)
                if bound is None:
                    continue
                A, b = eye3, zero3
                Rb = np.asarray(bound.R, np.float32)
                A_m = Rb.T
                b_m = (-Rb.T @ np.asarray(bound.center, np.float32))
                half = (0.5 * margin
                        * np.asarray(bound.extent)).astype(np.float32)
            cls_idx.append(i)
            inst_idx.append(k)
            As.append(A), bs.append(b), Ams.append(A_m), bms.append(b_m)
            halfs.append(half)

    if not cls_idx:
        staged = None
    else:
        dev = session.device
        p = session.full_params()
        ci = torch.tensor(cls_idx, device=dev)
        ki = torch.tensor(inst_idx, device=dev)

        def stack(xs):
            return torch.as_tensor(np.stack(xs), device=dev)

        staged = {
            "n_obj": len(cls_idx),
            "pe": UniDirsEmbed(p.cat_pe.B.detach()[ci]),
            "fc": _fc_rows(p.cat_fc, ci),
            "sc": p.codes.shape.detach()[ci, ki],
            "tc": p.codes.texture.detach()[ci, ki],
            "A": stack(As), "b": stack(bs), "Am": stack(Ams),
            "bm": stack(bms), "half": stack(halfs),
            "graphs": _UnionGraphs()}
    session._scene_staging_cache = (version, staged)
    return staged


def render_scene_views(session, out_dir: str, *, n_views: int = 4,
                       width: int = 320, height: int = 240,
                       n_bins: int = 64, device_mesh=None) -> list[str]:
    """Composited whole-scene renders from up to n_views dataset poses.
    device_mesh: see render_scene_view. Only rank 0 of a process group
    writes the PNGs."""
    if not getattr(session, "sample_dict", None):
        return []
    from catnerf_torch.parallel.mesh import is_main

    write = is_main()
    cam = default_orbit_cam(width, height)
    far = scene_far(session)
    written = []
    for v, fr in enumerate(
            spread_frames(sorted(session.sample_dict.keys()), n_views)):
        T = np.asarray(session.sample_dict[fr]["T"], np.float32)
        img, depth, alpha = render_scene_view(
            session, T, cam, near=0.05, far=far, n_bins=n_bins,
            device_mesh=device_mesh)
        name = f"scene_frame{fr}_view{v:02d}"
        if write:
            _save(out_dir, name, img, depth, alpha)
        written.append(name)
    return written


def restore_session(args):
    """The session of a CLI's --config/--synthetic scene on --device,
    restored from the latest checkpoint under <--logdir>/ckpt (shared by
    the render, edit and serve CLIs)."""
    from catnerf_torch.loaders import load_scene
    from catnerf_torch.train.checkpoint import (latest_checkpoint,
                                                restore_session_checkpoint)
    from catnerf_torch.train.loop import TrainingSession
    from catnerf_torch.utils import resolve_device

    device = resolve_device(args.device)
    cfg, inst_dict, sample_dict, cam = load_scene(
        args.config, synthetic=args.synthetic, device=device)
    session = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                              device=device)
    ckpt = latest_checkpoint(os.path.join(args.logdir, "ckpt"))
    if ckpt is None:
        raise SystemExit(f"no checkpoint under {args.logdir}/ckpt")
    restore_session_checkpoint(ckpt, session)
    return session


def add_scene_args(parser) -> None:
    """The CLIs' scene arguments: --logdir, --config, --synthetic,
    --device."""
    parser.add_argument("--logdir", required=True,
                        help="training logdir containing ckpt/")
    parser.add_argument("--config", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m catnerf_torch.render_views",
        description=__doc__.splitlines()[0])
    add_scene_args(parser)
    parser.add_argument("--out", default=None,
                        help="output dir (default <logdir>/renders)")
    parser.add_argument("--n-views", type=int, default=8)
    parser.add_argument("--width", type=int, default=320)
    parser.add_argument("--height", type=int, default=240)
    parser.add_argument("--n-bins", type=int, default=96)
    parser.add_argument("--scene", action="store_true",
                        help="also render composited whole-scene views "
                             "(all objects + background) from dataset poses")
    parser.add_argument("--sharded", action="store_true",
                        help="shard --scene composite tiles over every "
                             "process (torchrun --nproc-per-node N; "
                             "identical pixels)")
    args = parser.parse_args(argv)

    from catnerf_torch.parallel import mesh as pmesh

    device_mesh = None
    if args.sharded and args.scene:
        device_mesh = pmesh.cli_mesh(args.device, "--sharded")
    try:
        session = restore_session(args)
        out = args.out or os.path.join(args.logdir, "renders")
        written = []
        if pmesh.is_main():
            written = render_session_orbits(
                session, out, n_views=args.n_views, width=args.width,
                height=args.height, n_bins=args.n_bins)
        if args.scene:
            written += render_scene_views(
                session, out, n_views=args.n_views, width=args.width,
                height=args.height, n_bins=min(args.n_bins, 64),
                device_mesh=device_mesh)
        if pmesh.is_main():
            print(f"wrote {len(written)} views to {out}")
    finally:
        if device_mesh is not None:
            pmesh.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
