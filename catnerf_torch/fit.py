"""Test-time reconstruction of a new instance from a trained category prior.

The port's counterpart of the JAX package's `fit.py`. The payoff of
category-level fields (the paper's motivation, ref: src/model.py:22-84 +
README.md:8): once a category's CodeNeRF MLP is trained, a NEW, partially
observed instance of that category can be reconstructed WITHOUT retraining
— freeze the MLP and positional encoding and optimize only a fresh pair of
shape/texture latent codes (a few hundred Adam steps over the instance's
own rays, initialised at the category-mean code). The shared MLP supplies
the category prior, so unobserved parts of the new object complete
plausibly. The reference has no such entry point; this is a capability
beyond it, built from the same step math (ops/sampling.py, ops/losses.py —
ref: src/scene_cateogries.py:453-546, src/loss.py:18-74).

Only meaningful for multi-instance categories: their fields live in the
registered canonical frame, where any instance maps through its sim(3)
`T_obj`. Single-instance categories train in world frame at the original
object's location, so there is no reusable prior to fit against.

The fit runs on the session's device through the XLA-path modules in
float32 (no fused kernel: the JAX package's fit calls none either). A step
draws, from one generator on the device, the row indices (uniform below
the instance's ray count) and then the sampler's uniforms; on the card each
step is a replayed CUDA graph (`train/graph.CapturedStep`), the JAX
package's `n_inner` steps a dispatch. Threefry and Philox never agree, so a
test holds the port against the JAX package by injecting the JAX draws
(`FitDraws`, the `draws=` of `fit_instance`).

CLI:
  python -m catnerf_torch.fit --logdir <dir> [--synthetic | --config <json>]
      --cls <cls_id> --obj <inst_id> [--steps 600] [--mesh] [--views N]
      [--device cpu]
fits codes for the named instance's observations against the checkpoint's
frozen MLP (the instance may or may not have been in the training set) and
writes metrics, orbit renders, and optionally a mesh.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.models import codenerf, embedding
from catnerf_torch.ops import losses, sampling


class FitResult(NamedTuple):
    shape_code: np.ndarray
    texture_code: np.ndarray
    final_loss: float          # NOTE: the total is not monotone in fit
                               # quality (the depth term's 1/sqrt(var)
                               # weighting grows as depth sharpens,
                               # ref: src/loss.py:46,54) — compare PSNRs
    final_psnr: float          # L1-PSNR proxy on the fit rays
    init_loss: float           # loss at the init codes (first ray draw)
    init_psnr: float           # L1-PSNR at the init codes
    extent: np.ndarray         # metric extent for meshing/framing
    steps: int
    T_obj: np.ndarray          # the (possibly refined) sim(3) object pose


class FitDraws(NamedTuple):
    """One loss evaluation's draws: row indices [n_rays] (int64, each below
    the instance's ray count) and the sampler's uniforms [n_rays, n_u]."""
    idx: torch.Tensor
    u: torch.Tensor


def build_canonical_rays(frame_info: list, sample_dict: dict,
                         cam: CameraInfo, T_obj: np.ndarray,
                         this_id: int) -> dict:
    """Canonical-object-frame ray arrays for one instance's bbox crops —
    the same recipe the scene buffer uses (data/scene.py::
    build_instance_ray_arrays; ref: src/scene_cateogries.py:24-35,235-238):
    rays go through inv(T_obj) @ T_WC, inheriting the 1/s sim(3) factor,
    while depth stays metric."""
    from catnerf_torch.data.scene import build_instance_ray_arrays

    T_obj_inv = np.linalg.inv(np.asarray(T_obj, np.float64))

    def pose_fn(T_wc):
        T_oc = T_obj_inv @ T_wc
        return T_oc[:3, :3], T_oc[:3, 3]

    return build_instance_ray_arrays(frame_info, sample_dict, cam, this_id,
                                     pose_fn)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' rotation from an axis-angle vector (differentiable,
    guarded at w -> 0)."""
    th2 = (w * w).sum()
    th = torch.sqrt(th2 + 1e-12)
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    K = torch.stack([torch.stack([zero, -w[2], w[1]]),
                     torch.stack([w[2], zero, -w[0]]),
                     torch.stack([-w[1], w[0], zero])])
    return (torch.eye(3, dtype=w.dtype, device=w.device)
            + torch.sin(th) / th * K
            + (1.0 - torch.cos(th)) / (th2 + 1e-12) * (K @ K))


def refined_pose(T_obj: np.ndarray, log_s: float, w: np.ndarray,
                 t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(T_obj @ D, D): the pose a fit's sim(3) correction D (scale
    exp(log_s), rotation `_so3_exp(w)` in float32, translation t) refines
    T_obj into, in float64 on the host."""
    D = np.eye(4)
    R = _so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()
    D[:3, :3] = np.exp(float(log_s)) * R
    D[:3, 3] = np.asarray(t)
    return np.asarray(T_obj, np.float64) @ D, D


def observed_extent(arrays: dict, T_eff: np.ndarray,
                    D: np.ndarray | None = None) -> np.ndarray:
    """The observed canonical surface extent of a fit's ray arrays, metric-
    scaled back by s(T_eff); with a pose correction D the points are first
    mapped into the refined canonical frame (x' = inv(D) x). Float64."""
    s = abs(np.linalg.det(T_eff[:3, :3])) ** (1 / 3)
    d = arrays["depth"]
    ok = (arrays["state"] == 1) & (d > 0)
    if not ok.any():
        return np.full(3, 2.0 * s)
    pts_c = arrays["origins"][ok] + arrays["dirs"][ok] * d[ok, None]
    if D is not None:
        sD = abs(np.linalg.det(D[:3, :3])) ** (1 / 3)
        RD = D[:3, :3] / sD
        pts_c = (pts_c - D[:3, 3]) @ RD / sD
    return (pts_c.max(0) - pts_c.min(0)) * s


class InstanceFitter:
    """The fit of one instance: its codes (and sim(3) pose correction) and
    their Adam, its canonical rays on the device, the category's frozen PE
    and CodeNeRF. `step()` takes one optimizer step and returns its loss
    and PSNR at the pre-update codes (device tensors).

    pe, fc: one category's modules (`TrainingSession.category_params`),
    used under requires_grad_(False): the backward reaches only the codes
    and the pose, never the trained weights. arrays: the instance's ray
    arrays (`build_canonical_rays`). Adam is optax.adam: eps outside the
    square root, no eps_root; capturable on the card."""

    def __init__(self, pe, fc, cfg: Config, arrays: dict, shape_code,
                 texture_code, *, n_rays: int, lr: float,
                 optimize_pose: bool, device: torch.device):
        self.device = device = torch.device(device)
        if device.type == "cuda":
            # full float32 products, as the training session's
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.n_rays = n_rays
        self.n_u = sampling.n_uniforms(cfg.n_bins_cam2surface, cfg.n_bins)
        self.pe, self.fc = pe, fc
        for p in list(pe.parameters()) + list(fc.parameters()):
            p.requires_grad_(False)
        self.n = int(arrays["depth"].shape[0])

        def put(x, dtype=torch.float32):
            return torch.from_numpy(np.ascontiguousarray(x)).to(
                device=device, dtype=dtype)

        self.data = {"origins": put(arrays["origins"]),
                     "dirs": put(arrays["dirs"]),
                     "rgb": put(arrays["rgb"]) / 255.0,
                     "state": put(arrays["state"], torch.int64),
                     "depth": put(arrays["depth"])}

        def leaf(x):
            return torch.tensor(np.asarray(x, np.float32),
                                device=device).requires_grad_()

        self.codes = {"shape": leaf(shape_code),
                      "texture": leaf(texture_code)}
        self.optimize_pose = optimize_pose
        self.pose = ({"log_s": leaf(np.zeros(())), "w": leaf(np.zeros(3)),
                      "t": leaf(np.zeros(3))} if optimize_pose else {})
        self.optimizer = torch.optim.Adam(
            self.leaves(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
            capturable=device.type == "cuda")
        self.gen = torch.Generator(device).manual_seed(cfg.seed)
        self.captured: dict = {}  # "generator" | "injected" -> CapturedStep

    def leaves(self) -> list[torch.Tensor]:
        """The optimized tensors: the codes, then the pose correction."""
        return list(self.codes.values()) + list(self.pose.values())

    def draw(self) -> FitDraws:
        """One loss evaluation's draws from the fitter's generator."""
        r = torch.rand(self.n_rays, generator=self.gen, device=self.device)
        idx = torch.clamp((r * self.n).long(), max=self.n - 1)
        u = torch.rand(self.n_rays, self.n_u, generator=self.gen,
                       device=self.device)
        return FitDraws(idx, u)

    def forward(self, draws: FitDraws):
        """(RaySamples, sigma, colour) of one ray batch: the rays (mapped
        through the pose correction), their samples, the frozen field at
        them (ref: the JAX package's fit.py:118-139)."""
        cfg, d, idx = self.cfg, self.data, draws.idx
        o = d["origins"][idx]
        dirs = d["dirs"][idx]
        if self.optimize_pose:
            # effective pose T_obj @ D => rays get inv(D):
            # o' = R^T (o - t) / s, d' = R^T d / s
            pose = self.pose
            Rt = _so3_exp(pose["w"]).T
            inv_s = torch.exp(-pose["log_s"])
            o = (o - pose["t"]) @ Rt.T * inv_s
            dirs = dirs @ Rt.T * inv_s
        rays = sampling.sample_3d_points(
            draws.u, d["rgb"][idx], d["state"][idx], d["depth"][idx], o,
            dirs, n_bins_cam2surface=cfg.n_bins_cam2surface,
            n_bins=cfg.n_bins, min_depth=cfg.min_depth,
            surface_eps=cfg.surface_eps, stop_eps=cfg.stop_eps)
        emb = embedding.apply(self.pe, rays.input_pcs, scale=cfg.obj_scale,
                              max_deg=cfg.n_unidir_funcs)
        sigma, color = codenerf.apply(self.fc, emb, self.codes["shape"],
                                      self.codes["texture"])
        return rays, sigma, color

    def loss(self, draws: FitDraws) -> tuple[torch.Tensor, torch.Tensor]:
        """(total loss, L1-PSNR) of one ray batch against the frozen field
        (ref: the JAX package's fit.py:114-146)."""
        cfg = self.cfg
        rays, sigma, color = self.forward(draws)
        lb = losses.step_batch_loss(
            sigma[None, ..., 0], color[None], rays.gt_depth[None],
            rays.gt_rgb[None], rays.obj_labels[None],
            rays.valid_depth_mask[None], rays.z_vals[None],
            color_scaling=cfg.color_scaling,
            opacity_scaling=cfg.opacity_scaling)
        return lb.total, losses.psnr_from_l1(lb.psnr_color[0])

    def eager_step(self, idx: torch.Tensor | None = None,
                   u: torch.Tensor | None = None):
        """One Adam step, op by op, on the draws (idx, u), or on draws from
        the fitter's generator; its (loss, PSNR). The body `step` captures
        on the card, and the eager loop the capture is held against."""
        draws = self.draw() if idx is None else FitDraws(idx, u)
        self.optimizer.zero_grad(set_to_none=False)
        loss, psnr = self.loss(draws)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), psnr.detach()

    def step(self, draws: FitDraws | None = None):
        """One Adam step on `draws` (by default drawn from the fitter's
        generator); its (loss, PSNR). On the card each kind of step (drawn
        or injected) is a `train/graph.CapturedStep`: three eager warm-up
        steps, one captured, then replays (the returned tensors are the
        graph's static outputs, which the next step overwrites). On the
        CPU it is `eager_step`."""
        if self.device.type != "cuda":
            return self.eager_step(*(draws or (None, None)))
        from catnerf_torch.train.graph import CapturedStep

        kind = "generator" if draws is None else "injected"
        if kind not in self.captured:
            self.captured[kind] = CapturedStep(
                self.eager_step, self.device,
                (self.gen,) if draws is None else ())
        return self.captured[kind](*(() if draws is None else draws))

    def pose_values(self) -> tuple[float, np.ndarray, np.ndarray]:
        """(log_s, w, t) of the pose correction, on the host."""
        p = self.pose
        return (float(p["log_s"].detach()), p["w"].detach().cpu().numpy(),
                p["t"].detach().cpu().numpy())


def prepare_fit(session, cls_id: int, frame_info: list, sample_dict: dict,
                cam: CameraInfo, T_obj: np.ndarray, inst_id: int, *,
                steps: int = 1, n_rays: int = 360, lr: float = 5e-3,
                init: str = "mean", max_rays: int = 200_000,
                optimize_pose: bool = False):
    """(InstanceFitter, ray arrays) of `fit_instance`, before any step:
    the checks (in the JAX package's order), the canonical rays
    (subsampled to `max_rays` on the host, as the JAX package), the init
    codes."""
    from catnerf_torch.edit import mean_codes

    cfg = session.cfg
    cat = session.categories[session.cls_ids.index(cls_id)]
    if cat.n_obj <= 1:
        raise ValueError(
            f"category {cls_id} trained single-instance (world frame); "
            "there is no canonical-frame prior to fit a new instance into")
    params = session.category_params(cls_id)
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    arrays = build_canonical_rays(frame_info, sample_dict, cam, T_obj,
                                  inst_id)
    n = arrays["depth"].shape[0]
    rng = np.random.default_rng(cfg.seed)
    if n > max_rays:
        sel = rng.choice(n, max_rays, replace=False)
        arrays = {k: v[sel] for k, v in arrays.items()}
        n = max_rays
    if n == 0:
        raise ValueError(f"instance {inst_id}: no rays in frame_info crops")

    if init not in ("mean", "zero"):
        raise ValueError(f"init must be mean|zero, got {init!r}")
    sc0, tc0 = mean_codes(session, cls_id, zero=(init == "zero"))
    fitter = InstanceFitter(params["pe"], params["fc"], cfg, arrays, sc0,
                            tc0, n_rays=n_rays, lr=lr,
                            optimize_pose=optimize_pose,
                            device=session.device)
    return fitter, arrays


def fit_instance(session, cls_id: int, frame_info: list, sample_dict: dict,
                 cam: CameraInfo, T_obj: np.ndarray, inst_id: int, *,
                 extent=None, steps: int = 600, n_rays: int = 360,
                 lr: float = 5e-3, init: str = "mean",
                 max_rays: int = 200_000, optimize_pose: bool = False,
                 draws: Sequence[FitDraws] | None = None) -> FitResult:
    """Optimize shape/texture codes for a new instance against the frozen
    category MLP, on the session's device. init: 'mean' (category-mean
    code — the prior) or 'zero'.

    extent: metric OBB extent for the returned framing/meshing hint;
    derived from the observed depths if omitted.

    optimize_pose: jointly optimize a sim(3) correction D (log-scale +
    axis-angle + translation, init identity) applied in the canonical
    frame — the effective pose becomes T_obj @ D, and the returned
    FitResult.T_obj carries it. Makes the fit robust to registration
    error in the initial T_obj.

    draws: steps + 1 FitDraws, injected in place of the generator's: the
    first for the initial loss, then one per step. final_loss/final_psnr
    are the last step's, at its pre-update codes."""
    fitter, arrays = prepare_fit(
        session, cls_id, frame_info, sample_dict, cam, T_obj, inst_id,
        steps=steps, n_rays=n_rays, lr=lr, init=init, max_rays=max_rays,
        optimize_pose=optimize_pose)
    if draws is not None and len(draws) != steps + 1:
        raise ValueError(f"{len(draws)} draws for {steps} steps and the "
                         "initial loss")
    with torch.no_grad():
        init_loss, init_psnr = (float(x) for x in fitter.loss(
            fitter.draw() if draws is None else draws[0]))
    out = None
    for s in range(steps):
        out = fitter.step(None if draws is None else draws[s + 1])
    final_loss, final_psnr = (float(x) for x in out)
    return finish_fit(fitter, arrays, T_obj, extent, steps, init_loss,
                      init_psnr, final_loss, final_psnr)


def finish_fit(fitter: InstanceFitter, arrays: dict, T_obj, extent,
               steps: int, init_loss: float, init_psnr: float,
               final_loss: float, final_psnr: float) -> FitResult:
    """The FitResult of a fitter after its steps: the codes, the refined
    pose and the extent on the host."""
    T_eff, D = np.asarray(T_obj, np.float64).copy(), None
    if fitter.optimize_pose:
        T_eff, D = refined_pose(T_eff, *fitter.pose_values())
    if extent is None:
        extent = observed_extent(arrays, T_eff, D)
    return FitResult(
        shape_code=fitter.codes["shape"].detach().cpu().numpy(),
        texture_code=fitter.codes["texture"].detach().cpu().numpy(),
        final_loss=final_loss, final_psnr=final_psnr,
        init_loss=init_loss, init_psnr=init_psnr,
        extent=np.asarray(extent, np.float64), steps=steps, T_obj=T_eff)


# ---------------------------------------------------------------------------
# Adoption: a fitted instance written into the live session
# ---------------------------------------------------------------------------

def adopt_instance(session, cls_id: int, inst_id: int,
                   result: FitResult) -> None:
    """Write a fitted instance into the live session, so it meshes,
    renders, and serves exactly like a trained one (the new-scan workflow:
    observe -> register -> fit codes -> adopt -> serve, no retraining).

    Grows the padded [n_cls, max_obj, D] code tables — and the matching
    AdamW moments, zeros at the new slot — when the category is full,
    inserts the fitted codes, and registers the instance's sim(3)
    pose/extent metadata. A fast path enabled before is enabled again (its
    captured graph reads the old tables); the ray store is NOT rebuilt, so
    further training keeps sampling only the original instances, and
    mesh-time space carving only knows the original views.

    The adoption is recorded in session.adopted_instances;
    train/checkpoint.py::save_session_checkpoint persists the records as a
    sidecar so adopted instances survive a restart.
    """
    from catnerf_torch.ops.sim3 import sim3_to_tensor_np

    obj_tensor = sim3_to_tensor_np(np.asarray(result.T_obj, np.float64))
    rec = {"cls": int(cls_id), "id": int(inst_id),
           "extent": np.asarray(result.extent, np.float64).tolist(),
           "obj_tensor": np.asarray(obj_tensor, np.float64).tolist()}
    _adopt_slot(session, rec, result.shape_code, result.texture_code)


def apply_adopted_record(session, rec: dict) -> None:
    """Re-apply one persisted adoption record to a freshly built session:
    grows the code tables/optimizer moments and registers the metadata,
    with ZERO codes at the new slot — the real codes live in the
    checkpointed params, which restore_session_checkpoint loads right
    after (the grown template then matches the saved shapes)."""
    D = session.cfg.net_hyperparams.latent_dim
    zero = np.zeros(D, np.float32)
    _adopt_slot(session, rec, zero, zero)


def _grow_codes(state) -> None:
    """The state's code tables one slot wider [C, max_obj + 1, D], zeros at
    the new slot: new parameters, the optimizer's group pointed at them,
    and each AdamW moment moved to the new parameter padded with zeros
    (its step count kept as it is, on its device)."""
    codes, opt = state.params.codes, state.optimizer
    grown = {}
    for name in ("shape", "texture"):
        old = getattr(codes, name)
        new = torch.nn.Parameter(F.pad(old.detach(), (0, 0, 0, 1)))
        setattr(codes, name, new)
        grown[id(old)] = (old, new)
    for group in opt.param_groups:
        group["params"] = [grown[id(p)][1] if id(p) in grown else p
                           for p in group["params"]]
    for old, new in grown.values():
        st = opt.state.pop(old, None)
        if st:
            opt.state[new] = {
                k: (F.pad(v, (0, 0, 0, 1)) if torch.is_tensor(v)
                    and v.shape == old.shape else v)
                for k, v in st.items()}


def _adopt_slot(session, rec: dict, shape_code, texture_code) -> None:
    from catnerf_torch.models.codes import obj_validity_mask

    cls_id, inst_id = rec["cls"], rec["id"]
    cat = session.categories[session.cls_ids.index(cls_id)]
    if cat.n_obj <= 1:
        raise ValueError(f"category {cls_id} is single-instance "
                         "(world-frame field); nothing to adopt into")
    if inst_id in cat.inst_id_to_index:
        raise ValueError(f"instance {inst_id} already exists in "
                         f"category {cls_id}")
    if inst_id <= 0:
        raise ValueError(f"instance id must be > 0 (0 = background), "
                         f"got {inst_id}")

    ci = session.cls_ids.index(cls_id)
    slot = cat.n_obj
    codes = session.state.params.codes
    max_obj = codes.shape.shape[1]
    if slot >= max_obj:
        _grow_codes(session.state)
        max_obj += 1
    with torch.no_grad():
        for table, code in ((codes.shape, shape_code),
                            (codes.texture, texture_code)):
            table[ci, slot] = torch.as_tensor(
                np.asarray(code, np.float32), device=table.device)

    cat.obj_ids.append(inst_id)
    cat.inst_id_to_index[inst_id] = slot
    cat.n_obj += 1
    cat.extent_dict[inst_id] = np.asarray(rec["extent"], np.float64)
    cat.object_tensor_dict[inst_id] = np.asarray(rec["obj_tensor"],
                                                 np.float64)
    session.adopted_instances.append(dict(rec))

    session.obj_mask = obj_validity_mask(
        [c.n_obj for c in session.categories], max_n_obj=max_obj,
        device=session.device)
    sup = session._superstep
    if sup is not None:
        # the captured step reads the old tables and mask: rebuild the
        # fast path now. The ray store keeps only the ORIGINAL instances'
        # rays — further training never samples the adoptee.
        session.enable_fast_path(sup.n_inner, graph=sup.graph)


# ---------------------------------------------------------------------------
# The new-scan workflow from raw observations
# ---------------------------------------------------------------------------

def build_observation_frames(rgb: np.ndarray, depth: np.ndarray,
                             mask: np.ndarray, T_wc: np.ndarray,
                             cam: CameraInfo, inst_id: int, *,
                             bbox_scale: float = 0.2):
    """Private (frames, frame_info) for raw posed RGB-D observations of ONE
    new instance — the serving-side mirror of the dataset loaders' per-frame
    bbox recipe (data/replica.py; ref: src/dataset.py:135-156).

    Arrays use the repo's transposed (W, H) layout:
      rgb   [n, W, H, 3] uint8
      depth [n, W, H] float32, meters (invalid pixels 0)
      mask  [n, W, H] int8/bool — >0 this instance, 0 other/background,
            <0 unknown (excluded from opacity supervision)
      T_wc  [n, 4, 4] camera->world poses

    Frames whose mask is empty or tinier than the loaders' 10-px floor are
    skipped. Returns ({frame_idx: sample}, frame_info) shaped exactly like
    the dataset's sample_dict/inst_dict contract, so the result feeds
    accumulate_pointcloud and fit_instance unchanged."""
    from catnerf_torch.data.bbox import enlarge_bbox, mask_bbox

    rgb = np.asarray(rgb)
    depth = np.asarray(depth, np.float32)
    mask = np.asarray(mask)
    T_wc = np.asarray(T_wc, np.float64)
    n = rgb.shape[0]
    want = (cam.width, cam.height)
    if (rgb.shape != (n, *want, 3) or depth.shape != (n, *want)
            or mask.shape != (n, *want) or T_wc.shape != (n, 4, 4)):
        raise ValueError(
            f"observation shapes must be rgb [n,{want[0]},{want[1]},3], "
            f"depth/mask [n,{want[0]},{want[1]}], T_wc [n,4,4] "
            f"(transposed W,H layout); got rgb {rgb.shape}, depth "
            f"{depth.shape}, mask {mask.shape}, T_wc {T_wc.shape}")
    mask = mask.astype(np.int8) if mask.dtype == bool else mask

    frames: dict[int, dict] = {}
    frame_info: list[dict] = []
    for i in range(n):
        m = mask[i] > 0
        bb = mask_bbox(m)
        if bb is None:
            continue
        rmin, rmax, cmin, cmax = bb
        if rmax - rmin <= 10 or cmax - cmin <= 10:
            continue  # loaders' small-crop floor (ref: src/dataset.py:139-143)
        enlarged = enlarge_bbox([cmin, rmin, cmax, rmax], bbox_scale,
                                w=m.shape[1], h=m.shape[0])
        if enlarged is None:
            continue
        # -2 is never an instance id: those pixels become pixel-state 0
        # ("other"); <0 in the caller's mask stays -1 -> state 2 (unknown)
        obj_mask = np.where(m, inst_id,
                            np.where(mask[i] < 0, -1, -2)).astype(np.int32)
        frames[i] = {"image": rgb[i].astype(np.uint8), "depth": depth[i],
                     "obj_mask": obj_mask, "T": T_wc[i], "frame_id": i}
        frame_info.append({"frame": i,
                           "bbox": np.array([enlarged[1], enlarged[3],
                                             enlarged[0], enlarged[2]])})
    if not frame_info:
        raise ValueError("no usable observation frames (empty or sub-10-px "
                         "instance masks in every frame)")
    return frames, frame_info


def ingest_new_instance(session, cls_id: int, rgb, depth, mask, T_wc, *,
                        inst_id: int | None = None, steps: int = 600,
                        n_rays: int = 360, lr: float = 5e-3,
                        accumulate: str = "direct",
                        adopt: bool = True) -> dict:
    """The full new-scan workflow from raw arrays: posed RGB-D observations
    of an unseen instance -> world point cloud -> sim(3) registration
    against the trained category's canonical union
    (geometry/registration.py::register_new_instance) -> code-only fit with
    joint pose refinement against the frozen category MLP, on the
    session's device -> adoption into the live session (meshes, renders,
    serves like a trained instance).

    Array layout contract: build_observation_frames. accumulate: 'direct'
    (clean depth, ref: src/utils.py:189-210) or 'tsdf' (noisy real-world
    depth, ref: src/utils.py:212-247). Returns a JSON-ready summary dict.
    """
    from catnerf_torch.geometry.pointcloud import (accumulate_pointcloud,
                                                   accumulate_pointcloud_tsdf)
    from catnerf_torch.geometry.registration import register_new_instance
    from catnerf_torch.ops.sim3 import tensor_to_sim3_np

    if cls_id not in session.cls_ids:
        raise ValueError(f"unknown category {cls_id} "
                         f"(have {session.cls_ids})")
    cat = session.categories[session.cls_ids.index(cls_id)]
    if cat.n_obj <= 1:
        raise ValueError(f"category {cls_id} is single-instance (world "
                         "frame); there is no canonical prior to ingest "
                         "into")
    all_ids = {int(o) for c in session.categories for o in c.obj_ids}
    if inst_id is None:
        inst_id = max(all_ids, default=0) + 1  # flat serving namespace
    elif int(inst_id) in all_ids:
        raise ValueError(f"instance id {inst_id} already exists")
    elif int(inst_id) <= 0:
        # 0 is the background sentinel (/mesh?id=0 would shadow it) and
        # negative ids collide with the pixel-state sentinels (-1 unknown,
        # -2 other) in build_observation_frames
        raise ValueError(f"instance id must be > 0, got {inst_id}")
    inst_id = int(inst_id)

    frames, frame_info = build_observation_frames(rgb, depth, mask, T_wc,
                                                  session.cam, inst_id)
    if accumulate not in ("direct", "tsdf"):
        raise ValueError(f"accumulate must be direct|tsdf, got {accumulate!r}")
    acc = (accumulate_pointcloud if accumulate == "direct"
           else accumulate_pointcloud_tsdf)
    pcs_new = acc(inst_id, frame_info, frames, session.cam)
    if len(pcs_new) < 3:
        raise ValueError("observations unproject to fewer than 3 points")

    registered = []
    for oid in cat.obj_ids:
        fi = cat.frame_info_dict.get(oid)
        tensor = cat.object_tensor_dict.get(oid)
        if fi is None or tensor is None:
            continue  # e.g. a previously adopted instance — no frames here
        registered.append((accumulate_pointcloud(oid, fi,
                                                 session.sample_dict,
                                                 session.cam),
                           tensor_to_sim3_np(tensor)))
    if not registered:
        raise ValueError(f"category {cls_id} has no trained instances with "
                         "stored observations to register against")
    T_est, reg_cd = register_new_instance(registered, pcs_new)

    res = fit_instance(session, cls_id, frame_info, frames, session.cam,
                       T_est, inst_id, steps=steps, n_rays=n_rays, lr=lr,
                       optimize_pose=True)
    if adopt:
        adopt_instance(session, cls_id, inst_id, res)
    return {
        "id": inst_id,
        "cls": cls_id,
        "frames_used": len(frame_info),
        "registration_chamfer": round(float(reg_cd), 4),
        "fit_steps": res.steps,
        "psnr_prior_init": round(res.init_psnr, 2),
        "psnr_after_fit": round(res.final_psnr, 2),
        "extent": [round(float(v), 4) for v in res.extent],
        "T_obj": np.asarray(res.T_obj).tolist(),
        "adopted": bool(adopt),
    }


def main(argv=None) -> int:
    import argparse

    from catnerf_torch.utils import resolve_device

    parser = argparse.ArgumentParser(prog="python -m catnerf_torch.fit",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--logdir", required=True)
    parser.add_argument("--config", default=None)
    parser.add_argument("--synthetic", action="store_true")
    parser.add_argument("--cls", type=int, required=True)
    parser.add_argument("--obj", type=int, required=True,
                        help="instance id to fit (its observations come "
                             "from the dataset; its codes are fit fresh)")
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--n-rays", type=int, default=360)
    parser.add_argument("--lr", type=float, default=5e-3)
    parser.add_argument("--init", default="mean", choices=("mean", "zero"))
    parser.add_argument("--optimize-pose", action="store_true",
                        help="jointly refine a sim(3) pose correction "
                             "(robust to registration error in T_obj)")
    parser.add_argument("--views", type=int, default=0,
                        help="orbit renders of the fitted instance")
    parser.add_argument("--mesh", action="store_true")
    parser.add_argument("--out", default=None,
                        help="output dir (default <logdir>/fits)")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from catnerf_torch.loaders import load_scene
    from catnerf_torch.train.checkpoint import (latest_checkpoint,
                                                restore_session_checkpoint)
    from catnerf_torch.train.loop import TrainingSession

    device = resolve_device(args.device)
    cfg, inst_dict, sample_dict, cam = load_scene(
        args.config, synthetic=args.synthetic, device=device)
    session = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                              device=device)
    ckpt = latest_checkpoint(os.path.join(args.logdir, "ckpt"))
    if ckpt is None:
        raise SystemExit(f"no checkpoint under {args.logdir}/ckpt")
    restore_session_checkpoint(ckpt, session)

    if args.cls not in inst_dict or args.obj not in inst_dict[args.cls]:
        raise SystemExit(f"instance {args.obj} of category {args.cls} "
                         "not in the dataset")
    info = inst_dict[args.cls][args.obj]
    T_obj = info.get("T_obj")
    if T_obj is None:
        # unregistered instance: register its observed cloud against the
        # union of the category's registered canonical clouds
        from catnerf_torch.geometry.pointcloud import accumulate_pointcloud
        from catnerf_torch.geometry.registration import register_new_instance

        registered = []
        for oid, oinfo in inst_dict[args.cls].items():
            if oid == args.obj or oinfo.get("T_obj") is None:
                continue
            pcs = oinfo.get("pcs")
            if pcs is None:
                pcs = accumulate_pointcloud(oid, oinfo["frame_info"],
                                            sample_dict, cam)
            registered.append((pcs, oinfo["T_obj"]))
        if not registered:
            raise SystemExit(f"instance {args.obj} has no T_obj and no "
                             "registered sibling instances to align to")
        pcs_new = accumulate_pointcloud(args.obj, info["frame_info"],
                                        sample_dict, cam)
        T_obj, cd = register_new_instance(registered, pcs_new)
        print(f"registered new instance {args.obj} to the category "
              f"canonical frame (chamfer {cd:.4f})")

    res = fit_instance(session, args.cls, info["frame_info"], sample_dict,
                       cam, T_obj, args.obj, steps=args.steps,
                       n_rays=args.n_rays, lr=args.lr, init=args.init,
                       optimize_pose=args.optimize_pose)
    print(f"fit obj {args.obj} (cls {args.cls}): {res.steps} steps, "
          f"psnr {res.init_psnr:.2f} -> {res.final_psnr:.2f} "
          f"(loss {res.init_loss:.3f} -> {res.final_loss:.3f})")

    out = args.out or os.path.join(args.logdir, "fits")
    if args.views > 0:
        from catnerf_torch.render_views import (_save, default_orbit_cam,
                                                orbit_frame, orbit_poses,
                                                render_view)

        params = session.category_params(args.cls)
        s = abs(np.linalg.det(res.T_obj[:3, :3])) ** (1 / 3)
        ext_c = np.asarray(res.extent) / max(s, 1e-9)  # canonical extent
        radius, near, far = orbit_frame(ext_c)
        # mask to the fitted instance's canonical box (1.3x margin, the
        # shared rule): the category field is untrained outside it
        mask = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                (1.3 * ext_c / 2).astype(np.float32))
        for v, T in enumerate(orbit_poses(args.views, radius)):
            img, depth, alpha = render_view(
                params, cfg, T, cam=default_orbit_cam(320, 240),
                near=near, far=far, shape_code=res.shape_code,
                texture_code=res.texture_code, n_bins=96, mask_box=mask)
            _save(out, f"obj{args.obj}_fit_view{v:02d}", img, depth, alpha)
        print(f"wrote {args.views} views to {out}")
    if args.mesh:
        from catnerf_torch.mesher.meshing import adaptive_grid_dim, mesh_field

        dim = adaptive_grid_dim(res.extent, cfg.live_voxel_size,
                                cfg.grid_dim)
        params = session.category_params(args.cls)
        mesh = mesh_field(params, cfg, grid_dim=dim, is_background=False,
                          shape_code=res.shape_code,
                          texture_code=res.texture_code, extent=res.extent)
        if mesh is None:
            print("mesh: no iso-surface")
        else:
            os.makedirs(out, exist_ok=True)
            path = os.path.join(out, f"obj{args.obj}_fit.obj")
            mesh.export(path)
            print(f"mesh: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
