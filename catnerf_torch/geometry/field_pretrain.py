"""Self-contained per-object occupancy-field pretraining: the port of the
JAX package's `geometry/field_pretrain.py`.

The reference *requires* externally pretrained vMAP checkpoints for the
uncertainty-field template scoring and raises NotImplementedError without
them (ref: src/category_registration.py:93-94, README.md:50-51). This module
closes that gap: it trains a small vMAP-style OccupancyMap per object
directly from the object's own rays — all objects at once, as stacked
leading dims of the port's XLA-path modules (in place of the JAX package's
`jax.vmap` over the object axis), on the card unless `device` names
another.

Fields are trained in a cloud-centered world frame (origins shifted by the
instance point-cloud center) so positional-encoding frequencies are
well-conditioned; the returned field dict carries that `center` and
`uncertainty_score` shifts its spherical ray origins accordingly.

A step draws, from one generator on the device: each object's row indices,
uniform in [0, length) (ref: field_pretrain.py:169-173), then the
sampler's uniforms (:148-150). Threefry and Philox never agree, so a test
holds the port against the JAX package by injecting the JAX draws
(`PretrainDraws`) and its initial parameters (`init`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.device_buffer import _pack_rows
from catnerf_torch.models import embedding, occupancy
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap
from catnerf_torch.ops import losses, sampling
from catnerf_torch.utils import resolve_device

HIDDEN = 32          # vMAP per-object field width (SURVEY §2.1 OccupancyMap)
N_BINS_C2S = 1
N_BINS = 9
LR = 1e-3
N_U = sampling.n_uniforms(N_BINS_C2S, N_BINS)


class PretrainDraws(NamedTuple):
    """One step's draws: row indices [n_obj, n_rays] (int64, each below its
    object's ray count) and the sampler's uniforms [n_obj, n_rays, N_U]."""
    idx: torch.Tensor
    u: torch.Tensor


def build_object_ray_arrays(frame_info: list, sample_dict: dict,
                            cam: CameraInfo, this_id: int,
                            center: np.ndarray) -> dict:
    """World-frame (cloud-centered) ray arrays for one instance's bbox crops
    (the shared recipe: data/scene.py::build_instance_ray_arrays)."""
    from catnerf_torch.data.scene import build_instance_ray_arrays

    return build_instance_ray_arrays(
        frame_info, sample_dict, cam, this_id,
        lambda T_wc: (T_wc[:3, :3], T_wc[:3, 3] - center))


def _take(tree, i: int):
    """Object i of a stacked numpy tree."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_take(v, i) for v in tree]
    return np.array(tree[i])


class ObjectFieldTrainer:
    """The pretraining of one batch of objects: the stacked fields, their
    AdamW, the packed rays on the device. `step()` takes one optimizer
    step and returns its loss (a device tensor); `fields()` the trained
    fields. objects, max_rays_per_obj, cfg: as `pretrain_object_fields`.

    init: the initial parameters as the JAX package's stacked pytree
    ({'pe': {'B'}, 'fc': {...}}, numpy leaves, one row per kept object);
    by default they are drawn from a CPU generator seeded with cfg.seed."""

    def __init__(self, objects: list, sample_dict: dict, cam: CameraInfo,
                 cfg: Config, *, n_rays: int,
                 max_rays_per_obj: int = 200_000, device=None,
                 init: dict | None = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full float32 products, as the training session's
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.n_rays = n_rays
        self.full_n = len(objects)
        assert self.full_n > 0

        centers, scales, arrays_l, bboxes = [], [], [], []
        for this_id, frame_info, pcs in objects:
            pts = np.asarray(pcs)
            center = (pts.max(0) + pts.min(0)) / 2.0
            extent = np.maximum(pts.max(0) - pts.min(0), 0.10)
            centers.append(center)
            scales.append(float(np.max(extent) / 2.0 * 1.2))
            bboxes.append(np.stack([pts.min(0), pts.max(0)]))
            arrays_l.append(build_object_ray_arrays(
                frame_info, sample_dict, cam, this_id, center))

        # Cap per-object buffers (uniform random subsample) so one huge
        # object cannot blow up the padded [n_obj, max_len, 11] stack.
        rng = np.random.default_rng(cfg.seed)
        for i, a in enumerate(arrays_l):
            n = a["depth"].shape[0]
            if n > max_rays_per_obj:
                sel = rng.choice(n, max_rays_per_obj, replace=False)
                arrays_l[i] = {k2: v[sel] for k2, v in a.items()}

        # drop zero-ray objects from the training batch: training one would
        # draw indices below 0 and fit the field to zero-padding; callers
        # route None to the geometric coverage fallback
        self.keep = [i for i, a in enumerate(arrays_l)
                     if a["depth"].shape[0] > 0]
        if len(self.keep) < self.full_n:
            dropped = [objects[i][0] for i in range(self.full_n)
                       if i not in self.keep]
            print(f"field pretrain: object(s) {dropped} have no valid "
                  "bbox-crop rays; deferring them to coverage scoring")
        self.centers = [centers[i] for i in self.keep]
        self.scales = [scales[i] for i in self.keep]
        self.bboxes = [bboxes[i] for i in self.keep]
        arrays_l = [arrays_l[i] for i in self.keep]
        self.n_obj = len(self.keep)
        if not self.n_obj:
            return

        max_len = max(a["depth"].shape[0] for a in arrays_l)
        packed = np.zeros((self.n_obj, max_len, 11), np.float32)
        lengths = np.zeros((self.n_obj,), np.int64)
        for i, a in enumerate(arrays_l):
            n = a["depth"].shape[0]
            packed[i, :n] = _pack_rows(a, n, with_obj=False)
            lengths[i] = n
        dev = self.device
        self.packed = torch.from_numpy(packed).to(dev).reshape(-1, 11)
        self.lengths = torch.from_numpy(lengths).to(dev)
        self.row0 = torch.arange(self.n_obj, device=dev) * max_len
        self.scales_d = torch.tensor(self.scales, dtype=torch.float32,
                                     device=dev)

        if init is None:
            gen = torch.Generator().manual_seed(cfg.seed)
            self.pe = UniDirsEmbed.init((self.n_obj,)).to(dev)
            self.fc = OccupancyMap.init(gen, hidden_size=HIDDEN,
                                        lead=(self.n_obj,)).to(dev)
        else:
            self.pe = UniDirsEmbed(torch.tensor(
                np.asarray(init["pe"]["B"], np.float32), device=dev))
            self.fc = OccupancyMap(convert.layers_from_jax(init["fc"], dev))
        params = list(self.pe.parameters()) + list(self.fc.parameters())
        # optax.adamw(LR, weight_decay) on every leaf (field_pretrain.py:130)
        self.optimizer = torch.optim.AdamW(
            params, lr=LR, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay, capturable=dev.type == "cuda")
        self.gen = torch.Generator(dev).manual_seed(cfg.seed)
        self.captured: dict = {}  # "generator" | "injected" -> CapturedStep

    def draw(self) -> PretrainDraws:
        """One step's draws from the trainer's generator."""
        shape = (self.n_obj, self.n_rays)
        r = torch.rand(shape, generator=self.gen, device=self.device)
        idx = torch.minimum((r * self.lengths[:, None]).long(),
                            self.lengths[:, None] - 1)
        u = torch.rand(*shape, N_U, generator=self.gen, device=self.device)
        return PretrainDraws(idx, u)

    def loss(self, draws: PretrainDraws) -> losses.LossBreakdown:
        """The batch loss on `draws` (its `total` is what a step
        minimises), per object."""
        cfg = self.cfg
        rows = self.packed[(draws.idx + self.row0[:, None]).reshape(-1)]
        rows = rows.reshape(self.n_obj, self.n_rays, 11)
        rays = sampling.sample_3d_points(
            draws.u, rows[..., 6:9], rows[..., 10].long(), rows[..., 9],
            rows[..., 0:3], rows[..., 3:6], n_bins_cam2surface=N_BINS_C2S,
            n_bins=N_BINS, min_depth=cfg.min_depth,
            surface_eps=cfg.surface_eps, stop_eps=cfg.stop_eps)
        emb = embedding.apply(self.pe, rays.input_pcs, scale=self.scales_d)
        alpha, color = occupancy.apply(self.fc, emb)
        return losses.step_batch_loss(
            alpha[..., 0], color, rays.gt_depth, rays.gt_rgb,
            rays.obj_labels, rays.valid_depth_mask, rays.z_vals,
            color_scaling=cfg.color_scaling,
            opacity_scaling=cfg.opacity_scaling)

    def eager_step(self, idx: torch.Tensor | None = None,
                   u: torch.Tensor | None = None) -> torch.Tensor:
        """One AdamW step, op by op, on the draws (idx, u), or on draws
        from the trainer's generator; its loss. The body `step` captures
        on the card, and the eager loop the capture is held against."""
        draws = self.draw() if idx is None else PretrainDraws(idx, u)
        self.optimizer.zero_grad(set_to_none=False)
        loss = self.loss(draws).total
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def step(self, draws: PretrainDraws | None = None) -> torch.Tensor:
        """One AdamW step on `draws` (by default drawn from the trainer's
        generator); its loss. On the card each kind of step (drawn or
        injected) is a `train/graph.CapturedStep`: three eager warm-up
        steps, one captured, then replays, so that the host issues a step
        in one call (the returned loss is the graph's static output, which
        the next step overwrites). On the CPU it is `eager_step`."""
        if self.device.type != "cuda":
            return self.eager_step(*(draws or (None, None)))
        from catnerf_torch.train.graph import CapturedStep

        kind = "generator" if draws is None else "injected"
        if kind not in self.captured:
            self.captured[kind] = CapturedStep(
                self.eager_step, self.device,
                (self.gen,) if draws is None else ())
        return self.captured[kind](*(() if draws is None else draws))

    def fields(self) -> list:
        """One entry per object given: a field dict {'pe', 'fc',
        'obj_scale', 'center', 'bbox'} of numpy leaves (the contract of
        `checkpoint.load_vmap_pth` plus 'center'), None for a dropped one."""
        out: list = [None] * self.full_n
        if not self.n_obj:
            return out
        B = self.pe.B.detach().cpu().numpy()
        fc = convert.tree_of(self.fc)
        for i, orig in enumerate(self.keep):
            out[orig] = {"pe": {"B": np.array(B[i])}, "fc": _take(fc, i),
                         "obj_scale": self.scales[i],
                         "center": self.centers[i], "bbox": self.bboxes[i]}
        return out


def pretrain_object_fields(objects: list, sample_dict: dict, cam: CameraInfo,
                           cfg: Config, *, steps: int = 1000,
                           n_rays: int = 600, n_inner: int = 100,
                           max_rays_per_obj: int = 200_000, device=None,
                           draws=None, init: dict | None = None
                           ) -> list[dict]:
    """Train one occupancy field per object, all objects batched.

    objects: list of (this_id, frame_info, pcs) — instance mask id, frame
    list, accumulated world-frame point cloud. Returns one entry per
    object: a field dict {'pe', 'fc', 'obj_scale', 'center', 'bbox'} (the
    same contract as `checkpoint.load_vmap_pth` plus 'center'), or None for
    an object whose bbox crops yield zero ray rows (every frame crop
    degenerate); callers route None to the geometric coverage fallback.

    Trains ceil(steps / n_inner) * n_inner steps, as the JAX package's
    supersteps of n_inner (never fewer than asked). draws: one
    PretrainDraws per step, injected in place of the generator's; init:
    see `ObjectFieldTrainer`.
    """
    trainer = ObjectFieldTrainer(objects, sample_dict, cam, cfg,
                                 n_rays=n_rays,
                                 max_rays_per_obj=max_rays_per_obj,
                                 device=device, init=init)
    if not trainer.n_obj:
        return trainer.fields()
    n_steps = max(1, -(-steps // n_inner)) * n_inner
    if draws is not None and len(draws) != n_steps:
        raise ValueError(f"{len(draws)} draws for {n_steps} steps")
    loss = None
    for s in range(n_steps):
        loss = trainer.step(None if draws is None else draws[s])
    print(f"pretrained {trainer.n_obj} object fields: {n_steps} steps, "
          f"final loss {float(loss):.3f}")
    return trainer.fields()
