"""Training session driver (ref: train.py:15-243; the JAX package's
`train/loop.py`): builds the per-category ray buffers, the stacked train
state, and runs the step — host-staged (`step_once`) or from the device
ray store (`enable_fast_path` + `run_fast`), on a CUDA session as a
replayed CUDA graph of the step.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.device_buffer import FastDraws, build_device_store
from catnerf_torch.data.scene import CategoryScene, SceneBatcher
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.codes import obj_validity_mask
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.layers import Linear
from catnerf_torch.train import step as step_mod
from catnerf_torch.train.graph import make_superstep
from catnerf_torch.train.state import TrainState, init_train_state
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws, StepMetrics)
from catnerf_torch.utils import phase_timer, resolve_device


class TrainingSession:
    """device: "cuda" unless the caller names another ("cpu" runs the
    plain PyTorch versions of the kernels); with no GPU and no device
    named, it raises."""

    def __init__(self, cfg: Config, inst_dict: dict, sample_dict: dict,
                 cam: CameraInfo | None = None, with_background: bool = True,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        step_mod.check_supported(cfg)
        if self.device.type == "cuda":
            # the one-hot injection gather and the plain matmuls stay full
            # float32, as the kernels
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.cam = cam if cam is not None else CameraInfo.from_config(cfg)
        # kept for mesh-time space carving (cfg.mesh_space_carving)
        self.sample_dict = sample_dict
        cls_ids = sorted(k for k in inst_dict.keys() if k != 0)
        if len(cls_ids) > cfg.max_n_models:
            raise ValueError(f"{len(cls_ids)} categories exceeds "
                             f"max_n_models={cfg.max_n_models}")
        with phase_timer("session", "buffers"):
            self.categories = [
                CategoryScene(cfg, cid, inst_dict[cid], sample_dict, self.cam)
                for cid in cls_ids]
            self.background = (
                CategoryScene(cfg, 0, inst_dict[0], sample_dict, self.cam)
                if with_background and 0 in inst_dict else None)
        self.cls_ids = cls_ids
        self.batcher = SceneBatcher(self.categories, self.background)
        n_objs = self.batcher.n_objs_per_cls
        self.obj_mask = obj_validity_mask(n_objs, device=self.device)
        self.gen = torch.Generator().manual_seed(cfg.seed)
        with phase_timer("session", "state_init"):
            self.state: TrainState = init_train_state(
                self.gen, cfg, n_objs,
                with_background=self.background is not None,
                device=self.device)
        # the step's random draws come from a generator on the device
        self.draw_gen = torch.Generator(self.device).manual_seed(
            cfg.seed + 1)
        self.n_per_cls = self.batcher.rays_per_category(cfg.n_per_optim)
        # instances written after training by fit.adopt_instance, in
        # adoption order (the JAX package's; the port has no fit yet, and
        # its checkpoints refuse a non-empty list)
        self.adopted_instances: list[dict] = []
        self.iteration = 0
        self._store = None
        self._superstep = None
        self._fast_state = None

    def _device_batch(self):
        cat_np, bg_np = self.batcher.next_batch(self.n_per_cls,
                                                self.cfg.n_per_optim_bg)

        def put(arrays, cls):
            return cls(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, non_blocking=True) for k, v in arrays.items()})

        return (put(cat_np, CategoryBatch),
                put(bg_np, BackgroundBatch) if bg_np is not None else None)

    def _draws(self, gen: torch.Generator | None = None) -> StepDraws:
        return step_mod.draw_uniforms(
            self.cfg, len(self.cls_ids), self.n_per_cls,
            self.cfg.n_per_optim_bg if self.background is not None else None,
            self.draw_gen if gen is None else gen, self.device)

    def step_once(self, draws: StepDraws | None = None) -> StepMetrics:
        """One optimizer step on the next host batch (the reference's
        per-iteration shape, ref: train.py:98-201). `draws` injects the
        sampling uniforms; by default they come from the session's
        generator."""
        cat, bg = self._device_batch()
        draws = draws if draws is not None else self._draws()
        metrics = step_mod.train_step(self.state, cat, bg, draws, self.cfg,
                                      self.obj_mask)
        self.iteration += 1
        return metrics

    # ------------------------------------------------------------------
    # Fast path: the device-resident ray store, one window draw per step,
    # the superstep of the JAX API (ref: train/loop.py:174-236).
    def enable_fast_path(self, n_inner: int,
                         graph: bool | None = None) -> None:
        """Build the device ray store and the superstep: `n_inner` steps
        per call (`run_fast` accepts any number of steps all the same).
        graph: the step as a CUDA graph, replayed (train/graph.py); None
        means a graph on a CUDA session and the eager loop on a CPU one,
        True on a CPU session raises. graph=False runs the eager loop on
        any device, the reference a graph is held against. The superstep
        runs on the state the session holds now: after replacing
        `self.state` (a checkpoint restore does), call this again; until
        then run_fast raises. Writing into the parameters in place (a
        reference checkpoint import does) keeps the superstep valid."""
        if graph is None:
            graph = self.device.type == "cuda"
        with phase_timer("fast_path", "store_build"):
            store = build_device_store(
                self.categories, self.background, window_pad=self.n_per_cls,
                bg_window_pad=self.cfg.n_per_optim_bg, device=self.device)
        state = self.state

        def step_fn(cat, bg, draws):
            if isinstance(draws, torch.Generator):
                draws = self._draws(draws)
            return step_mod.update(state, cat, bg, draws, self.cfg,
                                   self.obj_mask)

        self._superstep = make_superstep(
            step_fn, store, self.n_per_cls, self.cfg.n_per_optim_bg,
            n_inner, graph=graph)
        self._store, self._fast_state = store, state

    def run_fast(self, n_steps: int,
                 draws: Sequence[FastDraws] | None = None) -> StepMetrics:
        """Advance n_steps iterations on batches drawn from the device
        store, as supersteps of `n_inner` steps and one shorter one for
        the rest. Returns the last step's metrics, a copy that no later
        step overwrites. `draws` injects each step's window offsets and
        sampling uniforms (n_steps of them, on the session's device); by
        default they come from the session's generator."""
        if self._superstep is None:
            raise RuntimeError("call enable_fast_path() first")
        if self.state is not self._fast_state:
            raise RuntimeError("the session's state was replaced after "
                               "enable_fast_path(): call it again")
        if draws is not None and len(draws) != n_steps:
            raise ValueError(f"{len(draws)} draws for {n_steps} steps")
        metrics = None
        n_inner = self._superstep.n_inner
        for s in range(0, n_steps, n_inner):
            k = min(n_inner, n_steps - s)
            metrics = self._superstep(
                self.draw_gen if draws is None else draws[s:s + k], k)
            self.iteration += k
            self.state.step += k
        if metrics is None:
            return None
        return StepMetrics(*(m.clone() for m in metrics))

    def metrics_to_dict(self, m: StepMetrics) -> dict[str, Any]:
        d = {"iteration": self.iteration, "total": float(m.total)}
        if self.background is not None:
            d["bg_psnr"] = float(m.bg_psnr)
        for i, cid in enumerate(self.cls_ids):
            d[f"cls_{cid}/depth"] = float(m.cat_depth[i])
            d[f"cls_{cid}/color"] = float(m.cat_color[i])
            d[f"cls_{cid}/opacity"] = float(m.cat_opacity[i])
            d[f"cls_{cid}/psnr"] = float(m.cat_psnr[i])
        if self.background is not None:
            d["background/depth"] = float(m.bg_depth)
            d["background/color"] = float(m.bg_color)
            d["background/opacity"] = float(m.bg_opacity)
        return d

    # ------------------------------------------------------------------
    def category_params(self, cls_id: int) -> dict:
        """One category's rows of the stacked parameters (PE, CodeNeRF,
        codes) for meshing and export: modules and tensors without the
        category axis, views of the session's parameters outside their
        autograd graph."""
        i = self.cls_ids.index(cls_id)
        p = self.state.params

        def row(layer):
            return Linear(layer.w.detach()[i], layer.b.detach()[i])

        return {
            "pe": UniDirsEmbed(p.cat_pe.B.detach()[i]),
            "fc": CodeNeRF({
                name: ([row(m) for m in layer]
                       if isinstance(layer, torch.nn.ModuleList)
                       else row(layer))
                for name, layer in p.cat_fc.named_children()}),
            "shape_codes": p.codes.shape.detach()[i],
            "texture_codes": p.codes.texture.detach()[i],
        }

    def background_params(self) -> dict | None:
        if self.background is None:
            return None
        return {"pe": self.state.params.bg_pe, "fc": self.state.params.bg_fc}
