"""Training session driver (ref: train.py:15-243; the JAX package's
`train/loop.py`): builds the per-category ray buffers, the stacked train
state, and runs the step — host-staged (`step_once`) or from the device
ray store (`enable_fast_path` + `run_fast`).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.scene import CategoryScene, SceneBatcher
from catnerf_torch.models.codes import obj_validity_mask
from catnerf_torch.train import step as step_mod
from catnerf_torch.train.state import TrainState, init_train_state
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws, StepMetrics)
from catnerf_torch.utils import phase_timer, resolve_device


class FastDraws(NamedTuple):
    """One device-store step's random draws: the window offsets, [n_cls]
    (int64, each in [0, its buffer's length)) and the background's scalar
    (None without a background), and the step's sampling uniforms."""

    offs: torch.Tensor
    boff: torch.Tensor | None
    step: StepDraws


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
        self.iteration = 0
        self._store = None

    def _device_batch(self):
        cat_np, bg_np = self.batcher.next_batch(self.n_per_cls,
                                                self.cfg.n_per_optim_bg)

        def put(arrays, cls):
            return cls(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device, non_blocking=True) for k, v in arrays.items()})

        return (put(cat_np, CategoryBatch),
                put(bg_np, BackgroundBatch) if bg_np is not None else None)

    def _draws(self) -> StepDraws:
        return step_mod.draw_uniforms(
            self.cfg, len(self.cls_ids), self.n_per_cls,
            self.cfg.n_per_optim_bg if self.background is not None else None,
            self.draw_gen, self.device)

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
    # Fast path: the device-resident ray store, one window draw per step.
    # The steps run as a plain Python loop; capturing them in a CUDA graph
    # is later work (ROADMAP.md Queue 1).
    def enable_fast_path(self, n_inner: int) -> None:
        """Build the device ray store. `n_inner` is the superstep length
        of the JAX API (the steps one `lax.scan` runs); it is reserved for
        the CUDA-graph capture, and the plain loop of `run_fast` does not
        use it."""
        from catnerf_torch.data.device_buffer import (build_device_store,
                                                      check_window_pad)

        with phase_timer("fast_path", "store_build"):
            self._store = build_device_store(
                self.categories, self.background, window_pad=self.n_per_cls,
                bg_window_pad=self.cfg.n_per_optim_bg, device=self.device)
        check_window_pad(self._store, self.n_per_cls,
                         self.cfg.n_per_optim_bg)

    def run_fast(self, n_steps: int,
                 draws: Sequence[FastDraws] | None = None) -> StepMetrics:
        """Advance n_steps iterations on batches drawn from the device
        store. Returns the last step's metrics. `draws` injects each
        step's window offsets and sampling uniforms (n_steps of them, on
        the session's device); by default they come from the session's
        generator."""
        from catnerf_torch.data.device_buffer import draw_offsets, sample_batch

        if self._store is None:
            raise RuntimeError("call enable_fast_path() first")
        if draws is not None and len(draws) != n_steps:
            raise ValueError(f"{len(draws)} draws for {n_steps} steps")
        metrics = None
        for i in range(n_steps):
            if draws is None:
                offs, boff = draw_offsets(self._store, self.draw_gen)
                step_draws = self._draws()
            else:
                offs, boff, step_draws = draws[i]
            cat, bg = sample_batch(self._store, self.n_per_cls,
                                   self.cfg.n_per_optim_bg, offs, boff)
            metrics = step_mod.train_step(self.state, cat, bg, step_draws,
                                          self.cfg, self.obj_mask)
            self.iteration += 1
        return metrics

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
