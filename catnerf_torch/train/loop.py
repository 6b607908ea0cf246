"""Training session driver (ref: train.py:15-243; the JAX package's
`train/loop.py`): builds the per-category ray buffers, the stacked train
state, and runs the step — host-staged (`step_once`, `run`: one packed
copy a step, the next host batch assembled on a worker thread while the
device runs the current step) or from the device ray store
(`enable_fast_path` + `run_fast`), on a CUDA session as a replayed CUDA
graph of the step.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

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
from catnerf_torch.train import packing
from catnerf_torch.train import step as step_mod
from catnerf_torch.train.graph import make_superstep
from catnerf_torch.train.state import TrainState, init_train_state
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws, StepMetrics)
from catnerf_torch.utils import phase_timer, resolve_device


class TrainingSession:
    """device: "cuda" unless the caller names another ("cpu" runs the
    plain PyTorch versions of the kernels); with no GPU and no device
    named, it raises. staging: how `step_once` ships its host batch,
    "packed" (one copy of one buffer, train/packing.py, the next batch
    prefetched) or "fields" (one copy a field, assembled when the step
    asks); both give the same tensors, bit for bit."""

    def __init__(self, cfg: Config, inst_dict: dict, sample_dict: dict,
                 cam: CameraInfo | None = None, with_background: bool = True,
                 device: str | torch.device | None = None,
                 staging: str = "packed"):
        if staging not in ("packed", "fields"):
            raise ValueError(f"staging {staging!r}: packed or fields")
        self.staging = staging
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
        # adoption order; checkpoints persist them as a sidecar
        self.adopted_instances: list[dict] = []
        self.iteration = 0
        self._pack_spec = packing.make_spec(
            len(cls_ids), self.n_per_cls, cfg.n_per_optim_bg,
            with_background=self.background is not None)
        self._stager = None
        self._slot = 1
        self._prefetch_pool = None
        self._prefetch_fut = None
        self._store = None
        self._superstep = None
        self._fast_state = None
        # a sharded session (enable_fast_path(device_mesh=...)): this
        # rank's place in the mesh (parallel/sharding.Shard); self.state
        # is then the rank's shard
        self.shard = None
        self._device_mesh = None
        self._reduction = None
        self._full_params = None

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

    def _fill(self, slot: int) -> int:
        """The next host batch packed into the stager's host buffer
        `slot` (on the prefetch worker, or on the calling thread when no
        batch is prefetched)."""
        cat_np, bg_np = self.batcher.next_batch(self.n_per_cls,
                                                self.cfg.n_per_optim_bg)
        return self._stager.fill(slot, cat_np, bg_np)

    def _packed_batch(self):
        """The next batch as views of one staged buffer; the batch after
        it is submitted to the worker first. The epoch cursor's order is
        unchanged: only the assembly overlaps the device's step."""
        if self._stager is None:
            self._stager = packing.Stager(self._pack_spec, self.device)
        if self._prefetch_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._prefetch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="batch-prefetch")
        fut, self._prefetch_fut = self._prefetch_fut, None
        slot = fut.result() if fut is not None else self._fill(1 - self._slot)
        self._slot = slot
        self._prefetch_fut = self._prefetch_pool.submit(self._fill, 1 - slot)
        return self._stager.stage(slot)

    def step_once(self, draws: StepDraws | None = None) -> StepMetrics:
        """One optimizer step on the next host batch (the reference's
        per-iteration shape, ref: train.py:98-201), staged as
        `self.staging` says. `draws` injects the sampling uniforms; by
        default they come from the session's generator, on the calling
        thread."""
        if self.staging == "packed":
            cat, bg = self._packed_batch()
        else:
            cat, bg = self._device_batch()
        draws = draws if draws is not None else self._draws()
        if self.shard is None:
            metrics = step_mod.train_step(self.state, cat, bg, draws,
                                          self.cfg, self.obj_mask)
        else:
            sh = self.shard
            metrics = step_mod.update(
                self.state, sh.cat_batch(cat), sh.bg_batch(bg),
                sh.draws(draws), self.cfg, self.obj_mask[sh.c0:sh.c1],
                reduction=self._reduction)
            self.state.step += 1
        self.iteration += 1
        return metrics

    def settle_prefetch(self) -> None:
        """Wait until the prefetched host batch is assembled, and keep it:
        nothing of the session is then touched by the worker (before a
        checkpoint or a mesh in the middle of a run)."""
        if self._prefetch_fut is not None:
            self._prefetch_fut.result()

    def release_prefetch(self) -> None:
        """Drop the prefetched host batch, as the JAX package's
        `release_prefetch` (ref: train/loop.py:136-144), and stop the
        worker. The epoch cursor has passed it: the next step_once takes
        the batch after it."""
        fut, self._prefetch_fut = self._prefetch_fut, None
        if fut is not None:
            fut.result()
        if self._prefetch_pool is not None:
            self._prefetch_pool.shutdown()
            self._prefetch_pool = None

    def run(self, n_iters: int,
            callback: Callable[[int, StepMetrics], None] | None = None,
            callback_every: int = 100) -> list[dict[str, Any]]:
        """n_iters host-staged steps (ref: train/loop.py:146-166): the
        callback and the history at every iteration that is a multiple of
        callback_every, and at the run's last one; then the prefetched
        batch is released."""
        history = []
        end_iter = self.iteration + n_iters
        for _ in range(n_iters):
            metrics = self.step_once()
            at_mark = (self.iteration % callback_every == 0
                       or self.iteration == end_iter)
            if callback is not None and at_mark:
                callback(self.iteration, metrics)
            if at_mark:
                history.append(self.metrics_to_dict(metrics))
        self.release_prefetch()
        return history

    # ------------------------------------------------------------------
    # Fast path: the device-resident ray store, one window draw per step,
    # the superstep of the JAX API (ref: train/loop.py:174-236).
    def enable_fast_path(self, n_inner: int, graph: bool | None = None,
                         device_mesh=None) -> None:
        """Build the device ray store and the superstep: `n_inner` steps
        per call (`run_fast` accepts any number of steps all the same).
        graph: the step as a CUDA graph, replayed (train/graph.py); None
        means a graph on a CUDA session and the eager loop on a CPU one,
        True on a CPU session raises. graph=False runs the eager loop on
        any device, the reference a graph is held against. The superstep
        runs on the state the session holds now: after replacing
        `self.state` (a checkpoint restore does), call this again; until
        then run_fast raises. Writing into the parameters in place (a
        reference checkpoint import does) keeps the superstep valid.

        device_mesh: a ('data', 'model') DeviceMesh of more than one
        process (parallel/mesh.make_mesh; every rank calls this) shards
        the session DP(rays) x EP(categories) (parallel/sharding.py): the
        state becomes the rank's shard, the store holds the rank's
        categories, and every later step (run_fast and step_once) is the
        sharded step, its metrics the whole step's. None, or a mesh of
        one process, runs unsharded (a sharded state is gathered back)."""
        if graph is None:
            graph = self.device.type == "cuda"
        # the store reads the host ray buffers, which the worker may be
        # reshuffling at an epoch's end
        self.settle_prefetch()
        # remembered so that a rebuild keeps the placement
        self._device_mesh = device_mesh
        shard = None
        if device_mesh is not None and device_mesh.size() > 1:
            from catnerf_torch.parallel import sharding

            shard = sharding.shard_plan(device_mesh, len(self.cls_ids))
            sharding.check_rays(shard, self.n_per_cls,
                                self.cfg.n_per_optim_bg)
        self._reshard(shard)
        state = self.state
        if shard is not None:
            with phase_timer("fast_path", "store_build"):
                self._superstep = sharding.make_sharded_superstep(
                    self.cfg, self.obj_mask, shard, state, self.categories,
                    self.background, self.n_per_cls, self.cfg.n_per_optim_bg,
                    n_inner, graph=graph, window=True)
            self._store, self._fast_state = self._superstep.store, state
            return
        with phase_timer("fast_path", "store_build"):
            store = build_device_store(
                self.categories, self.background, window_pad=self.n_per_cls,
                bg_window_pad=self.cfg.n_per_optim_bg, device=self.device)

        def step_fn(cat, bg, draws):
            if isinstance(draws, torch.Generator):
                draws = self._draws(draws)
            return step_mod.update(state, cat, bg, draws, self.cfg,
                                   self.obj_mask)

        self._superstep = make_superstep(
            step_fn, store, self.n_per_cls, self.cfg.n_per_optim_bg,
            n_inner, graph=graph)
        self._store, self._fast_state = store, state

    def _reshard(self, shard) -> None:
        """Place the state as `shard` says (None: whole on every rank),
        gathering a shard of another placement first."""
        from catnerf_torch.parallel import sharding

        if self.shard == shard:
            return
        if self.shard is not None:
            self.state = sharding.unshard_state(self.state, self.cfg,
                                                self.shard)
        if shard is not None:
            self.state = sharding.shard_state(self.state, self.cfg, shard)
        self.shard = shard
        self._reduction = (sharding.ShardedLoss(shard)
                           if shard is not None else None)

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
        # no worker calls into CUDA while a step may be captured
        self.settle_prefetch()
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
    def full_params(self):
        """Every parameter, whole: the session's own, or on a sharded
        session the category shards gathered over 'model' (a collective:
        every rank calls it), kept until the state changes: a new state,
        a step, or an adoption, which writes the code tables in place (the
        scene render's staging cache keys on it too)."""
        if self.shard is None:
            return self.state.params
        key = (id(self.state), int(self.state.step),
               len(self.adopted_instances))
        if self._full_params is None or self._full_params[0] != key:
            from catnerf_torch.parallel.sharding import gather_params

            self._full_params = (key, gather_params(self.state.params,
                                                    self.shard))
        return self._full_params[1]

    def category_params(self, cls_id: int) -> dict:
        """One category's rows of the stacked parameters (PE, CodeNeRF,
        codes) for meshing and export: modules and tensors without the
        category axis, views of the session's (whole, `full_params`)
        parameters outside their autograd graph."""
        i = self.cls_ids.index(cls_id)
        p = self.full_params()

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
