"""Sharding rules + the sharded train step and superstep: DP over rays x
EP over categories.

The port's counterpart of the JAX package's `parallel/sharding.py`
(:33-213). Parity target: none in the reference, which is strictly
single-device (SURVEY.md §2.2). The layer keeps the single-device step's
math (train/step.py) while spreading it over a ('data', 'model') mesh of
processes (parallel/mesh.py):

  stacked category params / codes / their AdamW moments, obj_mask
      -> the category axis split over 'model': rank (d, m) holds
         categories [m C/n_model, (m+1) C/n_model) as its own tensors,
         its optimizer built over them
  background params and moments -> replicated
  category ray batch -> categories over 'model', rays over 'data': rank
         (d, m) takes its categories' rays [d R/n_data, (d+1) R/n_data)
  background ray batch -> over 'data'
  metrics -> replicated (every rank holds the whole step's)

JAX places the arrays and GSPMD keeps the math; here every rank draws the
whole step's randomness from identically seeded generators (or is handed
it) and takes its part, so a sharded step consumes exactly the
single-device step's draws, and the collectives are written out
(`ShardedLoss`): the mask counts that divide each mean are the whole
batch's, the empty-mask rule spans every category, the code regulariser
enters on data-rank 0 only, the gradients sum over 'data' (the category
gradients within their model shard; the background's, computed alike on
every model rank, too), and the metrics are summed into the whole step's.
At world size 1 each collective is an identity and the sharded step is
bitwise `step.update`.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist

from catnerf_torch.config import Config
from catnerf_torch.data.device_buffer import (build_device_store, draw_rows,
                                              sample_batch, window_offsets)
from catnerf_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, all_gather,
                                         all_reduce, coords, mesh_shape)
from catnerf_torch.train import step as step_mod
from catnerf_torch.train.graph import make_superstep
from catnerf_torch.train.state import (FieldParams, TrainState, load_state,
                                       make_optimizer, optimizer_param_names,
                                       state_dict)
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws)

#: parameter groups stacked over the categories (the JAX rule's
#: {'cat_pe', 'cat_fc', 'codes'}): split over 'model'
STACKED = ("cat_pe.", "cat_fc.", "codes.")


def is_stacked(name: str) -> bool:
    return name.startswith(STACKED)


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place in the mesh and its part of each axis: the
    categories [c0, c1) of n_cls."""

    mesh: object
    n_data: int
    n_model: int
    d: int
    m: int
    n_cls: int

    @property
    def c0(self) -> int:
        return self.m * (self.n_cls // self.n_model)

    @property
    def c1(self) -> int:
        return self.c0 + self.n_cls // self.n_model

    @property
    def data_group(self):
        return self.mesh.get_group(DATA_AXIS)

    @property
    def model_group(self):
        return self.mesh.get_group(MODEL_AXIS)

    @property
    def world_group(self):
        return dist.group.WORLD

    def rays(self, n: int) -> slice:
        """This rank's run of n rays: [d n/n_data, (d+1) n/n_data)."""
        k = n // self.n_data
        return slice(self.d * k, (self.d + 1) * k)

    def cat_batch(self, batch: CategoryBatch) -> CategoryBatch:
        r = self.rays(batch.depth.shape[1])
        return CategoryBatch(*(x[self.c0:self.c1, r] for x in batch))

    def bg_batch(self, batch: BackgroundBatch | None):
        if batch is None:
            return None
        r = self.rays(batch.depth.shape[0])
        return BackgroundBatch(*(x[r] for x in batch))

    def draws(self, draws: StepDraws) -> StepDraws:
        cat = draws.cat[self.c0:self.c1, self.rays(draws.cat.shape[1])]
        bg = (None if draws.bg is None
              else draws.bg[self.rays(draws.bg.shape[0])])
        return StepDraws(cat, bg)


def shard_plan(mesh, n_cls: int) -> Shard:
    n_data, n_model = mesh_shape(mesh)
    if n_cls % n_model:
        raise ValueError(
            f"{n_cls} categories not divisible over the mesh's "
            f"{n_model}-way 'model' axis; use make_mesh(n_model=d) "
            f"with d | {n_cls}")
    d, m = coords(mesh)
    return Shard(mesh, n_data, n_model, d, m, n_cls)


def check_rays(shard: Shard, n_per_cls: int, n_bg: int | None) -> None:
    if n_per_cls % shard.n_data or (n_bg or 0) % shard.n_data:
        raise ValueError(
            f"ray batch ({n_per_cls}/cat, {n_bg} bg) not divisible over "
            f"the {shard.n_data}-way 'data' axis")


# ---------------------------------------------------------------------------
# State placement
# ---------------------------------------------------------------------------

def _shard_tensor(name: str, x, shard: Shard):
    return (x[shard.c0:shard.c1].clone()
            if is_stacked(name) and torch.is_tensor(x) and x.ndim >= 1
            else x)


def _optimizer_names(params: FieldParams) -> dict[int, str]:
    return dict(enumerate(optimizer_param_names(params)))


def shard_state_dict(raw: dict, params: FieldParams, shard: Shard) -> dict:
    """The rank's part of a whole train state's `state_dict`: each stacked
    parameter and its AdamW moments cut to the rank's categories. `params`
    (either layout) names the optimizer's entries."""
    names = _optimizer_names(params)
    osd = raw["optimizer"]
    return {
        "params": {k: _shard_tensor(k, v, shard)
                   for k, v in raw["params"].items()},
        "optimizer": {**osd, "state": {
            i: {k: (_shard_tensor(names[i], v, shard)
                    if k != "step" else v) for k, v in st.items()}
            for i, st in osd["state"].items()}},
        "step": raw["step"]}


def _local_params(params: FieldParams, shard: Shard) -> FieldParams:
    """A copy of `params` whose stacked tensors hold the rank's
    categories: its own tensors, not views."""
    local = copy.deepcopy(params)
    for name, p in local.named_parameters():
        if is_stacked(name):
            p.data = p.data[shard.c0:shard.c1].clone()
    return local


def shard_state(state: TrainState, cfg: Config, shard: Shard) -> TrainState:
    """The rank's shard of a whole train state: the stacked parameters and
    their moments for its categories, the background replicated, a new
    AdamW over the rank's tensors."""
    local = _local_params(state.params, shard)
    template = TrainState(local, make_optimizer(cfg, local))
    return load_state(shard_state_dict(state_dict(state), state.params,
                                       shard), template)


def _gather(name: str, x, shard: Shard):
    if is_stacked(name) and torch.is_tensor(x) and x.ndim >= 1:
        return all_gather(x, shard.model_group)
    return x


def gather_state_dict(state: TrainState, shard: Shard) -> dict:
    """The whole train state's `state_dict`, the category shards and their
    moments gathered over 'model' (every rank calls this; every rank gets
    it), in the unsharded layout: what an unsharded session saves."""
    raw = state_dict(state)
    names = _optimizer_names(state.params)
    osd = raw["optimizer"]
    return {
        "params": {k: _gather(k, v, shard) for k, v in raw["params"].items()},
        "optimizer": {**osd, "state": {
            i: {k: (_gather(names[i], v, shard) if k != "step" else v)
                for k, v in st.items()}
            for i, st in osd["state"].items()}},
        "step": raw["step"]}


@torch.no_grad()
def gather_params(params: FieldParams, shard: Shard) -> FieldParams:
    """The whole parameters (every category), gathered over 'model' onto
    every rank: what meshing and rendering read (the JAX package meshes
    with replicated parameters)."""
    full = copy.deepcopy(params)
    for name, p in full.named_parameters():
        if is_stacked(name):
            p.data = all_gather(p.data, shard.model_group)
    return full


def unshard_state(state: TrainState, cfg: Config, shard: Shard) -> TrainState:
    """The whole train state on every rank, from the ranks' shards."""
    raw = gather_state_dict(state, shard)
    full = copy.deepcopy(state.params)
    for name, p in full.named_parameters():
        p.data = raw["params"][name].clone()
    return load_state(raw, TrainState(full, make_optimizer(cfg, full)))


# ---------------------------------------------------------------------------
# The sharded loss: the collectives of one step
# ---------------------------------------------------------------------------

class ShardedLoss:
    """`step.loss_fn`'s reduction on rank (d, m) (see loss_fn). Each call
    issues one all-reduce:

    - cat_counts: the [3, C/n_model] mask counts placed in a [3, C] buffer
      summed over every rank, which yields each category's whole-batch
      count and the empty-mask flag over all C;
    - bg_counts: the background's [3, 1] counts summed over 'data';
    - metrics: the category terms (each a shard's numerator over the
      whole count), the code norms (data-rank 0's) and the background
      terms (model-rank 0's) summed over every rank;
    - gradients: every gradient summed over 'data', in one flat buffer per
      dtype. The counts are integers in float32, so their sums are exact."""

    def __init__(self, shard: Shard):
        self.shard = shard
        self.with_reg = shard.d == 0

    def cat_counts(self, local: torch.Tensor):
        s = self.shard
        buf = local.new_zeros(local.shape[0], s.n_cls)
        buf[:, s.c0:s.c1] = local
        all_reduce(buf, s.world_group)
        return buf[:, s.c0:s.c1], (buf == 0).any(-1)

    def bg_counts(self, local: torch.Tensor):
        buf = local.clone()
        all_reduce(buf, self.shard.data_group)
        return buf, (buf == 0).any(-1)

    def metrics(self, cat_terms, reg_terms, bg_terms):
        s = self.shard
        local = torch.stack([t.detach().float()
                             for t in (*cat_terms, *reg_terms)])
        if not self.with_reg:
            local[3:] = 0.0
        full = local.new_zeros(local.shape[0], s.n_cls)
        full[:, s.c0:s.c1] = local
        bg = torch.cat([t.detach().float() for t in bg_terms])
        if s.m != 0:
            bg = torch.zeros_like(bg)
        buf = torch.cat([full.reshape(-1), bg])
        all_reduce(buf, s.world_group)
        full = buf[:full.numel()].reshape(full.shape)
        bg = buf[full.numel():]
        dtypes = [t.dtype for t in (*cat_terms, *reg_terms)]
        rows = [full[i].to(dt) for i, dt in enumerate(dtypes)]
        return (tuple(rows[:3]), tuple(rows[3:]),
                tuple(bg[i:i + 1].to(t.dtype)
                      for i, t in enumerate(bg_terms)))

    def gradients(self, params: FieldParams) -> None:
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        for dtype in sorted({g.dtype for g in grads}, key=str):
            gs = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in gs])
            all_reduce(flat, self.shard.data_group)
            torch._foreach_copy_(gs, [x.view_as(g) for x, g in zip(
                flat.split([g.numel() for g in gs]), gs)])


# ---------------------------------------------------------------------------
# The sharded step and superstep
# ---------------------------------------------------------------------------

def make_sharded_train_step(cfg: Config, obj_mask: torch.Tensor,
                            shard: Shard, state: TrainState):
    """step(cat, bg, draws) -> the whole step's metrics: one optimizer
    step of the rank's shard `state` (in place) on the rank's part of the
    whole batch and draws it is given (every rank the same)."""
    mask = obj_mask[shard.c0:shard.c1]
    reduction = ShardedLoss(shard)

    def step(cat, bg, draws):
        return step_mod.update(state, shard.cat_batch(cat), shard.bg_batch(bg),
                               shard.draws(draws), cfg, mask,
                               reduction=reduction)

    return step


def make_sharded_superstep(cfg: Config, obj_mask: torch.Tensor, shard: Shard,
                           state: TrainState, categories, background,
                           n_per_cls: int, n_bg: int, n_inner: int, *,
                           graph: bool = False, window: bool = False):
    """The sharded superstep (ref: sharding.py:171-213): make_superstep
    over the rank's device ray store (its categories only, and the
    background) running make_sharded_train_step. Each step draws the whole
    step's offsets or rows (window=False: uniform rows, gathered per
    category) and uniforms from the generator, with every category's
    length, as the unsharded superstep draws them, and takes the rank's
    part. Injected FastDraws are the whole step's too. graph: the step,
    its collectives inside, as a CUDA graph (CUDA + NCCL)."""
    with_bg = background is not None and state.params.bg_fc is not None
    n_bg_step = n_bg if with_bg else None
    check_rays(shard, n_per_cls, n_bg_step)
    device = state.params.cat_pe.B.device
    store = build_device_store(
        categories[shard.c0:shard.c1], background if with_bg else None,
        window_pad=n_per_cls, bg_window_pad=n_bg, device=device)
    lengths = torch.tensor([c.buffer.n for c in categories], device=device)
    max_length = max(c.buffer.n for c in categories)
    bg_length = store.bg_length if with_bg else None
    r, rb = shard.rays(n_per_cls), shard.rays(n_bg)
    n_loc, nb_loc = r.stop - r.start, rb.stop - rb.start
    cls = slice(shard.c0, shard.c1)
    if window:
        def draw(gen):
            return window_offsets(lengths, bg_length, gen, max_length)

        def sample(offs, boff):
            return sample_batch(
                store, n_loc, nb_loc, offs[cls] + r.start,
                None if boff is None else boff + rb.start)
    else:
        def draw(gen):
            return draw_rows(lengths, bg_length, n_per_cls, n_bg, gen,
                             max_length)

        def sample(idx, bidx):
            return sample_batch(
                store, n_loc, nb_loc, idx[cls, r],
                None if bidx is None else bidx[rb], window=False,
                per_category_gather=True)

    mask = obj_mask[cls]
    reduction = ShardedLoss(shard)

    def step_fn(cat, bg, draws):
        if isinstance(draws, torch.Generator):
            draws = step_mod.draw_uniforms(cfg, shard.n_cls, n_per_cls,
                                           n_bg_step, draws, device)
        return step_mod.update(state, cat, bg, shard.draws(draws), cfg,
                               mask, reduction=reduction)

    return make_superstep(step_fn, store, n_per_cls, n_bg, n_inner,
                          graph=graph, window=window, draw=draw,
                          sample=sample)
