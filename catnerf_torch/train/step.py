"""The training step: 3D point sampling, latent injections, the category
ensemble and the background field (the fused kernels, or the XLA-path
modules), loss assembly, code regularisation, and the AdamW update.

Parity target: the JAX package's `train/step.py` (ref: train.py:98-201):
`category_forward` :96-161, `background_forward` :164-187, `loss_fn` and
`train_step` :200-252. Which field path a config takes is the JAX
package's own rule (`fused_eligible`, :68-74 and :174). The stacked
parameters are the single source of truth, as there.

Randomness: the step draws its sampling uniforms from a torch generator.
`StepDraws` lets a caller inject them instead (the tests inject the JAX
package's draws, which follow its key schedule: fold_in(key, step), a
split into category and background keys, a split per category).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from catnerf_torch import tracing
from catnerf_torch.config import Config
from catnerf_torch.kernels import fused_field
from catnerf_torch.models import codenerf, embedding, occupancy
from catnerf_torch.models.layers import store, upcast
from catnerf_torch.ops import losses, sampling
from catnerf_torch.train.state import FieldParams, TrainState


class CategoryBatch(NamedTuple):
    """Per-step ray batch for all object categories ([c]=n_cls,
    [r]=rays/category): rgbs [c, r, 3] in [0, 1]; states [c, r] int pixel
    states; depth [c, r]; origins/dirs [c, r, 3] canonical-object-frame
    rays; obj_indices [c, r] code-slot indices."""

    rgbs: torch.Tensor
    states: torch.Tensor
    depth: torch.Tensor
    origins: torch.Tensor
    dirs: torch.Tensor
    obj_indices: torch.Tensor


class BackgroundBatch(NamedTuple):
    """Per-step background ray batch (world-frame rays), shapes [r, ...]."""

    rgbs: torch.Tensor
    states: torch.Tensor
    depth: torch.Tensor
    origins: torch.Tensor
    dirs: torch.Tensor


class StepMetrics(NamedTuple):
    total: torch.Tensor
    cat_depth: torch.Tensor    # [n_cls]
    cat_color: torch.Tensor    # [n_cls]
    cat_opacity: torch.Tensor  # [n_cls]
    cat_psnr: torch.Tensor     # [n_cls]
    reg_shape: torch.Tensor    # [n_cls]
    reg_texture: torch.Tensor  # [n_cls]
    bg_depth: torch.Tensor
    bg_color: torch.Tensor
    bg_opacity: torch.Tensor
    bg_psnr: torch.Tensor


class StepDraws(NamedTuple):
    """The step's sampling uniforms: cat [c, r, n_u], bg [r_bg, n_u_bg]
    (n_u from sampling.n_uniforms), bg None without a background."""

    cat: torch.Tensor
    bg: torch.Tensor | None


def fused_eligible(cfg: Config) -> bool:
    """The fused kernels are specialised for the reference's shipped
    architecture (ref: step.py:68-74 `_fused_eligible`); every other
    config runs the XLA-path modules."""
    nh = cfg.net_hyperparams
    return (cfg.use_fused_kernels and nh.shape_blocks == 2
            and nh.texture_blocks == 1 and nh.W == 32
            and cfg.n_unidir_funcs == 5)


def act_dtype(cfg: Config):
    """The XLA path's activation storage dtype (ref: step.py:118, :183)."""
    return torch.bfloat16 if cfg.bf16_activations else None


def check_supported(cfg: Config) -> None:
    """Raise for the configs the port does not run yet. A rule on the
    static config: a supported config never falls back at run time."""
    if fused_eligible(cfg) and cfg.bf16_activations:
        raise NotImplementedError(
            "bf16_activations=True with the fused kernels is not ported: "
            "the JAX package's fused backward declares float32 injection "
            "gradients for bf16 injections (experimental/fused_field.py:359), "
            "so the reference does not run that combination either (set "
            "cfg.bf16_activations = False, or cfg.use_fused_kernels = False "
            "for the XLA path in bf16)")


def draw_uniforms(cfg: Config, n_cls: int, n_rays: int, n_bg: int | None,
                  gen: torch.Generator, device) -> StepDraws:
    n_u = sampling.n_uniforms(cfg.n_bins_cam2surface, cfg.n_bins)
    cat = torch.rand(n_cls, n_rays, n_u, generator=gen, device=device)
    bg = None
    if n_bg is not None:
        n_u_bg = sampling.n_uniforms(cfg.n_bins_cam2surface_bg, cfg.n_bins)
        bg = torch.rand(n_bg, n_u_bg, generator=gen, device=device)
    return StepDraws(cat, bg)


def gather_injections(inj_s_inst: torch.Tensor, inj_t_inst: torch.Tensor,
                      obj_indices: torch.Tensor):
    """Per-ray injection lookup [c, max_obj, w] -> [c, r, w] as a one-hot
    batched matmul (ref: step.py:77-93): exactly one 1.0 per row, so the
    values equal a gather's (in full f32: TF32 must be off), and the
    backward is a deterministic contraction instead of a scatter-add. The
    one-hot is a comparison, which needs no range check on the host (and
    so no device sync).

    bf16 injections are upcast and contracted with a float32 one-hot, and
    the result is stored as bf16: the same values, and a backward that sums
    in float32 and rounds once, as the reference's bf16 dot accumulates."""
    slots = torch.arange(inj_s_inst.shape[1], device=obj_indices.device)
    onehot = (obj_indices.long()[..., None] == slots).float()
    return tuple(store(onehot @ upcast(inj), inj.dtype)
                 for inj in (inj_s_inst, inj_t_inst))


def category_forward(params: FieldParams, batch: CategoryBatch,
                     u: torch.Tensor, cfg: Config):
    """Sample 3D points and run the category ensemble: the fused kernel
    for the shipped architecture, else the XLA-path modules.
    Returns (alpha [c, r, b], color [c, r, b, 3], ray_samples)."""
    rays = sampling.sample_3d_points(
        u, batch.rgbs, batch.states, batch.depth, batch.origins, batch.dirs,
        n_bins_cam2surface=cfg.n_bins_cam2surface, n_bins=cfg.n_bins,
        min_depth=cfg.min_depth, surface_eps=cfg.surface_eps,
        stop_eps=cfg.stop_eps)
    # project-then-gather (ref: train.py:136-137 gathers the codes per ray)
    # bf16 storage (ref: step.py:114-118) on the XLA path only: the fused
    # kernels take float32 (check_supported)
    dt = act_dtype(cfg)
    inj_s_inst, inj_t_inst = codenerf.project_codes(
        params.cat_fc, params.codes.shape, params.codes.texture,
        act_dtype=dt)
    inj_s, inj_t = gather_injections(inj_s_inst, inj_t_inst,
                                     batch.obj_indices)
    if not fused_eligible(cfg):
        emb = embedding.apply(params.cat_pe, rays.input_pcs,
                              scale=cfg.obj_scale,
                              max_deg=cfg.n_unidir_funcs, act_dtype=dt)
        alpha, color = codenerf.apply_with_injections(
            params.cat_fc, emb, inj_s[:, :, None, :], inj_t[:, :, None, :],
            act_dtype=dt)
        return alpha[..., 0], color, rays
    C, R, Bt, _ = rays.input_pcs.shape
    N = R * Bt
    W = cfg.net_hyperparams.W
    # injection layout (project_codes): [shape0, shape1, cat | tex0]
    zs0, zs1, zc = inj_s[..., :W], inj_s[..., W:2 * W], inj_s[..., 2 * W:]
    zt0 = inj_t[..., :W]

    def per_point(z):
        return z[:, :, None, :].expand(C, R, Bt, W).reshape(C, N, W)

    sigma, rgb = fused_field.codenerf_fused_apply(
        params.cat_fc, params.cat_pe, rays.input_pcs.reshape(C, N, 3),
        per_point(zs0), per_point(zc), per_point(zs1), per_point(zt0),
        scale=cfg.obj_scale)
    return sigma.reshape(C, R, Bt), rgb.reshape(C, R, Bt, 3), rays


def background_forward(params: FieldParams, batch: BackgroundBatch,
                       u: torch.Tensor, cfg: Config):
    """Background sampling + OccupancyMap (ref: train.py:172-178): the
    fused kernel for the shipped architecture with one hidden block, else
    the XLA-path module."""
    rays = sampling.sample_3d_points(
        u, batch.rgbs, batch.states, batch.depth, batch.origins, batch.dirs,
        n_bins_cam2surface=cfg.n_bins_cam2surface_bg, n_bins=cfg.n_bins,
        min_depth=cfg.min_depth, surface_eps=cfg.surface_eps,
        stop_eps=cfg.stop_eps)
    fc = params.bg_fc
    if not (fused_eligible(cfg) and len(fc.mid1) == 1
            and len(fc.mid2) == 1):
        dt = act_dtype(cfg)
        emb = embedding.apply(params.bg_pe, rays.input_pcs,
                              scale=cfg.bg_scale, max_deg=cfg.n_unidir_funcs,
                              act_dtype=dt)
        alpha, color = occupancy.apply(fc, emb, act_dtype=dt)
        return alpha[..., 0], color, rays
    R, Bt, _ = rays.input_pcs.shape
    alpha, color = fused_field.occupancy_fused_apply(
        fc, params.bg_pe, rays.input_pcs.reshape(R * Bt, 3),
        scale=cfg.bg_scale)
    return alpha.reshape(R, Bt), color.reshape(R, Bt, 3), rays


def loss_fn(params: FieldParams, cat_batch: CategoryBatch,
            bg_batch: BackgroundBatch | None, draws: StepDraws, cfg: Config,
            obj_mask: torch.Tensor, reg_scaling: float = 5e-4,
            reduction=None):
    """Total loss and metrics (ref: step.py:200-240); reg_scaling is the
    reference constant (ref: train.py:165).

    reduction: on one rank of a sharded step (parallel/sharding.py
    `ShardedLoss`), the seam to the other ranks: the whole batch's mask
    counts for each mean (`cat_counts`, `bg_counts`), whether the code
    regulariser enters this rank's objective (`with_reg`: on data-rank 0
    only, so that the gradient sum over 'data' counts it once), and the
    metrics of the whole batch (`metrics`). The total returned is then
    this rank's share of the objective; the metrics are the whole
    step's."""
    alpha, color, rays = category_forward(params, cat_batch, draws.cat, cfg)
    cat_loss = losses.step_batch_loss(
        alpha, color, rays.gt_depth, rays.gt_rgb, rays.obj_labels,
        rays.valid_depth_mask, rays.z_vals,
        color_scaling=cfg.color_scaling, opacity_scaling=cfg.opacity_scaling,
        global_counts=None if reduction is None else reduction.cat_counts)
    reg_s, reg_t = losses.code_reg_loss(params.codes.shape,
                                        params.codes.texture, obj_mask)
    if reduction is None or reduction.with_reg:
        total = cat_loss.total + reg_scaling * (reg_s + reg_t).sum()
    else:
        total = cat_loss.total
    if bg_batch is not None and params.bg_fc is not None:
        bg_alpha, bg_color, bg_rays = background_forward(params, bg_batch,
                                                         draws.bg, cfg)
        bg_loss = losses.step_batch_loss(
            bg_alpha[None], bg_color[None], bg_rays.gt_depth[None],
            bg_rays.gt_rgb[None], bg_rays.obj_labels[None],
            bg_rays.valid_depth_mask[None], bg_rays.z_vals[None],
            color_scaling=cfg.color_scaling,
            opacity_scaling=cfg.opacity_scaling,
            global_counts=None if reduction is None else reduction.bg_counts)
        total = total + bg_loss.total
    else:
        z = torch.zeros(1, device=total.device)
        bg_loss = losses.LossBreakdown(z[0], z, z, z, z)
    cat_terms = (cat_loss.depth, cat_loss.color, cat_loss.opacity)
    bg_terms = (bg_loss.depth, bg_loss.color, bg_loss.opacity)
    metric_total = total
    if reduction is not None:
        cat_terms, (reg_s, reg_t), bg_terms = reduction.metrics(
            cat_terms, (reg_s, reg_t), bg_terms)

        def l_batch(terms):
            depth, col, opacity = terms
            return (depth + col * cfg.color_scaling
                    + opacity * cfg.opacity_scaling).sum()

        # the unsharded total's expression, on the whole step's terms
        metric_total = (l_batch(cat_terms)
                        + reg_scaling * (reg_s + reg_t).sum())
        if bg_batch is not None and params.bg_fc is not None:
            metric_total = metric_total + l_batch(bg_terms)
    metrics = StepMetrics(
        total=metric_total,
        cat_depth=cat_terms[0], cat_color=cat_terms[1],
        cat_opacity=cat_terms[2],
        cat_psnr=losses.psnr_from_l1(cat_terms[1]),
        reg_shape=reg_s, reg_texture=reg_t,
        bg_depth=bg_terms[0][0], bg_color=bg_terms[1][0],
        bg_opacity=bg_terms[2][0],
        bg_psnr=losses.psnr_from_l1(bg_terms[1][0]),
    )
    return total, metrics


def update(state: TrainState, cat_batch: CategoryBatch,
           bg_batch: BackgroundBatch | None, draws: StepDraws, cfg: Config,
           obj_mask: torch.Tensor, reduction=None) -> StepMetrics:
    """`train_step`'s work on the device, without the host's step count:
    the body that a CUDA graph captures (train/graph.py). With a
    `reduction` (a sharded step's, see loss_fn) the gradients are summed
    over the ranks that share each parameter before AdamW. Recorded as the
    spans step.forward, step.backward and step.optimizer (tracing.py)."""
    # drops the gradients and queues no device work, so it lies outside
    # the phases (the graph's phase map counts none of its nodes)
    state.optimizer.zero_grad(set_to_none=True)
    with tracing.span("step.forward"):
        total, metrics = loss_fn(state.params, cat_batch, bg_batch, draws,
                                 cfg, obj_mask, reduction=reduction)
    with tracing.span("step.backward"):
        total.backward()
        if reduction is not None:
            reduction.gradients(state.params)
    with tracing.span("step.optimizer"):
        state.optimizer.step()
    return StepMetrics(*(m.detach() for m in metrics))


def train_step(state: TrainState, cat_batch: CategoryBatch,
               bg_batch: BackgroundBatch | None, draws: StepDraws,
               cfg: Config, obj_mask: torch.Tensor) -> StepMetrics:
    """One optimizer step in place on `state` (ref: step.py:242-252).
    Returns the step's metrics, detached."""
    metrics = update(state, cat_batch, bg_batch, draws, cfg, obj_mask)
    state.step += 1
    return metrics
