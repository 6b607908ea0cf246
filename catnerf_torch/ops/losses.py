"""Training losses.

Parity target: the JAX package's `ops/losses.py` (ref: src/loss.py:5-74).
Depth L1 is information-weighted by the detached rendered-depth variance;
color L1 is channel-summed and masked to object rays; opacity L1
supervises the termination sum against the object mask on all
non-unknown rays. Per-category code-norm regularisation applies only to
categories with more than one instance.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from catnerf_torch.ops import render as render_ops
from catnerf_torch.ops.sampling import OTHER_OBJ, UNKNOWN_OBJ


class LossBreakdown(NamedTuple):
    total: torch.Tensor        # scalar
    depth: torch.Tensor        # [n_models]
    color: torch.Tensor        # [n_models]
    opacity: torch.Tensor      # [n_models]
    psnr_color: torch.Tensor   # [n_models] raw color loss (PSNR proxy input)


def step_batch_loss(alpha: torch.Tensor, color: torch.Tensor,
                    gt_depth: torch.Tensor, gt_color: torch.Tensor,
                    sem_labels: torch.Tensor, mask_depth: torch.Tensor,
                    z_vals: torch.Tensor, color_scaling: float = 5.0,
                    opacity_scaling: float = 10.0,
                    global_counts=None) -> LossBreakdown:
    """Batched render losses (ref: src/loss.py:18-74). Shapes: alpha
    [m, r, b] raw logits, color [m, r, b, 3], gt_depth [m, r], gt_color
    [m, r, 3], sem_labels [m, r] pixel states, mask_depth [m, r] bool,
    z_vals [m, r, b].

    global_counts: on a shard of the batch (parallel/sharding.py), a
    function of this shard's mask counts [3, m] (float32: the depth,
    colour and opacity masks) to the whole batch's counts and empty-mask
    flags [3], which then divide each mean (reduce_batch_loss's counts)."""
    # the reference's mask_obj is `sem_labels != 0`: it includes unknown
    # (state 2) pixels — preserved (ref: src/loss.py:33-34)
    mask_obj = sem_labels != OTHER_OBJ
    mask_sem = sem_labels != UNKNOWN_OBJ
    m_depth = mask_depth & mask_obj
    counts = [None] * 3
    if global_counts is not None:
        nums, empty = global_counts(torch.stack(
            [m.sum(-1, dtype=torch.float32)
             for m in (m_depth, mask_obj, mask_sem)]))
        counts = list(zip(nums, empty))

    termination = render_ops.occupancy_to_termination(torch.sigmoid(alpha))
    render_depth = render_ops.render(termination, z_vals)
    diff_sq = (z_vals - render_depth[..., None]) ** 2
    var = render_ops.render(termination, diff_sq).detach()
    render_color = render_ops.render(termination[..., None], color, dim=-2)
    render_opacity = torch.sum(termination, dim=-1)

    loss_depth = render_ops.reduce_batch_loss(
        torch.abs(render_depth - gt_depth) * m_depth, var, m_depth,
        counts[0])
    loss_col_raw = torch.abs(render_color - gt_color).sum(-1)
    loss_col = render_ops.reduce_batch_loss(loss_col_raw * mask_obj, None,
                                            mask_obj, counts[1])
    loss_opacity_raw = torch.abs(render_opacity
                                 - mask_obj.to(render_opacity.dtype))
    loss_opacity = render_ops.reduce_batch_loss(loss_opacity_raw * mask_sem,
                                                None, mask_sem, counts[2])

    l_batch = (loss_depth + loss_col * color_scaling
               + loss_opacity * opacity_scaling)
    return LossBreakdown(total=l_batch.sum(), depth=loss_depth,
                         color=loss_col, opacity=loss_opacity,
                         psnr_color=loss_col)


def code_reg_loss(shape_codes: torch.Tensor, texture_codes: torch.Tensor,
                  obj_mask: torch.Tensor):
    """Per-category code L2-norm regularisation (ref: src/loss.py:5-15);
    categories with <= 1 real instance contribute zero."""
    multi = (obj_mask.sum(dim=-1) > 1).to(shape_codes.dtype)

    def norm_sum(codes):
        norms = torch.linalg.vector_norm(codes, dim=-1)
        return torch.sum(norms * obj_mask, dim=-1) * multi

    return norm_sum(shape_codes), norm_sum(texture_codes)


def psnr_from_l1(loss_col: torch.Tensor) -> torch.Tensor:
    """-10*log10(L1 color loss): the reference computes this from L1, not
    MSE (ref: src/loss.py:94-102)."""
    return -10.0 * torch.log(loss_col) / math.log(10.0)
