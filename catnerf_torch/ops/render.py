"""Differentiable rendering math: occupancy -> termination -> composited
values, plus masked/variance-weighted loss reduction.

Parity target: the JAX package's `ops/render.py` (ref:
src/render_rays.py). Pure functions of tensors over leading batch axes.
"""

from __future__ import annotations

import torch


def occupancy_activation(alpha: torch.Tensor) -> torch.Tensor:
    """UniSurf-style occupancy: sigmoid of the raw head output
    (ref: src/render_rays.py:3-7)."""
    return torch.sigmoid(alpha)


def occupancy_to_termination(occupancy: torch.Tensor) -> torch.Tensor:
    """term[i] = occ[i] * prod_{j<i}(1 - occ[j] + 1e-10)
    (ref: src/render_rays.py:25-44).

    The running product is a chain of multiplies, not torch.cumprod: the
    latter's backward divides by its input, and a saturated occupancy
    makes that input 1e-10, which costs the gradient three digits."""
    free = 1.0 - occupancy + 1e-10
    trans = [torch.ones_like(occupancy[..., 0])]
    for i in range(occupancy.shape[-1] - 1):
        trans.append(trans[-1] * free[..., i])
    return occupancy * torch.stack(trans, dim=-1)


def render(termination: torch.Tensor, vals: torch.Tensor,
           dim: int = -1) -> torch.Tensor:
    """Composite per-sample values (ref: src/render_rays.py:46-50)."""
    return torch.sum(termination * vals, dim=dim)


def render_loss(rendered: torch.Tensor, gt: torch.Tensor, loss: str = "L1",
                normalise: bool = False) -> torch.Tensor:
    """Elementwise render loss (ref: src/render_rays.py:52-64)."""
    residual = rendered - gt
    if loss == "L2":
        loss_mat = residual**2
    elif loss == "L1":
        loss_mat = torch.abs(residual)
    else:
        raise NotImplementedError(f"loss type {loss} not implemented")
    return loss_mat / gt if normalise else loss_mat


def reduce_batch_loss(loss_mat: torch.Tensor, var: torch.Tensor | None,
                      mask: torch.Tensor, counts=None) -> torch.Tensor:
    """Masked, optionally 1/sqrt(var)-weighted (L1) mean over the ray axis
    (ref: src/render_rays.py:66-95). loss_mat, mask: [n_models, n_rays];
    returns [n_models].

    Reference quirk preserved: if ANY model has an all-zero mask the whole
    batch returns zero loss (render.py:86-87).

    counts: (mask_num [n_models] float32, any_empty) given by a caller
    whose batch is a shard of the whole: the whole batch's counts per model
    and its empty-mask flag over every model (parallel/sharding.py), in
    place of this shard's."""
    if var is not None:
        loss_mat = loss_mat * (1.0 / (torch.sqrt(var) + 1e-4))
    mask_f = mask.to(loss_mat.dtype)
    if counts is None:
        mask_num = torch.sum(mask_f, dim=-1)
        any_empty = torch.any(mask_num == 0)
    else:
        mask_num, any_empty = counts
        mask_num = mask_num.to(loss_mat.dtype)
    per_model = torch.sum(loss_mat * mask_f, dim=-1) / (mask_num + 1e-10)
    return torch.where(any_empty, torch.zeros_like(per_model), per_model)


def make_3d_grid(occ_range=(-1.0, 1.0), dim: int = 256,
                 transform: torch.Tensor | None = None,
                 scale: torch.Tensor | None = None,
                 device=None) -> torch.Tensor:
    """Regular [dim, dim, dim, 3] grid over `occ_range`^3, optionally
    scaled per axis and rigidly transformed (ref:
    src/render_rays.py:97-121)."""
    t = torch.linspace(occ_range[0], occ_range[1], dim, device=device)
    grid = torch.stack(torch.meshgrid(t, t, t, indexing="ij"), dim=-1)
    if scale is not None:
        grid = grid * scale
    if transform is not None:
        grid = (torch.einsum("ij,xyzj->xyzi", transform[:3, :3], grid)
                + transform[:3, 3])
    return grid
