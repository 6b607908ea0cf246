"""Differentiable rendering math: occupancy -> termination -> composited
values, plus masked/variance-weighted loss reduction.

Parity target: the JAX package's `ops/render.py` (ref:
src/render_rays.py). Pure functions of tensors over leading batch axes.
"""

from __future__ import annotations

import torch


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


def reduce_batch_loss(loss_mat: torch.Tensor, var: torch.Tensor | None,
                      mask: torch.Tensor) -> torch.Tensor:
    """Masked, optionally 1/sqrt(var)-weighted (L1) mean over the ray axis
    (ref: src/render_rays.py:66-95). loss_mat, mask: [n_models, n_rays];
    returns [n_models].

    Reference quirk preserved: if ANY model has an all-zero mask the whole
    batch returns zero loss (render.py:86-87)."""
    if var is not None:
        loss_mat = loss_mat * (1.0 / (torch.sqrt(var) + 1e-4))
    mask_f = mask.to(loss_mat.dtype)
    mask_num = torch.sum(mask_f, dim=-1)
    per_model = torch.sum(loss_mat * mask_f, dim=-1) / (mask_num + 1e-10)
    any_empty = torch.any(mask_num == 0)
    return torch.where(any_empty, torch.zeros_like(per_model), per_model)
