"""Per-instance latent codes (ref: src/trainer.py:52-60): shape/texture
codes are (n_obj, latent_dim) embeddings initialised
N(0, 1) / sqrt(latent_dim / 2).

The category axis is stacked and padded to `max_n_obj`, so all categories
share one (n_cls, max_n_obj, latent_dim) table; a validity mask handles
ragged instance counts.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class LatentCodes(nn.Module):
    def __init__(self, shape: torch.Tensor, texture: torch.Tensor):
        super().__init__()
        self.shape = nn.Parameter(shape)
        self.texture = nn.Parameter(texture)

    @classmethod
    def init(cls, gen: torch.Generator, n_objs: list[int], latent_dim: int,
             max_n_obj: int | None = None) -> "LatentCodes":
        """Padded slots are initialised like real ones (no ray indexes
        them and the reg loss masks them out)."""
        n_cls = len(n_objs)
        max_n = max_n_obj if max_n_obj is not None else max(n_objs)
        std = 1.0 / math.sqrt(latent_dim / 2.0)
        shape = torch.randn(n_cls, max_n, latent_dim, generator=gen) * std
        texture = torch.randn(n_cls, max_n, latent_dim, generator=gen) * std
        return cls(shape, texture)


def obj_validity_mask(n_objs: list[int], max_n_obj: int | None = None,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """(n_cls, max_n_obj) bool mask of real (non-padding) instance slots."""
    max_n = max_n_obj if max_n_obj is not None else max(n_objs)
    return (torch.arange(max_n, device=device)[None, :]
            < torch.tensor(n_objs, device=device)[:, None])
