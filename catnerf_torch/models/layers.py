"""Linear layers in the JAX package's layout, with torch-compatible
initialisation.

A weight is `w` [*lead, in, out] plus `b` [*lead, out], as in the JAX
package's `models/layers.py`, so that conversion and the kernels need no
transposes. `lead` is () for one model and (C,) for the stacked category
ensemble, whose layers then run as batched matmuls in place of `jax.vmap`.

The reference initialises Linear weights with xavier_normal_ (applied via
model.init_weights, ref: src/model.py:4-6) and leaves biases at the torch
default uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    @classmethod
    def init(cls, gen: torch.Generator, in_f: int, out_f: int,
             lead: tuple[int, ...] = ()) -> "Linear":
        """xavier_normal weight, uniform bias; drawn on the generator's
        device (the CPU) so that a seed gives the same weights anywhere."""
        std = math.sqrt(2.0 / (in_f + out_f))
        w = torch.randn(*lead, in_f, out_f, generator=gen) * std
        bound = 1.0 / math.sqrt(in_f)
        b = (torch.rand(*lead, out_f, generator=gen) * 2.0 - 1.0) * bound
        return cls(w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b.unsqueeze(-2)
