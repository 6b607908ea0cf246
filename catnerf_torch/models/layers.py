"""Linear layers in the JAX package's layout, with torch-compatible
initialisation.

A weight is `w` [*lead, in, out] plus `b` [*lead, out], as in the JAX
package's `models/layers.py`, so that conversion and the kernels need no
transposes. `lead` is () for one model and (C,) for the stacked category
ensemble, whose layers then run as batched matmuls in place of `jax.vmap`
(`linear`, `linear_relu`: the XLA-path field modules).

bf16 activation storage (`Config.bf16_activations`, the JAX package's
`act_dtype`): a layer's output may be stored as bf16 (`linear_relu(...,
act_dtype=torch.bfloat16)`), and the next product upcasts it to float32
first (`affine`), as the JAX package's bf16 x f32 promotion does. No
product runs in bf16.

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
        return linear(self, x)


def lead_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [*lead, *mid, k] @ w [*lead, k, n] -> [*lead, *mid, n]: one matrix
    per stacked model, applied to all of its rows (in place of jax.vmap)."""
    n_lead = w.dim() - 2
    if n_lead == 0:
        return x @ w
    rows = x.reshape(*x.shape[:n_lead], -1, x.shape[-1]) @ w
    return rows.reshape(*x.shape[:-1], w.shape[-1])


def upcast(x: torch.Tensor) -> torch.Tensor:
    """A stored bf16 activation as the float32 operand of a product (its
    backward rounds the gradient to bf16, as the transpose of the JAX
    package's `astype(bf16)` does); a float32 tensor as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def store(x: torch.Tensor, act_dtype) -> torch.Tensor:
    """x in the storage dtype `act_dtype` (None: as it is)."""
    return x if act_dtype is None else x.to(act_dtype)


def affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x @ w + b for x [*lead, *mid, in], w [*lead, in, out], b [*lead, out];
    a bf16 x is upcast first, so that the product runs in float32."""
    x = upcast(x)
    for _ in range(x.dim() - b.dim()):
        b = b.unsqueeze(-2)
    return lead_matmul(x, w) + b


def linear(layer: Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ w + b (ref: the JAX package's models/layers.py:33), with x's
    leading dims starting with the layer's stacked ones."""
    return affine(x, layer.w, layer.b)


def linear_relu(layer: Linear, x: torch.Tensor,
                act_dtype=None) -> torch.Tensor:
    """relu(x @ w + b), computed in float32 and stored in `act_dtype`."""
    return store(torch.relu(linear(layer, x)), act_dtype)
