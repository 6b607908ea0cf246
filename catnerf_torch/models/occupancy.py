"""OccupancyMap — the unconditional background field (ref:
src/model.py:86-155, hidden=128). On the fused training path the field
runs in the kernel (kernels/fused_field.py); `apply` is the XLA path's
(the JAX package's models/occupancy.py:43), for any hidden size and
number of hidden blocks. Parameters are named as the JAX pytree's keys."""

from __future__ import annotations

import torch
from torch import nn

from catnerf_torch.models.embedding import EMB_SIZE1, EMB_SIZE2
from catnerf_torch.models.layers import Linear, linear, linear_relu


class OccupancyMap(nn.Module):
    def __init__(self, layers: dict):
        super().__init__()
        for name, layer in layers.items():
            setattr(self, name, nn.ModuleList(layer)
                    if isinstance(layer, list) else layer)

    @classmethod
    def init(cls, gen, *, emb_size1: int = EMB_SIZE1,
             emb_size2: int = EMB_SIZE2, hidden_size: int = 128,
             hidden_layers_block: int = 1) -> "OccupancyMap":
        h = hidden_size
        return cls({
            "in_layer": Linear.init(gen, emb_size1, h),
            "mid1": [Linear.init(gen, h, h)
                     for _ in range(hidden_layers_block)],
            "cat_layer": Linear.init(gen, h + emb_size1, h),
            "mid2": [Linear.init(gen, h, h)
                     for _ in range(hidden_layers_block)],
            "out_alpha": Linear.init(gen, h, 1),
            "color_linear": Linear.init(gen, emb_size2 + h, h),
            "out_color": Linear.init(gen, h, 3),
        })


def apply(fc: OccupancyMap, emb: torch.Tensor, *, emb_size1: int = EMB_SIZE1,
          do_alpha: bool = True, do_color: bool = True, do_cat: bool = True,
          act_dtype=None):
    """Forward pass (ref: occupancy.py:43-76). emb [..., 129]. Returns
    (alpha [..., 1] | None, color [..., 3] | None); alpha carries the x10
    UniSurf logit scale. act_dtype: the storage dtype of every ReLU layer's
    output and of both concats (bf16 with `Config.bf16_activations`); the
    products and the heads run in float32 (ref: occupancy.py:53-73)."""
    x1 = emb[..., :emb_size1]
    x2 = emb[..., emb_size1:]

    h = linear_relu(fc.in_layer, x1, act_dtype)
    for layer in fc.mid1:
        h = linear_relu(layer, h, act_dtype)
    if do_cat:
        h = linear_relu(fc.cat_layer, torch.cat([h, x1.to(h.dtype)], dim=-1),
                        act_dtype)
    for layer in fc.mid2:
        h = linear_relu(layer, h, act_dtype)

    alpha = linear(fc.out_alpha, h) * 10.0 if do_alpha else None
    color = None
    if do_color and hasattr(fc, "out_color"):
        hc = linear_relu(fc.color_linear,
                         torch.cat([h, x2.to(h.dtype)], dim=-1), act_dtype)
        color = torch.sigmoid(linear(fc.out_color, hc))
    return alpha, color
