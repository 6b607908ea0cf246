"""OccupancyMap — the unconditional background field (ref:
src/model.py:86-155, hidden=128). On the training path the field runs in
the fused kernel (kernels/fused_field.py); this module holds its
parameters, named as the JAX pytree's keys."""

from __future__ import annotations

from torch import nn

from catnerf_torch.models.embedding import EMB_SIZE1, EMB_SIZE2
from catnerf_torch.models.layers import Linear


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
