"""CodeNeRF — the conditional category-level neural field, as a stacked
ensemble over the category axis.

Parity target: `CodeNeRF` (ref: src/model.py:22-84) and the JAX package's
`models/codenerf.py`. A W-wide MLP over the 87-dim density embedding,
conditioned on per-instance shape/texture latent codes via additive
(Linear+ReLU)-projected injections; at shape block j==1 the xyz embedding
is re-concatenated through `cat_layer`. Every parameter is stacked
[C, ...] over the categories. On the training path the field itself runs
in the fused kernel (kernels/fused_field.py); this module holds the
parameters and the latent projection.
"""

from __future__ import annotations

import torch
from torch import nn

from catnerf_torch.models.embedding import EMB_SIZE1, EMB_SIZE2
from catnerf_torch.models.layers import Linear


class CodeNeRF(nn.Module):
    """Parameters of C CodeNeRFs, named as the JAX pytree's keys."""

    def __init__(self, layers: dict):
        super().__init__()
        for name, layer in layers.items():
            setattr(self, name, nn.ModuleList(layer)
                    if isinstance(layer, list) else layer)

    @classmethod
    def init(cls, gen: torch.Generator, n_cls: int, *,
             emb_size1: int = EMB_SIZE1, emb_size2: int = EMB_SIZE2,
             shape_blocks: int = 2, texture_blocks: int = 1, W: int = 32,
             latent_dim: int = 256) -> "CodeNeRF":
        """The reference layer graph (ref: src/model.py:30-54)."""
        lead = (n_cls,)

        def lin(i, o):
            return Linear.init(gen, i, o, lead)

        return cls({
            "encoding_xyz": lin(emb_size1, W),
            "cat_layer": lin(W + emb_size1, W),
            "cat_latent_layer": lin(latent_dim, W),
            "encoding_shape": lin(W, W),
            "sigma": lin(W, 1),
            "encoding_viewdir": lin(W + emb_size2, W),
            "rgb_0": lin(W, W // 2),
            "rgb_1": lin(W // 2, 3),
            "shape_latent_layers": [lin(latent_dim, W)
                                    for _ in range(shape_blocks)],
            "shape_layers": [lin(W, W) for _ in range(shape_blocks)],
            "texture_latent_layers": [lin(latent_dim, W)
                                      for _ in range(texture_blocks)],
            "texture_layers": [lin(W, W) for _ in range(texture_blocks)],
        })


def project_codes(fc: CodeNeRF, shape_latent: torch.Tensor,
                  texture_latent: torch.Tensor):
    """Latent-code injections for rows of codes (ref: the JAX package's
    codenerf.project_codes :55, do_cat=True).

    All shape-side injections (and the cat-layer one) share the same input,
    so their projections run as ONE batched matmul; likewise for the
    texture side. The injections depend only on the instance code, so the
    step calls this on the [C, n_obj, latent_dim] code tables and gathers
    the W-wide results per ray (project-then-gather).

    Returns (shape_inj [C, n, (shape_blocks+1)*W] laid out
    [shape0, shape1, cat], texture_inj [C, n, texture_blocks*W])."""
    shape_layers = list(fc.shape_latent_layers) + [fc.cat_latent_layer]
    w_s = torch.cat([p.w for p in shape_layers], dim=-1)
    b_s = torch.cat([p.b for p in shape_layers], dim=-1)
    w_t = torch.cat([p.w for p in fc.texture_latent_layers], dim=-1)
    b_t = torch.cat([p.b for p in fc.texture_latent_layers], dim=-1)
    shape_inj = torch.relu(shape_latent @ w_s + b_s.unsqueeze(-2))
    texture_inj = torch.relu(texture_latent @ w_t + b_t.unsqueeze(-2))
    return shape_inj, texture_inj
