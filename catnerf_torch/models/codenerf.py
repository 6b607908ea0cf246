"""CodeNeRF — the conditional category-level neural field, as a stacked
ensemble over the category axis.

Parity target: `CodeNeRF` (ref: src/model.py:22-84) and the JAX package's
`models/codenerf.py`. A W-wide MLP over the 87-dim density embedding,
conditioned on per-instance shape/texture latent codes via additive
(Linear+ReLU)-projected injections; at shape block j==1 the xyz embedding
is re-concatenated through `cat_layer`. Every parameter is stacked
[C, ...] over the categories. On the fused training path the field itself
runs in the kernel (kernels/fused_field.py); `apply_with_injections` and
`apply` are the XLA path's, for any architecture.
"""

from __future__ import annotations

import torch
from torch import nn

from catnerf_torch.models.embedding import EMB_SIZE1, EMB_SIZE2
from catnerf_torch.models.layers import (Linear, affine, linear, linear_relu,
                                         store)


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
                  texture_latent: torch.Tensor, *, do_cat: bool = True,
                  act_dtype=None):
    """Latent-code injections for rows of codes (ref: the JAX package's
    codenerf.project_codes :55).

    All shape-side injections (and the cat-layer one) share the same input,
    so their projections run as ONE batched matmul; likewise for the
    texture side. The injections depend only on the instance code, so the
    step calls this on the [C, n_obj, latent_dim] code tables and gathers
    the W-wide results per ray (project-then-gather). act_dtype: the
    storage dtype of the injections (ref: codenerf.py:78-79); they are
    computed in float32.

    Returns (shape_inj [C, n, (shape_blocks+do_cat)*W] laid out
    [shape0, shape1, .., cat], texture_inj [C, n, texture_blocks*W])."""
    shape_layers = (list(fc.shape_latent_layers)
                    + ([fc.cat_latent_layer] if do_cat else []))
    w_s = torch.cat([p.w for p in shape_layers], dim=-1)
    b_s = torch.cat([p.b for p in shape_layers], dim=-1)
    w_t = torch.cat([p.w for p in fc.texture_latent_layers], dim=-1)
    b_t = torch.cat([p.b for p in fc.texture_latent_layers], dim=-1)
    return (store(torch.relu(affine(shape_latent, w_s, b_s)), act_dtype),
            store(torch.relu(affine(texture_latent, w_t, b_t)), act_dtype))


def _concat(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[y, x] along the features, x broadcast to y's leading dims."""
    return torch.cat([y, x.expand(*y.shape[:-1], x.shape[-1])], dim=-1)


class _InjectBf16(torch.autograd.Function):
    """y + inj for bf16 y [..., S, w] and inj [..., 1, w], broadcast over
    the S samples of a ray. The backward sums inj's gradient over the
    samples in bf16, one sample at a time in order: the reference's
    transpose of a bf16 broadcast accumulates so on XLA (a float32 sum
    rounded once differs from it by ulps in about half the entries)."""

    @staticmethod
    def forward(ctx, y, inj):
        return y + inj

    @staticmethod
    def backward(ctx, g):
        acc = g[..., :1, :]
        for k in range(1, g.shape[-2]):
            acc = acc + g[..., k:k + 1, :]
        return g, acc


def _inject(y: torch.Tensor, inj: torch.Tensor) -> torch.Tensor:
    """y + inj, inj in y's dtype (ref: codenerf.py:124,131,145)."""
    inj = inj.to(y.dtype)
    if y.dtype == torch.bfloat16 and inj.shape != y.shape:
        return _InjectBf16.apply(y, inj)
    return y + inj


def apply_with_injections(fc: CodeNeRF, emb: torch.Tensor,
                          shape_inj: torch.Tensor, texture_inj: torch.Tensor,
                          *, emb_size1: int = EMB_SIZE1, do_cat: bool = True,
                          act_dtype=None, do_color: bool = True):
    """Forward pass given precomputed latent injections (ref:
    codenerf.py:104-149), stacked over the leading category axis.

    emb [C, ..., 129]; shape_inj / texture_inj broadcastable against emb's
    leading dims. Returns (sigma [C, ..., 1], rgb [C, ..., 3]).

    act_dtype: the storage dtype of the hidden activations (bf16 with
    `Config.bf16_activations`): every ReLU layer's output and the 129-wide
    concat before `encoding_viewdir` are stored in it, and the injection
    adds run in it; each product, sigma and the rgb head run in float32
    (ref: codenerf.py:115-146).

    do_color=False returns (sigma, None) without running the colour
    branch (the mesher's occupancy grids; under jit XLA drops that branch
    from the JAX package's grid evaluation by itself)."""
    x1 = emb[..., :emb_size1]
    x2 = emb[..., emb_size1:]
    shape_blocks = len(fc.shape_layers)
    W = fc.shape_layers[0].w.shape[-1]

    y = linear_relu(fc.encoding_xyz, x1, act_dtype)
    for j in range(shape_blocks):
        if do_cat and j == 1:
            y = _inject(y, shape_inj[..., shape_blocks * W:])
            y = linear_relu(fc.cat_layer, _concat(y, x1.to(y.dtype)),
                            act_dtype)
        y = _inject(y, shape_inj[..., j * W:(j + 1) * W])
        y = linear_relu(fc.shape_layers[j], y, act_dtype)

    y = linear(fc.encoding_shape, y)
    sigma = linear(fc.sigma, y) * 10.0  # UniSurf logit scale
    if not do_color:
        return sigma, None

    y = store(y, act_dtype)  # after sigma is taken, as :138-139
    y = linear_relu(fc.encoding_viewdir, _concat(y, x2.to(y.dtype)),
                    act_dtype)
    for j, layer in enumerate(fc.texture_layers):
        y = _inject(y, texture_inj[..., j * W:(j + 1) * W])
        y = linear_relu(layer, y, act_dtype)
    rgb = torch.sigmoid(linear(fc.rgb_1, torch.relu(linear(fc.rgb_0, y))))
    return sigma, rgb


def apply(fc: CodeNeRF, emb: torch.Tensor, shape_latent: torch.Tensor,
          texture_latent: torch.Tensor, *, emb_size1: int = EMB_SIZE1,
          do_cat: bool = True, do_color: bool = True):
    """Forward pass (ref: codenerf.py:152-164, src/model.py:56-84).

    emb [C, ..., 129]; shape/texture_latent [C, ..., latent_dim]
    broadcastable against emb's leading dims. Returns (sigma [C, ..., 1],
    rgb [C, ..., 3] | None with do_color=False)."""
    shape_inj, texture_inj = project_codes(fc, shape_latent, texture_latent,
                                           do_cat=do_cat)
    return apply_with_injections(fc, emb, shape_inj, texture_inj,
                                 emb_size1=emb_size1, do_cat=do_cat,
                                 do_color=do_color)
