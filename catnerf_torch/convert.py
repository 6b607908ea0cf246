"""Convert parameters between the JAX package's pytree and the port.

The JAX params pytree is a dict of numpy-convertible leaves
(`cat_pe`, `cat_fc`, `codes`, and optionally `bg_pe`, `bg_fc`; category
leaves stacked [C, ...]); linear layers are {"w": [in, out], "b": [out]}
in both packages, so conversion copies arrays and transposes nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.codes import LatentCodes
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.layers import Linear
from catnerf_torch.models.occupancy import OccupancyMap
from catnerf_torch.train.state import FieldParams


def _t(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def layers_from_jax(tree: dict, device="cpu") -> dict:
    """A JAX layer pytree (e.g. cat_fc, bg_fc) -> {name: Linear | [Linear]}
    for CodeNeRF(...) / OccupancyMap(...)."""
    def one(p):
        return Linear(_t(p["w"], device), _t(p["b"], device))

    return {k: [one(p) for p in v] if isinstance(v, (list, tuple)) else one(v)
            for k, v in tree.items()}


def params_from_jax(tree: dict, device="cpu") -> FieldParams:
    """JAX params pytree (numpy or jax leaves) -> the port's FieldParams."""
    bg = "bg_fc" in tree
    return FieldParams(
        cat_pe=UniDirsEmbed(_t(tree["cat_pe"]["B"], device)),
        cat_fc=CodeNeRF(layers_from_jax(tree["cat_fc"], device)),
        codes=LatentCodes(_t(tree["codes"]["shape"], device),
                          _t(tree["codes"]["texture"], device)),
        bg_pe=UniDirsEmbed(_t(tree["bg_pe"]["B"], device)) if bg else None,
        bg_fc=(OccupancyMap(layers_from_jax(tree["bg_fc"], device))
               if bg else None),
    )


def _np(p: torch.nn.Parameter, grads: bool) -> np.ndarray:
    x = p.grad if grads else p
    if x is None:  # a parameter the last backward did not reach
        return np.zeros(tuple(p.shape), np.float32)
    return x.detach().cpu().numpy()


def tree_of(module: torch.nn.Module, grads: bool = False):
    """A module's parameters (or, with grads=True, their gradients) as the
    JAX pytree of its layers: {"w", "b"} leaves, lists for ModuleLists."""
    if isinstance(module, Linear):
        return {"w": _np(module.w, grads), "b": _np(module.b, grads)}
    if isinstance(module, torch.nn.ModuleList):
        return [tree_of(m, grads) for m in module]
    return {name: tree_of(m, grads) for name, m in module.named_children()}


def params_to_numpy(params: FieldParams, grads: bool = False) -> dict:
    """The port's FieldParams (or their gradients) -> the JAX pytree
    layout, numpy leaves."""
    out = {
        "cat_pe": {"B": _np(params.cat_pe.B, grads)},
        "cat_fc": tree_of(params.cat_fc, grads),
        "codes": {"shape": _np(params.codes.shape, grads),
                  "texture": _np(params.codes.texture, grads)},
    }
    if params.bg_fc is not None:
        out["bg_pe"] = {"B": _np(params.bg_pe.B, grads)}
        out["bg_fc"] = tree_of(params.bg_fc, grads)
    return out
