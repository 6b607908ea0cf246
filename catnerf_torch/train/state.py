"""Training state: stacked category ensemble + background model + AdamW.

Replaces the reference's module zoo + AdamW param groups (ref:
train.py:40-64, src/trainer.py:38-60) and the JAX package's
`train/state.py` (an optax multi_transform). The parameter groups:
  'model' — category MLP + PE ensembles and the background model
            (lr=learning_rate, wd=weight_decay)
  'codes' — per-instance shape/texture latents
            (lr=code_learning_rate, wd=code_weight_decay)
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from catnerf_torch.config import Config
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.codes import LatentCodes
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap


class FieldParams(nn.Module):
    """Every trainable parameter, named as the JAX params pytree:
    cat_pe / cat_fc / codes stacked [C, ...], bg_pe / bg_fc (or None)."""

    def __init__(self, cat_pe: UniDirsEmbed, cat_fc: CodeNeRF,
                 codes: LatentCodes, bg_pe: UniDirsEmbed | None = None,
                 bg_fc: OccupancyMap | None = None):
        super().__init__()
        self.cat_pe = cat_pe
        self.cat_fc = cat_fc
        self.codes = codes
        self.bg_pe = bg_pe
        self.bg_fc = bg_fc

    @classmethod
    def init(cls, gen: torch.Generator, cfg: Config, n_objs: list[int],
             with_background: bool = True) -> "FieldParams":
        nh = cfg.net_hyperparams
        n_cls = len(n_objs)
        return cls(
            cat_pe=UniDirsEmbed.init((n_cls,)),
            cat_fc=CodeNeRF.init(gen, n_cls, shape_blocks=nh.shape_blocks,
                                 texture_blocks=nh.texture_blocks, W=nh.W,
                                 latent_dim=nh.latent_dim),
            codes=LatentCodes.init(gen, [int(n) for n in n_objs],
                                   nh.latent_dim),
            bg_pe=UniDirsEmbed.init() if with_background else None,
            bg_fc=(OccupancyMap.init(gen,
                                     hidden_size=cfg.hidden_feature_size_bg)
                   if with_background else None),
        )


def make_optimizer(cfg: Config, params: FieldParams) -> torch.optim.AdamW:
    """AdamW with the reference's two param groups. betas, eps and both
    weight decays are set explicitly: torch's default weight decay (1e-2)
    is not the config's. Decoupled decay scaled by lr, as optax.adamw.

    On a CUDA device it is built capturable (its step counts and bias
    corrections live on the device), so that a CUDA graph can capture its
    step (train/graph.py); it is built so from the start, so that the
    state of earlier eager steps already lies on the device. torch has no
    capturable AdamW on the CPU."""
    codes = list(params.codes.parameters())
    code_ids = {id(p) for p in codes}
    model = [p for p in params.parameters() if id(p) not in code_ids]
    return torch.optim.AdamW(
        [{"params": model, "lr": cfg.learning_rate,
          "weight_decay": cfg.weight_decay, "name": "model"},
         {"params": codes, "lr": cfg.code_learning_rate,
          "weight_decay": cfg.code_weight_decay, "name": "codes"}],
        betas=(0.9, 0.999), eps=1e-8, capturable=codes[0].is_cuda)


@dataclasses.dataclass
class TrainState:
    params: FieldParams
    optimizer: torch.optim.AdamW
    step: int = 0


def make_train_state(cfg: Config, params: FieldParams,
                     step: int = 0) -> TrainState:
    return TrainState(params=params, optimizer=make_optimizer(cfg, params),
                      step=step)


def init_train_state(gen: torch.Generator, cfg: Config, n_objs: list[int],
                     with_background: bool = True,
                     device: torch.device | str = "cpu") -> TrainState:
    """Draw the parameters on the CPU generator (the same seed gives the
    same weights on any device), then move them to `device`."""
    params = FieldParams.init(gen, cfg, n_objs, with_background).to(device)
    return make_train_state(cfg, params)
