"""Icosahedral uni-directional positional encoding: the constants and the
trainable basis (ref: src/embedding.py:43-92).

  emb = [x/s (3), sin(pi * 2^0 * Bx) (21), ..., sin(pi * 2^5 * Bx) (21)]

The density trunk consumes the first EMB_SIZE1 = 87 dims (freqs 2^0..2^3)
and the color head the last EMB_SIZE2 = 42 (freqs 2^4..2^5) — ref:
src/trainer.py:20-21. On the fused path the encoding itself is computed
inside the kernels (kernels/fused_field.py); the basis B is trainable, as
in the reference (train.py:55,62).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

# 21 icosahedral unit directions (ref: src/embedding.py:51-73).
ICOSAHEDRON_DIRS = np.array(
    [
        [0.8506508, 0.0, 0.5257311],
        [0.809017, 0.5, 0.309017],
        [0.5257311, 0.8506508, 0.0],
        [1.0, 0.0, 0.0],
        [0.809017, 0.5, -0.309017],
        [0.8506508, 0.0, -0.5257311],
        [0.309017, 0.809017, -0.5],
        [0.0, 0.5257311, -0.8506508],
        [0.5, 0.309017, -0.809017],
        [0.0, 1.0, 0.0],
        [-0.5257311, 0.8506508, 0.0],
        [-0.309017, 0.809017, -0.5],
        [0.0, 0.5257311, 0.8506508],
        [-0.309017, 0.809017, 0.5],
        [0.309017, 0.809017, 0.5],
        [0.5, 0.309017, 0.809017],
        [0.5, -0.309017, 0.809017],
        [0.0, 0.0, 1.0],
        [-0.5, 0.309017, 0.809017],
        [-0.809017, 0.5, 0.309017],
        [-0.809017, 0.5, -0.309017],
    ],
    dtype=np.float32,
)

N_DIRS = 21
DEFAULT_MAX_DEG = 5
EMB_SIZE1 = N_DIRS * (3 + 1) + 3  # 87: raw xyz + freqs 2^0..2^3
EMB_SIZE2 = N_DIRS * (5 + 1) + 3 - EMB_SIZE1  # 42: freqs 2^4..2^5
EMB_SIZE_TOTAL = EMB_SIZE1 + EMB_SIZE2  # 129


class UniDirsEmbed(nn.Module):
    """The trainable basis `B` [*lead, 21, 3], initialised to the unit
    icosahedral directions (`lead` = (C,) for the category ensemble)."""

    def __init__(self, B: torch.Tensor):
        super().__init__()
        self.B = nn.Parameter(B)

    @classmethod
    def init(cls, lead: tuple[int, ...] = ()) -> "UniDirsEmbed":
        B = torch.from_numpy(ICOSAHEDRON_DIRS.copy())
        return cls(B.expand(*lead, N_DIRS, 3).clone())
