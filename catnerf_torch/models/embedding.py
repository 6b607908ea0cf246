"""Icosahedral uni-directional positional encoding: the constants and the
trainable basis (ref: src/embedding.py:43-92).

  emb = [x/s (3), sin(pi * 2^0 * Bx) (21), ..., sin(pi * 2^5 * Bx) (21)]

The density trunk consumes the first EMB_SIZE1 = 87 dims (freqs 2^0..2^3)
and the color head the last EMB_SIZE2 = 42 (freqs 2^4..2^5) — ref:
src/trainer.py:20-21. On the fused path the encoding itself is computed
inside the kernels (kernels/fused_field.py); `apply` is the XLA path's
(the JAX package's models/embedding.py:125), with its polynomial `sinpi`.
The basis B is trainable, as in the reference (train.py:55,62).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from catnerf_torch.models.layers import lead_matmul, store

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


def frequency_bands(min_deg: int = 0, max_deg: int = DEFAULT_MAX_DEG,
                    device=None) -> torch.Tensor:
    """2^min_deg .. 2^max_deg, float32 (ref: embedding.py:70), made on
    `device` (no host copy, so no stream sync, on the step's path)."""
    return 2.0 ** torch.arange(min_deg, max_deg + 1, dtype=torch.float32,
                               device=device)


# --- fast sin(pi*x) (ref: embedding.py:75-122) ------------------------------
# sin(pi*x) reduces exactly: r = x - round(x) in [-1/2, 1/2], a sign flip by
# the parity of round(x), then a degree-9 odd minimax polynomial (max abs
# error 3.4e-9). `_FAST_SINPI` selects it in `apply`, as in the JAX package.
_FAST_SINPI = True

_SINPI_C = (3.1415925801, -5.1677068823, 2.5500314321,
            -5.9804549862e-01, 7.7220761261e-02)
_COSPI_C = (9.9999995351e-01, -4.9347928654, 4.0584120689,
            -1.3318812806, 2.1969928934e-01)


def _reduce_half(x: torch.Tensor):
    n = torch.round(x)  # half to even, as jnp.round
    r = x - n
    # (-1)^n from the parity of round(x): remainder is in [0, 2), as jnp.mod
    # (fmod would keep the sign of a negative n)
    sign = torch.where(torch.remainder(n, 2.0) >= 1.0, -1.0, 1.0)
    return r, sign


def _poly(u: torch.Tensor, c) -> torch.Tensor:
    c0, c1, c2, c3, c4 = c
    return c0 + u * (c1 + u * (c2 + u * (c3 + u * c4)))


def _sinpi(x: torch.Tensor) -> torch.Tensor:
    r, sign = _reduce_half(x)
    return sign * r * _poly(r * r, _SINPI_C)


def cospi(x: torch.Tensor) -> torch.Tensor:
    """cos(pi * x) via the same reduction and an even polynomial."""
    r, sign = _reduce_half(x)
    return sign * _poly(r * r, _COSPI_C)


class _SinPi(torch.autograd.Function):
    """The JAX package's custom JVP (:119-122): d sinpi(x) = pi cospi(x) dx."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sinpi(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return math.pi * cospi(x) * g


def sinpi(x: torch.Tensor) -> torch.Tensor:
    """sin(pi * x) via exact range reduction + odd minimax polynomial."""
    return _SinPi.apply(x)


def apply(pe: UniDirsEmbed, x: torch.Tensor, *,
          scale: float | torch.Tensor, max_deg: int = DEFAULT_MAX_DEG,
          act_dtype=None) -> torch.Tensor:
    """x [*lead, ..., 3] -> [*lead, ..., 3 + (max_deg+1)*21] (ref:
    embedding.py:125-153), `lead` the basis' stacked dims.

    scale: one float for every stacked model, or a tensor of shape `lead`,
    one scale each (the per-object scales of the registration's field
    pretraining, traced under the JAX package's vmap). A tensor divides on
    the device in every case; a float as x / float, as it always has.

    Frequency-major flattening ([f0 d0..d20, f1 d0..d20, ...]), so the 87/42
    split picks the low and high bands. The projection is a full float32
    matmul (K=3; TF32 off), as the JAX package's HIGHEST precision.

    act_dtype: the storage dtype of the result (bf16 with
    `Config.bf16_activations`); the encoding is computed in float32 either
    way and cast once at the end (ref: embedding.py:153)."""
    if isinstance(scale, torch.Tensor):
        scale = scale.reshape(*scale.shape, *[1] * (x.dim() - scale.dim()))
    t = x / scale
    proj = lead_matmul(t, pe.B.transpose(-1, -2))  # [..., 21]
    bands = frequency_bands(0, max_deg, proj.device)
    xb = proj[..., None, :] * bands[:, None]  # [..., n_freqs, 21]
    xb = xb.reshape(*proj.shape[:-1], -1)
    s = sinpi(xb) if _FAST_SINPI else torch.sin(math.pi * xb)
    return store(torch.cat([t, s], dim=-1), act_dtype)
