"""Device-resident ray store + on-device batch draws (window mode).

Parity target: the JAX package's `data/device_buffer.py`. The whole ray
store lives on the device and each step draws its batch there, so the
hot loop moves no rays from the host (the reference pays a CPU->GPU copy
per category per step, ref: src/scene_cateogries.py:369-372,424-428).

Each step takes, per buffer, one random offset and the contiguous window
of rows after it from the build-time-shuffled rows: a uniform cyclic
window, without replacement within the step, the execution shape of the
reference's epoch cursor over a shuffled buffer (ref:
src/scene_cateogries.py:421-449) minus the per-epoch reshuffle. The store
is [n_cls, max_len + pad, 12]; the pad rows repeat each buffer's first
rows, so a window at any offset in [0, length) needs no wraparound.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from catnerf_torch.data.scene import CategoryScene
from catnerf_torch.train.step import (BackgroundBatch, CategoryBatch,
                                      StepDraws)
from catnerf_torch.utils import phase_add

_CAT_COLS = 12  # origins 0:3 | dirs 3:6 | rgb 6:9 | depth 9 | state 10 | obj 11
_BG_COLS = 11   # same minus obj_idx


class DeviceRayStore(NamedTuple):
    """packed [n_cls, max_len + pad, 12] float32 rows (state/obj_idx are
    small ints, exact in f32); lengths [n_cls] valid rows; bg_packed
    [n_bg + pad, 11] (optional) and its scalar length."""

    packed: torch.Tensor
    lengths: torch.Tensor
    bg_packed: torch.Tensor | None = None
    bg_length: int | None = None


def _pack_rows(arrays: dict, n: int, with_obj: bool,
               out: np.ndarray | None = None) -> np.ndarray:
    cols = _CAT_COLS if with_obj else _BG_COLS
    if out is None:
        out = np.zeros((n, cols), np.float32)
    out[:, 0:3] = arrays["origins"]
    out[:, 3:6] = arrays["dirs"]
    out[:, 6:9] = np.asarray(arrays["rgb"], np.float32) / 255.0
    out[:, 9] = arrays["depth"]
    out[:, 10] = arrays["state"]
    if with_obj:
        out[:, 11] = arrays["obj_idx"]
    return out


def build_device_store(categories: list[CategoryScene],
                       background: CategoryScene | None, window_pad: int,
                       bg_window_pad: int, device) -> DeviceRayStore:
    """window_pad / bg_window_pad: rows past each buffer's end holding a
    cyclic repetition of its first rows, sized to the per-step batch."""
    max_len = max(c.buffer.n for c in categories) + window_pad
    t0 = time.time()
    packed = np.zeros((len(categories), max_len, _CAT_COLS), np.float32)
    for i, c in enumerate(categories):
        rows = _pack_rows(c.buffer.arrays, c.buffer.n, True,
                          out=packed[i, : c.buffer.n])
        packed[i, c.buffer.n: c.buffer.n + window_pad] = np.resize(
            rows, (window_pad, _CAT_COLS))
    bg_rows, bg_n = None, None
    if background is not None:
        b = background.buffer.arrays
        bg_n = int(b["depth"].shape[0])
        bg_rows = _pack_rows(b, bg_n, False)
        bg_rows = np.concatenate(
            [bg_rows, np.resize(bg_rows, (bg_window_pad, _BG_COLS))])
    phase_add("fast_path", "store_pack", time.time() - t0)
    return DeviceRayStore(
        packed=torch.from_numpy(packed).to(device),
        lengths=torch.tensor([c.buffer.n for c in categories],
                             device=device),
        bg_packed=(torch.from_numpy(bg_rows).to(device)
                   if bg_rows is not None else None),
        bg_length=bg_n)


def check_window_pad(store: DeviceRayStore, n_per_cls: int,
                     n_bg: int | None = None) -> None:
    """A short pad would make windows read the store's zero rows."""
    pad = store.packed.shape[1] - int(store.lengths.max())
    if pad < n_per_cls:
        raise ValueError(f"window draw of {n_per_cls} rays needs a store "
                         f"built with window_pad >= {n_per_cls} (has {pad})")
    if n_bg is not None and store.bg_packed is not None:
        bpad = store.bg_packed.shape[0] - store.bg_length
        if bpad < n_bg:
            raise ValueError(f"window draw of {n_bg} bg rays needs "
                             f"bg_window_pad >= {n_bg} (has {bpad})")


def draw_offsets(store: DeviceRayStore, gen: torch.Generator):
    """Uniform window offsets: [n_cls] in [0, lengths), and one in
    [0, bg_length) (None without a background store)."""
    dev = store.packed.device
    u = torch.rand(store.lengths.shape[0], generator=gen, device=dev)
    offs = torch.minimum((u * store.lengths).long(), store.lengths - 1)
    boff = None
    if store.bg_packed is not None:
        ub = torch.rand((), generator=gen, device=dev)
        boff = torch.clamp((ub * store.bg_length).long(),
                           max=store.bg_length - 1)
    return offs, boff


def _unpack_cat(rows: torch.Tensor) -> CategoryBatch:
    return CategoryBatch(
        rgbs=rows[..., 6:9], states=rows[..., 10].to(torch.int32),
        depth=rows[..., 9], origins=rows[..., 0:3], dirs=rows[..., 3:6],
        obj_indices=rows[..., 11].to(torch.int32))


def _unpack_bg(rows: torch.Tensor) -> BackgroundBatch:
    return BackgroundBatch(
        rgbs=rows[..., 6:9], states=rows[..., 10].to(torch.int32),
        depth=rows[..., 9], origins=rows[..., 0:3], dirs=rows[..., 3:6])


def sample_batch(store: DeviceRayStore, n_per_cls: int, n_bg: int,
                 offs: torch.Tensor, boff: torch.Tensor | None):
    """Window draw (ref: device_buffer.py:176-245, window=True): rows
    [off, off + n) of each buffer, on the device, with no host sync.
    Returns (CategoryBatch, BackgroundBatch | None)."""
    n_cls = store.packed.shape[0]
    dev = store.packed.device
    idx = offs[:, None] + torch.arange(n_per_cls, device=dev)[None, :]
    rows = store.packed[torch.arange(n_cls, device=dev)[:, None], idx]
    bg = None
    if store.bg_packed is not None and boff is not None:
        bg = _unpack_bg(store.bg_packed[boff + torch.arange(n_bg,
                                                            device=dev)])
    return _unpack_cat(rows), bg


class FastDraws(NamedTuple):
    """One device-store step's random draws: the window offsets, [n_cls]
    (int64, each in [0, its buffer's length)) and the background's scalar
    (None without a background), and the step's sampling uniforms."""

    offs: torch.Tensor
    boff: torch.Tensor | None
    step: StepDraws

