"""Device-resident ray store + on-device batch draws.

Parity target: the JAX package's `data/device_buffer.py`. The whole ray
store lives on the device and each step draws its batch there, so the
hot loop moves no rays from the host (the reference pays a CPU->GPU copy
per category per step, ref: src/scene_cateogries.py:369-372,424-428).

The window draw (the training session's): each step takes, per buffer,
one random offset and the contiguous window of rows after it from the
build-time-shuffled rows: a uniform cyclic window, without replacement
within the step, the execution shape of the reference's epoch cursor over
a shuffled buffer (ref: src/scene_cateogries.py:421-449) minus the
per-epoch reshuffle. The store is [n_cls, max_len + pad, 12]; the pad rows
repeat each buffer's first rows, so a window at any offset in
[0, length) needs no wraparound. The row draw (JAX's window=False):
uniform row indices with replacement, gathered flat or per category.
A sharded session's store holds its own categories only.
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
    small ints, exact in f32); lengths [n_cls] valid rows; max_length the
    largest of lengths, known on the host (the draws' precision);
    bg_packed [n_bg + pad, 11] (optional) and its scalar length."""

    packed: torch.Tensor
    lengths: torch.Tensor
    max_length: int
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
    t0 = time.perf_counter()
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
    phase_add("fast_path", "store_pack", time.perf_counter() - t0)
    return DeviceRayStore(
        packed=torch.from_numpy(packed).to(device),
        lengths=torch.tensor([c.buffer.n for c in categories],
                             device=device),
        max_length=max(c.buffer.n for c in categories),
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


# A float32 uniform has 24 random bits: scaled by a length past 2^24 it
# reaches only some rows (at 80M, 10% odd offsets). Past it the draws take
# float64 uniforms (53 bits), uniform over the integers as
# jax.random.randint is; below it they stay the float32 stream.
F32_ROWS = 1 << 24


def _uniform(shape, length: int, gen: torch.Generator, dev):
    dtype = torch.float64 if length > F32_ROWS else torch.float32
    return torch.rand(shape, generator=gen, device=dev, dtype=dtype)


def window_offsets(lengths: torch.Tensor, bg_length: int | None,
                   gen: torch.Generator, max_length: int):
    """Uniform window offsets: [n_cls] in [0, lengths), and one in
    [0, bg_length) (None without a background). max_length: the largest
    of lengths, known on the host (reading it from lengths would wait on
    the card)."""
    dev = lengths.device
    u = _uniform(lengths.shape[0], max_length, gen, dev)
    offs = torch.minimum((u * lengths).long(), lengths - 1)
    boff = None
    if bg_length is not None:
        ub = _uniform((), bg_length, gen, dev)
        boff = torch.clamp((ub * bg_length).long(), max=bg_length - 1)
    return offs, boff


def draw_offsets(store: DeviceRayStore, gen: torch.Generator):
    """window_offsets of the store's buffers."""
    return window_offsets(
        store.lengths,
        store.bg_length if store.bg_packed is not None else None, gen,
        store.max_length)


def draw_rows(lengths: torch.Tensor, bg_length: int | None, n_per_cls: int,
              n_bg: int, gen: torch.Generator, max_length: int):
    """Uniform row indices with replacement (JAX's window=False draw):
    [n_cls, n_per_cls] each in [0, its length), and [n_bg] in
    [0, bg_length) (None without a background). max_length as in
    window_offsets."""
    dev = lengths.device
    u = _uniform((lengths.shape[0], n_per_cls), max_length, gen, dev)
    idx = torch.minimum((u * lengths[:, None]).long(), lengths[:, None] - 1)
    bidx = None
    if bg_length is not None:
        ub = _uniform(n_bg, bg_length, gen, dev)
        bidx = torch.clamp((ub * bg_length).long(), max=bg_length - 1)
    return idx, bidx


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
                 offs: torch.Tensor, boff: torch.Tensor | None, *,
                 window: bool = True, per_category_gather: bool = False):
    """The step's batch from the store, on the device, with no host sync
    (ref: device_buffer.py:176-245). Returns (CategoryBatch,
    BackgroundBatch | None).

    window=True: rows [off, off + n) of each buffer, offs [n_cls] and the
    scalar boff from window_offsets. window=False: offs are row indices
    [n_cls, n_per_cls] and boff [n_bg] (draw_rows), gathered as one flat
    row gather over the whole store, or with per_category_gather one
    gather along each category's rows (the JAX package's take_along_axis,
    which stays on a category-sharded store)."""
    n_cls, max_len = store.packed.shape[:2]
    dev = store.packed.device
    bg = None
    if window:
        idx = offs[:, None] + torch.arange(n_per_cls, device=dev)[None, :]
        rows = store.packed[torch.arange(n_cls, device=dev)[:, None], idx]
        if store.bg_packed is not None and boff is not None:
            bg = store.bg_packed[boff + torch.arange(n_bg, device=dev)]
    else:
        if per_category_gather:
            rows = torch.gather(store.packed, 1, offs[..., None].expand(
                *offs.shape, store.packed.shape[2]))
        else:
            flat = offs + (torch.arange(n_cls, device=dev) * max_len)[:, None]
            rows = store.packed.reshape(-1, store.packed.shape[2])[
                flat.reshape(-1)].reshape(*offs.shape, -1)
        if store.bg_packed is not None and boff is not None:
            bg = store.bg_packed[boff]
    return _unpack_cat(rows), (_unpack_bg(bg) if bg is not None else None)


class FastDraws(NamedTuple):
    """One device-store step's random draws: the window offsets, [n_cls]
    (int64, each in [0, its buffer's length)) and the background's scalar
    (None without a background), or for the row draw (window=False) the
    row indices [n_cls, n_per_cls] and [n_bg]; and the step's sampling
    uniforms."""

    offs: torch.Tensor
    boff: torch.Tensor | None
    step: StepDraws

