"""One-transfer host-to-device batch staging for the host-staged step
(a copy of the JAX package's `train/packing.py`, with the device side in
PyTorch).

The reference stages each batch tensor to the device separately every
iteration (ref: train.py:98-134, ~11 `.to(device)` moves a step). Here
every field of the (CategoryBatch, BackgroundBatch) pair is packed into
ONE flat float32 host buffer (the int32 fields stored bit for bit through
`.view(np.float32)`, never cast), shipped in one copy, and unpacked into
views of the one device buffer: a float field is a slice, an int field a
slice `.view(torch.int32)`. No arithmetic touches the int fields' bits (an
int32 index read as float32 is a denormal, which arithmetic may flush to
zero), so the unpacked tensors equal per-field staging bit for bit.

`Stager` owns the buffers: two host buffers (pinned on a CUDA session)
and one device buffer. The host buffer of a step is filled, possibly on a
worker thread, only after the copy out of it for the step two back has
run (a CUDA event recorded after each copy): a pinned buffer refilled
while its copy is still in flight would ship the next batch's bytes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from catnerf_torch.train.step import BackgroundBatch, CategoryBatch

# (name, trailing_shape, is_int) per field, in pack order. Leading dims are
# (n_cls, r) for category fields and (n_bg,) for background fields.
_CAT_FIELDS = (
    ("rgbs", (3,), False),
    ("states", (), True),
    ("depth", (), False),
    ("origins", (3,), False),
    ("dirs", (3,), False),
    ("obj_indices", (), True),
)
_BG_FIELDS = (
    ("rgbs", (3,), False),
    ("states", (), True),
    ("depth", (), False),
    ("origins", (3,), False),
    ("dirs", (3,), False),
)


class _Field(NamedTuple):
    name: str
    shape: tuple
    is_int: bool
    offset: int
    size: int


class PackSpec(NamedTuple):
    cat_fields: tuple
    bg_fields: tuple  # empty when the session has no background model
    total: int


def make_spec(n_cls: int, rays_per_cls: int, n_bg: int,
              with_background: bool) -> PackSpec:
    off = 0

    def build(defs, lead):
        nonlocal off
        out = []
        for name, trail, is_int in defs:
            shape = lead + trail
            size = int(np.prod(shape, dtype=np.int64))
            out.append(_Field(name, shape, is_int, off, size))
            off += size
        return tuple(out)

    cat = build(_CAT_FIELDS, (n_cls, rays_per_cls))
    bg = build(_BG_FIELDS, (n_bg,)) if with_background else ()
    return PackSpec(cat, bg, off)


def pack(spec: PackSpec, cat_np: dict, bg_np: dict | None,
         out: np.ndarray | None = None) -> np.ndarray:
    """Host side: flatten both batch dicts into one float32 buffer (into
    `out` when given, e.g. a pinned buffer's numpy view)."""
    if out is None:
        out = np.empty(spec.total, np.float32)

    def put(fields, src):
        for f in fields:
            a = src[f.name]
            if f.is_int:
                a = np.ascontiguousarray(a, np.int32).view(np.float32)
            else:
                a = np.asarray(a, np.float32)
            out[f.offset:f.offset + f.size] = a.reshape(-1)

    put(spec.cat_fields, cat_np)
    if spec.bg_fields:
        assert bg_np is not None, "spec was built with a background batch"
        put(spec.bg_fields, bg_np)
    return out


def unpack(spec: PackSpec, flat: torch.Tensor):
    """(CategoryBatch, BackgroundBatch or None) of views of `flat`."""

    def take(fields):
        vals = {}
        for f in fields:
            x = flat[f.offset:f.offset + f.size]
            if f.is_int:
                x = x.view(torch.int32)
            vals[f.name] = x.view(f.shape)
        return vals

    cat = CategoryBatch(**take(spec.cat_fields))
    bg = BackgroundBatch(**take(spec.bg_fields)) if spec.bg_fields else None
    return cat, bg


class Stager:
    """The buffers of packed staging on `device`. `fill(slot, cat, bg)`
    packs a host batch into host buffer `slot` (0 or 1; any thread), once
    the last copy out of that buffer has run; `stage(slot)` copies it into
    the device buffer on the calling thread's stream and returns the
    unpacked views. The device buffer is reused from step to step: the
    copy is queued behind the previous step's kernels on the same
    stream."""

    def __init__(self, spec: PackSpec, device: torch.device):
        self.spec = spec
        self.device = device
        cuda = device.type == "cuda"
        self.host = [torch.empty(spec.total, dtype=torch.float32,
                                 pin_memory=cuda) for _ in range(2)]
        self.events = ([torch.cuda.Event() for _ in range(2)] if cuda
                       else None)
        self.dev = (torch.empty(spec.total, dtype=torch.float32,
                                device=device) if cuda else None)

    def fill(self, slot: int, cat_np: dict, bg_np: dict | None) -> int:
        if self.events is not None:
            # returns at once for an event never recorded
            self.events[slot].synchronize()
        pack(self.spec, cat_np, bg_np, out=self.host[slot].numpy())
        return slot

    def stage(self, slot: int):
        if self.dev is None:
            # the CPU session reads the host buffer itself: the next fill
            # of this slot comes two steps later, after this step has run
            return unpack(self.spec, self.host[slot])
        self.dev.copy_(self.host[slot], non_blocking=True)
        self.events[slot].record()
        return unpack(self.spec, self.dev)
