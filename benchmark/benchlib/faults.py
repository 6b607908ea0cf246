"""Faults planted under the timed path, for the tests and the calibration
of the limits: each is a context manager that breaks the program while it
is open.

- `frozen`: every optimizer step returns the state unchanged;
- `half_batch`: half of each step's rays are left out, the means taken
  over the rest;
- `store_depth`: the device ray store's depth column a thousandth too
  deep;
- `stale_draws`: the captured step's replays keep the draws it was
  captured with;
- `objects_dropped` (a served view): the objects' fields are left out of
  the scene's composite, which shows the background alone.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def frozen():
    step = torch.optim.AdamW.step
    torch.optim.AdamW.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.AdamW.step = step


@contextlib.contextmanager
def half_batch():
    from catnerf_torch.train import step as step_mod

    loss_fn = step_mod.loss_fn

    def halved(params, cat, bg, draws, *args, **kwargs):
        r, rb = cat.depth.shape[1] // 2, bg.depth.shape[0] // 2
        cat = type(cat)(*(x[:, :r] for x in cat))
        bg = type(bg)(*(x[:rb] for x in bg))
        draws = type(draws)(draws.cat[:, :r], draws.bg[:rb])
        return loss_fn(params, cat, bg, draws, *args, **kwargs)

    step_mod.loss_fn = halved
    try:
        yield
    finally:
        step_mod.loss_fn = loss_fn


@contextlib.contextmanager
def store_depth():
    from catnerf_torch.data import device_buffer

    pack = device_buffer._pack_rows

    def deeper(*args, **kwargs):
        out = pack(*args, **kwargs)
        out[:, 9] *= 1.001
        return out

    device_buffer._pack_rows = deeper
    try:
        yield
    finally:
        device_buffer._pack_rows = pack


@contextlib.contextmanager
def stale_draws():
    from catnerf_torch.train import graph

    call = graph.CapturedStep.__call__

    def replay_only(self, *inputs):
        if self.graph is None:
            return call(self, *inputs)
        self.graph.replay()
        return self.outputs

    graph.CapturedStep.__call__ = replay_only
    try:
        yield
    finally:
        graph.CapturedStep.__call__ = call


@contextlib.contextmanager
def objects_dropped():
    from catnerf_torch import render_views

    tile = render_views._scene_tile

    def background_only(staged, *args, **kwargs):
        return tile({**staged, "half": torch.full_like(staged["half"], -1.0)},
                    *args, **kwargs)

    render_views._scene_tile = background_only
    try:
        yield
    finally:
        render_views._scene_tile = tile


FAULTS = {"train": {"frozen": frozen, "half_batch": half_batch,
                    "store_depth": store_depth, "stale_draws": stale_draws},
          "view": {"objects_dropped": objects_dropped}}
