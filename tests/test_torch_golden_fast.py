"""The JAX package's device-store loss-curve goldens replayed by the port:
`tests/golden/loss_curve_fast_seed0.json` (float32) and
`loss_curve_fast_seed0_bf16.json` (the default `Config()`, bf16 activation
storage), 20 `run_fast(10)` calls each, under the golden test's config and
bounds (tests/test_loss_curve_pin.py:78-85, :98-99).

The port's `run_fast` is handed each step's window offsets and sampling
uniforms (`FastDraws`), drawn on the JAX fast path's key schedule: per
superstep `base_key, k = split(base_key)` (train/loop.py:233) and
`split(k, n_inner)` (device_buffer.py:274); per inner step `k_draw, k_step
= split(k)` (:268), offsets `randint(k_cat, (n_cls,), 0, lengths)` and
`randint(k_bg, (), 0, bg_length)` from `k_cat, k_bg = split(k_draw)`
(:201, :210, :235), and the step's uniforms from `fold_in(k_step, step)`.
Which bounds hold where: see tests/test_torch_golden_staged.py.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from catnerf_torch.train.loop import FastDraws
from test_torch_golden_staged import (EVERY, N_STEPS, assert_within_golden,
                                      jax_uniforms, load_golden, sessions)

torch.set_num_threads(1)

N_INNER = 10


def jax_fast_draws(jsess, tsess, key, step0: int) -> list[FastDraws]:
    """One superstep's draws from its key `key`, its first step `step0`."""
    store = tsess._store
    lengths = store.lengths.numpy().astype(np.int32)
    bg_length = np.int32(store.bg_length)
    draws = []
    for i, k in enumerate(jax.random.split(key, N_INNER)):
        k_draw, k_step = jax.random.split(k)
        k_cat, k_bg = jax.random.split(k_draw)
        offs = np.asarray(jax.random.randint(k_cat, lengths.shape, 0,
                                             lengths))
        boff = np.asarray(jax.random.randint(k_bg, (), 0, bg_length))
        draws.append(FastDraws(torch.tensor(offs, dtype=torch.int64),
                               torch.tensor(boff, dtype=torch.int64),
                               jax_uniforms(jsess, k_step, step0 + i)))
    return draws


def replay_fast(bf16: bool, jsess=None, tsess=None) -> dict:
    """The port's 200 device-store steps on the JAX fast path's draws; the
    metrics of each superstep's last step, as the golden records them."""
    if tsess is None:
        jsess, tsess = sessions(bf16)
    tsess.enable_fast_path(N_INNER)
    base_key = jsess.base_key
    curve = {"total": [], "cat_psnr": []}
    for s in range(N_STEPS // N_INNER):
        base_key, k = jax.random.split(base_key)
        m = tsess.run_fast(N_INNER, draws=jax_fast_draws(jsess, tsess, k,
                                                         s * N_INNER))
        curve["total"].append(float(m.total))
        curve["cat_psnr"].append(float(m.cat_psnr.mean()))
    assert N_INNER == EVERY
    return curve


@pytest.mark.parametrize("variant,fname,bf16", [
    ("f32", "loss_curve_fast_seed0.json", False),
    ("bf16", "loss_curve_fast_seed0_bf16.json", True),
], ids=["f32", "bf16"])
def test_port_replays_fast_golden(variant, fname, bf16):
    dev = assert_within_golden(replay_fast(bf16), load_golden(fname))
    print(f"fast {variant}: {dev}")


def test_run_fast_takes_injected_draws():
    """Handed the draws its own generator would give, `run_fast` takes the
    same steps as without them (the hook changes no default)."""
    from catnerf_torch.config import Config
    from catnerf_torch.data.device_buffer import draw_offsets
    from catnerf_torch.data.synthetic import make_scene
    from catnerf_torch.train.loop import TrainingSession

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 16
    cfg.n_per_optim_bg = 60
    scene = make_scene(n_frames=2, width=32, height=24, n_categories=2,
                       insts_per_cat=2, seed=0)
    a, b = (TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                            cam=scene.cam, device="cpu") for _ in range(2))
    for s in (a, b):
        s.enable_fast_path(N_INNER)
    want = a.run_fast(3)
    draws = []
    for _ in range(3):
        offs, boff = draw_offsets(b._store, b.draw_gen)
        draws.append(FastDraws(offs, boff, b._draws()))
    got = b.run_fast(3, draws=draws)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws for"):
        b.run_fast(2, draws=draws)
