"""How far 200-step curves on the golden configs lie from the JAX package's
loss-curve goldens, and how far float32 rounding alone moves them:

- the port's replay (tests/test_torch_golden_{staged,fast}.py);
- the port's replay from initial weights each multiplied by 1 + 1e-7 n,
  n standard normal (a change below float32 rounding of a sum), K seeds;
- the JAX package's own train step run eagerly (unjitted), on the same
  batches and keys as the jitted step that wrote the goldens.

    JAX_PLATFORMS=cpu python tests/torch_golden_spread.py [K]

Prints one line per curve: the golden test's statistics (largest and mean
|PSNR difference|, largest and mean relative total difference over all
200 steps and before the golden's first spike) and the relative total
difference at each checkpoint. Takes ~10 min on a CPU core.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

from test_torch_golden_fast import N_INNER, replay_fast  # noqa: E402
from test_torch_golden_staged import (EVERY, N_STEPS, deviations,  # noqa
                                      load_golden, replay_staged, sessions)

VARIANTS = [("staged", "f32", False), ("staged", "bf16", True),
            ("fast", "f32", False), ("fast", "bf16", True)]


def perturb(tsess, seed: int) -> None:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in tsess.state.params.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))


def eager_jax(path: str, jsess) -> dict:
    """The JAX package's unjitted train step on the jitted session's
    batches and keys (host-staged: its batcher and base_key; fast: the
    device store's window draws on the superstep's key schedule)."""
    from catnerf_tpu.data.device_buffer import build_device_store, sample_batch
    from catnerf_tpu.train import step as jstep

    step = jstep.make_train_step(jsess.cfg, jsess.obj_mask, jit=False)
    state = jsess.state
    curve = {"total": [], "cat_psnr": []}
    if path == "staged":
        curve["bg_psnr"] = []
        for i in range(N_STEPS):
            cat, bg = jsess.batcher.next_batch(jsess.n_per_cls,
                                               jsess.cfg.n_per_optim_bg)
            state, m = step(
                state, jstep.CategoryBatch(**{k: jnp.asarray(v)
                                              for k, v in cat.items()}),
                jstep.BackgroundBatch(**{k: jnp.asarray(v)
                                         for k, v in bg.items()}),
                jsess.base_key)
            if (i + 1) % EVERY == 0:
                curve["total"].append(float(m.total))
                curve["cat_psnr"].append(float(m.cat_psnr.mean()))
                curve["bg_psnr"].append(float(m.bg_psnr))
        return curve
    store = build_device_store(jsess.categories, jsess.background,
                               window_pad=jsess.n_per_cls,
                               bg_window_pad=jsess.cfg.n_per_optim_bg)
    base_key = jsess.base_key
    for _ in range(N_STEPS // N_INNER):
        base_key, k = jax.random.split(base_key)
        for kk in jax.random.split(k, N_INNER):
            k_draw, k_step = jax.random.split(kk)
            cat, bg = sample_batch(store, k_draw, jsess.n_per_cls,
                                   jsess.cfg.n_per_optim_bg, window=True)
            state, m = step(state, cat, bg, k_step)
        curve["total"].append(float(m.total))
        curve["cat_psnr"].append(float(m.cat_psnr.mean()))
    return curve


def show(what: str, curve: dict, golden: dict) -> None:
    dev = deviations(curve, golden)
    rel = [round(a / b - 1, 4) for a, b in zip(curve["total"],
                                               golden["total"])]
    print(f"{what}: " + ", ".join(
        f"{k} {tuple(round(v, 4) for v in vs)}" for k, vs in dev.items())
        + f"; total rel by checkpoint {rel}", flush=True)


def main(k: int = 3) -> None:
    torch.set_num_threads(1)
    for path, variant, bf16 in VARIANTS:
        golden = load_golden(f"loss_curve{'_fast' if path == 'fast' else ''}"
                             f"_seed0{'_bf16' if bf16 else ''}.json")
        replay = replay_staged if path == "staged" else replay_fast
        for seed in range(k + 1):
            jsess, tsess = sessions(bf16)
            if seed:
                perturb(tsess, seed)
            show(f"{path} {variant} port" + (f", weights moved (seed "
                                              f"{seed})" if seed else ""),
                 replay(bf16, jsess, tsess), golden)
        show(f"{path} {variant} JAX eager", eager_jax(path, sessions(bf16)[0]),
             golden)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
