"""One training step of the reference's default configuration (`Config()`:
bf16 activation storage on the XLA-path modules) against the JAX package's
unjitted step, at seeds 0, 2 and 4, on the scene of tests/test_torch_step.py
(2 categories x 2 instances, 48x36, latent_dim 32).

Same weights (the JAX init, converted), byte-equal batches, JAX's sampling
uniforms injected, rays with a ReLU tie shifted on both sides alike
(`test_torch_step._untie_relus`). The loss, every metric, every gradient
and the AdamW update are held.

Bounds (the flips of bf16 storage are counted and bounded module by module
in tests/test_torch_bf16.py: at most FLIP_SHARE of a stored tensor, each
one bf16 ulp, ULP = 2^-7 relative, beyond the float32 tolerance):

- metrics: the float32 step's METRIC_RTOL plus FLIP_SHARE * ULP relative,
  the most that flips of at most FLIP_SHARE of the stored values, each
  moving its value by one ulp, move a mean at unit sensitivity;
- gradients: the float32 step's GRAD_TOL plus one ulp of the leaf's
  largest entry (test_torch_bf16.grads_close).

Observed (eager JAX on the CPU; printed with `-s`): metrics within 2.5e-6
relative; gradients within 2.0e-3 of their leaf's largest entry (seed 4's
CodeNeRF), the other leaves within 2.4e-4.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.train import step as jstep
from catnerf_tpu.train.loop import TrainingSession as JSession
from catnerf_tpu.train.state import make_optimizer as jmake_optimizer
from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train import step as tstep
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state
from test_torch_bf16 import FLIP_SHARE, ULP, grads_close
from test_torch_step import (GRAD_TOL, METRIC_RTOL, SCENE, SEEDS,
                             _grad_recorder, _jbatch, _tbatch, _untie_relus,
                             jax_draws)

torch.set_num_threads(1)

BF16_METRIC_RTOL = METRIC_RTOL + FLIP_SHARE * ULP


def _configure(cfg, seed):
    """`Config()` (bf16_activations=True, use_fused_kernels=False) at the
    step test's size."""
    assert cfg.bf16_activations and not cfg.use_fused_kernels
    cfg.net_hyperparams.latent_dim = 32
    cfg.n_per_optim_bg = 240
    cfg.seed = seed
    return cfg


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def one_step(request):
    """One step of each side from the same weights, on the seed's batch
    with its ReLU ties shifted away, the port replaying JAX's draws."""
    seed = request.param
    js = jmake_scene(**SCENE)
    jsess = JSession(_configure(JConfig(), seed), js.inst_dict,
                     js.sample_dict, cam=js.cam)
    ts = make_scene(**SCENE)
    cfg = _configure(Config(), seed)
    tsess = TrainingSession(cfg, ts.inst_dict, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    tsess.state = make_train_state(
        cfg, convert.params_from_jax(jsess.state.params))
    cat_np, bg_np = jsess.batcher.next_batch(jsess.n_per_cls,
                                             jsess.cfg.n_per_optim_bg)
    draws = jax_draws(jsess, 0)
    _untie_relus(tsess, cat_np, bg_np, draws)
    params0 = jax.tree.map(np.asarray, jsess.state.params)
    store = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstep, "make_optimizer", lambda cfg: _grad_recorder(store))
        train_step = jstep.make_train_step(jsess.cfg, jsess.obj_mask,
                                           jit=False)
    _, jmetrics = train_step(jsess.state,
                             _jbatch(jstep.CategoryBatch, cat_np),
                             _jbatch(jstep.BackgroundBatch, bg_np),
                             jsess.base_key)
    ttotal, tmetrics = tstep.loss_fn(
        tsess.state.params, _tbatch(tstep.CategoryBatch, cat_np),
        _tbatch(tstep.BackgroundBatch, bg_np), draws, tsess.cfg,
        tsess.obj_mask)
    ttotal.backward()
    return dict(jax=(float(jmetrics.total), store["grads"], jmetrics,
                     params0),
                torch=(float(ttotal.detach()), tmetrics, tsess),
                cfg=jsess.cfg)


def test_bf16_step_loss_matches_jax(one_step):
    np.testing.assert_allclose(one_step["torch"][0], one_step["jax"][0],
                               rtol=BF16_METRIC_RTOL)


@pytest.mark.parametrize("field", jstep.StepMetrics._fields)
def test_bf16_step_metrics_match_jax(one_step, field):
    jm = np.asarray(getattr(one_step["jax"][2], field))
    tm = getattr(one_step["torch"][1], field).detach().numpy()
    print(f"{field}: relative difference "
          f"{np.max(np.abs(tm - jm) / np.maximum(np.abs(jm), 1e-12)):.2e}")
    np.testing.assert_allclose(tm, jm, rtol=BF16_METRIC_RTOL, atol=1e-7)


@pytest.mark.parametrize("group", ["cat_pe", "cat_fc", "codes", "bg_pe",
                                   "bg_fc"])
def test_bf16_step_grads_match_jax(one_step, group):
    grads = one_step["jax"][1]
    tgrads = convert.params_to_numpy(one_step["torch"][2].state.params,
                                     grads=True)
    worst = jax.tree.leaves(jax.tree.map(
        lambda a, b: grads_close(group, b, a, GRAD_TOL), grads[group],
        tgrads[group]))
    print(f"{group}: largest difference {max(worst):.2e} of the leaf's "
          "largest gradient")


def test_bf16_adamw_update_matches_optax(one_step):
    """The two-group AdamW update of `Config()` fed the JAX step's
    gradients, against optax's, within 1e-6 (as the float32 step's)."""
    _, grads, _, params0 = one_step["jax"]
    cfg = one_step["cfg"]
    tx = jmake_optimizer(cfg)
    updates, _ = tx.update(grads, tx.init(params0), params0)
    want = optax.apply_updates(params0, updates)

    state = make_train_state(_configure(Config(), cfg.seed),
                             convert.params_from_jax(params0))
    gtree = convert.params_from_jax(jax.tree.map(np.asarray, grads))
    for p, g in zip(state.params.parameters(), gtree.parameters()):
        p.grad = g.detach().clone()
    state.optimizer.step()
    got = convert.params_to_numpy(state.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=1e-6, atol=1e-6), want, got)


def test_default_config_session_trains_on_the_bf16_xla_path():
    """A `Config()` session runs host-staged and device-store steps through
    the XLA-path modules with bf16 storage: finite losses, every stored
    activation bf16, no kernel wrapper reached."""
    from catnerf_torch.kernels import fused_field as ff

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 16
    cfg.n_per_optim_bg = 60
    assert not tstep.fused_eligible(cfg)
    assert tstep.act_dtype(cfg) is torch.bfloat16
    scene = make_scene(n_frames=2, width=32, height=24, n_categories=2,
                       insts_per_cat=2, seed=0)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    before = dict(ff.LAUNCHES)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tstep.codenerf, tstep.embedding):
            store = mod.store

            def spy(x, dt, store=store):
                seen.append(dt)
                return store(x, dt)

            mp.setattr(mod, "store", spy)
        totals = [float(sess.step_once().total) for _ in range(2)]
        sess.enable_fast_path(2)
        totals.append(float(sess.run_fast(2).total))
    assert all(np.isfinite(totals)) and sess.state.step == 4
    assert ff.LAUNCHES == before
    assert seen and all(dt is torch.bfloat16 for dt in seen)
