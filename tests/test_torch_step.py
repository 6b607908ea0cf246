"""The slice as a whole: the port's training step against the JAX
package's, on a 2-category x 2-instance 48x36 scene (latent_dim 32), in
two configurations: the fused-kernel step (use_fused_kernels=True,
bf16_activations=False) and the strict-parity step
(`Config.apply_strict_parity()`: the XLA-path field modules). The fused
step also runs once with a background 64 wide (the port's background
kernels take any width to 256; the JAX kernel reads it from its weights).

Both start from the same weights (the JAX init, converted), read
byte-equal batches, and the port is handed JAX's sampling uniforms, drawn
on JAX's key schedule (fold_in(key, step), split cat/bg, split per
category). The JAX Pallas kernels run in interpret mode on the CPU. For
the one-step gradient check, rays with a sample whose ReLU pre-activation
is within rounding of zero are shifted first, on both sides alike
(`_untie_relus`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.experimental import fused_field as jff
from catnerf_tpu.train import step as jstep
from catnerf_tpu.train.loop import TrainingSession as JSession
from catnerf_tpu.train.state import make_optimizer as jmake_optimizer
from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.ops import sampling
from catnerf_torch.train import step as tstep
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state

torch.set_num_threads(1)

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)
SEEDS = (0, 2, 4)
# (seed, strict, background width): the one-step checks run the fused step
# on every seed, and on seed 0 with a background 64 wide, and the
# strict-parity step on two
ONE_STEP_CASES = ([(s, False, 128) for s in SEEDS] + [(0, False, 64)]
                  + [(0, True, 128), (2, True, 128)])
METRIC_RTOL = 1e-5
GRAD_TOL = 2e-4
# A ReLU whose pre-activation lies this close to zero (absolute; they are
# of order 1 at init) may fall on either side of it in two valid float32
# summation orders, and that one row then moves a weight gradient far past
# GRAD_TOL (seeds 0 and 4 hold one at 2e-7 each).
RELU_TIE = 1e-5


def _configure(cfg, seed=SEEDS[0], strict=False, hidden_bg=None):
    if hidden_bg is not None:
        cfg.hidden_feature_size_bg = hidden_bg
    if strict:
        cfg.apply_strict_parity()
    else:
        cfg.use_fused_kernels = True
        cfg.bf16_activations = False
    cfg.net_hyperparams.latent_dim = 32
    # 240 background rays (3,360 points) instead of 1,200 keep the test
    # quick
    cfg.n_per_optim_bg = 240
    cfg.seed = seed
    return cfg


def _sessions(seed, strict=False, hidden_bg=None):
    js = jmake_scene(**SCENE)
    jsess = JSession(_configure(JConfig(), seed, strict, hidden_bg),
                     js.inst_dict, js.sample_dict, cam=js.cam)
    ts = make_scene(**SCENE)
    cfg = _configure(Config(), seed, strict, hidden_bg)
    tsess = TrainingSession(cfg, ts.inst_dict, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    tsess.state = make_train_state(
        cfg, convert.params_from_jax(jsess.state.params))
    return jsess, tsess


def jax_draws(jsess, step: int) -> tstep.StepDraws:
    """The uniforms JAX's train step draws at `step` (step.py:102,202,244;
    sampling.py:123-124)."""
    cfg = jsess.cfg
    key = jax.random.fold_in(jsess.base_key, step)
    k_cat, k_bg = jax.random.split(key)
    keys = jax.random.split(k_cat, len(jsess.cls_ids))
    n_u = sampling.n_uniforms(cfg.n_bins_cam2surface, cfg.n_bins)
    n_u_bg = sampling.n_uniforms(cfg.n_bins_cam2surface_bg, cfg.n_bins)
    u_cat = np.stack([np.asarray(jax.random.uniform(k, (jsess.n_per_cls,
                                                        n_u)))
                      for k in keys])
    u_bg = np.asarray(jax.random.uniform(k_bg, (cfg.n_per_optim_bg, n_u_bg)))
    return tstep.StepDraws(torch.tensor(u_cat), torch.tensor(u_bg))


def _grad_recorder(store: dict):
    """An optax transform that passes the gradients through unchanged and
    keeps them, so the JAX package's own train step yields its grads."""
    def update(updates, state, params=None):
        store["grads"] = updates
        return updates, state

    return optax.GradientTransformation(lambda p: optax.EmptyState(), update)


@pytest.fixture(scope="module")
def eager_jax():
    """The JAX step runs unjitted, as the port runs (op by op): under jit,
    XLA's fusion reorders the f32 loss arithmetic, and on saturated rays
    at init the depth loss's 1/sqrt(var) weight turns that into a change
    of the first step's loss far beyond 1e-5 (ROADMAP.md Queue 3). Only
    the Pallas kernels are jitted, to keep their interpret mode quick."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("codenerf_fused_apply", "occupancy_fused_apply"):
            mp.setattr(jff, name, jax.jit(getattr(jff, name),
                                          static_argnames=("scale",
                                                           "interpret")))
        yield mp


def _untie_relus(tsess, cat_np, bg_np, draws):
    """Shift the origin of every ray that has a sample with a ReLU tie
    (RELU_TIE) in the batch both sides read, until no sample has one. The
    ties are found on the port's forward with the step's own inputs: every
    ReLU of the field, fused (plain version, [C, R*bins, w] and
    [R_bg*bins, w]) or not ([C, R, bins, w] and [R_bg, bins, w])."""
    cfg = tsess.cfg
    C, R = cat_np["origins"].shape[:2]
    R_bg = bg_np["origins"].shape[0]
    for _ in range(8):
        seen = []
        relu = torch.relu

        def spy(a):
            seen.append(a.abs().amin(-1) < RELU_TIE)
            return relu(a)

        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr(torch, "relu", spy)
            tstep.loss_fn(tsess.state.params, _tbatch(tstep.CategoryBatch,
                                                      cat_np),
                          _tbatch(tstep.BackgroundBatch, bg_np), draws,
                          cfg, tsess.obj_mask)
        tied_cat = np.zeros((C, R), bool)
        tied_bg = np.zeros(R_bg, bool)
        for near in seen:
            if near.shape[0] == C and near.numel() == C * R * \
                    cfg.bins_per_ray_obj:
                tied_cat |= near.reshape(C, R, -1).any(-1).numpy()
            elif near.numel() == R_bg * cfg.bins_per_ray_bg:
                tied_bg |= near.reshape(R_bg, -1).any(-1).numpy()
        if not (tied_cat.any() or tied_bg.any()):
            return
        cat_np["origins"][tied_cat] += 1e-3
        bg_np["origins"][tied_bg] += 1e-3
    raise AssertionError("ReLU ties left after 8 shifts")


def _tbatch(cls, arrays):
    return cls(**{k: torch.tensor(v) for k, v in arrays.items()})


def _jbatch(cls, arrays):
    return cls(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module", params=ONE_STEP_CASES,
                ids=lambda c: (f"{'strict-' if c[1] else ''}seed{c[0]}"
                               + (f"-bg{c[2]}" if c[2] != 128 else "")))
def one_step(request, eager_jax):
    """One step of each side from the same weights, on the seed's batch
    with its ReLU ties shifted away, the port replaying JAX's draws."""
    jsess, tsess = _sessions(*request.param)
    cat_np, bg_np = jsess.batcher.next_batch(jsess.n_per_cls,
                                             jsess.cfg.n_per_optim_bg)
    draws = jax_draws(jsess, 0)
    _untie_relus(tsess, cat_np, bg_np, draws)
    params0 = jax.tree.map(np.asarray, jsess.state.params)
    # the JAX package's own (unjitted) train step, recording its grads
    store = {}
    eager_jax.setattr(jstep, "make_optimizer",
                      lambda cfg: _grad_recorder(store))
    train_step = jstep.make_train_step(jsess.cfg, jsess.obj_mask, jit=False)
    _, jmetrics = train_step(jsess.state,
                             _jbatch(jstep.CategoryBatch, cat_np),
                             _jbatch(jstep.BackgroundBatch, bg_np),
                             jsess.base_key)
    eager_jax.setattr(jstep, "make_optimizer", jmake_optimizer)

    ttotal, tmetrics = tstep.loss_fn(
        tsess.state.params, _tbatch(tstep.CategoryBatch, cat_np),
        _tbatch(tstep.BackgroundBatch, bg_np), draws, tsess.cfg,
        tsess.obj_mask)
    ttotal.backward()
    return dict(jax=(float(jmetrics.total), store["grads"], jmetrics,
                     params0),
                torch=(float(ttotal.detach()), tmetrics, tsess),
                cfg=jsess.cfg)


def test_step_loss_matches_jax(one_step):
    total = one_step["jax"][0]
    ttotal = one_step["torch"][0]
    np.testing.assert_allclose(ttotal, total, rtol=METRIC_RTOL)


@pytest.mark.parametrize("field", jstep.StepMetrics._fields)
def test_step_metrics_match_jax(one_step, field):
    jm = np.asarray(getattr(one_step["jax"][2], field))
    tm = getattr(one_step["torch"][1], field).detach().numpy()
    np.testing.assert_allclose(tm, jm, rtol=METRIC_RTOL, atol=1e-7)


@pytest.mark.parametrize("group", ["cat_pe", "cat_fc", "codes", "bg_pe",
                                   "bg_fc"])
def test_step_grads_match_jax(one_step, group):
    grads = one_step["jax"][1]
    tgrads = convert.params_to_numpy(one_step["torch"][2].state.params,
                                     grads=True)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=GRAD_TOL, atol=GRAD_TOL),
        grads[group], tgrads[group])


def test_adamw_update_matches_optax(one_step):
    """Both optimizers fed JAX's gradients: the two-group AdamW update
    (lr, betas, eps, weight decays) agrees with optax's within 1e-6."""
    _, grads, _, params0 = one_step["jax"]
    cfg = one_step["cfg"]
    tx = jmake_optimizer(cfg)
    updates, _ = tx.update(grads, tx.init(params0), params0)
    want = optax.apply_updates(params0, updates)

    tcfg = _configure(Config(), cfg.seed, strict=not cfg.use_fused_kernels,
                      hidden_bg=cfg.hidden_feature_size_bg)
    state = make_train_state(tcfg, convert.params_from_jax(params0))
    gtree = convert.params_from_jax(jax.tree.map(np.asarray, grads))
    for p, g in zip(state.params.parameters(), gtree.parameters()):
        p.grad = g.detach().clone()
    state.optimizer.step()
    got = convert.params_to_numpy(state.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        b, np.asarray(a), rtol=1e-6, atol=1e-6), want, got)


def test_a_fused_background_runs_at_its_width(monkeypatch):
    """A fused session with a background 64 wide steps through the fused
    background function at width 64 (its plain version on the CPU, so no
    kernel launch is counted); a width past the widest instantiation
    builds too (the kernels' run-time width)."""
    from catnerf_torch.kernels import fused_field

    _, tsess = _sessions(0, hidden_bg=64)
    calls, real = [], fused_field.occupancy_fwd

    def spy(*args):
        calls.append(args[-1])
        return real(*args)

    monkeypatch.setattr(fused_field, "occupancy_fwd", spy)
    before = dict(fused_field.LAUNCHES)
    assert np.isfinite(float(tsess.step_once().total))
    tsess.release_prefetch()
    assert calls == [64] and fused_field.LAUNCHES == before
    for hidden in (512, fused_field.OC_WIDTHS[-1] + 1):
        cfg = _configure(Config(), hidden_bg=hidden)
        tstep.check_supported(cfg)
        sess = TrainingSession(cfg, *(lambda s: (s.inst_dict, s.sample_dict))(
            make_scene(**SCENE)), device="cpu")
        assert sess.state.params.bg_fc.in_layer.w.shape[-1] == hidden


@pytest.mark.parametrize("seed", SEEDS)
def test_five_step_trajectory_matches_jax(eager_jax, seed):
    """Five steps from the same weights, each side on its own batcher
    (byte-equal batches) with JAX's draws replayed: the port's step_once
    against the JAX package's train step (AdamW included); totals within
    1e-3."""
    jsess, tsess = _sessions(seed)
    train_step = jstep.make_train_step(jsess.cfg, jsess.obj_mask, jit=False)
    state = jsess.state
    jtot, ttot = [], []
    for i in range(5):
        cat_np, bg_np = jsess.batcher.next_batch(jsess.n_per_cls,
                                                 jsess.cfg.n_per_optim_bg)
        state, m = train_step(
            state,
            jstep.CategoryBatch(**{k: jnp.asarray(v)
                                   for k, v in cat_np.items()}),
            jstep.BackgroundBatch(**{k: jnp.asarray(v)
                                     for k, v in bg_np.items()}),
            jsess.base_key)
        jtot.append(float(m.total))
        ttot.append(float(tsess.step_once(draws=jax_draws(jsess, i)).total))
    np.testing.assert_allclose(ttot, jtot, rtol=1e-3)
    assert tsess.state.step == 5 and tsess.iteration == 5
