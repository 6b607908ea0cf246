"""The port's superstep (`train/graph.make_superstep`, run eagerly on the CPU
through `TrainingSession.run_fast`) against the JAX package's
`make_superstep` (catnerf_tpu/data/device_buffer.py:248-288), jitted as the
JAX fast path runs it, on the scene of tests/test_torch_step.py (2
categories x 2 instances, 48x36, latent_dim 32), seed 0, N_INNER = 3 steps.

Both start from the JAX initial parameters (converted) and read the same
store (byte-equal rows). The port is handed each inner step's window
offsets and sampling uniforms as JAX draws them from its superstep key:
`split(key, n_inner)`, then per step `k_draw, k_step = split(k)`, offsets
from `k_cat, k_bg = split(k_draw)` and the uniforms from
`fold_in(k_step, step)` (ref: device_buffer.py:201-210, :268-274;
step.py:244). The last step's metrics are held.

The JAX superstep is compiled with XLA's `xla_allow_excess_precision`
off, so that XLA keeps each bf16 rounding its unjitted ops make (with it on,
a fusion keeps bf16 values in float32 between ops); for float32 it changes
nothing. The port runs op by op, as the unjitted JAX package does.

Bounds:

- the fused float32 config: the one-step bounds of tests/test_torch_step.py,
  METRIC_RTOL = 1e-5 relative (atol 1e-7), and DEPTH_RTOL = 1e-4 for the
  metrics weighted by 1/sqrt(var) of the rendered depth (total, cat_depth,
  bg_depth), as chip_smoke.py's step check. Observed: 1.2e-6, and 3.2e-5
  for the depth-weighted ones.
- `Config()` (bf16 activation storage on the XLA path): BF16_RTOL = 6e-3,
  set from readings. The one-step bound plus the bf16 flip allowance of
  tests/test_torch_bf16.py (8.8e-5; 1.8e-4 depth-weighted) holds one
  forward, not three steps: a value stored one bf16 ulp apart can turn the
  sign of a gradient that is near zero, and AdamW's first update moves
  each weight by the learning rate times that sign. Readings on these
  three steps, largest relative difference over the metrics (cat_depth in
  each): the port 2.0e-3 from this reference and 3.0e-3 from the unjitted
  JAX superstep (28 s on one core, not run here), which is itself 2.0e-3
  from this reference and 7.3e-3 from the default-compiled one. Wrong
  supersteps, against this reference: float32 activation storage 7.3e-2,
  the second inner step's AdamW update left out 1.04, each window one row
  off 0.41. The bound lies 3x above the sound reading and 12x under the
  nearest wrong one; `test_bf16_bound_rejects_wrong_supersteps` holds the
  first two outside it.

The contract cases run the port alone on a smaller scene.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data import device_buffer as jdb
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.train import step as jstep
from catnerf_tpu.train.loop import TrainingSession as JSession
from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.device_buffer import FastDraws, build_device_store
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.kernels import fused_field
from catnerf_torch.train.graph import make_superstep
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state
from test_torch_golden_staged import jax_uniforms
from test_torch_step import METRIC_RTOL, SCENE
from test_torch_step import _configure as fused_configure

torch.set_num_threads(1)

N_INNER = 3
DEPTH_RTOL = 1e-4
DEPTH_WEIGHTED = ("total", "cat_depth", "bg_depth")
BF16_RTOL = 6e-3


def default_configure(cfg):
    """`Config()` at the step test's size (tests/test_torch_step_bf16.py)."""
    assert cfg.bf16_activations and not cfg.use_fused_kernels
    cfg.net_hyperparams.latent_dim = 32
    cfg.n_per_optim_bg = 240
    cfg.seed = 0
    return cfg


CONFIGS = {"fused": lambda c: fused_configure(c, 0),
           "default": default_configure}


def superstep_draws(jsess, tsess, key) -> list[FastDraws]:
    """The draws of the JAX superstep's inner steps from its key `key`."""
    store = tsess._store
    lengths = store.lengths.numpy().astype(np.int32)
    bg_length = np.int32(store.bg_length)
    draws = []
    for i, k in enumerate(jax.random.split(key, N_INNER)):
        k_draw, k_step = jax.random.split(k)
        k_cat, k_bg = jax.random.split(k_draw)
        offs = jax.random.randint(k_cat, lengths.shape, 0, lengths)
        boff = jax.random.randint(k_bg, (), 0, bg_length)
        draws.append(FastDraws(torch.tensor(np.asarray(offs),
                                            dtype=torch.int64),
                               torch.tensor(np.asarray(boff),
                                            dtype=torch.int64),
                               jax_uniforms(jsess, k_step, i)))
    return draws


@functools.cache
def jax_superstep(name):
    """The JAX session, its superstep's first key (train/loop.py:233), its
    store's lengths and the last step's metrics of its superstep
    (train/loop.py:196-215)."""
    js = jmake_scene(**SCENE)
    jsess = JSession(CONFIGS[name](JConfig()), js.inst_dict, js.sample_dict,
                     cam=js.cam)
    jstore = jdb.build_device_store(
        jsess.categories, jsess.background, window_pad=jsess.n_per_cls,
        bg_window_pad=jsess.cfg.n_per_optim_bg)
    superstep = jdb.make_superstep(
        jstep.make_train_step(jsess.cfg, jsess.obj_mask, jit=False), jstore,
        jsess.n_per_cls, jsess.cfg.n_per_optim_bg, N_INNER, donate=False,
        window=True)
    _, key = jax.random.split(jsess.base_key)
    compiled = superstep.lower(jsess.state, key).compile(
        compiler_options={"xla_allow_excess_precision": False})
    _, want = compiled(jsess.state, key, jstore)
    return jsess, key, np.asarray(jstore.lengths), want


def port_superstep(name, variant=None):
    """The port's superstep from the JAX initial parameters on the JAX
    superstep's draws: the JAX session, the port's session and its last
    step's metrics. variant: None, or a wrong superstep, "f32_storage"
    (float32 activations) or "skipped_update" (the second inner step's
    AdamW update left out)."""
    jsess, key, _, _ = jax_superstep(name)
    ts = make_scene(**SCENE)
    cfg = CONFIGS[name](Config())
    if variant == "f32_storage":
        cfg.bf16_activations = False
    tsess = TrainingSession(cfg, ts.inst_dict, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    tsess.state = make_train_state(
        cfg, convert.params_from_jax(jsess.state.params))
    tsess.enable_fast_path(N_INNER)
    draws = superstep_draws(jsess, tsess, key)
    if variant != "skipped_update":
        return tsess, tsess.run_fast(N_INNER, draws=draws)
    tsess.run_fast(1, draws=draws[:1])
    opt = tsess.state.optimizer
    opt.step = lambda: None
    tsess.run_fast(1, draws=draws[1:2])
    del opt.step
    return tsess, tsess.run_fast(1, draws=draws[2:])


def relative(want, got) -> dict[str, float]:
    """The largest relative difference of each metric."""
    out = {}
    for field in want._fields:
        a = np.asarray(getattr(want, field), np.float64)
        b = getattr(got, field).double().numpy()
        out[field] = float((np.abs(b - a)
                            / np.maximum(np.abs(a), 1e-12)).max())
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_superstep_matches_jax(name):
    _, _, lengths, want = jax_superstep(name)
    tsess, got = port_superstep(name)
    np.testing.assert_array_equal(tsess._store.lengths.numpy(), lengths)
    assert tsess.iteration == N_INNER and tsess.state.step == N_INNER
    for field in want._fields:
        if tsess.cfg.bf16_activations:
            rtol = BF16_RTOL
        else:
            rtol = DEPTH_RTOL if field in DEPTH_WEIGHTED else METRIC_RTOL
        np.testing.assert_allclose(
            getattr(got, field).double().numpy(),
            np.asarray(getattr(want, field), np.float64), rtol=rtol,
            atol=1e-7, err_msg=field)
    print(f"{name}: last-step metrics, relative: {relative(want, got)}")


@pytest.mark.parametrize("variant", ["f32_storage", "skipped_update"])
def test_bf16_bound_rejects_wrong_supersteps(variant):
    """BF16_RTOL is tight enough to fail a `Config()` superstep that stores
    its activations in float32, or that leaves out one AdamW update."""
    _, _, _, want = jax_superstep("default")
    _, got = port_superstep("default", variant)
    worst = max(relative(want, got).values())
    assert worst > 2 * BF16_RTOL, worst


# ---------------------------------------------------------------------------
# the contract of the session's fast path, on the port alone

def small_session(n_inner=N_INNER, **kw) -> TrainingSession:
    cfg = Config()
    cfg.net_hyperparams.latent_dim = 16
    cfg.n_per_optim_bg = 60
    scene = make_scene(n_frames=2, width=32, height=24, n_categories=2,
                       insts_per_cat=2, seed=0)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    sess.enable_fast_path(n_inner, **kw)
    return sess


def test_run_fast_returns_metrics_later_steps_keep():
    sess = small_session()
    first = sess.run_fast(2)
    kept = [m.clone() for m in first]
    second = sess.run_fast(2)
    for x, y, z in zip(first, kept, second):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert x.data_ptr() != z.data_ptr()
    assert not torch.equal(first.total, second.total)


@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_run_fast_counts_steps(n):
    sess = small_session()
    sess.step_once()
    sess.run_fast(n)
    assert sess.iteration == 1 + n and sess.state.step == 1 + n


def test_run_fast_any_n():
    """7 steps as supersteps of 3 (3 + 3 + 1) take the same steps as 7
    supersteps of one step, and as one superstep of 7."""
    runs = [small_session(n_inner) for n_inner in (3, 1, 7)]
    metrics = [s.run_fast(7) for s in runs]
    for s, m in zip(runs[1:], metrics[1:]):
        for x, y in zip(m, metrics[0]):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        for p, q in zip(s.state.params.parameters(),
                        runs[0].state.params.parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=0)


def test_graph_on_cpu_session_raises():
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA session"):
        small_session(graph=True)


def test_graph_default_is_eager_on_cpu():
    sess = small_session()
    assert not sess._superstep.graph
    sess.run_fast(2)
    assert sess._superstep.captured == {}


def test_optimizer_not_capturable_on_cpu():
    sess = small_session()
    groups = sess.state.optimizer.param_groups
    assert len(groups) == 2 and not any(g["capturable"] for g in groups)


def test_replaced_state_needs_enable_again():
    sess = small_session()
    sess.state = make_train_state(sess.cfg, sess.state.params)
    with pytest.raises(RuntimeError, match="call it again"):
        sess.run_fast(1)
    sess.enable_fast_path(N_INNER)
    sess.run_fast(1)


def test_superstep_checks_window_pad_and_mode():
    """A store too short for the windows, and a graph on the CPU."""
    sess = small_session()
    short = build_device_store(sess.categories, sess.background,
                               window_pad=sess.n_per_cls - 1,
                               bg_window_pad=sess.cfg.n_per_optim_bg,
                               device="cpu")
    with pytest.raises(ValueError, match="window_pad"):
        make_superstep(None, short, sess.n_per_cls, sess.cfg.n_per_optim_bg,
                       N_INNER)
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA session"):
        make_superstep(None, sess._store, sess.n_per_cls,
                       sess.cfg.n_per_optim_bg, N_INNER, graph=True)


def test_superstep_records_offsets():
    """The superstep keeps the last step's window offsets: those drawn, or
    those injected."""
    sess = small_session()
    sess.run_fast(1)
    offs, boff = sess._superstep.offsets
    assert offs.shape == (2,) and boff.shape == ()
    assert bool((offs < sess._store.lengths).all())
    d = FastDraws(torch.zeros(2, dtype=torch.int64),
                  torch.tensor(5, dtype=torch.int64), sess._draws())
    sess.run_fast(1, draws=[d])
    assert sess._superstep.offsets[0] is d.offs


def test_launch_counts_under_capture():
    """A capture's launches come back out of the counts and are counted at
    each replay."""
    before = dict(fused_field.LAUNCHES)
    with fused_field.launches_captured() as captured:
        fused_field.LAUNCHES["codenerf_fwd"] += 1
        fused_field.LAUNCHES["occupancy_bwd"] += 2
    assert fused_field.LAUNCHES == before
    assert captured == {"codenerf_fwd": 1, "occupancy_bwd": 2}
    for _ in range(3):
        fused_field.count_replay(captured)
    assert fused_field.LAUNCHES["codenerf_fwd"] == before["codenerf_fwd"] + 3
    assert (fused_field.LAUNCHES["occupancy_bwd"]
            == before["occupancy_bwd"] + 6)
    fused_field.LAUNCHES.update(before)
