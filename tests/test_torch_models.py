"""The port's model and op functions against the JAX package's, on the
same inputs (JAX-initialised weights, numpy draws, JAX's uniforms
injected into the sampler)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.models import codenerf as jcodenerf
from catnerf_tpu.models import codes as jcodes
from catnerf_tpu.ops import losses as jlosses
from catnerf_tpu.ops import sampling as jsampling
from catnerf_tpu.train import state as jstate
from catnerf_tpu.train.step import _gather_injections
from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.models import codenerf, codes
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.ops import losses, sampling
from catnerf_torch.train import step as tstep
from catnerf_torch.train.state import FieldParams

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.fixture(scope="module")
def stacked_fc():
    C, L = 2, 32
    return jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jcodenerf.init_params(k, latent_dim=L)
        for k in jax.random.split(jax.random.PRNGKey(3), C)])


def test_project_codes_matches_jax(stacked_fc):
    rng = np.random.default_rng(0)
    shape = rng.normal(size=(2, 3, 32)).astype(np.float32)
    tex = rng.normal(size=(2, 3, 32)).astype(np.float32)
    js, jt = jax.vmap(jcodenerf.project_codes)(stacked_fc, shape, tex)
    fc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray,
                                                       stacked_fc)))
    ts, tt = codenerf.project_codes(fc, _t(shape), _t(tex))
    _close(ts.detach(), js, 1e-6)
    _close(tt.detach(), jt, 1e-6)


def test_onehot_injection_lookup_equals_jax_exactly():
    rng = np.random.default_rng(1)
    inj_s = rng.normal(size=(3, 4, 96)).astype(np.float32)
    inj_t = rng.normal(size=(3, 4, 32)).astype(np.float32)
    idx = rng.integers(0, 4, size=(3, 50)).astype(np.int32)
    js, jt = _gather_injections(jnp.asarray(inj_s), jnp.asarray(inj_t),
                                jnp.asarray(idx))
    ts, tt = tstep.gather_injections(_t(inj_s), _t(inj_t), _t(idx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(),
                                  np.take_along_axis(inj_s, idx[..., None],
                                                     axis=1))


def _rays(rng, n, n_cls=None):
    lead = (n,) if n_cls is None else (n_cls, n)
    depth = rng.uniform(0.5, 4.0, size=lead).astype(np.float32)
    depth[..., ::7] = 0.0  # invalid-depth rays
    return dict(
        rgbs=rng.uniform(size=lead + (3,)).astype(np.float32),
        states=rng.integers(0, 3, size=lead).astype(np.int32),
        depth=depth,
        origins=rng.normal(size=lead + (3,)).astype(np.float32),
        dirs=rng.normal(size=lead + (3,)).astype(np.float32))


@pytest.mark.parametrize("c2s", [1, 5])
def test_sample_3d_points_matches_jax_with_injected_draws(c2s):
    cfg = Config()
    rng = np.random.default_rng(c2s)
    n_cls, n = 3, 64
    rays = _rays(rng, n, n_cls)
    kw = dict(n_bins_cam2surface=c2s, n_bins=cfg.n_bins,
              min_depth=cfg.min_depth, surface_eps=cfg.surface_eps,
              stop_eps=cfg.stop_eps)
    n_u = sampling.n_uniforms(c2s, cfg.n_bins)
    keys = jax.random.split(jax.random.PRNGKey(5), n_cls)
    j = jax.vmap(lambda k, r, s, d, o, di: jsampling.sample_3d_points(
        k, r, s, d, o, di, **kw))(keys, *(rays[k] for k in
                                          ("rgbs", "states", "depth",
                                           "origins", "dirs")))
    u = jax.vmap(lambda k: jax.random.uniform(k, (n, n_u)))(keys)
    t = sampling.sample_3d_points(_t(u), *(_t(rays[k]) for k in
                                           ("rgbs", "states", "depth",
                                            "origins", "dirs")), **kw)
    _close(t.z_vals, j.z_vals, 1e-6)
    _close(t.input_pcs, j.input_pcs, 1e-6)
    np.testing.assert_array_equal(t.valid_depth_mask.numpy(),
                                  np.asarray(j.valid_depth_mask))


def test_sorted_normal_clip_keeps_samples_finite():
    """u at the f32 edges would give erfinv(+-1) = inf without the 2^-22
    clip (ref: sampling.py:45-53)."""
    u = torch.tensor([[1.0, 1e-30, 1e-30, 1e-30], [1e-30, 1.0, 1.0, 1.0]])
    z = sampling._sorted_normal_from_u(u, torch.tensor([2.0, 2.0]), 0.1, 0.3)
    assert torch.isfinite(z).all()


@pytest.fixture(scope="module")
def loss_inputs():
    rng = np.random.default_rng(7)
    m, r, b = 3, 40, 10
    states = rng.integers(0, 3, size=(m, r)).astype(np.int32)
    return dict(
        alpha=rng.normal(size=(m, r, b)).astype(np.float32) * 3,
        color=rng.uniform(size=(m, r, b, 3)).astype(np.float32),
        gt_depth=rng.uniform(0.5, 3, size=(m, r)).astype(np.float32),
        gt_color=rng.uniform(size=(m, r, 3)).astype(np.float32),
        sem_labels=states,
        mask_depth=rng.uniform(size=(m, r)) > 0.2,
        z_vals=np.sort(rng.uniform(0.1, 4, size=(m, r, b)),
                       -1).astype(np.float32))


def test_step_batch_loss_matches_jax(loss_inputs):
    j = jlosses.step_batch_loss(**{k: jnp.asarray(v)
                                   for k, v in loss_inputs.items()})
    t = losses.step_batch_loss(**{k: _t(v) for k, v in loss_inputs.items()})
    for a, b in zip(t, j):
        _close(a, b, 1e-6 * max(1.0, float(np.abs(np.asarray(b)).max())))


def test_step_batch_loss_empty_mask_zeroes_batch(loss_inputs):
    """Any all-empty mask zeroes the whole batch (render.py:86-87)."""
    li = dict(loss_inputs)
    li["sem_labels"] = li["sem_labels"].copy()
    li["sem_labels"][1] = 0  # category 1: no object ray
    t = losses.step_batch_loss(**{k: _t(v) for k, v in li.items()})
    assert float(t.color.abs().sum()) == 0.0
    assert float(t.depth.abs().sum()) == 0.0


def test_code_reg_loss_matches_jax():
    rng = np.random.default_rng(2)
    n_objs = [3, 1, 2]
    shape = rng.normal(size=(3, 3, 16)).astype(np.float32)
    tex = rng.normal(size=(3, 3, 16)).astype(np.float32)
    mask_j = jcodes.obj_validity_mask(n_objs)
    mask_t = codes.obj_validity_mask(n_objs)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    js, jt = jlosses.code_reg_loss(shape, tex, mask_j)
    ts, tt = losses.code_reg_loss(_t(shape), _t(tex), mask_t)
    _close(ts, js, 1e-6 * 10)
    _close(tt, jt, 1e-6 * 10)
    assert float(ts[1]) == 0.0  # a single-instance category adds nothing


def test_psnr_from_l1_matches_jax():
    x = np.array([0.05, 0.3, 1.7], np.float32)
    _close(losses.psnr_from_l1(_t(x)), jlosses.psnr_from_l1(x), 1e-5)


def test_param_tree_matches_jax_layout_and_round_trips():
    """FieldParams.init has the JAX init's tree and shapes, and
    params_from_jax / params_to_numpy round-trip exactly."""
    jcfg, cfg = JConfig(), Config()
    jcfg.net_hyperparams.latent_dim = cfg.net_hyperparams.latent_dim = 32
    n_objs = [2, 1]
    jp = jstate.init_train_state(jax.random.PRNGKey(0), jcfg, n_objs).params
    tp = FieldParams.init(torch.Generator().manual_seed(0), cfg, n_objs)
    tree = convert.params_to_numpy(tp)
    assert (jax.tree.structure(jax.tree.map(np.asarray, jp))
            == jax.tree.structure(tree))
    jax.tree.map(lambda a, b: np.testing.assert_equal(np.shape(a),
                                                      np.shape(b)), jp, tree)
    back = convert.params_to_numpy(convert.params_from_jax(jp))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 jp, back)
