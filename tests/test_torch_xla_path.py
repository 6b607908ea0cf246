"""The port's XLA-path field modules against the JAX package's:
`embedding.frequency_bands / sinpi / cospi / apply`, `codenerf.apply /
apply_with_injections` and `occupancy.apply`, on the same inputs
(JAX-initialised weights, numpy draws), forward and gradients.

These are the modules of the strict-parity configuration
(`Config.apply_strict_parity()`: use_fused_kernels=False,
bf16_activations=False); the step itself on that configuration is held
against the JAX step in tests/test_torch_step.py. The same modules with bf16
activation storage (`act_dtype`) are held in tests/test_torch_bf16.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_tpu.models import codenerf as jcodenerf
from catnerf_tpu.models import embedding as jembedding
from catnerf_tpu.models import occupancy as joccupancy
from catnerf_torch import convert
from catnerf_torch.models import codenerf, embedding, occupancy
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap

torch.set_num_threads(1)

FWD_TOL = 1e-5
GRAD_TOL = 1e-5
# the weight gradients sum x^T d over every row, d of order 10-100 after
# the x10 sigma scale: two float32 summation orders then differ by ~1e-4 on
# elements that cancel; 2e-4 is the bound of the port's other gradient
# tests (test_torch_fused_field.py, test_torch_step.py)
LAYER_GRAD_TOL = 2e-4


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def test_frequency_bands_match_jax():
    np.testing.assert_array_equal(embedding.frequency_bands().numpy(),
                                  np.asarray(jembedding.frequency_bands()))
    np.testing.assert_array_equal(
        embedding.frequency_bands(1, 3).numpy(),
        np.asarray(jembedding.frequency_bands(1, 3)))


def _sinpi_args():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4000) * 40).astype(np.float32)
    # ties of round() (half to even) and signed parities
    edges = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.0, -0.0, 1.0, -1.0,
                      3.0, -3.0, 1e-8, 63.75, -63.75], np.float32)
    return np.concatenate([edges, x])


@pytest.mark.parametrize("name", ["sinpi", "cospi"])
def test_sinpi_cospi_match_jax(name):
    x = _sinpi_args()
    want = np.asarray(getattr(jembedding, name)(jnp.asarray(x)))
    got = getattr(embedding, name)(torch.tensor(x)).numpy()
    _close(got, want, 1e-6)
    # against the transcendental: the polynomial's own error
    ref = (np.sin if name == "sinpi" else np.cos)(np.pi * x.astype(np.float64))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_sinpi_gradient_is_the_custom_jvp():
    """d sinpi = pi cospi(x) dx (ref: embedding.py:119-122)."""
    x = _sinpi_args()
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jembedding.sinpi(v) * w))(
        jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (embedding.sinpi(xt) * torch.tensor(w)).sum().backward()
    _close(xt.grad, want, 1e-5)


@pytest.fixture(params=[True, False], ids=["fast_sinpi", "sin"])
def fast_sinpi(request, monkeypatch):
    """Both settings of the `_FAST_SINPI` switch, on both sides alike."""
    monkeypatch.setattr(jembedding, "_FAST_SINPI", request.param)
    monkeypatch.setattr(embedding, "_FAST_SINPI", request.param)
    return request.param


@pytest.mark.parametrize("lead", [(), (3,)], ids=["one", "stacked"])
def test_embedding_apply_and_grads_match_jax(fast_sinpi, lead):
    rng = np.random.default_rng(2)
    B = (np.broadcast_to(jembedding.ICOSAHEDRON_DIRS, lead + (21, 3))
         + 0.05 * rng.normal(size=lead + (21, 3))).astype(np.float32)
    x = rng.normal(size=lead + (40, 5, 3)).astype(np.float32)
    w = rng.normal(size=lead + (40, 5, 129)).astype(np.float32)

    def f(B, x):
        one = lambda b, p: jembedding.apply({"B": b}, p, scale=2.0)
        emb = jax.vmap(one)(B, x) if lead else one(B, x)
        return jnp.sum(emb * w), emb

    (_, want), (gB, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(B, x)
    pe = UniDirsEmbed(torch.tensor(B))
    xt = torch.tensor(x, requires_grad=True)
    got = embedding.apply(pe, xt, scale=2.0)
    (got * torch.tensor(w)).sum().backward()
    assert got.shape == want.shape == lead + (40, 5, 129)
    _close(got.detach(), want, FWD_TOL)
    _close(pe.B.grad, gB, 1e-4)  # sums of 200 rows x 126 slots, each O(30)
    _close(xt.grad, gx, 1e-4)


# (name, codenerf.init_params kwargs, do_cat): the shipped architecture and
# two the fused kernels do not take
CN_ARCHS = [
    ("shipped", dict(), True),
    ("w64_shape3_tex2", dict(W=64, shape_blocks=3, texture_blocks=2), True),
    ("no_cat", dict(), False),
]


@pytest.fixture(scope="module", params=CN_ARCHS, ids=lambda a: a[0])
def cn_case(request):
    """C=3 stacked CodeNeRFs on [C, R=20, Bt=6] points: JAX's vmapped
    `apply` (latents -> injections -> chain) and gradients of
    sum(sin(sigma)) + sum(rgb^2) w.r.t. every parameter and the embedding;
    the port's on the same inputs."""
    _, kw, do_cat = request.param
    C, L = 3, 16
    rng = np.random.default_rng(3)
    fc = _stack([jcodenerf.init_params(k, latent_dim=L, **kw)
                 for k in jax.random.split(jax.random.PRNGKey(3), C)])
    emb = rng.uniform(-1, 1, size=(C, 20, 6, 129)).astype(np.float32)
    sl = rng.normal(size=(C, 20, 1, L)).astype(np.float32)
    tl = rng.normal(size=(C, 20, 1, L)).astype(np.float32)

    def loss(fc, emb):
        s, r = jax.vmap(lambda p, e, a, b: jcodenerf.apply(
            p, e, a, b, do_cat=do_cat))(fc, emb, sl, tl)
        return jnp.sum(jnp.sin(s)) + jnp.sum(r * r), (s, r)

    (_, (s, r)), (gfc, gemb) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(fc, jnp.asarray(emb))
    tfc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    temb = torch.tensor(emb, requires_grad=True)
    ts, tr = codenerf.apply(tfc, temb, torch.tensor(sl), torch.tensor(tl),
                            do_cat=do_cat)
    (torch.sin(ts).sum() + (tr * tr).sum()).backward()
    return dict(jax=(s, r, gfc, gemb), torch=(ts, tr, tfc, temb))


def test_codenerf_apply_matches_jax(cn_case):
    s, r, _, _ = cn_case["jax"]
    ts, tr = cn_case["torch"][:2]
    assert ts.shape == s.shape and tr.shape == r.shape
    _close(ts.detach(), s, FWD_TOL)
    _close(tr.detach(), r, FWD_TOL)


def test_codenerf_grads_match_jax(cn_case):
    """Every layer, latent layers included, and the embedding."""
    _, _, gfc, gemb = cn_case["jax"]
    tfc, temb = cn_case["torch"][2:]
    jax.tree.map(lambda a, b: _close(b, a, LAYER_GRAD_TOL), gfc,
                 convert.tree_of(tfc, grads=True))
    _close(temb.grad, gemb, GRAD_TOL)


def test_apply_with_injections_matches_jax():
    """The step's call: injections [C, R, 1, w] against the embedding
    [C, R, Bt, 129] (train/step.py:158-160)."""
    C = 2
    rng = np.random.default_rng(4)
    fc = _stack([jcodenerf.init_params(k, latent_dim=8)
                 for k in jax.random.split(jax.random.PRNGKey(4), C)])
    emb = rng.uniform(-1, 1, size=(C, 10, 7, 129)).astype(np.float32)
    inj_s = np.maximum(rng.normal(size=(C, 10, 1, 96)), 0).astype(np.float32)
    inj_t = np.maximum(rng.normal(size=(C, 10, 1, 32)), 0).astype(np.float32)
    s, r = jax.vmap(jcodenerf.apply_with_injections)(fc, emb, inj_s, inj_t)
    tfc = CodeNeRF(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    ts, tr = codenerf.apply_with_injections(
        tfc, torch.tensor(emb), torch.tensor(inj_s), torch.tensor(inj_t))
    _close(ts.detach(), s, FWD_TOL)
    _close(tr.detach(), r, FWD_TOL)


# (name, init kwargs, apply kwargs): the shipped background and others
OC_ARCHS = [
    ("hidden128", dict(hidden_size=128), dict()),
    ("hidden64_blocks2", dict(hidden_size=64, hidden_layers_block=2), dict()),
    ("hidden32_no_cat", dict(hidden_size=32), dict(do_cat=False)),
    ("alpha_only", dict(hidden_size=32), dict(do_color=False)),
    ("color_only", dict(hidden_size=32), dict(do_alpha=False)),
]


@pytest.mark.parametrize("arch", OC_ARCHS, ids=lambda a: a[0])
def test_occupancy_apply_and_grads_match_jax(arch):
    _, init_kw, kw = arch
    rng = np.random.default_rng(5)
    fc = joccupancy.init_params(jax.random.PRNGKey(5), **init_kw)
    emb = rng.uniform(-1, 1, size=(30, 4, 129)).astype(np.float32)

    def loss(fc, emb):
        a, c = joccupancy.apply(fc, emb, **kw)
        total = jnp.sum(jnp.tanh(a)) if a is not None else 0.0
        total = total + (jnp.sum(c * c) if c is not None else 0.0)
        return total, (a, c)

    (_, (a, c)), (gfc, gemb) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(fc, jnp.asarray(emb))
    tfc = OccupancyMap(convert.layers_from_jax(jax.tree.map(np.asarray, fc)))
    temb = torch.tensor(emb, requires_grad=True)
    ta, tc = occupancy.apply(tfc, temb, **kw)
    assert (ta is None) == (a is None) and (tc is None) == (c is None)
    total = torch.tanh(ta).sum() if ta is not None else 0.0
    total = total + ((tc * tc).sum() if tc is not None else 0.0)
    total.backward()
    if a is not None:
        _close(ta.detach(), a, FWD_TOL)
    if c is not None:
        _close(tc.detach(), c, FWD_TOL)
    jax.tree.map(lambda g, t: _close(t, g, LAYER_GRAD_TOL), gfc,
                 convert.tree_of(tfc, grads=True))
    _close(temb.grad, gemb, GRAD_TOL)


def test_strict_parity_session_trains_on_the_xla_path():
    """A session in the strict-parity configuration runs host-staged and
    device-store steps through the XLA-path modules: finite losses, no
    kernel wrapper reached."""
    from catnerf_torch.config import Config
    from catnerf_torch.data.synthetic import make_scene
    from catnerf_torch.kernels import fused_field as ff
    from catnerf_torch.train import step as step_mod
    from catnerf_torch.train.loop import TrainingSession

    cfg = Config().apply_strict_parity()
    cfg.net_hyperparams.latent_dim = 16
    cfg.n_per_optim_bg = 60
    assert not step_mod.fused_eligible(cfg)
    scene = make_scene(n_frames=2, width=32, height=24, n_categories=2,
                       insts_per_cat=2, seed=0)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    before = dict(ff.LAUNCHES)
    totals = [float(sess.step_once().total) for _ in range(2)]
    sess.enable_fast_path(2)
    totals.append(float(sess.run_fast(2).total))
    assert all(np.isfinite(totals)) and sess.state.step == 4
    assert ff.LAUNCHES == before
