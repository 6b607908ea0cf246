"""The last public helpers of the JAX package's shared modules, in the port,
against their JAX counterparts on the CPU: `ops/sim3.py`'s batched
quat_to_rotation, tensor_to_sim3, invert_se3, origin_dirs_world and
origin_dirs_object; `ops/sampling.py`'s stratified_bins and
normal_bins_sampling (the port takes the uniforms the JAX function draws
from its key); `ops/render.py`'s render_loss and make_3d_grid; `utils.py`'s
reset_phase_timings, performance_measure, to8b, load_matrix_from_txt and
importance_sampling_coords (its uniforms injected the same way).

float32 on both sides: within 1e-6 relative (1e-5 where a general matrix
inverse or the normal inverse CDF is in the way); integer results and
byte outputs bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_tpu import utils as jutils
from catnerf_tpu.ops import render as jrender
from catnerf_tpu.ops import sampling as jsampling
from catnerf_tpu.ops import sim3 as jsim3
from catnerf_torch import utils as tutils
from catnerf_torch.ops import render as trender
from catnerf_torch.ops import sampling as tsampling
from catnerf_torch.ops import sim3 as tsim3

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _sim3_tensors(n=6, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rng.uniform(0.3, 2.0, size=(n, 1))
    t = rng.normal(size=(n, 3))
    return np.concatenate([s, q, t], -1).astype(np.float32)


def test_quat_to_rotation():
    q = _sim3_tensors()[:, 1:5] * 1.7  # not unit: two_s normalises
    _close(tsim3.quat_to_rotation(_t(q)), jsim3.quat_to_rotation(q))
    _close(tsim3.quat_to_rotation(_t(q[0])), jsim3.quat_to_rotation(q[0]))


def test_tensor_to_sim3_and_its_numpy_twin():
    t = _sim3_tensors().reshape(2, 3, 8)
    got = tsim3.tensor_to_sim3(_t(t))
    assert got.shape == (2, 3, 4, 4)
    _close(got, jsim3.tensor_to_sim3(t))
    _close(got[0, 0], tsim3.tensor_to_sim3_np(t[0, 0]), rtol=1e-5,
           atol=1e-6)


def test_invert_se3():
    t = _sim3_tensors(seed=1)
    t[:, 0] = 1.0  # rigid
    T = np.asarray(jsim3.tensor_to_sim3(t))
    got = tsim3.invert_se3(_t(T))
    _close(got, jsim3.invert_se3(T))
    _close(got @ _t(T), np.broadcast_to(np.eye(4), T.shape), atol=1e-5)


@pytest.mark.parametrize("frame", ["world", "object"])
def test_origin_dirs(frame):
    rng = np.random.default_rng(2)
    T = np.asarray(jsim3.tensor_to_sim3(_sim3_tensors(seed=2)))
    dirs = rng.normal(size=(T.shape[0], 3)).astype(np.float32)
    fn = "origin_dirs_world" if frame == "world" else "origin_dirs_object"
    got = getattr(tsim3, fn)(_t(T), _t(dirs))
    want = getattr(jsim3, fn)(jnp.asarray(T), jnp.asarray(dirs))
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-5, atol=1e-5)


def test_stratified_bins_on_the_jax_draw():
    rng = np.random.default_rng(3)
    n, n_bins = 50, 12
    lo = rng.uniform(0.1, 0.5, n).astype(np.float32)
    hi = lo + rng.uniform(0.5, 3.0, n).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jsampling.stratified_bins(key, jnp.asarray(lo), jnp.asarray(hi),
                                     n_bins)
    u = jax.random.uniform(key, (n, n_bins))
    got = tsampling.stratified_bins(_t(u), _t(lo), _t(hi))
    _close(got, want)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


def test_normal_bins_sampling_on_the_jax_draw():
    rng = np.random.default_rng(5)
    n, n_bins, delta = 50, 10, 0.05
    depth = rng.uniform(0.5, 3.0, n).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jsampling.normal_bins_sampling(key, jnp.asarray(depth), n_bins,
                                          delta)
    u = jax.random.uniform(key, (n, n_bins + 1))
    got = tsampling.normal_bins_sampling(_t(u), _t(depth), delta)
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert float((got - _t(depth)[:, None]).abs().max()) <= delta + 1e-6


@pytest.mark.parametrize("loss,normalise", [("L1", False), ("L2", False),
                                            ("L1", True), ("L2", True)])
def test_render_loss(loss, normalise):
    rng = np.random.default_rng(7)
    a = rng.normal(size=(3, 40)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, size=(3, 40)).astype(np.float32)
    _close(trender.render_loss(_t(a), _t(b), loss, normalise),
           jrender.render_loss(a, b, loss, normalise))


def test_render_loss_unknown_type_raises():
    x = torch.zeros(2)
    with pytest.raises(NotImplementedError, match="Huber"):
        trender.render_loss(x, x, "Huber")


@pytest.mark.parametrize("affine", [False, True])
def test_make_3d_grid(affine):
    kw = {}
    if affine:
        T = np.asarray(jsim3.tensor_to_sim3(_sim3_tensors(1, seed=8)[0]))
        kw = dict(transform=T, scale=np.array([0.5, 1.0, 2.0], np.float32))
    want = jrender.make_3d_grid((-1.0, 1.0), 9, **kw)
    got = trender.make_3d_grid((-1.0, 1.0), 9,
                               **{k: _t(v) for k, v in kw.items()})
    assert got.shape == (9, 9, 9, 3)
    _close(got, want, rtol=1e-6, atol=1e-6)


def test_phase_reset_of_one_group_and_of_all():
    tutils.phase_add("a_group", "x", 1.0)
    tutils.phase_add("b_group", "y", 2.0)
    tutils.reset_phase_timings("a_group")
    assert tutils.phase_timings("a_group") == {}
    assert tutils.phase_timings("b_group") == {"y": 2.0}
    tutils.reset_phase_timings()
    assert tutils.phase_timings("b_group") == {}


def test_performance_measure_prints_as_the_jax_package(capsys):
    with tutils.performance_measure("block"):
        pass
    mine = capsys.readouterr().out
    with jutils.performance_measure("block"):
        pass
    theirs = capsys.readouterr().out
    assert mine.startswith("block execution time: ") and mine.endswith(
        " ms\n")
    assert theirs.split(":")[0] == mine.split(":")[0]


def test_to8b_and_load_matrix_from_txt(tmp_path):
    x = np.random.default_rng(9).uniform(-0.5, 1.5, (4, 5, 3))
    got = tutils.to8b(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jutils.to8b(x))
    M = np.random.default_rng(10).normal(size=(4, 4))
    path = tmp_path / "m.txt"
    np.savetxt(path, M)
    np.testing.assert_array_equal(tutils.load_matrix_from_txt(str(path)),
                                  jutils.load_matrix_from_txt(str(path)))


@pytest.mark.parametrize("det", [False, True])
def test_importance_sampling_coords(det):
    rng = np.random.default_rng(11)
    w = rng.uniform(0, 1, (6, 16)).astype(np.float32)
    w[0] = 0.0  # all weight from the 1e-5 floor
    key = jax.random.PRNGKey(12)
    inds, u, cdf = jutils.importance_sampling_coords(key, jnp.asarray(w), 20,
                                                     det=det)
    got = tutils.importance_sampling_coords(_t(w), 20,
                                            None if det else _t(u))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(inds))
    _close(got[1], u)
    _close(got[2], cdf)
