"""The host-staged step's packed staging (`catnerf_torch/train/packing.py`)
and its prefetch (`TrainingSession.step_once`, `release_prefetch`, `run`),
against the JAX package's `train/packing.py` and `train/loop.py`, on the
CPU: the same numpy batches, bitwise."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train import loop as loop_mod
from catnerf_torch.train import packing
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.step import BackgroundBatch, CategoryBatch

torch.set_num_threads(1)

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)


def _session(staging="packed", with_background=True):
    cfg = Config()
    cfg.seed = 0
    scene = make_scene(**SCENE)
    return TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, with_background=with_background,
                           device="cpu", staging=staging)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("with_background", [True, False])
def test_pack_is_the_jax_packages_buffer_bit_for_bit(with_background):
    """The spec and the flat buffer of a session's host batch equal the
    JAX package's, bit for bit (the int32 states and code-slot indices
    stored through a bit view, not cast)."""
    from catnerf_tpu.train import packing as jpacking

    sess = _session(with_background=with_background)
    cat_np, bg_np = sess.batcher.next_batch(sess.n_per_cls,
                                            sess.cfg.n_per_optim_bg)
    n_bg = sess.cfg.n_per_optim_bg
    spec = packing.make_spec(2, sess.n_per_cls, n_bg, with_background)
    jspec = jpacking.make_spec(2, sess.n_per_cls, n_bg, with_background)
    assert tuple(map(tuple, spec.cat_fields)) == tuple(
        map(tuple, jspec.cat_fields))
    assert tuple(map(tuple, spec.bg_fields)) == tuple(
        map(tuple, jspec.bg_fields))
    assert spec.total == jspec.total
    got = packing.pack(spec, cat_np, bg_np)
    want = jpacking.pack(jspec, cat_np, bg_np)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))
    f = next(f for f in spec.cat_fields if f.name == "obj_indices")
    np.testing.assert_array_equal(
        got[f.offset:f.offset + f.size].view(np.int32),
        cat_np["obj_indices"].reshape(-1))
    # into a given buffer, as the stager packs into its host buffers
    out = np.full(spec.total, np.nan, np.float32)
    packing.pack(spec, cat_np, bg_np, out=out)
    np.testing.assert_array_equal(_bits(out), _bits(want))


def test_pack_casts_other_dtypes_as_the_jax_package_does():
    """int64 states and float64 depths (the JAX package's
    test_spec_without_background): the same buffer, bit for bit."""
    from catnerf_tpu.train import packing as jpacking

    rng = np.random.default_rng(0)
    cat_np = {
        "rgbs": rng.random((3, 10, 3)).astype(np.float32),
        "states": np.arange(30, dtype=np.int64).reshape(3, 10),
        "depth": rng.random((3, 10)),
        "origins": rng.standard_normal((3, 10, 3)).astype(np.float32),
        "dirs": rng.standard_normal((3, 10, 3)).astype(np.float32),
        "obj_indices": np.ones((3, 10), np.int32),
    }
    spec = packing.make_spec(3, 10, 7, with_background=False)
    got = packing.pack(spec, cat_np, None)
    want = jpacking.pack(jpacking.make_spec(3, 10, 7, False), cat_np, None)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    cat, bg = packing.unpack(spec, torch.from_numpy(got))
    assert bg is None
    assert cat.states.dtype == torch.int32
    np.testing.assert_array_equal(cat.states.numpy(),
                                  cat_np["states"].astype(np.int32))
    np.testing.assert_array_equal(cat.depth.numpy(),
                                  cat_np["depth"].astype(np.float32))


def test_unpack_round_trips_bitwise():
    """unpack gives views of the one buffer with the per-field tensors'
    dtypes, shapes and bits; the int fields are float32 slices viewed as
    int32, and large indices (whose bits are a float32 denormal or NaN)
    come back unchanged."""
    sess = _session()
    cat_np, bg_np = sess.batcher.next_batch(sess.n_per_cls,
                                            sess.cfg.n_per_optim_bg)
    cat_np["obj_indices"] = cat_np["obj_indices"].copy()
    cat_np["obj_indices"].flat[:3] = [1, 2**31 - 1, -1]
    flat = torch.from_numpy(packing.pack(sess._pack_spec, cat_np, bg_np))
    cat, bg = packing.unpack(sess._pack_spec, flat)
    for got, (name, want) in zip(list(cat) + list(bg),
                                 list(cat_np.items()) + list(bg_np.items())):
        want = torch.from_numpy(np.ascontiguousarray(want))
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()
        assert torch.equal(got.view(-1).view(torch.int32),
                           want.reshape(-1).view(torch.int32)), name
    assert isinstance(cat, CategoryBatch) and isinstance(bg, BackgroundBatch)


def _record_steps(monkeypatch):
    """Spy on the step: each call's batch (cloned) as the step saw it."""
    seen = []
    train_step = loop_mod.step_mod.train_step

    def spy(state, cat, bg, draws, cfg, obj_mask):
        seen.append([t.clone() for t in (*cat, *bg)])
        return train_step(state, cat, bg, draws, cfg, obj_mask)

    monkeypatch.setattr(loop_mod.step_mod, "train_step", spy)
    return seen


def _params(sess) -> list[torch.Tensor]:
    return [p.detach().clone() for p in sess.state.params.parameters()]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def test_a_packed_step_once_equals_a_per_field_one_bitwise(monkeypatch):
    """One step on the same state and draws: per-field staging against
    the packed buffer gives the same batch, metrics and parameters, bit
    for bit."""
    seen = _record_steps(monkeypatch)
    fields, packed = _session("fields"), _session("packed")
    draws = fields._draws()
    m_fields = fields.step_once(draws)
    m_packed = packed.step_once(draws)
    packed.release_prefetch()
    assert _equal(seen[0], seen[1])
    assert _equal(list(m_fields), list(m_packed))
    assert _equal(_params(fields), _params(packed))


def test_prefetched_steps_see_the_same_batches_and_reach_the_same_state(
        monkeypatch):
    """Five packed steps, each with the next batch assembled on the
    worker while it runs, against five per-field steps that assemble
    their batch when they ask: the same batches in the same order, the
    same metrics and parameters, bit for bit. The epoch cursor runs one
    batch ahead while a batch is prefetched, and release_prefetch drops
    that batch, as the JAX package's does."""
    seen = _record_steps(monkeypatch)
    fields, packed = _session("fields"), _session("packed")
    n = 5
    m_f = [fields.step_once() for _ in range(n)]
    m_p = [packed.step_once() for _ in range(n)]
    assert packed._prefetch_fut is not None
    for a, b in zip(seen[:n], seen[n:]):
        assert _equal(a, b)
    for a, b in zip(m_f, m_p):
        assert _equal(list(a), list(b))
    assert _equal(_params(fields), _params(packed))
    packed.release_prefetch()
    assert packed._prefetch_fut is None and packed._prefetch_pool is None
    # the dropped batch: the next step takes the batch after it
    fields.batcher.next_batch(fields.n_per_cls, fields.cfg.n_per_optim_bg)
    fields.step_once()
    packed.step_once()
    packed.release_prefetch()
    assert _equal(seen[-2], seen[-1])


class _FakeRunner:
    """What `run` touches of a session, for the JAX package's `run`."""

    def __init__(self):
        self.iteration = 4  # a resumed session: marks are absolute
        self.released = 0

    def step_once(self):
        self.iteration += 1
        return self.iteration

    def metrics_to_dict(self, m):
        return {"iteration": self.iteration, "m": m}

    def release_prefetch(self):
        self.released += 1


@pytest.mark.parametrize("n_iters,every", [(7, 3), (6, 3), (1, 100),
                                           (0, 5)])
def test_run_calls_back_where_the_jax_run_does(n_iters, every):
    """`run`'s callback and history at the same iterations as the JAX
    package's `TrainingSession.run` (ref: train/loop.py:146-166): the
    multiples of callback_every and the run's last iteration; then the
    prefetched batch is released."""
    from catnerf_tpu.train.loop import TrainingSession as JSession

    out = {}
    for name, run in (("jax", JSession.run), ("torch", TrainingSession.run)):
        runner, marks = _FakeRunner(), []
        history = run(runner, n_iters,
                      callback=lambda it, m: marks.append((it, m)),
                      callback_every=every)
        out[name] = (marks, history, runner.released)
    assert out["torch"] == out["jax"]


def test_run_trains_n_steps_and_releases_the_prefetch():
    sess = _session()
    marks = []
    history = sess.run(3, callback=lambda it, m: marks.append(it),
                       callback_every=2)
    assert sess.iteration == 3 and marks == [2, 3]
    assert [h["iteration"] for h in history] == [2, 3]
    assert all(np.isfinite(h["total"]) for h in history)
    assert sess._prefetch_fut is None and sess._prefetch_pool is None


def test_staging_must_be_packed_or_fields():
    with pytest.raises(ValueError, match="packed or fields"):
        _session("pinned")


def test_the_prefetch_worker_keeps_the_cursors_order_under_stress(
        monkeypatch):
    """200 packed steps with the interpreter switching threads every
    microsecond (the step itself skipped: only staging is under test),
    a settle and a release in between: each step's batch is the one a
    twin session's epoch cursor gives, in order, through several
    reshuffles; a batch lost or staged twice would break the sequence."""
    import sys

    seen = []
    monkeypatch.setattr(loop_mod.step_mod, "train_step",
                        lambda state, cat, bg, *a: seen.append(
                            [t.clone() for t in (*cat, *bg)]))
    sess, twin = _session(), _session()
    want = []

    def expect(n):
        for _ in range(n):
            cat_np, bg_np = twin.batcher.next_batch(
                twin.n_per_cls, twin.cfg.n_per_optim_bg)
            want.append([torch.from_numpy(np.ascontiguousarray(v))
                         for v in (*cat_np.values(), *bg_np.values())])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(100):
            sess.step_once(draws=())
        sess.settle_prefetch()
        expect(100)
        for _ in range(50):
            sess.step_once(draws=())
        sess.release_prefetch()
        expect(51)   # the released batch is drawn, then dropped
        want.pop()
        for _ in range(50):
            sess.step_once(draws=())
        sess.release_prefetch()
        expect(50)
    finally:
        sys.setswitchinterval(interval)
    assert sess.batcher.categories[0].buffer.n < 100 * sess.n_per_cls
    assert len(seen) == len(want) == 200
    for i, (a, b) in enumerate(zip(seen, want)):
        assert _equal(a, b), i
