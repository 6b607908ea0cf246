"""The port's multi-process layer (`catnerf_torch/parallel/`: DP over rays
x EP over categories on torch.distributed) against the JAX package's
single-device step and its own unsharded paths, mirroring the JAX
package's tests/test_parallel.py on gloo ranks on the CPU.

The ranks are spawned processes (tests/torch_parallel_ranks.py), joined by
a FileStore under tmp_path, one thread each, importing no jax; the JAX
side runs here. Spawns: world 4 (the 2 x 2 and 4 x 1 steps, the superstep,
the session and its checkpoint), world 2 (the 2 x 1 and 1 x 2 steps, grid
evaluation, meshes, a scene render, the checkpoint restored sharded,
adoption into sharded sessions), world 1 (the 1 x 1 step and superstep,
bitwise), and two ranks under `torch.distributed.run` for the CLI.

Bounds:
- against the JAX package's unjitted step (tests/test_torch_step.py's
  inputs and bounds): the loss and every metric within METRIC_RTOL = 1e-5
  relative (atol 1e-7), the batch with its ReLU ties shifted away;
- against the port's unsharded step on the same draws: every metric
  within 1e-6 relative (the sums over rays are split between ranks), the
  parameters after the update by the JAX package's own rule
  (tests/test_parallel.py:85-97: rtol 5e-3, atol 2e-4, mean |diff| under
  2e-5);
- bitwise: the 1 x 1 sharded step and superstep against the unsharded
  ones, `sample_batch`'s two gather modes against JAX's on the same
  indices, grid evaluation, `.obj` files and scene renders against the
  unsharded port, checkpoints across layouts, adoption into and restores
  of adopted checkpoints into 1 x 2 and 2 x 1 sessions against the
  unsharded port's (held to the JAX package's by tests/test_torch_fit.py).
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data import device_buffer as jdb
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu import fit as jfit
from catnerf_tpu.experimental import fused_field as jff
from catnerf_tpu.train import step as jstep
from catnerf_tpu.train.loop import TrainingSession as JSession
from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data import device_buffer as tdb
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train import checkpoint as ckpt
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state, state_dict
from test_torch_render_views import _soften
from test_torch_superstep import BF16_RTOL
from test_torch_step import (METRIC_RTOL, SCENE, _configure, _jbatch,
                             _sessions, _untie_relus, jax_draws)
from torch_parallel_ranks import (SCENE5, _adopt, fused_config, launch,
                                  render_frame0, session, small_config)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
UNSHARDED_RTOL = 1e-6


def _np(t):
    return t.detach().double().numpy()


@functools.cache
def step_inputs():
    """Seed 0's batch and draws, the port's ReLU ties shifted away, and
    the JAX initial weights (tests/test_torch_step.py's one step): what
    the ranks get; and the JAX session."""
    jsess, tsess = _sessions(0)
    cat_np, bg_np = jsess.batcher.next_batch(jsess.n_per_cls,
                                             jsess.cfg.n_per_optim_bg)
    draws = jax_draws(jsess, 0)
    _untie_relus(tsess, cat_np, bg_np, draws)
    payload = {"params0": jax.tree.map(np.asarray, jsess.state.params),
               "cat": cat_np, "bg": bg_np, "u_cat": draws.cat.numpy(),
               "u_bg": draws.bg.numpy()}
    return payload, jsess


@functools.cache
def jax_metrics():
    """The JAX package's unjitted single-device step on those inputs (its
    Pallas kernels jitted, as tests/test_torch_step.py runs them)."""
    payload, jsess = step_inputs()
    with pytest.MonkeyPatch.context() as mp:
        for name in ("codenerf_fused_apply", "occupancy_fused_apply"):
            mp.setattr(jff, name, jax.jit(getattr(jff, name),
                                          static_argnames=("scale",
                                                           "interpret")))
        train_step = jstep.make_train_step(jsess.cfg, jsess.obj_mask,
                                           jit=False)
        _, jm = train_step(jsess.state,
                           _jbatch(jstep.CategoryBatch, payload["cat"]),
                           _jbatch(jstep.BackgroundBatch, payload["bg"]),
                           jsess.base_key)
    return jax.tree.map(np.asarray, jm)


@functools.cache
def adoption_inputs():
    """The adoption checks' records, codes and weights: rec (its codes
    `codes`) into the first category, rec2 (`codes2`) into the second,
    each at the pose and extent of the category's first instance, so that
    the adoptee shows in frame 0; the JAX initial weights with each
    occupancy head softened (tests/test_torch_render_views.py `_soften`),
    so that objects show in a composite at all; and the JAX session
    holding them."""
    jsess, _ = _sessions(0)
    _soften(jsess, -0.3)
    tsess = session(fused_config())
    rng = np.random.default_rng(20)
    recs, codes = [], []
    for i, inst_id in ((0, 90), (1, 91)):
        cat = tsess.categories[i]
        first = cat.obj_ids[0]
        recs.append({"cls": tsess.cls_ids[i], "id": inst_id,
                     "extent": np.asarray(cat.extent_dict[first]).tolist(),
                     "obj_tensor": np.asarray(
                         cat.object_tensor_dict[first]).tolist()})
        codes.append(tuple(rng.normal(0, 0.3, 32).astype(np.float32)
                           for _ in range(2)))
    return {"rec": recs[0], "codes": codes[0], "rec2": recs[1],
            "codes2": codes[1],
            "params": jax.tree.map(np.asarray, jsess.state.params)}, jsess


def adopted_checkpoint(ckpt_dir: str) -> str:
    """The port's unsharded session on the JAX initial weights, one step
    (the AdamW moments non-zero), rec adopted, saved with its sidecar."""
    payload, _ = step_inputs()
    inputs, _ = adoption_inputs()
    cfg = fused_config()
    sess = session(cfg)
    sess.state = make_train_state(cfg,
                                  convert.params_from_jax(payload["params0"]))
    sess.step_once()
    sess.release_prefetch()
    _adopt(sess, inputs["rec"], inputs["codes"])
    return ckpt.save_session_checkpoint(ckpt_dir, sess, sess.iteration)


@functools.cache
def jax_adopted_step():
    """rec adopted into the JAX session on the softened weights, then the
    JAX package's unjitted step on the step inputs (as jax_metrics): its
    metrics, the parameters after it (the port's names) and obj_mask."""
    payload, _ = step_inputs()
    inputs, jsess = adoption_inputs()
    jfit._adopt_slot(jsess, inputs["rec"], *inputs["codes"])
    with pytest.MonkeyPatch.context() as mp:
        for name in ("codenerf_fused_apply", "occupancy_fused_apply"):
            mp.setattr(jff, name, jax.jit(getattr(jff, name),
                                          static_argnames=("scale",
                                                           "interpret")))
        train_step = jstep.make_train_step(jsess.cfg, jsess.obj_mask,
                                           jit=False)
        state, jm = train_step(jsess.state,
                               _jbatch(jstep.CategoryBatch, payload["cat"]),
                               _jbatch(jstep.BackgroundBatch, payload["bg"]),
                               jsess.base_key)
    params = convert.params_from_jax(jax.tree.map(np.asarray, state.params))
    return (jax.tree.map(np.asarray, jm), params.state_dict(),
            np.asarray(jsess.obj_mask))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn, in order: world 4, then world 2 (which restores world
    4's checkpoint and an adopted one), then world 1; {world: {check:
    [each rank's]}}. The JAX steps run here meanwhile."""
    payload, _ = step_inputs()
    inputs, _ = adoption_inputs()
    out = {}

    def spawns():
        for world in (4, 2, 1):
            arg = payload
            tmp = str(tmp_path_factory.mktemp(f"w{world}"))
            if world == 2:
                adopt = {**inputs, "ckpt": adopted_checkpoint(
                    os.path.join(tmp, "adopted"))}
                adopt.update({k: payload[k]
                              for k in ("cat", "bg", "u_cat", "u_bg")})
                arg = {"step": payload,
                       "path": out[4]["session"][0]["path"],
                       "adopt": adopt}
                out["adopted_ckpt"] = adopt["ckpt"]
            ranks = launch(f"world{world}", world, tmp, arg)
            out[world] = {k: [r[k] for r in ranks] for k in ranks[0]}

    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawns)
        jax_metrics()
        jax_adopted_step()
        done.result()
    return out


# ---------------------------------------------------------------------------
# make_mesh (tests/test_parallel.py:33-48)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [1, 2, 4])
def test_make_mesh_shapes_and_errors(runs, world):
    r = runs[world]["mesh_errors"][0]
    assert r["shape"] == (world, 1)
    if world > 1:
        assert r["shape_model"] == (1, world)
    err = r["errors"]
    assert "does not divide" in err["n_model=3"]
    assert "n_model" in err["n_model=0"]
    assert "devices" in err["too big"]
    if world > 1:
        assert "covers 1 of the" in err["too small"]
    else:
        assert err["too small"] is None


# ---------------------------------------------------------------------------
# The sharded step (tests/test_parallel.py:61-111)
# ---------------------------------------------------------------------------

MESHES = [(1, (1, 1)), (2, (2, 1)), (2, (1, 2)), (4, (4, 1)), (4, (2, 2))]


def _mesh_run(runs, world, shape, rank=0):
    return runs[world]["steps"][rank]["meshes"][shape]


@pytest.mark.parametrize("world,shape", MESHES, ids=str)
def test_sharded_step_matches_unsharded(runs, world, shape):
    ref = runs[world]["steps"][0]["ref"]
    got = _mesh_run(runs, world, shape)
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(_np(got["metrics"][k]), _np(want),
                                   rtol=UNSHARDED_RTOL, atol=1e-7,
                                   err_msg=k)
    for k, want in ref["state"]["params"].items():
        a, b = _np(want), _np(got["state"]["params"][k])
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=2e-4, err_msg=k)
        assert np.mean(np.abs(a - b)) < 2e-5, (k, np.mean(np.abs(a - b)))


def test_one_by_one_step_is_bitwise_the_unsharded_step(runs):
    ref = runs[1]["steps"][0]["ref"]
    got = _mesh_run(runs, 1, (1, 1))
    for k in ref["metrics"]:
        assert torch.equal(ref["metrics"][k], got["metrics"][k]), k
    for k in ref["state"]["params"]:
        assert torch.equal(ref["state"]["params"][k],
                           got["state"]["params"][k]), k
    moments = ref["state"]["optimizer"]["state"]
    assert moments
    for i, st in moments.items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                got["state"]["optimizer"]["state"][i][k])), (i, k)


@pytest.mark.parametrize("world,shape", [(4, (2, 2)), (2, (1, 2))], ids=str)
def test_sharded_step_matches_jax(runs, world, shape):
    """The 2 x 2 and 1 x 2 steps against the JAX package's single-device
    step, under tests/test_torch_step.py's bounds."""
    jm = jax_metrics()
    got = _mesh_run(runs, world, shape)["metrics"]
    for field in jstep.StepMetrics._fields:
        np.testing.assert_allclose(_np(got[field]),
                                   np.asarray(getattr(jm, field)),
                                   rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=field)


@pytest.mark.parametrize("world,shape", MESHES[1:], ids=str)
def test_state_placement_and_replicated_background(runs, world, shape):
    """Each rank holds its categories' slices as its own tensors, the
    background whole; after 3 more steps the background (and every
    parameter not stacked) is bitwise equal on every rank."""
    n_data, n_model = shape
    for rank in range(world):
        r = _mesh_run(runs, world, shape, rank)
        assert r["placed"] and r["own"]
        assert r["local_shapes"]["codes.shape"][0] == 2 // n_model
        assert r["local_shapes"]["cat_fc.cat_layer.w"][0] == 2 // n_model
        assert r["coords"] == (rank // n_model, rank % n_model)
        assert r["bg_equal"]


# ---------------------------------------------------------------------------
# The sharded superstep (tests/test_parallel.py:129-167)
# ---------------------------------------------------------------------------

def test_sharded_superstep_trains(runs):
    """20 steps: the loss falls (the JAX test's opacity rule does not
    hold on the port's draws, sharded or not, with 16 rays a category);
    the first 4 steps' metrics agree with the unsharded superstep's on the
    same draws within tests/test_torch_superstep.py's bound for `Config()`
    (bf16 storage; 1.5e-4 read); every rank holds the whole step's
    metrics."""
    r = runs[4]["superstep"][0]
    assert r["step"] == 20
    assert r["store_rows"][0] == 1  # the rank's category only
    got, want = r["got"], r["want"]
    assert all(np.isfinite(float(m["total"])) for m in got)
    assert float(got[-1]["total"]) < 0.5 * float(got[0]["total"])
    for k in got[0]:
        np.testing.assert_allclose(_np(got[0][k]), _np(want[0][k]),
                                   rtol=BF16_RTOL, atol=1e-7, err_msg=k)
    for other in runs[4]["superstep"][1:]:
        assert all(torch.equal(other["got"][-1][k], got[-1][k])
                   for k in got[-1])


@pytest.mark.parametrize("kind", ["fused", "default"])
def test_one_by_one_superstep_is_bitwise_run_fast(runs, kind):
    r = runs[1]["superstep"][0][kind]
    assert r["n_moments"] > 0
    assert r["metrics"] and r["params"] and r["moments"]


@functools.cache
def _stores():
    js = jmake_scene(**SCENE)
    jsess = JSession(_configure(JConfig()), js.inst_dict, js.sample_dict,
                     cam=js.cam)
    jstore = jdb.build_device_store(jsess.categories, jsess.background)
    ts = make_scene(**SCENE)
    tsess = TrainingSession(_configure(Config()), ts.inst_dict,
                            ts.sample_dict, cam=ts.cam, device="cpu")
    tstore = tdb.build_device_store(tsess.categories, tsess.background,
                                    window_pad=0, bg_window_pad=0,
                                    device="cpu")
    return jstore, tstore


@pytest.mark.parametrize("per_category", [False, True])
def test_row_draw_gathers_match_jax(per_category):
    """sample_batch(window=False), flat and per-category, bitwise equal to
    the JAX package's sample_batch on the same row indices (JAX's randint
    draws from its key, injected into the port)."""
    jstore, tstore = _stores()
    key = jax.random.PRNGKey(11)
    n, n_bg = 64, 96
    jcat, jbg = jdb.sample_batch(jstore, key, n, n_bg,
                                 per_category_gather=per_category)
    k_cat, k_bg = jax.random.split(key)
    idx = jax.random.randint(k_cat, (jstore.packed.shape[0], n), 0,
                             jstore.lengths[:, None])
    bidx = jax.random.randint(k_bg, (n_bg,), 0, jstore.bg_length)
    tcat, tbg = tdb.sample_batch(
        tstore, n, n_bg, torch.tensor(np.asarray(idx), dtype=torch.int64),
        torch.tensor(np.asarray(bidx), dtype=torch.int64), window=False,
        per_category_gather=per_category)
    for a, b in zip(jcat, tcat):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(jbg, tbg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_row_draw_stays_in_each_buffer():
    _, tstore = _stores()
    gen = torch.Generator().manual_seed(0)
    idx, bidx = tdb.draw_rows(tstore.lengths, tstore.bg_length, 500, 500,
                              gen, tstore.max_length)
    assert idx.shape == (tstore.lengths.shape[0], 500)
    assert bool((idx >= 0).all()) and bool(
        (idx < tstore.lengths[:, None]).all())
    assert int(bidx.max()) < tstore.bg_length and int(bidx.min()) >= 0


# ---------------------------------------------------------------------------
# Collective volume, structural (tests/test_parallel.py:170-261)
# ---------------------------------------------------------------------------

def _volume(runs, world, shape):
    """(total bytes, biggest, ops, shapes) one rank handed to collectives
    in one step."""
    tally = _mesh_run(runs, world, shape)["tally"]
    return (sum(b for _, _, b, _ in tally), max(b for _, _, b, _ in tally),
            {op for op, _, _, _ in tally}, [s for _, _, _, s in tally])


def test_collective_volume(runs):
    """Only gradients, mask counts and scalar metrics cross, never a
    ray-batch-sized tensor; the volume stays constant as 'data' grows
    1 -> 2 -> 4 and falls when the categories are sharded (2 x 2 against
    4 x 1)."""
    param_bytes = runs[1]["steps"][0]["param_bytes"]
    v1, big1, ops1, shapes1 = _volume(runs, 1, (1, 1))
    v2, _, ops2, _ = _volume(runs, 2, (2, 1))
    v4, big4, ops4, shapes4 = _volume(runs, 4, (4, 1))
    vep, _, opsep, _ = _volume(runs, 4, (2, 2))
    assert ops1 == ops2 == ops4 == opsep == {"all_reduce"}
    assert v1 == v2 == v4, (v1, v2, v4)
    assert v4 < 1.15 * param_bytes, (v4, param_bytes)
    assert big4 <= param_bytes
    assert vep < v4, (vep, v4)
    n_rays = step_inputs()[0]["cat"]["depth"].shape[1]
    for s in shapes1 + shapes4:
        assert len(s) <= 2 and n_rays not in s and n_rays // 4 not in s, s


# ---------------------------------------------------------------------------
# Grid evaluation, meshes, renders (tests/test_parallel.py:264-380)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["cat", "bg"])
def test_sharded_grid_eval_is_bitwise(runs, field):
    for rank in (0, 1):
        assert runs[2]["evaluation"][rank]["grid_eval"][field]


def test_sharded_meshes_are_byte_identical(runs):
    one, many, same = runs[2]["evaluation"][0]["meshes"]
    assert one == many and len(one) >= 1
    assert all(same)


def test_sharded_scene_render_is_pixel_identical(runs):
    for rank in (0, 1):
        assert runs[2]["evaluation"][rank]["render"] == [True] * 3


# ---------------------------------------------------------------------------
# The session and its checkpoints (tests/test_parallel.py:383-413)
# ---------------------------------------------------------------------------

def test_session_sharded_fast_path(runs):
    r = runs[4]["session"][0]
    assert r["local_rows"] == 1 and r["store_cats"] == 1
    assert r["it1"] == 8 and r["it2"] == 16 and r["step"] == 16
    assert np.isfinite(r["total1"]) and np.isfinite(r["total2"])
    assert r["total2"] < r["total1"] * 1.5
    assert "model" in r["model_error"]


def _state_equal(a: dict, b: dict) -> None:
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                b["optimizer"]["state"][i][k])), (i, k)
    assert a["step"] == b["step"]


def test_sharded_checkpoint_restores_unsharded(runs):
    r = runs[4]["session"][0]
    assert all(x["path"] == r["path"] for x in runs[4]["session"])
    sess = TrainingSession(small_config(), *_scene5(), device="cpu")
    ckpt.restore_session_checkpoint(r["path"], sess)
    assert sess.iteration == r["iteration"] == 16
    from catnerf_torch.train.state import state_dict

    _state_equal(r["gathered"], state_dict(sess.state))


def test_sharded_checkpoint_restores_into_another_layout(runs):
    r = runs[4]["session"][0]
    for rank in (0, 1):
        got = runs[2]["evaluation"][rank]
        assert got["local_rows"] == 2 and got["restored_iteration"] == 16
        _state_equal(r["gathered"], got["restored"])


def _scene5():
    s = make_scene(**SCENE5)
    return s.inst_dict, s.sample_dict, s.cam


# ---------------------------------------------------------------------------
# Adoption into a sharded session
# ---------------------------------------------------------------------------

ADOPT_MESHES = [(2, 1), (1, 2)]


def _adoption(runs, shape, rank=0):
    return runs[2]["adoption"][rank][shape]


def _unsharded(params=None, ckpt_path=None):
    """The port's unsharded session of the adoption checks: on `params`
    (JAX numpy leaves), or restored from `ckpt_path`."""
    cfg = fused_config()
    sess = session(cfg)
    if params is not None:
        sess.state = make_train_state(cfg, convert.params_from_jax(params))
    if ckpt_path is not None:
        ckpt.restore_session_checkpoint(ckpt_path, sess)
    return sess


@functools.cache
def unsharded_adoption():
    """rec adopted into the unsharded session on the softened weights:
    its state, obj_mask, records and the frame-0 render after it (one
    before it first, as the ranks render)."""
    inputs, _ = adoption_inputs()
    sess = _unsharded(params=inputs["params"])
    render_frame0(sess)
    _adopt(sess, inputs["rec"], inputs["codes"])
    return (state_dict(sess.state), sess.obj_mask, sess.adopted_instances,
            render_frame0(sess))


@functools.cache
def unsharded_restore(path: str, then_adopt: bool = False):
    sess = _unsharded(ckpt_path=path)
    if then_adopt:
        inputs, _ = adoption_inputs()
        _adopt(sess, inputs["rec2"], inputs["codes2"])
    return state_dict(sess.state), sess


@pytest.mark.parametrize("shape", ADOPT_MESHES, ids=str)
def test_sharded_adoption_gathers_to_the_unsharded_one(runs, shape):
    """Every parameter and AdamW tensor, the obj_mask and the records, on
    both ranks: bitwise the unsharded session's after the same adoption."""
    want, mask, records, _ = unsharded_adoption()
    for rank in (0, 1):
        got = _adoption(runs, shape, rank)
        _state_equal(want, got["adopted"])
        assert got["adopted"]["params"]["codes.shape"].shape[1] == 3
        assert torch.equal(got["obj_mask"], mask)
        assert got["records"] == records


@pytest.mark.parametrize("shape", ADOPT_MESHES, ids=str)
def test_a_sharded_render_after_a_sharded_adoption_sees_the_adoptee(
        runs, shape):
    """The composite after the adoption is the unsharded session's after
    the same adoption, and not the one before it: the gathered parameters
    (`full_params`) are cached by the adopted count too."""
    after = unsharded_adoption()[3]
    for rank in (0, 1):
        before, got = _adoption(runs, shape, rank)["render"]
        assert all(np.array_equal(a, b) for a, b in zip(got, after))
        assert not np.array_equal(got[0], before[0])


@pytest.mark.parametrize("shape", ADOPT_MESHES, ids=str)
def test_the_first_sharded_step_after_adoption_matches_jax(runs, shape):
    """The step after adoption against the JAX package's step on the
    adopted state: the metrics within METRIC_RTOL, the parameters by the
    JAX package's rule (rtol 5e-3, atol 2e-4, mean |diff| under 2e-5).

    The code tables on their valid slots only: the JAX package's
    `jnp.linalg.norm` has a NaN gradient at a zero code, which its mask
    multiplies by 0, so the zero slot the growth pads onto the other
    category comes out NaN there after one step; torch's `vector_norm`
    takes 0 at zero, and the port's padded slot stays 0 (ROADMAP.md
    Queue 3)."""
    jm, params, mask = jax_adopted_step()
    got = _adoption(runs, shape)
    np.testing.assert_array_equal(got["obj_mask"].numpy(), mask)
    for field in jstep.StepMetrics._fields:
        np.testing.assert_allclose(_np(got["metrics"][field]),
                                   np.asarray(getattr(jm, field)),
                                   rtol=METRIC_RTOL, atol=1e-7,
                                   err_msg=field)
    valid = mask.astype(bool)
    assert not valid.all()
    for k, want in params.items():
        a, b = _np(want), _np(got["stepped"][k])
        if k.startswith("codes."):
            assert np.isnan(a[~valid]).all() and (b[~valid] == 0).all(), k
            a, b = a[valid], b[valid]
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=2e-4, err_msg=k)
        assert np.mean(np.abs(a - b)) < 2e-5, (k, np.mean(np.abs(a - b)))


@pytest.mark.parametrize("shape", ADOPT_MESHES, ids=str)
def test_an_adopted_checkpoint_restores_sharded_and_adopts_again(runs,
                                                                 shape):
    """An adopted checkpoint restored into a session sharded before the
    restore, then a second instance adopted on top: each gathered bitwise
    the unsharded session's after the same restore and adoption."""
    path = runs["adopted_ckpt"]
    restored, _ = unsharded_restore(path)
    again, sess = unsharded_restore(path, then_adopt=True)
    for rank in (0, 1):
        got = _adoption(runs, shape, rank)
        assert got["restored_rows"] == 2 // shape[1]
        _state_equal(restored, got["restored"])
        _state_equal(again, got["restored_adopted"])
        assert got["restored_records"] == sess.adopted_instances


@pytest.mark.parametrize("which", ["saved", "resumed"])
def test_a_sharded_save_writes_the_sidecar(runs, which):
    """A 1 x 2 session that carries adoptees and is saved writes the
    `.adopted.json` sidecar as the unsharded session does: `saved` adopted
    into the sharded session, `resumed` restored unsharded and then
    sharded (the training CLI's --resume --train-sharded). A fresh
    unsharded session restores either with the adoptees' records, their
    metadata and every tensor bitwise."""
    got = _adoption(runs, (1, 2))
    path = got[which]
    assert all(_adoption(runs, (1, 2), r)[which] == path for r in (0, 1))
    with open(f"{path}.adopted.json") as f:
        records = json.load(f)
    want, sess = unsharded_restore(runs["adopted_ckpt"],
                                   then_adopt=which == "saved")
    assert records == sess.adopted_instances
    fresh = _unsharded(ckpt_path=path)
    assert fresh.adopted_instances == records
    _state_equal(want, state_dict(fresh.state))
    for rec in records:
        cat = fresh.categories[fresh.cls_ids.index(rec["cls"])]
        np.testing.assert_array_equal(cat.extent_dict[rec["id"]],
                                      rec["extent"])
        np.testing.assert_array_equal(cat.object_tensor_dict[rec["id"]],
                                      rec["obj_tensor"])
        assert cat.inst_id_to_index[rec["id"]] == 2


# ---------------------------------------------------------------------------
# The CLI under torch.distributed.run
# ---------------------------------------------------------------------------

def _cli(tmp_path, nproc, *args) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    launcher = ([sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc-per-node", str(nproc)]
                if nproc else [sys.executable])
    return subprocess.run(
        launcher + ["-m", "catnerf_torch.train", "--synthetic", "--device",
                    "cpu", "--logdir", str(tmp_path), "--grid-dim", "32",
                    *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_cli_trains_saves_resumes_and_meshes_sharded(tmp_path):
    """Two ranks: --train-sharded (2 x 1: the synthetic scene's 3
    categories divide over no 2-way 'model' axis) --mesh-sharded, 2 logged
    chunks and a checkpoint; then --resume --mesh-only sharded, and the
    same unsharded in one process: byte-identical meshes."""
    out = _cli(tmp_path, 2, "--max-iter", "5", "--log-iter", "2",
               "--save-iter", "4", "--mesh-it", "1000", "--train-sharded",
               "--mesh-sharded")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "training sharded over {'data': 2, 'model': 1} mesh" in out.stderr
    rows = [json.loads(x) for x in out.stdout.splitlines()]
    assert [r["iteration"] for r in rows] == [2, 4]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["iteration"] for x in lines] == [2, 4]
    assert (tmp_path / "ckpt" / "4").exists()
    out = _cli(tmp_path, 2, "--resume", "--mesh-only", "--mesh-sharded")
    assert out.returncode == 0, out.stderr[-3000:]
    sharded = {p.name: p.read_bytes()
               for p in (tmp_path / "scene_mesh").glob("*.obj")}
    assert len(sharded) >= 1
    for p in (tmp_path / "scene_mesh").glob("*.obj"):
        p.unlink()
    out = _cli(tmp_path, 0, "--resume", "--mesh-only")
    assert out.returncode == 0, out.stderr[-3000:]
    single = {p.name: p.read_bytes()
              for p in (tmp_path / "scene_mesh").glob("*.obj")}
    assert single == sharded
