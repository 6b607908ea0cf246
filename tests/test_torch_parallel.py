"""The port's multi-process layer (`catnerf_torch/parallel/`: DP over rays
x EP over categories on torch.distributed) against the JAX package's
single-device step and its own unsharded paths, mirroring the JAX
package's tests/test_parallel.py on gloo ranks on the CPU.

The ranks are spawned processes (tests/torch_parallel_ranks.py), joined by
a FileStore under tmp_path, one thread each, importing no jax; the JAX
side runs here. Spawns: world 4 (the 2 x 2 and 4 x 1 steps, the superstep,
the session and its checkpoint), world 2 (the 2 x 1 and 1 x 2 steps, grid
evaluation, meshes, a scene render, the checkpoint restored sharded),
world 1 (the 1 x 1 step and superstep, bitwise), and two ranks under
`torch.distributed.run` for the CLI.

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
  unsharded port, checkpoints across layouts.
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
from catnerf_tpu.experimental import fused_field as jff
from catnerf_tpu.train import step as jstep
from catnerf_tpu.train.loop import TrainingSession as JSession
from catnerf_torch.config import Config
from catnerf_torch.data import device_buffer as tdb
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train import checkpoint as ckpt
from catnerf_torch.train.loop import TrainingSession
from test_torch_superstep import BF16_RTOL
from test_torch_step import (METRIC_RTOL, SCENE, _configure, _jbatch,
                             _sessions, _untie_relus, jax_draws)
from torch_parallel_ranks import SCENE5, launch, small_config

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn, in order: world 4, then world 2 (which restores world
    4's checkpoint), then world 1; {world: {check: [each rank's]}}. The
    JAX step runs here meanwhile."""
    payload, _ = step_inputs()
    out = {}

    def spawns():
        for world in (4, 2, 1):
            arg = payload
            if world == 2:
                arg = {"step": payload,
                       "path": out[4]["session"][0]["path"]}
            ranks = launch(f"world{world}", world,
                           str(tmp_path_factory.mktemp(f"w{world}")), arg)
            out[world] = {k: [r[k] for r in ranks] for k in ranks[0]}

    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawns)
        jax_metrics()
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
                              gen)
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
# The CLI under torch.distributed.run, and what still raises
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


def test_serve_sharded_and_sharded_adoption_raise_naming_item_4h():
    from catnerf_torch import fit, serve

    with pytest.raises(NotImplementedError, match="item 4h"):
        serve.main(["--logdir", "unused", "--synthetic", "--sharded",
                    "--device", "cpu"])

    class Sharded:
        shard = object()

    with pytest.raises(NotImplementedError, match="item 4h"):
        fit._adopt_slot(Sharded(), {"cls": 1, "id": 9}, None, None)
