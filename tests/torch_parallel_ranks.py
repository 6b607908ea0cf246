"""The rank programs of tests/test_torch_parallel.py: each runs in a
process that `launch` spawns, one per rank, joined over gloo by a
FileStore, on the CPU, one thread each. They import torch, numpy and
catnerf_torch only (no jax: the JAX side runs in the test's own process);
each rank writes what it returns to `<tmp>/<program>_<rank>.pt`.
"""

from __future__ import annotations

import copy
import os
import sys
from pathlib import Path

import numpy as np
import torch

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)
# the JAX package's tests/test_parallel.py scenes
SCENE5 = dict(n_frames=3, width=48, height=36, n_categories=2,
              insts_per_cat=2, seed=5)


def launch(program: str, world: int, tmp: str, payload=None) -> list:
    """Run `program(tmp, payload)` on `world` spawned ranks; returns each
    rank's result."""
    import torch.multiprocessing as mp

    mp.spawn(_entry, args=(world, program, tmp, payload), nprocs=world,
             join=True)
    return [torch.load(os.path.join(tmp, f"{program}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank: int, world: int, program: str, tmp: str, payload):
    torch.set_num_threads(1)
    from catnerf_torch.parallel import mesh as pm

    pm.init_distributed("cpu", init_method=f"file://{tmp}/store_{program}",
                        world_size=world, rank=rank)
    try:
        out = globals()[program](tmp, payload)
        torch.save(out, os.path.join(tmp, f"{program}_{rank}.pt"))
    finally:
        pm.shutdown()


def fused_config():
    """tests/test_torch_step.py's fused configuration, seed 0."""
    from catnerf_torch.config import Config

    cfg = Config()
    cfg.use_fused_kernels = True
    cfg.bf16_activations = False
    cfg.net_hyperparams.latent_dim = 32
    cfg.n_per_optim_bg = 240
    cfg.seed = 0
    return cfg


def small_config():
    """tests/test_parallel.py's `_cfg()`: `Config()` at latent 16, a
    background 32 wide (the XLA path)."""
    from catnerf_torch.config import Config

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 32
    return cfg


def session(cfg, scene=SCENE):
    from catnerf_torch.data.synthetic import make_scene
    from catnerf_torch.train.loop import TrainingSession

    s = make_scene(**scene)
    return TrainingSession(cfg, s.inst_dict, s.sample_dict, cam=s.cam,
                           device="cpu")


def _metrics(m) -> dict:
    return {k: v.detach().clone() for k, v in m._asdict().items()}


def _meshes(world: int):
    """The meshes of the step checks at this world size: every
    n_data x n_model over the processes with n_model | 2 categories."""
    return [(world // k, k) for k in (1, 2) if world % k == 0]


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------

def mesh_errors(tmp, payload):
    """make_mesh at this world size: its shapes and the JAX package's
    errors; the modules the rank loaded."""
    from catnerf_torch.parallel import mesh as pm

    world = pm.world_size()
    out = {"shape": pm.mesh_shape(pm.make_mesh()),
           "shape_model": (pm.mesh_shape(pm.make_mesh(n_model=world))
                           if world > 1 else None),
           "errors": {}, "modules": sorted(sys.modules)}
    for name, kw in (("n_model=3", dict(n_model=3)),
                     ("n_model=0", dict(n_model=0)),
                     ("too big", dict(n_data=2 * world, n_model=2)),
                     ("too small", dict(n_data=1, n_model=1))):
        try:
            pm.make_mesh(**kw)
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)
    return out


def steps(tmp, p):
    """One step of the fused configuration from the JAX initial weights
    on the given (whole) batch and draws: unsharded (`step.update`) and
    sharded on each mesh of this world size, the metrics, the whole state
    after it (gathered) and the bytes this rank handed to collectives;
    then, on the last mesh, the placement and 3 more steps."""
    from catnerf_torch import convert
    from catnerf_torch.parallel import mesh as pm, sharding
    from catnerf_torch.train import step as step_mod
    from catnerf_torch.train.state import make_train_state, state_dict

    cfg = fused_config()
    sess = session(cfg)
    cat = step_mod.CategoryBatch(**{k: torch.tensor(v)
                                    for k, v in p["cat"].items()})
    bg = step_mod.BackgroundBatch(**{k: torch.tensor(v)
                                     for k, v in p["bg"].items()})
    draws = step_mod.StepDraws(torch.tensor(p["u_cat"]),
                               torch.tensor(p["u_bg"]))

    def fresh():
        return make_train_state(cfg, convert.params_from_jax(p["params0"]))

    ref = fresh()
    m_ref = step_mod.update(ref, cat, bg, draws, cfg, sess.obj_mask)
    out = {"ref": {"metrics": _metrics(m_ref),
                   "state": copy.deepcopy(state_dict(ref))},
           "meshes": {}}
    for nd, nm in _meshes(pm.world_size()):
        mesh = pm.make_mesh(nd, nm)
        shard = sharding.shard_plan(mesh, len(sess.cls_ids))
        whole = fresh()
        local = sharding.shard_state(whole, cfg, shard)
        placed = all(
            torch.equal(v, whole.params.state_dict()[k][shard.c0:shard.c1]
                        if sharding.is_stacked(k)
                        else whole.params.state_dict()[k])
            for k, v in local.params.state_dict().items())
        own = all(v.untyped_storage().data_ptr() != w.untyped_storage()
                  .data_ptr() for v, w in zip(local.params.parameters(),
                                              whole.params.parameters()))
        step = sharding.make_sharded_train_step(cfg, sess.obj_mask, shard,
                                                local)
        with pm.tally_collectives() as tally:
            m = step(cat, bg, draws)
        rec = {"metrics": _metrics(m),
               "state": copy.deepcopy(
                   sharding.gather_state_dict(local, shard)),
               "tally": list(tally), "placed": placed, "own": own,
               "coords": (shard.d, shard.m),
               "local_shapes": {k: tuple(v.shape) for k, v in
                                local.params.state_dict().items()}}
        for _ in range(3):
            step(cat, bg, draws)
        bg_now = {k: v for k, v in local.params.state_dict().items()
                  if not sharding.is_stacked(k)}
        everyone = pm.all_gather_objects(bg_now)
        rec["bg_equal"] = all(
            torch.equal(a[k], b[k]) for a in everyone for b in everyone
            for k in a)
        out["meshes"][(nd, nm)] = rec
    out["param_bytes"] = sum(v.numel() * v.element_size()
                             for v in ref.params.state_dict().values())
    return out


def superstep_bitwise(tmp, payload):
    """At 1 x 1: make_sharded_superstep against the unsharded run_fast,
    4 generator-drawn steps from one seed, for the fused configuration and
    `Config()`: metrics, every parameter and every AdamW tensor."""
    from catnerf_torch.config import Config
    from catnerf_torch.parallel import mesh as pm, sharding
    from catnerf_torch.train.state import state_dict

    out = {}
    mesh = pm.make_mesh(1, 1)
    for name, cfg in (("fused", fused_config()), ("default", Config())):
        cfg.net_hyperparams.latent_dim = 32
        cfg.n_per_optim_bg = 240
        a, b = session(cfg), session(cfg)
        a.enable_fast_path(2)
        ma = a.run_fast(4)
        shard = sharding.shard_plan(mesh, len(b.cls_ids))
        b.state = sharding.shard_state(b.state, cfg, shard)
        sup = sharding.make_sharded_superstep(
            cfg, b.obj_mask, shard, b.state, b.categories, b.background,
            b.n_per_cls, cfg.n_per_optim_bg, 2, window=True)
        mb = sup(b.draw_gen, 4)
        sa, sb = state_dict(a.state), state_dict(b.state)
        out[name] = {
            "metrics": all(torch.equal(x, y) for x, y in zip(ma, mb)),
            "params": all(torch.equal(sa["params"][k], sb["params"][k])
                          for k in sa["params"]),
            "moments": all(
                torch.equal(torch.as_tensor(v), torch.as_tensor(
                    sb["optimizer"]["state"][i][k]))
                for i, st in sa["optimizer"]["state"].items()
                for k, v in st.items()),
            "n_moments": len(sa["optimizer"]["state"])}
    return out


def superstep_2x2(tmp, payload):
    """tests/test_parallel.py::test_sharded_superstep_trains_and_matches_
    shapes: 5 x 4 steps of the sharded superstep at 2 x 2 with the row
    draw gathered per category (window=False), beside the unsharded
    superstep's 5 x 4 from the same seed (the flat row gather)."""
    from catnerf_torch.parallel import mesh as pm, sharding
    from catnerf_torch.train import step as step_mod
    from catnerf_torch.train.graph import make_superstep

    cfg = small_config()
    sess, ref = session(cfg, SCENE5), session(cfg, SCENE5)
    shard = sharding.shard_plan(pm.make_mesh(2, 2), len(sess.cls_ids))
    state = sharding.shard_state(sess.state, cfg, shard)
    sup = sharding.make_sharded_superstep(
        cfg, sess.obj_mask, shard, state, sess.categories, sess.background,
        16, 32, 4, window=False)
    store = tdb_store(ref, 16, 32)

    def ref_step(cat, bg, gen):
        draws = step_mod.draw_uniforms(cfg, 2, 16, 32, gen, "cpu")
        return step_mod.update(ref.state, cat, bg, draws, cfg, ref.obj_mask)

    ref_sup = make_superstep(ref_step, store, 16, 32, 4, window=False)
    got, want = [], []
    for _ in range(5):
        got.append(_metrics(sup(sess.draw_gen)))
        want.append(_metrics(ref_sup(ref.draw_gen)))
        state.step += 4
    return {"step": state.step, "got": got, "want": want,
            "store_rows": tuple(sup.store.packed.shape)}


def tdb_store(sess, n_per_cls: int, n_bg: int):
    from catnerf_torch.data.device_buffer import build_device_store

    return build_device_store(sess.categories, sess.background,
                              window_pad=n_per_cls, bg_window_pad=n_bg,
                              device="cpu")


def session_2x2(tmp, payload):
    """tests/test_parallel.py::test_session_sharded_fast_path on a 2 x 2
    mesh (8 + 8 steps), the 'model' divisibility error, then the sharded
    session's checkpoint (gathered; rank 0 writes) and its whole state."""
    from catnerf_torch.parallel import mesh as pm, sharding
    from catnerf_torch.train import checkpoint as ckpt

    cfg = small_config()
    sess = session(cfg, SCENE5)
    mesh = pm.make_mesh(2, 2)
    sess.enable_fast_path(n_inner=4, device_mesh=mesh)
    out = {"local_rows": sess.state.params.cat_fc.cat_layer.w.shape[0],
           "store_cats": sess._store.packed.shape[0]}
    m1 = sess.run_fast(8)
    out["it1"] = sess.iteration
    m2 = sess.run_fast(8)
    out.update(it2=sess.iteration, total1=float(m1.total),
               total2=float(m2.total), step=sess.state.step)
    try:
        session(cfg, SCENE5).enable_fast_path(
            n_inner=4, device_mesh=pm.make_mesh(n_data=1, n_model=4))
        out["model_error"] = None
    except ValueError as e:
        out["model_error"] = str(e)
    path = ckpt.save_session_checkpoint(os.path.join(tmp, "ckpt"), sess,
                                        sess.iteration)
    out["path"] = path
    out["gathered"] = copy.deepcopy(
        sharding.gather_state_dict(sess.state, sess.shard))
    out["iteration"] = sess.iteration
    return out


def evaluation(tmp, p):
    """Grid evaluation, meshes and a scene render, sharded over this world
    against unsharded; the 2 x 2 checkpoint restored into a sharded
    session."""
    from catnerf_torch.data.camera import CameraInfo
    from catnerf_torch.mesher import meshing
    from catnerf_torch.parallel import mesh as pm, sharding
    from catnerf_torch.render_views import render_scene_view
    from catnerf_torch.train import checkpoint as ckpt
    from catnerf_torch.train.state import init_train_state

    out = {}
    mesh = pm.make_mesh()
    cfg = small_config()
    # grid evaluation (tests/test_parallel.py:264-301), both fields
    st = init_train_state(torch.Generator().manual_seed(3), cfg, [2, 2])
    sess0 = session(cfg)
    sess0.state = st
    params = sess0.category_params(sess0.cls_ids[0])
    pts = np.random.RandomState(0).uniform(-1, 1, (5001, 3)).astype(
        np.float32)
    sc = params["shape_codes"][0].numpy()
    tc = params["texture_codes"][0].numpy()
    got = {}
    for name, kw in (
            ("cat", dict(shape_code=sc, texture_code=tc,
                         is_background=False, want_color=True)),
            ("bg", dict(is_background=True, want_color=False))):
        fp = params if name == "cat" else sess0.background_params()
        one = meshing.eval_points(pts, fp, cfg, chunk=256, **kw)
        many = meshing.eval_points(pts, fp, cfg, chunk=256,
                                   device_mesh=mesh, **kw)
        got[name] = all(
            (a is None and b is None) or np.array_equal(a, b)
            for a, b in zip(one, many))
    out["grid_eval"] = got

    # meshes (tests/test_parallel.py:331-353)
    cfg = small_config()
    cfg.grid_dim = 32
    cfg.live_voxel_size = 0.2
    sess = session(cfg, dict(SCENE5, seed=7))
    sess.enable_fast_path(10, graph=False)
    sess.run_fast(30)
    d1 = os.path.join(tmp, "mesh_single")
    d2 = os.path.join(tmp, "mesh_sharded")
    if pm.is_main():
        w1 = meshing.mesh_scene(sess, d1, iteration=30)
    w2 = meshing.mesh_scene(sess, d2, iteration=30, device_mesh=mesh)
    if pm.is_main():
        out["meshes"] = (sorted(w1), sorted(w2), [
            Path(w1[k]).read_bytes() == Path(w2[k]).read_bytes()
            for k in w1])

    # the scene render (tests/test_parallel.py:356-380)
    cam = CameraInfo(40, 30, 35.0, 35.0, 20.0, 15.0)
    T = np.asarray(sess.sample_dict[sorted(sess.sample_dict)[0]]["T"],
                   np.float32)
    one = render_scene_view(sess, T, cam, near=0.05, far=6.0, n_bins=8,
                            chunk=512)
    many = render_scene_view(sess, T, cam, near=0.05, far=6.0, n_bins=8,
                             chunk=512, device_mesh=mesh)
    out["render"] = [np.array_equal(a, b) for a, b in zip(one, many)]

    # the 2 x 2 session's checkpoint into a sharded session of this world
    if p is not None:
        cfg = small_config()
        s2 = session(cfg, SCENE5)
        s2.enable_fast_path(n_inner=4, device_mesh=mesh)
        ckpt.restore_session_checkpoint(p["path"], s2)
        out["restored"] = sharding.gather_state_dict(s2.state, s2.shard)
        out["restored_iteration"] = s2.iteration
        out["local_rows"] = s2.state.params.codes.shape.shape[0]
    return out


def ingest_scene():
    """tests/test_torch_serve.py's ingest scene: 3 frames of 64 x 48, one
    category of three spheres, the last held out of training; latent 16,
    background 32 wide, grid 32 (a /mesh in seconds on one core). Returns
    (cfg, scene, the training inst_dict, cls_id, the held-out id, its
    observations as an .npz body)."""
    import io

    from catnerf_torch.config import Config
    from catnerf_torch.data.synthetic import make_scene

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 32
    cfg.grid_dim = 32
    scene = make_scene(n_frames=3, width=64, height=48, n_categories=1,
                       insts_per_cat=3, seed=11)
    cls_id = [c for c in scene.inst_dict if c != 0][0]
    held = sorted(scene.inst_dict[cls_id])[-1]
    train = copy.deepcopy(scene.inst_dict)
    del train[cls_id][held]
    frames = sorted(scene.sample_dict)
    buf = io.BytesIO()
    np.savez(buf,
             rgb=np.stack([scene.sample_dict[f]["image"] for f in frames]),
             depth=np.stack([scene.sample_dict[f]["depth"] for f in frames]),
             mask=np.stack([scene.sample_dict[f]["obj_mask"] == held
                            for f in frames]).astype(np.int8),
             T_wc=np.stack([scene.sample_dict[f]["T"] for f in frames]))
    return cfg, scene, train, cls_id, held, buf.getvalue()


def ingest_session():
    """A CPU session of ingest_scene's training instances."""
    from catnerf_torch.train.loop import TrainingSession

    cfg, scene, train, *_ = ingest_scene()
    return TrainingSession(cfg, train, scene.sample_dict, cam=scene.cam,
                           device="cpu")


#: 48 x 36, added to serve._SIZES while a test's server runs
SMALL = (48, 36)


def serving(tmp, p):
    """A sharded server over this world's ranks on the checkpoint under
    p["ckpt_dir"]: rank 0 serves HTTP on a free port while a client
    thread sends p["requests"] ((name, path, body or None), in order),
    then shuts the server down; the other ranks follow. Every rank
    returns its loop's exit value and its session's code tables, obj_mask
    and adoption records; rank 0 also each answer's (status, bytes)."""
    import threading
    import urllib.error
    import urllib.request

    from catnerf_torch import serve
    from catnerf_torch.parallel import mesh as pm
    from catnerf_torch.train import checkpoint as ckpt

    serve._SIZES = (SMALL,) + serve._SIZES
    sess = ingest_session()
    ckpt.restore_session_checkpoint(ckpt.latest_checkpoint(p["ckpt_dir"]),
                                    sess)
    server = serve.SceneServer(sess, ckpt_dir=p["ckpt_dir"],
                               device_mesh=pm.make_mesh())
    out = {}
    if not pm.is_main():
        out["exit"] = serve.follow(server)
    else:
        httpd = serve.serve(sess, port=0, scene_server=server)
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        answers = {}

        def client():
            try:
                for name, path, body in p["requests"]:
                    req = urllib.request.Request(base + path, data=body)
                    try:
                        with urllib.request.urlopen(req, timeout=600) as r:
                            answers[name] = (r.status, r.read())
                    except urllib.error.HTTPError as e:
                        answers[name] = (e.code, e.read())
            finally:
                httpd.shutdown()

        thread = threading.Thread(target=client)
        thread.start()
        out["exit"] = serve.serve_sharded(server, httpd)
        thread.join()
        out["answers"] = answers
    codes = sess.state.params.codes
    out.update(shape=codes.shape.detach().clone(),
               texture=codes.texture.detach().clone(),
               obj_mask=sess.obj_mask.clone(),
               adopted=sess.adopted_instances)
    return out


#: the scene render of the adoption checks: 40 x 30 x 8 from frame 0
RENDER_CAM = (40, 30, 35.0, 35.0, 20.0, 15.0)
RENDER_KW = dict(near=0.05, far=6.0, n_bins=8, chunk=512)


def render_frame0(sess, device_mesh=None):
    from catnerf_torch.data.camera import CameraInfo
    from catnerf_torch.render_views import render_scene_view

    T = np.asarray(sess.sample_dict[sorted(sess.sample_dict)[0]]["T"],
                   np.float32)
    return render_scene_view(sess, T, CameraInfo(*RENDER_CAM),
                             device_mesh=device_mesh, **RENDER_KW)


def _adopt(sess, rec, codes):
    from catnerf_torch import fit

    fit._adopt_slot(sess, rec, *codes)


def _gathered(sess) -> dict:
    from catnerf_torch.parallel import sharding

    return copy.deepcopy(sharding.gather_state_dict(sess.state, sess.shard))


def adoption(tmp, p):
    """Adoption into a session sharded on each mesh of this world, from
    one record and its codes (p["rec"], p["codes"]; the same on every
    rank): (a) into the fused configuration's session on p["params"]
    sharded before, the gathered state after it, the obj_mask, a sharded
    scene render before and after it, then one sharded step on the given
    batch and draws (its metrics, the gathered parameters after it);
    (b) the adopted checkpoint p["ckpt"] restored into a session sharded
    before the restore, gathered, then p["rec2"] adopted on top, gathered;
    at 1 x 2 that session saved sharded (rank 0 writes, with the sidecar);
    (c) at 1 x 2, p["ckpt"] restored unsharded, then sharded and saved
    (the training CLI's --resume --train-sharded)."""
    from catnerf_torch import convert
    from catnerf_torch.parallel import mesh as pm
    from catnerf_torch.train import checkpoint as ckpt
    from catnerf_torch.train import step as step_mod
    from catnerf_torch.train.state import make_train_state

    cfg = fused_config()
    cat = step_mod.CategoryBatch(**{k: torch.tensor(v)
                                    for k, v in p["cat"].items()})
    bg = step_mod.BackgroundBatch(**{k: torch.tensor(v)
                                     for k, v in p["bg"].items()})
    draws = step_mod.StepDraws(torch.tensor(p["u_cat"]),
                               torch.tensor(p["u_bg"]))
    out = {}
    for nd, nm in ((2, 1), (1, 2)):
        mesh = pm.make_mesh(nd, nm)
        rec = {}
        sess = session(cfg)
        sess.state = make_train_state(cfg,
                                      convert.params_from_jax(p["params"]))
        sess.enable_fast_path(2, graph=False, device_mesh=mesh)
        before = render_frame0(sess, mesh)
        _adopt(sess, p["rec"], p["codes"])
        rec["adopted"] = _gathered(sess)
        rec["obj_mask"] = sess.obj_mask.clone()
        rec["records"] = list(sess.adopted_instances)
        rec["render"] = (before, render_frame0(sess, mesh))
        sh = sess.shard
        m = step_mod.update(sess.state, sh.cat_batch(cat), sh.bg_batch(bg),
                            sh.draws(draws), cfg, sess.obj_mask[sh.c0:sh.c1],
                            reduction=sess._reduction)
        rec["metrics"] = _metrics(m)
        rec["stepped"] = _gathered(sess)["params"]

        s2 = session(cfg)
        s2.enable_fast_path(2, graph=False, device_mesh=mesh)
        ckpt.restore_session_checkpoint(p["ckpt"], s2)
        rec["restored"] = _gathered(s2)
        rec["restored_rows"] = s2.state.params.codes.shape.shape[0]
        _adopt(s2, p["rec2"], p["codes2"])
        rec["restored_adopted"] = _gathered(s2)
        rec["restored_records"] = list(s2.adopted_instances)
        if (nd, nm) == (1, 2):
            rec["saved"] = ckpt.save_session_checkpoint(
                os.path.join(tmp, "sharded_adopted"), s2, s2.iteration)
            s3 = session(cfg)
            ckpt.restore_session_checkpoint(p["ckpt"], s3)
            s3.enable_fast_path(2, graph=False, device_mesh=mesh)
            rec["resumed"] = ckpt.save_session_checkpoint(
                os.path.join(tmp, "sharded_resumed"), s3, s3.iteration)
        out[(nd, nm)] = rec
    return out


def loaded_modules(tmp, payload):
    """The modules a rank has loaded after importing every module of
    catnerf_torch.parallel and joining the group."""
    import importlib

    for name in ("mesh", "sharding", "grid_eval"):
        importlib.import_module(f"catnerf_torch.parallel.{name}")
    return sorted(sys.modules)


def world4(tmp, payload):
    return {"mesh_errors": mesh_errors(tmp, None),
            "steps": steps(tmp, payload),
            "superstep": superstep_2x2(tmp, None),
            "session": session_2x2(tmp, None)}


def world2(tmp, payload):
    return {"mesh_errors": mesh_errors(tmp, None),
            "steps": steps(tmp, payload["step"]),
            "evaluation": evaluation(tmp, payload),
            "adoption": adoption(tmp, payload["adopt"])}


def world1(tmp, payload):
    return {"mesh_errors": mesh_errors(tmp, None),
            "steps": steps(tmp, payload),
            "superstep": superstep_bitwise(tmp, None)}
