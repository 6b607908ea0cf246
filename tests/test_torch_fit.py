"""The port's test-time fitting (`catnerf_torch/fit.py`) against the JAX
package's `fit.py`, on the CPU.

The fixture is the JAX package's test scene (tests/test_fit.py: 6 frames
of 80 x 60, one category of three spheres, the last held out, latent 16,
background 64, the XLA-path modules). The JAX session's weights (drawn by
the port's seeded initialisation, `_seeded_state`: the JAX package's own
eager draws compile one program a layer, ~14 s on one core; the occupancy
head softened as tests/test_torch_render_views.py's `_soften` does, so the
fields do not saturate) go into the port's session through `convert`.

The JAX side runs unjitted (`jax.disable_jit()`), as the port runs op by op
(ROADMAP.md: XLA reorders the float32 loss under jit). The draws are the
JAX package's key schedule, taken with `jax.random` and injected. The
fit's loss is ill-conditioned (its depth term is weighted by 1/sqrt(var)):
two free runs part by ~3e-4 in T_obj within 20 steps, so each step is held
from the JAX state it starts from (experimental/fit_check.py's bounds).
"""

from __future__ import annotations

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from catnerf_torch import convert, fit
from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.device_buffer import FastDraws, draw_offsets
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.experimental import fit_check as fc
from catnerf_torch.geometry.pointcloud import accumulate_pointcloud_tsdf
from catnerf_torch.render_views import render_scene_view
from catnerf_torch.train import checkpoint as ckpt
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import FieldParams
from catnerf_tpu import fit as jfit
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.camera import CameraInfo as JCameraInfo
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.geometry import pointcloud as jpointcloud
from catnerf_tpu.train import checkpoint as jckpt
from catnerf_tpu.train import loop as jloop
from catnerf_tpu.train import state as jstate
from test_torch_render_views import _soften

torch.set_num_threads(1)

FIXTURE = dict(n_frames=6, width=80, height=60, n_categories=1,
               insts_per_cat=3, seed=6)
N_RAYS = 120
LR = 5e-3
N_STEPS = 20
# the trajectory's keys (the free 20-step schedule), and a 2-step schedule
# of one-step chunks on a subsampled instance, run by the JAX package's
# own fit_instance as well
KEY_A, KEY_B = 3, 11
MAX_RAYS_B = 2000
HOST_TOL = 1e-6


def _configure(cfg):
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 64
    cfg.n_per_optim = 120
    cfg.n_per_optim_bg = 600
    return cfg


def _seeded_state(key, cfg, n_objs, with_background=True):
    """The JAX session's initial TrainState, drawn by the port's
    FieldParams.init on a CPU generator seeded with cfg.seed."""
    params = convert.params_to_numpy(FieldParams.init(
        torch.Generator().manual_seed(cfg.seed), cfg, n_objs,
        with_background))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return jstate.TrainState(
        params=params, opt_state=jstate.make_optimizer(cfg).init(params),
        step=jnp.zeros((), jnp.int32))


def _held_out(inst_dict):
    cls_id = [c for c in inst_dict if c != 0][0]
    held = sorted(inst_dict[cls_id])[-1]
    train = copy.deepcopy(inst_dict)
    del train[cls_id][held]
    return cls_id, held, train


def _pair(scene_kw=FIXTURE, bias=-0.3, hold_out=True):
    """(port session on the CPU, JAX session, port scene, JAX scene, cls,
    held-out id): the same scene, the same weights."""
    js, ts = jmake_scene(**scene_kw), make_scene(**scene_kw)
    cls_id, held, jtrain = _held_out(js.inst_dict)
    _, _, ttrain = _held_out(ts.inst_dict)
    if not hold_out:
        jtrain, ttrain = js.inst_dict, ts.inst_dict
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "init_train_state", _seeded_state)
        jsess = jloop.TrainingSession(_configure(JConfig()), jtrain,
                                      js.sample_dict, cam=js.cam)
    _soften(jsess, bias)
    cfg = _configure(Config())
    tsess = TrainingSession(cfg, ttrain, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    # copied into the session's own modules, so that the optimizer's
    # parameter order is a fresh session's (a checkpoint maps its moments
    # by that order)
    tsess.state.params.load_state_dict(
        convert.params_from_jax(jsess.state.params).state_dict())
    return tsess, jsess, ts, js, cls_id, held


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _info(scene, cls_id, held):
    return scene.inst_dict[cls_id][held]


# ---------------------------------------------------------------------------
# the JAX package's fit, step by step
# ---------------------------------------------------------------------------

def _statics(cfg, optimize_pose: bool):
    return jfit._FitStatics(
        n_rays=N_RAYS, n_inner=1, optimize_pose=optimize_pose, lr=LR,
        n_bins_cam2surface=cfg.n_bins_cam2surface, n_bins=cfg.n_bins,
        min_depth=cfg.min_depth, surface_eps=cfg.surface_eps,
        stop_eps=cfg.stop_eps, obj_scale=cfg.obj_scale,
        max_deg=cfg.n_unidir_funcs, color_scaling=cfg.color_scaling,
        opacity_scaling=cfg.opacity_scaling)


def _arrays(js, cls_id, held, max_rays, seed):
    """The JAX package's rays of the held-out instance, subsampled as
    fit_instance subsamples them."""
    info = _info(js, cls_id, held)
    arrays = jfit.build_canonical_rays(info["frame_info"], js.sample_dict,
                                       js.cam, info["T_obj"], held)
    n = arrays["depth"].shape[0]
    if n > max_rays:
        sel = np.random.default_rng(seed).choice(n, max_rays, replace=False)
        arrays = {k: v[sel] for k, v in arrays.items()}
    return arrays


def _schedule(key: int, steps: int, n_inner: int):
    """The JAX fit's keys: the initial loss's, then each step's
    (fit.py:251-267)."""
    key = jax.random.PRNGKey(key)
    keys = [jax.random.fold_in(key, 0)]
    inner = min(n_inner, steps)
    chunks = [inner] * (steps // inner) + ([steps % inner]
                                           if steps % inner else [])
    for sz in chunks:
        key, k = jax.random.split(key)
        keys.extend(jax.random.split(k, sz))
    return keys


def _draws(keys, n: int, n_u: int):
    """The port's FitDraws of each key, drawn as `_fit_loss` draws."""
    out = []
    for k in keys:
        k_draw, k_sample = jax.random.split(k)
        idx = jax.random.randint(k_draw, (N_RAYS,), 0,
                                 jnp.asarray(n, jnp.int32))
        u = jax.random.uniform(k_sample, (N_RAYS, n_u))
        out.append(fit.FitDraws(torch.tensor(np.asarray(idx),
                                             dtype=torch.int64),
                                torch.tensor(np.asarray(u))))
    return out


def _flat(tree) -> dict:
    """{"codes.shape": array, ...} of a JAX fit parameter tree."""
    return {f"{g}.{k}": np.asarray(v) for g, sub in tree.items()
            for k, v in sub.items()}


def _jax_trajectory(jsess, arrays, cls_id, keys, optimize_pose):
    """The JAX package's fit, unjitted, from the category-mean codes on
    `keys` (the first the initial loss's): for each step the state it
    starts from, its loss, PSNR and gradients; then the final state."""
    from catnerf_tpu.edit import mean_codes

    pe = jsess.category_params(cls_id)["pe"]
    fcp = jsess.category_params(cls_id)["fc"]
    st = _statics(jsess.cfg, optimize_pose)
    data = {"origins": jnp.asarray(arrays["origins"]),
            "dirs": jnp.asarray(arrays["dirs"]),
            "rgb": jnp.asarray(arrays["rgb"], jnp.float32) / 255.0,
            "state": jnp.asarray(arrays["state"], jnp.int32),
            "depth": jnp.asarray(arrays["depth"])}
    n_valid = jnp.asarray(arrays["depth"].shape[0], jnp.int32)
    sc0, tc0 = mean_codes(jsess, cls_id)
    fp = {"codes": {"shape": jnp.asarray(sc0), "texture": jnp.asarray(tc0)}}
    if optimize_pose:
        fp["pose"] = {"log_s": jnp.zeros(()), "w": jnp.zeros(3),
                      "t": jnp.zeros(3)}
    tx = optax.adam(LR)
    opt = tx.init(fp)
    steps = []
    with jax.disable_jit():
        init = [float(x) for x in jfit._fit_loss(fp, keys[0], data, n_valid,
                                                pe, fcp, st)]
        for k in keys[1:]:
            (loss, psnr), grads = jax.value_and_grad(
                jfit._fit_loss, has_aux=True)(fp, k, data, n_valid, pe, fcp,
                                              st)
            steps.append({"params": _flat(fp), "mu": _flat(opt[0].mu),
                          "nu": _flat(opt[0].nu),
                          "count": int(opt[0].count), "loss": float(loss),
                          "psnr": float(psnr), "grads": _flat(grads)})
            updates, opt = tx.update(grads, opt, fp)
            fp = optax.apply_updates(fp, updates)
    return {"init": init, "steps": steps, "final": _flat(fp)}


def _fitter(tsess, ts, cls_id, held, optimize_pose, max_rays=200_000):
    info = _info(ts, cls_id, held)
    return fit.prepare_fit(tsess, cls_id, info["frame_info"], ts.sample_dict,
                           tsess.cam, info["T_obj"], held, n_rays=N_RAYS,
                           lr=LR, max_rays=max_rays,
                           optimize_pose=optimize_pose)


def _hold(fitter, traj, draws) -> fc.FitCheck:
    """Each port step from the JAX state it starts from, on its draws."""
    check = fc.FitCheck(steps=len(traj["steps"]))
    ends = [s["params"] for s in traj["steps"][1:]] + [traj["final"]]
    for s, d, want_new in zip(traj["steps"], draws[1:], ends):
        fc.set_state(fitter, s["params"], s["mu"], s["nu"], s["count"])
        loss, psnr = fitter.step(d)
        check.add(float(loss), s["loss"], float(psnr), s["psnr"],
                  fc.grads_of(fitter), s["grads"],
                  fc.get_state(fitter)[0], want_new, LR)
    return check


@pytest.fixture(scope="module")
def trajectory(pair):
    """The JAX package's 20-step fit with pose refinement (schedule A),
    its 2-step fit in one-step chunks on a subsampled instance (schedule
    B, also run by the JAX package's own fit_instance), and a 1-step fit
    without pose refinement; each with the port's draws."""
    tsess, jsess, ts, js, cls_id, held = pair
    n_u = fit.sampling.n_uniforms(jsess.cfg.n_bins_cam2surface,
                                  jsess.cfg.n_bins)
    out = {}
    for name, key, steps, n_inner, pose, max_rays in (
            ("A", KEY_A, N_STEPS, 100, True, 200_000),
            ("B", KEY_B, 2, 1, True, MAX_RAYS_B),
            ("C", KEY_A, 1, 100, False, 200_000)):
        arrays = _arrays(js, cls_id, held, max_rays, jsess.cfg.seed)
        keys = _schedule(key, steps, n_inner)
        traj = _jax_trajectory(jsess, arrays, cls_id, keys, pose)
        traj["draws"] = _draws(keys, arrays["depth"].shape[0], n_u)
        traj["arrays"] = arrays
        out[name] = traj
    info = _info(js, cls_id, held)
    with jax.disable_jit():
        out["B"]["result"] = jfit.fit_instance(
            jsess, cls_id, info["frame_info"], js.sample_dict, js.cam,
            info["T_obj"], held, steps=2, n_rays=N_RAYS, lr=LR,
            key=jax.random.PRNGKey(KEY_B), n_inner=1, max_rays=MAX_RAYS_B,
            optimize_pose=True)
    return out


# ---------------------------------------------------------------------------
# host stages, bitwise
# ---------------------------------------------------------------------------

def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_build_canonical_rays_is_bitwise(pair):
    tsess, jsess, ts, js, cls_id, held = pair
    for oid in (held, *sorted(ts.inst_dict[cls_id])[:1]):
        ti, ji = _info(ts, cls_id, oid), _info(js, cls_id, oid)
        got = fit.build_canonical_rays(ti["frame_info"], ts.sample_dict,
                                       ts.cam, ti["T_obj"], oid)
        want = jfit.build_canonical_rays(ji["frame_info"], js.sample_dict,
                                         js.cam, ji["T_obj"], oid)
        _assert_trees_equal(got, want)
        assert got["depth"].shape[0] > 1000


def test_the_host_subsample_is_the_jax_packages(pair, trajectory):
    """Rows over max_rays are dropped by the JAX package's draw
    (np.random.default_rng(cfg.seed).choice), bitwise."""
    tsess, _, ts, _, cls_id, held = pair
    _, arrays = _fitter(tsess, ts, cls_id, held, True, MAX_RAYS_B)
    assert arrays["depth"].shape[0] == MAX_RAYS_B
    _assert_trees_equal(arrays, trajectory["B"]["arrays"])


def _contract_case():
    W, H = 48, 36
    n = 3
    rgb = np.zeros((n, W, H, 3), np.uint8)
    rgb[..., 1] = 7
    depth = np.ones((n, W, H), np.float32)
    mask = np.zeros((n, W, H), np.int8)
    mask[0, 10:30, 8:28] = 1          # usable
    mask[0, 5:8, 5:8] = -1            # unknown region
    mask[1, 0:5, 0:5] = 1             # sub-10-px: skipped
    # frame 2 empty: skipped
    T_wc = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    return (W, H), (rgb, depth, mask, T_wc)


def _scene_case(scene, cls_id, held):
    frames = sorted(scene.sample_dict)
    rgb = np.stack([scene.sample_dict[f]["image"] for f in frames])
    depth = np.stack([scene.sample_dict[f]["depth"] for f in frames])
    mask = np.stack([(scene.sample_dict[f]["obj_mask"] == held)
                     for f in frames])
    T_wc = np.stack([scene.sample_dict[f]["T"] for f in frames])
    return rgb, depth, mask, T_wc


@pytest.mark.parametrize("case", ["contract", "scene"])
def test_build_observation_frames_is_bitwise(pair, case):
    """frames and frame_info equal the JAX package's: the loaders'
    10-px floor, the pixel-state mapping, the enlarged crops."""
    _, _, ts, js, cls_id, held = pair
    if case == "contract":
        (W, H), arrays = _contract_case()
        tcam = CameraInfo(W, H, 40.0, 40.0, W / 2.0, H / 2.0)
        jcam = JCameraInfo(W, H, 40.0, 40.0, W / 2.0, H / 2.0)
        inst = 7
    else:
        arrays, tcam, jcam, inst = (_scene_case(ts, cls_id, held), ts.cam,
                                    js.cam, held)
    got = fit.build_observation_frames(*arrays, tcam, inst)
    want = jfit.build_observation_frames(*arrays, jcam, inst)
    _assert_trees_equal(got, want)
    if case == "contract":
        frames, frame_info = got
        assert [fi["frame"] for fi in frame_info] == [0]
        om = frames[0]["obj_mask"]
        assert om[15, 15] == 7 and om[6, 6] == -1 and om[40, 30] == -2
    else:
        assert len(got[1]) == FIXTURE["n_frames"]


@pytest.mark.parametrize("bad", ["shapes", "no usable"])
def test_build_observation_frames_raises_as_the_jax_packages(bad):
    (W, H), (rgb, depth, mask, T_wc) = _contract_case()
    cam = CameraInfo(W, H, 40.0, 40.0, W / 2.0, H / 2.0)
    jcam = JCameraInfo(W, H, 40.0, 40.0, W / 2.0, H / 2.0)
    args = ((rgb[..., :2], depth, mask, T_wc) if bad == "shapes"
            else (rgb, depth, np.zeros_like(mask), T_wc))
    msgs = []
    for mod, c in ((fit, cam), (jfit, jcam)):
        with pytest.raises(ValueError, match=bad) as e:
            mod.build_observation_frames(*args, c, 7)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_accumulate_pointcloud_tsdf_is_bitwise(pair):
    """The TSDF route of /ingest (accumulate=tsdf): both packages run the
    same C++ sources; the held-out sphere's fused cloud, bitwise."""
    _, _, ts, js, cls_id, held = pair
    ti, ji = _info(ts, cls_id, held), _info(js, cls_id, held)
    got = accumulate_pointcloud_tsdf(held, ti["frame_info"], ts.sample_dict,
                                     ts.cam)
    want = jpointcloud.accumulate_pointcloud_tsdf(
        held, ji["frame_info"], js.sample_dict, js.cam)
    assert got.dtype == want.dtype and len(got) > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", ["zero", "small", "random", "large"])
def test_so3_exp_and_its_jacobian_match_jax(w):
    """Rodrigues' rotation and its Jacobian within 1e-6 of the JAX
    package's, at the identity (the 1e-12 guard keeps its gradient
    finite) and away from it."""
    rng = np.random.default_rng(0)
    x = {"zero": np.zeros(3), "small": np.array([1e-4, -2e-4, 5e-5]),
         "random": rng.normal(size=3) * 0.3,
         "large": np.array([1.0, -2.0, 0.5])}[w].astype(np.float32)
    got = fit._so3_exp(torch.tensor(x)).numpy()
    want = np.asarray(jfit._so3_exp(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=HOST_TOL)
    jac = torch.autograd.functional.jacobian(fit._so3_exp,
                                             torch.tensor(x)).numpy()
    jjac = np.asarray(jax.jacfwd(jfit._so3_exp)(jnp.asarray(x)))
    assert np.isfinite(jac).all()
    np.testing.assert_allclose(jac, jjac, rtol=0, atol=HOST_TOL)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["loss", "psnr", "grads", "update"])
@pytest.mark.parametrize("pose", [False, True], ids=["codes", "pose"])
def test_one_fit_step_matches_jax(pair, trajectory, pose, what):
    """The first step from the category-mean codes on the JAX package's
    draws: the loss within 1e-4 relative (its depth term is weighted), the
    PSNR within 1e-5, each gradient within 1e-4 of its largest entry, the
    Adam update within 1e-6 (2 lr where the gradient is within rounding of
    0)."""
    tsess, _, ts, _, cls_id, held = pair
    traj = trajectory["A" if pose else "C"]
    fitter, _ = _fitter(tsess, ts, cls_id, held, pose)
    first = {**traj, "steps": traj["steps"][:1],
             "final": (traj["steps"][1]["params"] if pose
                       else traj["final"])}
    check = _hold(fitter, first, traj["draws"][:2])
    bound, got = {"loss": (fc.LOSS_TOL, check.worst_loss),
                  "psnr": (fc.PSNR_TOL, check.worst_psnr),
                  "grads": (fc.GRAD_TOL, max(check.worst_grad,
                                             check.worst_pose_grad)),
                  "update": (1.0, check.worst_update)}[what]
    assert got <= bound, check.line()
    names = {n for n, _ in fc.named_leaves(fitter)}
    assert names == set(traj["steps"][0]["grads"])
    assert ("pose.w" in names) == pose


def test_the_trajectory_is_the_jax_packages_fit(pair, trajectory):
    """The test's copy of the JAX fit (schedule B: two one-step chunks
    on a subsampled instance) ends where the JAX package's fit_instance
    does, bitwise, with its initial and last losses."""
    traj, res = trajectory["B"], trajectory["B"]["result"]
    np.testing.assert_array_equal(traj["final"]["codes.shape"],
                                  res.shape_code)
    np.testing.assert_array_equal(traj["final"]["codes.texture"],
                                  res.texture_code)
    assert traj["init"] == [res.init_loss, res.init_psnr]
    assert [traj["steps"][-1][k] for k in ("loss", "psnr")] == \
        [res.final_loss, res.final_psnr]


def test_twenty_fit_steps_held_from_each_jax_state(pair, trajectory):
    """Each of the 20 steps of schedule A from the JAX state it starts
    from (pose refinement on) holds the step bounds."""
    tsess, _, ts, _, cls_id, held = pair
    fitter, _ = _fitter(tsess, ts, cls_id, held, True)
    check = _hold(fitter, trajectory["A"], trajectory["A"]["draws"])
    assert check.steps == N_STEPS
    assert not check.failures(), check.line()


def test_fit_instance_on_the_jax_draws(pair, trajectory):
    """fit_instance over 20 steps on schedule A: its initial loss and
    PSNR as the JAX package's; its steps are the fitter's, so they hold
    as above; the codes stay near the JAX package's (the free runs part
    by the loss's conditioning, ~1e-5 here)."""
    tsess, _, ts, _, cls_id, held = pair
    traj = trajectory["A"]
    info = _info(ts, cls_id, held)
    res = fit.fit_instance(tsess, cls_id, info["frame_info"], ts.sample_dict,
                           tsess.cam, info["T_obj"], held, steps=N_STEPS,
                           n_rays=N_RAYS, lr=LR, optimize_pose=True,
                           draws=traj["draws"])
    assert res.steps == N_STEPS
    init_loss, init_psnr = traj["init"]
    assert abs(res.init_loss - init_loss) <= fc.LOSS_TOL * abs(init_loss)
    assert abs(res.init_psnr - init_psnr) <= fc.PSNR_TOL * abs(init_psnr)
    last = traj["steps"][-1]
    assert abs(res.final_psnr - last["psnr"]) <= 1e-2 * abs(last["psnr"])
    np.testing.assert_allclose(res.shape_code, traj["final"]["codes.shape"],
                               rtol=0, atol=1e-3)
    assert res.final_psnr > res.init_psnr
    with pytest.raises(ValueError, match="draws"):
        fit.fit_instance(tsess, cls_id, info["frame_info"], ts.sample_dict,
                         tsess.cam, info["T_obj"], held, steps=N_STEPS,
                         optimize_pose=True, draws=traj["draws"][:-1])


def test_extent_and_refined_pose_match_jax(pair, trajectory):
    """From the JAX package's final state of schedule B, the refined pose
    T_obj @ D and the observed extent (float64 on the host) within 1e-6 of
    what the JAX package's fit_instance returned."""
    tsess, _, ts, _, cls_id, held = pair
    traj, res = trajectory["B"], trajectory["B"]["result"]
    fitter, arrays = _fitter(tsess, ts, cls_id, held, True, MAX_RAYS_B)
    last = traj["steps"][-1]
    fc.set_state(fitter, traj["final"], last["mu"], last["nu"],
                 last["count"] + 1)
    got = fit.finish_fit(fitter, arrays, _info(ts, cls_id, held)["T_obj"],
                         None, 2, *traj["init"], last["loss"], last["psnr"])
    np.testing.assert_allclose(got.T_obj, res.T_obj, rtol=0, atol=HOST_TOL)
    np.testing.assert_allclose(got.extent, res.extent, rtol=0,
                               atol=HOST_TOL)
    assert got.T_obj.dtype == got.extent.dtype == np.float64
    np.testing.assert_array_equal(got.shape_code, res.shape_code)
    assert not np.allclose(got.T_obj, _info(ts, cls_id, held)["T_obj"])


def test_shift_ties_moves_every_ray_off_a_kink(pair, monkeypatch):
    """The card-vs-CPU check's redraw of the rays on a kink (a depth
    residual or a ReLU pre-activation within rounding of 0), here with
    the depth tie widened to 5 cm so that some rays are on it: the spy
    sees the field's per-sample ReLU layers, and after the shift no ray
    is tied, every row below the instance's count."""
    tsess, _, ts, _, cls_id, held = pair
    fitter, _ = _fitter(tsess, ts, cls_id, held, True)
    monkeypatch.setattr(fc, "DEPTH_TIE", 0.05)
    d = fitter.draw()
    assert fc.tied_rays(fitter, d).any()
    layers = []
    relu = torch.relu
    monkeypatch.setattr(torch, "relu",
                        lambda a: layers.append(a.shape) or relu(a))
    fc.tied_rays(fitter, d)
    monkeypatch.setattr(torch, "relu", relu)
    per_sample = [s for s in layers if len(s) == 3]
    assert len(per_sample) >= 5 and all(s[0] == N_RAYS for s in per_sample)
    assert all(len(s) == 1 for s in layers if len(s) != 3)  # the codes'
    shifted, k = fc.shift_ties(fitter, d, torch.Generator().manual_seed(0))
    assert k > 0 and not fc.tied_rays(fitter, shifted).any()
    assert int(shifted.idx.max()) < fitter.n
    assert torch.equal(shifted.u, d.u)


def test_the_card_check_holds_a_fitter_against_its_twin(pair):
    """fit_card_vs_cpu's plumbing on the CPU: a fitter against its twin
    (cpu_twin), the same steps from the same states, without a
    difference."""
    tsess, _, ts, _, cls_id, held = pair
    fitter, arrays = _fitter(tsess, ts, cls_id, held, True)
    check = fc.fit_card_vs_cpu(fitter, fc.cpu_twin(fitter, arrays), 3, LR)
    assert check.steps == 3 and not check.failures()
    assert check.worst_loss == check.worst_grad == check.worst_update == 0


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def _fit_call(sess, scene, cls_id, held, **kw):
    info = _info(scene, cls_id, held)
    return fit.fit_instance(sess, cls_id, info["frame_info"],
                            scene.sample_dict, sess.cam, info["T_obj"],
                            held, **{"n_rays": 32, **kw})


@pytest.mark.parametrize("bad,kw,match", [
    ("steps", dict(steps=0), "steps must be >= 1"),
    ("init", dict(steps=1, init="median"), "init must be mean|zero"),
    ("rays", dict(steps=1, frame_info=[]), "no rays"),
])
def test_fit_rejects_as_the_jax_package(pair, bad, kw, match):
    tsess, _, ts, _, cls_id, held = pair
    if bad == "rays":
        with pytest.raises(ValueError, match=match):
            fit.fit_instance(tsess, cls_id, [], ts.sample_dict, tsess.cam,
                             _info(ts, cls_id, held)["T_obj"], held,
                             steps=1)
        return
    with pytest.raises(ValueError, match=match):
        _fit_call(tsess, ts, cls_id, held, **kw)


def test_fit_rejects_a_single_instance_category():
    scene = make_scene(n_frames=3, width=48, height=36, n_categories=1,
                       insts_per_cat=1, seed=8)
    cfg = _configure(Config())
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    cls_id = sess.cls_ids[0]
    inst = sess.categories[0].obj_ids[0]
    with pytest.raises(ValueError, match="single-instance"):
        _fit_call(sess, scene, cls_id, inst, steps=10)


@pytest.mark.parametrize("bad", [0, -1])
def test_ingest_rejects_nonpositive_ids(pair, bad):
    tsess = pair[0]
    W, H = tsess.cam.width, tsess.cam.height
    with pytest.raises(ValueError, match="must be > 0"):
        fit.ingest_new_instance(
            tsess, tsess.cls_ids[0], np.zeros((1, W, H, 3), np.uint8),
            np.zeros((1, W, H), np.float32), np.zeros((1, W, H), np.int8),
            np.eye(4)[None], inst_id=bad)


def test_ingest_rejects_unknown_categories_and_taken_ids(pair):
    tsess = pair[0]
    W, H = tsess.cam.width, tsess.cam.height
    obs = (np.zeros((1, W, H, 3), np.uint8), np.zeros((1, W, H), np.float32),
           np.zeros((1, W, H), np.int8), np.eye(4)[None])
    with pytest.raises(ValueError, match="unknown category 424242"):
        fit.ingest_new_instance(tsess, 424242, *obs)
    taken = tsess.categories[0].obj_ids[0]
    with pytest.raises(ValueError, match=f"instance id {taken} already"):
        fit.ingest_new_instance(tsess, tsess.cls_ids[0], *obs,
                                inst_id=taken)


# ---------------------------------------------------------------------------
# adoption, checkpoints
# ---------------------------------------------------------------------------

ADOPT_SCENE = dict(n_frames=3, width=48, height=36, n_categories=1,
                   insts_per_cat=3, seed=11)


def _record(cls_id, inst_id, seed=0):
    rng = np.random.default_rng(seed)
    return {"cls": int(cls_id), "id": int(inst_id),
            "extent": (0.5 + rng.random(3)).tolist(),
            "obj_tensor": [0.4, 1.0, 0.0, 0.0, 0.0, *rng.normal(size=3)]}


@pytest.fixture(scope="module")
def adopted():
    """A pair on the small adoption scene (two instances trained, one
    held out): the port's session after one step (its AdamW has moments),
    then fitted and adopted, with the renders before and after."""
    tsess, jsess, ts, js, cls_id, held = _pair(ADOPT_SCENE, bias=0.0)
    tsess.step_once()
    tsess.enable_fast_path(2, graph=False)
    before_ids = list(tsess.categories[0].obj_ids)
    cam = CameraInfo(24, 18, 20.0, 20.0, 12.0, 9.0)
    T = np.asarray(ts.sample_dict[0]["T"], np.float32)
    before = render_scene_view(tsess, T, cam, near=0.05, far=6.0, n_bins=8)
    res = _fit_call(tsess, ts, cls_id, held, steps=5)
    moments = {k: v.clone() for k, v in tsess.state.optimizer.state[
        tsess.state.params.codes.shape].items()}
    fit.adopt_instance(tsess, cls_id, held, res)
    after = render_scene_view(tsess, T, cam, near=0.05, far=6.0, n_bins=8)
    return dict(tsess=tsess, jsess=jsess, ts=ts, cls_id=cls_id, held=held,
                res=res, before=before, after=after, moments=moments,
                before_ids=before_ids)


def test_adopting_into_a_full_category_grows_as_the_jax_package(adopted):
    """The code tables and their AdamW moments one slot wider, as the JAX
    package's _adopt_slot grows them, the fitted codes at the new slot,
    zero moments there, the old moments and step counts kept."""
    a = adopted
    tsess, jsess, cls_id, held = a["tsess"], a["jsess"], a["cls_id"], a["held"]
    assert a["before_ids"] == tsess.categories[0].obj_ids[:2]
    jfit.apply_adopted_record(jsess, _record(cls_id, held))
    codes = tsess.state.params.codes
    jcodes = jsess.state.params["codes"]
    assert tuple(codes.shape.shape) == jcodes["shape"].shape == (1, 3, 16)
    assert tuple(codes.texture.shape) == jcodes["texture"].shape
    cat = tsess.categories[0]
    k = cat.inst_id_to_index[held]
    assert k == 2 and cat.n_obj == 3
    np.testing.assert_array_equal(codes.shape.detach()[0, k].numpy(),
                                  a["res"].shape_code)
    np.testing.assert_array_equal(codes.texture.detach()[0, k].numpy(),
                                  a["res"].texture_code)
    assert tsess.obj_mask.tolist() == [[True, True, True]]
    opt = tsess.state.optimizer
    group = next(g for g in opt.param_groups if g["name"] == "codes")
    assert group["params"][0] is codes.shape
    assert group["params"][1] is codes.texture
    st = opt.state[codes.shape]
    for name in ("exp_avg", "exp_avg_sq"):
        assert st[name].shape == codes.shape.shape
        assert not st[name][:, 2].any()
        torch.testing.assert_close(st[name][:, :2], a["moments"][name],
                                   rtol=0, atol=0)
    assert torch.equal(st["step"], a["moments"]["step"])
    assert tsess.adopted_instances[0]["id"] == held


def test_a_category_with_a_free_slot_is_written_in_place():
    scene = make_scene(n_frames=3, width=48, height=36, n_categories=2,
                       insts_per_cat=3, seed=11)
    cls_ids = sorted(c for c in scene.inst_dict if c != 0)
    inst = copy.deepcopy(scene.inst_dict)
    held = sorted(inst[cls_ids[0]])[-1]
    del inst[cls_ids[0]][held]
    sess = TrainingSession(_configure(Config()), inst, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    table = sess.state.params.codes.shape
    fit.apply_adopted_record(sess, _record(cls_ids[0], held))
    assert sess.state.params.codes.shape is table
    assert tuple(table.shape) == (2, 3, 16)
    assert not table.detach()[0, 2].any()
    assert sess.obj_mask.tolist() == [[True] * 3, [True] * 3]
    with pytest.raises(ValueError, match="already exists"):
        fit.apply_adopted_record(sess, _record(cls_ids[0], held))


def test_the_session_trains_after_adoption(adopted):
    """A host-staged step and a step of the rebuilt fast path (its store
    keeps the original instances' rays only)."""
    tsess = adopted["tsess"]
    assert tsess._fast_state is tsess.state
    m = tsess.step_once()
    assert np.isfinite(float(m.total))
    m = tsess.run_fast(2)
    assert np.isfinite(float(m.total))


def test_a_render_after_adoption_shows_the_adoptee(adopted):
    """The scene composite's staging cache is keyed by the adopted count:
    the render after adoption differs from the one before."""
    before, after = adopted["before"], adopted["after"]
    assert before[0].shape == after[0].shape == (24, 18, 3)
    assert np.isfinite(after[0]).all()
    assert not np.array_equal(before[0], after[0])


def _assert_params_equal(a, b):
    pa, pb = (dict(s.state.params.named_parameters()) for s in (a, b))
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def _fast(sess, seed):
    gen = torch.Generator().manual_seed(seed)
    offs, boff = draw_offsets(sess._store, gen)
    return [FastDraws(offs, boff, sess._draws(gen))]


def test_an_adopted_checkpoint_restores_bitwise_and_steps_alike(adopted,
                                                                tmp_path):
    """save with the sidecar, restore into a fresh session built from the
    adoptee-less instances: every parameter and AdamW tensor bitwise, the
    metadata and records equal, and the next fast-path step of each on
    the same draws bitwise."""
    a = adopted
    tsess = a["tsess"]
    path = ckpt.save_session_checkpoint(str(tmp_path), tsess, 7)
    assert os.path.exists(f"{path}.adopted.json")
    ts = a["ts"]
    _, _, train = _held_out(ts.inst_dict)
    fresh = TrainingSession(tsess.cfg, train, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    ckpt.restore_session_checkpoint(path, fresh)
    assert fresh.adopted_instances == tsess.adopted_instances
    assert fresh.iteration == tsess.state.step
    held, cat, cat2 = a["held"], tsess.categories[0], fresh.categories[0]
    assert cat2.obj_ids == cat.obj_ids
    np.testing.assert_array_equal(cat2.extent_dict[held],
                                  cat.extent_dict[held])
    np.testing.assert_array_equal(cat2.object_tensor_dict[held],
                                  cat.object_tensor_dict[held])
    _assert_params_equal(tsess, fresh)
    s1, s2 = (s.state.optimizer.state_dict()["state"]
              for s in (tsess, fresh))
    assert s1.keys() == s2.keys()
    for k in s1:
        for name in s1[k]:
            assert torch.equal(s1[k][name], s2[k][name]), (k, name)
    assert torch.equal(fresh.obj_mask, tsess.obj_mask)
    # the device store is built from the host ray buffers in their epoch
    # cursor's order, which no checkpoint holds (in either package); the
    # trained session's step_once has drawn one batch ahead (its prefetch)
    # and may have reshuffled them, so the fresh session takes its order
    tsess.release_prefetch()
    for c2, c in zip(fresh.categories + [fresh.background],
                     tsess.categories + [tsess.background]):
        c2.buffer.arrays, c2.buffer.cursor = c.buffer.arrays, c.buffer.cursor
    tsess.enable_fast_path(1, graph=False)
    fresh.enable_fast_path(1, graph=False)
    m1 = tsess.run_fast(1, _fast(tsess, 5))
    m2 = fresh.run_fast(1, _fast(fresh, 5))
    assert all(torch.equal(x, y) for x, y in zip(m1, m2))
    _assert_params_equal(tsess, fresh)


def test_a_fresh_session_takes_the_sidecar_before_any_step(adopted,
                                                           tmp_path):
    """A fresh session has no AdamW moments: applying the record still
    leaves a template that load_checkpoint accepts (the saved moments
    come from the file)."""
    tsess = adopted["tsess"]
    path = ckpt.save_session_checkpoint(str(tmp_path), tsess, 9)
    fresh = TrainingSession(tsess.cfg, _held_out(adopted["ts"].inst_dict)[2],
                            adopted["ts"].sample_dict,
                            cam=adopted["ts"].cam, device="cpu")
    assert not fresh.state.optimizer.state
    ckpt.restore_session_checkpoint(path, fresh)
    st = fresh.state.optimizer.state[fresh.state.params.codes.shape]
    assert st["exp_avg"].shape == (1, 3, 16)


def test_a_stale_sidecar_is_removed_on_an_adoptee_less_save(tmp_path):
    scene = make_scene(**ADOPT_SCENE)
    sess = TrainingSession(_configure(Config()), scene.inst_dict,
                           scene.sample_dict, cam=scene.cam, device="cpu")
    stale = tmp_path / "7.adopted.json"
    stale.write_text(json.dumps([_record(1, 5)]))
    path = ckpt.save_session_checkpoint(str(tmp_path), sess, 7)
    assert not stale.exists() and os.path.exists(path)
    ckpt.restore_session_checkpoint(path, sess)
    assert sess.adopted_instances == []


def test_the_sidecar_is_the_one_the_jax_package_writes(adopted, tmp_path):
    """The same records applied to both packages' sessions: the
    `.adopted.json` files are byte for byte the same."""
    a = adopted
    _, jsess, _, _, cls_id, held = _pair(ADOPT_SCENE)
    tsess = TrainingSession(a["tsess"].cfg,
                            _held_out(a["ts"].inst_dict)[2],
                            a["ts"].sample_dict, cam=a["ts"].cam,
                            device="cpu")
    for k, oid in enumerate((held, held + 40)):
        rec = _record(cls_id, oid, seed=k)
        fit.apply_adopted_record(tsess, rec)
        jfit.apply_adopted_record(jsess, rec)
    mine = ckpt.save_session_checkpoint(str(tmp_path / "port"), tsess, 3)
    theirs = jckpt.save_session_checkpoint(str(tmp_path / "jax"), jsess, 3)
    with open(f"{mine}.adopted.json", "rb") as f1, \
            open(f"{theirs}.adopted.json", "rb") as f2:
        assert f1.read() == f2.read()

