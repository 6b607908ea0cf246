"""The port's renderer (`catnerf_torch/render_views.py`) against the JAX
package's, on the CPU.

Both packages build their sessions from the same `make_scene` seed; the
port's weights come from the JAX session through
`convert.params_from_jax`. The host helpers (poses, framing, masks, the
numpy composite) agree within 1e-6; the renders (rgb, depth, alpha) within
1e-5 absolute: float32 field evaluations summed in two orders.
"""

from __future__ import annotations

import copy
import os
import sys
import threading

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_torch import convert, render_views as rv
from catnerf_torch.config import Config
from catnerf_torch.data import png
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.models import codenerf as tcodenerf
from catnerf_torch.models import embedding as tembedding
from catnerf_torch.models import occupancy as toccupancy
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state
from catnerf_tpu import render_views as jrv
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.train.loop import TrainingSession as JSession

torch.set_num_threads(1)

RENDER_TOL = 1e-5
HOST_TOL = 1e-6


def _configure(cfg):
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 32
    return cfg


def _soften(jsess, bias: float) -> None:
    """The JAX session's initial weights with each occupancy head scaled
    down (w x 0.1, b = `bias`): the initial fields saturate every ray
    within a few bins (alpha 1 everywhere); with b = -0.3 part of each view
    stays empty, with b = 0 the occupancy crosses 0.5 (a surface to
    mesh)."""
    tree = jax.tree_util.tree_map(np.asarray, jsess.state.params)
    for fc, head in (("cat_fc", "sigma"), ("bg_fc", "out_alpha")):
        tree[fc][head] = {"w": tree[fc][head]["w"] * np.float32(0.1),
                          "b": np.full_like(tree[fc][head]["b"], bias)}
    jsess.state = jsess.state._replace(
        params=jax.tree_util.tree_map(jnp.asarray, tree))


def _pair(insts: int = 2, n_categories: int = 2, seed: int = 3,
          bias: float = -0.3):
    """(port session on the CPU, JAX session): the same scene, the JAX
    session's (softened) initial weights in both."""
    scene = dict(n_frames=3, width=48, height=36, n_categories=n_categories,
                 insts_per_cat=insts, seed=seed)
    js = jmake_scene(**scene)
    jsess = JSession(_configure(JConfig()), js.inst_dict, js.sample_dict,
                     cam=js.cam)
    _soften(jsess, bias)
    ts = make_scene(**scene)
    cfg = _configure(Config())
    tsess = TrainingSession(cfg, ts.inst_dict, ts.sample_dict, cam=ts.cam,
                            device="cpu")
    tsess.state = make_train_state(
        cfg, convert.params_from_jax(jsess.state.params))
    return tsess, jsess


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def single_pair():
    return _pair(insts=1)


def _close(got, want, tol=RENDER_TOL):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

HELPER_CASES = {
    "look_at": [((2.0, -1.0, 1.5), (0.2, 0.3, -0.1)),
                ((0.0, 0.0, 3.0), (0.0, 0.0, 0.0)),   # along up
                ((0.0, 0.0, 0.0), (0.0, 0.0, -2.0))],
    "orbit_eye": [(0.3, 0.4, 2.0, (1.0, 0.0, 0.5)), (np.pi / 2, 0.0, 1.0),
                  (0.0, np.pi / 2, 2.5)],
    "orbit_frame": [(np.array([0.6, 0.4, 0.9]),),
                    (np.array([0.6, 0.4, 0.9]), 5.0), ([3.0, 0.1, 0.1], 0.2)],
    "orbit_poses": [(6, 3.0, (1.0, 0.0, 0.0)), (3, 1.5, (0.0, 0.2, 0.1), 40.0)],
    "default_orbit_cam": [(320, 240), (160, 120), (1280, 960)],
    "spread_frames": [(list(range(24)), 4), (list(range(3)), 8),
                      ([5, 9, 11], 2)],
}


@pytest.mark.parametrize("name", sorted(HELPER_CASES))
def test_pose_helpers_equal_the_jax_packages(name):
    for args in HELPER_CASES[name]:
        got = getattr(rv, name)(*args)
        want = getattr(jrv, name)(*args)
        if name == "default_orbit_cam":
            got = [got.width, got.height, got.fx, got.fy, got.cx, got.cy,
                   got.rays_dir_cache]
            want = [want.width, want.height, want.fx, want.fy, want.cx,
                    want.cy, want.rays_dir_cache]
        if name == "spread_frames":
            assert got == want
            continue
        for g, w in zip(np.atleast_1d(np.asarray(got, dtype=object)),
                        np.atleast_1d(np.asarray(want, dtype=object))):
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=0, atol=HOST_TOL)


@pytest.mark.parametrize("which", ["multi", "single"])
def test_framing_and_masks_equal_the_jax_packages(which, pair, single_pair):
    """instance_frame and instance_mask_box for each object alone and for
    a category's instances together, and scene_far."""
    tsess, jsess = pair if which == "multi" else single_pair
    assert rv.scene_far(tsess) == pytest.approx(jrv.scene_far(jsess),
                                                abs=HOST_TOL)
    for cls_id, cat in zip(tsess.cls_ids, tsess.categories):
        groups = [[o] for o in cat.obj_ids] + [list(cat.obj_ids)]
        for objs in groups:
            for fn in ("instance_frame", "instance_mask_box"):
                got = getattr(rv, fn)(tsess, cls_id, objs)
                want = getattr(jrv, fn)(jsess, cls_id, objs)
                assert (got is None) == (want is None)
                for g, w in zip(got or (), want or ()):
                    np.testing.assert_allclose(g, w, rtol=0, atol=HOST_TOL)


def test_composite_equals_the_jax_packages():
    rng = np.random.default_rng(0)
    occ = rng.uniform(0, 1, (5, 7, 12))
    rgb = rng.uniform(0, 1, (5, 7, 12, 3))
    z = np.linspace(0.5, 3.0, 12)
    for g, w in zip(rv._composite(occ, rgb, z), jrv._composite(occ, rgb, z)):
        np.testing.assert_allclose(g, w, rtol=0, atol=HOST_TOL)


# ---------------------------------------------------------------------------
# renders
# ---------------------------------------------------------------------------

CAM = CameraInfo(40, 30, 35.0, 35.0, 20.0, 15.0)


def _object_args(sess, cls_pos=0, obj_pos=0):
    cls_id = sess.cls_ids[cls_pos]
    cat = sess.categories[cls_pos]
    params = sess.category_params(cls_id)
    k = cat.inst_id_to_index[cat.obj_ids[obj_pos]]
    return cls_id, cat.obj_ids[obj_pos], params, \
        np.asarray(params["shape_codes"][k]), \
        np.asarray(params["texture_codes"][k])


@pytest.mark.parametrize("field", ["codenerf", "codenerf_masked",
                                   "background"])
def test_render_view_equals_the_jax_packages(pair, field):
    """40 x 30 x 12 bins in tiles of 4,096 points (a ragged last tile)."""
    tsess, jsess = pair
    kw = dict(near=0.3, far=3.0, n_bins=12, chunk=4096)
    if field == "background":
        T = np.asarray(tsess.sample_dict[0]["T"], np.float32)
        got = rv.render_view(tsess.background_params(), tsess.cfg, T, CAM,
                             is_background=True, **{**kw, "far": 6.0})
        want = jrv.render_view(jsess.background_params(), jsess.cfg, T, CAM,
                               is_background=True, **{**kw, "far": 6.0})
    else:
        T = rv.look_at((1.5, 0.5, 1.0))
        cls_id, obj, tp, sc, tc = _object_args(tsess, 1, 1)
        _, _, jp, jsc, jtc = _object_args(jsess, 1, 1)
        np.testing.assert_array_equal(sc, jsc)
        mask = (rv.instance_mask_box(tsess, cls_id, [obj])
                if field == "codenerf_masked" else None)
        got = rv.render_view(tp, tsess.cfg, T, CAM, shape_code=sc,
                             texture_code=tc, mask_box=mask, **kw)
        want = jrv.render_view(jp, jsess.cfg, T, CAM, shape_code=jsc,
                               texture_code=jtc, mask_box=mask, **kw)
        if mask is not None:  # the box clips part of the field
            unmasked = rv.render_view(tp, tsess.cfg, T, CAM, shape_code=sc,
                                      texture_code=tc, **kw)
            assert (got[2] <= unmasked[2] + 1e-6).all()
            assert not np.allclose(got[2], unmasked[2])
    assert got[0].shape == (40, 30, 3) and got[1].shape == (40, 30)
    assert 0.01 < got[2].mean() < 0.99  # neither empty nor saturated
    _close(got, want)


@pytest.mark.parametrize("which", ["multi", "single"])
def test_render_scene_view_equals_the_jax_packages(which, pair, single_pair):
    """Two categories and the background composited from a dataset pose
    (multi-instance: canonical frames through the inverse sim(3);
    single-instance: world frame in the OBB)."""
    tsess, jsess = pair if which == "multi" else single_pair
    cam = CameraInfo(32, 24, 28.0, 28.0, 16.0, 12.0)
    T = np.asarray(tsess.sample_dict[1]["T"], np.float32)
    kw = dict(near=0.1, far=6.0, n_bins=10, chunk=2048)
    shares = []
    tile = rv._scene_tile

    def spy(staged, bg_params, cfg, p):
        x_m = p @ staged["Am"].transpose(1, 2) + staged["bm"][:, None]
        inside = (x_m.abs() <= staged["half"][:, None]).all(-1).any(0)
        shares.append(float(inside.float().mean()))
        return tile(staged, bg_params, cfg, p)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rv, "_scene_tile", spy)
        got = rv.render_scene_view(tsess, T, cam, **kw)
    # the object fields ran on part of the points only, in some tile
    assert any(0.0 < share < 1.0 for share in shares), shares
    want = jrv.render_scene_view(jsess, T, cam, **kw)
    n_obj = 4 if which == "multi" else 2
    assert tsess._scene_staging_cache[1]["n_obj"] == n_obj
    assert jsess._scene_staging_cache[1]["n_obj"] == n_obj
    _close(got, want)


def test_a_scene_without_renderable_objects_renders_the_background(
        single_pair, monkeypatch):
    """No object has a bound: the composite falls back to the background
    alone, as the JAX package's does."""
    tsess, jsess = single_pair
    for sess in (tsess, jsess):
        for cat in sess.categories:
            monkeypatch.setattr(cat, "bound_dict", {})
        monkeypatch.setattr(sess, "_scene_staging_cache", None,
                            raising=False)
    cam = CameraInfo(24, 18, 21.0, 21.0, 12.0, 9.0)
    T = np.asarray(tsess.sample_dict[0]["T"], np.float32)
    kw = dict(near=0.1, far=6.0, n_bins=8, chunk=2048)
    got = rv.render_scene_view(tsess, T, cam, **kw)
    assert tsess._scene_staging_cache[1] is None
    _close(got, jrv.render_scene_view(jsess, T, cam, **kw))
    _close(got, rv.render_view(tsess.background_params(), tsess.cfg, T, cam,
                               is_background=True, **kw), tol=0.0)


def _dense_tile(staged, bg_params, cfg, p):
    """The dense tile that the slotted `_scene_tile` replaced, as a plain
    reference: every object field on every point inside some box, masked
    to its own box afterwards."""
    x_m = p @ staged["Am"].transpose(1, 2) + staged["bm"][:, None]
    mask = (x_m.abs() <= staged["half"][:, None]).all(-1)
    inside = mask.any(0).nonzero().squeeze(1)
    one_minus = torch.ones_like(p[:, 0])
    csum = torch.zeros_like(p)
    wsum = torch.zeros_like(p[:, 0])
    if inside.numel():
        x_e = p[inside] @ staged["A"].transpose(1, 2) + staged["b"][:, None]
        emb = tembedding.apply(staged["pe"], x_e, scale=cfg.obj_scale,
                               max_deg=cfg.n_unidir_funcs)
        sigma, rgbs = tcodenerf.apply(staged["fc"], emb,
                                      staged["sc"][:, None],
                                      staged["tc"][:, None])
        occs = torch.sigmoid(sigma[..., 0]) * mask[:, inside].float()
        one_minus[inside] = torch.prod(1.0 - occs, dim=0)
        csum[inside] = (occs[..., None] * rgbs).sum(0)
        wsum[inside] = occs.sum(0)
    emb = tembedding.apply(bg_params["pe"], p, scale=cfg.bg_scale,
                           max_deg=cfg.n_unidir_funcs)
    sigma, rgb = toccupancy.apply(bg_params["fc"], emb)
    occb = torch.sigmoid(sigma[..., 0])
    one_minus = one_minus * (1.0 - occb)
    csum = csum + occb[:, None] * rgb
    wsum = wsum + occb
    return 1.0 - one_minus, csum / torch.clamp(wsum[:, None], min=1e-8)


def _on(tree: dict, device) -> dict:
    """A copy of a dict of tensors and modules on `device`."""
    return {k: (copy.deepcopy(v).to(device) if isinstance(v, torch.nn.Module)
                else v.to(device) if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def _tile_case(case: str, n_obj: int):
    """(Am, bm, half [n_obj, ...] world-frame boxes, points p [n, 3]) of
    one handmade tile."""
    gen = torch.Generator().manual_seed(7)
    Am = torch.eye(3).expand(n_obj, 3, 3).clone()
    centers = torch.tensor([[0.0, 0.0, 0.0], [0.3, 0.0, 0.0],
                            [0.0, 0.3, 0.1], [2.0, 2.0, 2.0]])[:n_obj]
    half = torch.full((n_obj, 3), 0.4)
    if case == "many":  # object 0 holds more points than a slot
        half[0] = 1.0
        p = torch.rand(4 * rv.SLOT_ROWS, 3, generator=gen) * 2.4 - 1.2
    elif case == "empty":  # no point inside any box
        p = torch.rand(300, 3, generator=gen) + 5.0
    else:
        p = torch.rand(600, 3, generator=gen) * 3.0 - 0.5
        p[0] = torch.tensor([0.15, 0.15, 0.05])  # inside boxes 0, 1 and 2
    if case == "dropped":
        half = torch.full_like(half, -1.0)
    return Am, -centers, half, p


@pytest.mark.parametrize("device", ["cpu", pytest.param(
    "cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("case", ["overlap", "empty", "many", "dropped",
                                  "replay"])
def test_the_slotted_scene_tile_equals_the_dense_one(pair, case, device):
    """_scene_tile runs each object only on its own box's points, in
    object-major slots; the union equals the dense evaluation's within
    1e-6, and two calls agree bit for bit. Cases: a point inside three
    overlapping boxes, a tile with no point in any box, an object with
    more inside points than a slot holds, the boxes dropped (half = -1:
    the background alone), and a second tile of the same size and slot
    count, its points in reverse order (on a CUDA device it replays the
    first tile's graph on new inputs)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tsess, _ = pair
    staged = rv._stage_scene_fields(tsess, 1.3)
    Am, bm, half, p = _tile_case(case, staged["n_obj"])
    staged = _on({**staged, "Am": Am, "bm": bm, "half": half}, device)
    bg = _on(tsess.background_params(), device)
    p = p.to(device)
    counts = ((p @ staged["Am"].transpose(1, 2) + staged["bm"][:, None])
              .abs() <= staged["half"][:, None]).all(-1).sum(1).tolist()
    if case in ("overlap", "replay"):
        inside = ((p[0] + staged["bm"]).abs() <= staged["half"]).all(-1)
        assert inside.tolist()[:3] == [True, True, True]
        assert 0 < sum(counts) < p.shape[0]
    elif case == "many":
        assert counts[0] > rv.SLOT_ROWS
    else:
        assert sum(counts) == 0
    with torch.inference_mode():
        got = rv._scene_tile(staged, bg, tsess.cfg, p)
        again = rv._scene_tile(staged, bg, tsess.cfg, p)
        want = _dense_tile(staged, bg, tsess.cfg, p)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=0, atol=1e-6)
    if case == "dropped":  # the background alone, as with no box at all
        empty = {**staged, "half": torch.zeros_like(staged["half"]),
                 "bm": staged["bm"] + 100.0}
        with torch.inference_mode():
            alone = rv._scene_tile(empty, bg, tsess.cfg, p)
        for g, a in zip(got, alone):
            assert torch.equal(g, a)
    if case == "replay":
        q = p.flip(0)
        with torch.inference_mode():
            got = rv._scene_tile(staged, bg, tsess.cfg, q)
            want = _dense_tile(staged, bg, tsess.cfg, q)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=0, atol=1e-6)
        if device == "cuda":  # one graph, captured once and replayed
            assert len(staged["graphs"].graphs) == 1


@pytest.mark.cuda
def test_threads_sharing_a_stagings_graphs_get_their_own_tiles(pair):
    """Threads rendering tiles of one staging at once on a CUDA device
    replay its shared graphs: each gets its own tile's union, bitwise the
    eager one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    tsess, _ = pair
    cfg = tsess.cfg
    staged = rv._stage_scene_fields(tsess, 1.3)
    Am, bm, half, p = _tile_case("overlap", staged["n_obj"])
    staged = _on({**staged, "Am": Am, "bm": bm, "half": half}, "cuda")
    tiles, wants = [], []
    with torch.inference_mode():
        for k in range(16):  # the same counts, so one graph for all
            q = p.roll(37 * k, 0).cuda()
            mask = ((q @ staged["Am"].transpose(1, 2)
                     + staged["bm"][:, None]).abs()
                    <= staged["half"][:, None]).all(-1)
            counts = mask.sum(1)
            n_slots = rv._slot_bucket(sum(-(-h // rv.SLOT_ROWS)
                                          for h in counts.tolist()))
            tiles.append((q, mask, counts, n_slots))
            wants.append(rv._object_union(staged, cfg, n_slots, q, mask,
                                          counts))
    failures = []

    def work(k):
        q, mask, counts, n_slots = tiles[k]
        try:
            with torch.inference_mode():
                for _ in range(10):
                    got, _ = staged["graphs"](staged, cfg, n_slots, q, mask,
                                              counts)
                    if not all(torch.equal(g, w)
                               for g, w in zip(got, wants[k])):
                        failures.append(k)
        except Exception as e:  # a thread's error fails the test below
            failures.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(len(tiles))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert failures == []
    assert len(staged["graphs"].graphs) == 1


@pytest.mark.parametrize("how", ["step_once", "run_fast"])
def test_the_staging_cache_is_hit_then_invalidated_by_training(how):
    """A second render reuses the staged fields; a training step
    (step_once, or run_fast's steps, which add k to the step at once)
    makes the next render stage the new parameters."""
    tsess, _ = _pair(n_categories=1)
    cam = CameraInfo(24, 18, 21.0, 21.0, 12.0, 9.0)
    T = np.asarray(tsess.sample_dict[0]["T"], np.float32)
    kw = dict(near=0.1, far=6.0, n_bins=8, chunk=2048)
    img1, _, _ = rv.render_scene_view(tsess, T, cam, **kw)
    ver1, staged1 = tsess._scene_staging_cache
    img2, _, _ = rv.render_scene_view(tsess, T, cam, **kw)
    assert tsess._scene_staging_cache[1] is staged1
    np.testing.assert_array_equal(img1, img2)
    if how == "step_once":
        tsess.step_once()
    else:
        tsess.enable_fast_path(2)
        tsess.run_fast(2)
    img3, _, _ = rv.render_scene_view(tsess, T, cam, **kw)
    ver3, staged3 = tsess._scene_staging_cache
    assert ver3 != ver1 and staged3 is not staged1
    assert ver3[0] == (1 if how == "step_once" else 2)
    assert not np.array_equal(img1, img3)
    # the staged rows are the session's parameters after the step
    np.testing.assert_array_equal(
        staged3["sc"][0], tsess.state.params.codes.shape[0, 0].detach())


def test_render_session_orbits_writes_the_jax_packages_files(pair, tmp_path):
    """The same names; each PNG decodes (the port's reader and cv2) to
    pixels within 1 LSB of the JAX package's file."""
    tsess, jsess = pair
    kw = dict(n_views=2, width=32, height=24, n_bins=8)
    got = rv.render_session_orbits(tsess, str(tmp_path / "port"), **kw)
    want = jrv.render_session_orbits(jsess, str(tmp_path / "jax"), **kw)
    assert got == want and len(got) == 2 * 4 + 2
    for name in got:
        for suffix in ("_rgb.png", "_depth.png", "_alpha.png"):
            a = str(tmp_path / "port" / (name + suffix))
            b = str(tmp_path / "jax" / (name + suffix))
            mine = png.imread_unchanged(a)
            np.testing.assert_array_equal(
                mine, cv2.imread(a, cv2.IMREAD_UNCHANGED))
            theirs = cv2.imread(b, cv2.IMREAD_UNCHANGED)
            assert mine.shape == theirs.shape and mine.dtype == theirs.dtype
            assert mine.shape[:2] == (24, 32)
            diff = np.abs(mine.astype(np.int64) - theirs.astype(np.int64))
            assert diff.max() <= 1, (name + suffix, diff.max())


def test_a_sharded_render_raises_and_names_its_item(pair, capsys):
    """Sharded renders raised until parallel/ existed (ROADMAP.md item 4g,
    done; tests/test_torch_parallel.py renders sharded): a device_mesh
    that is no DeviceMesh raises naming it, and `--scene --sharded` in one
    process runs unsharded and says so (here it then stops: no
    checkpoint)."""
    tsess, _ = pair
    with pytest.raises(TypeError, match="DeviceMesh"):
        rv.render_scene_view(tsess, np.eye(4), CAM, near=0.1, far=1.0,
                             device_mesh=object())
    with pytest.raises(SystemExit, match="no checkpoint"):
        rv.main(["--logdir", "unused", "--synthetic", "--scene",
                 "--sharded", "--device", "cpu"])
    assert ("--sharded: single device visible, running unsharded"
            in capsys.readouterr().err)


def test_renders_take_inference_mode_in_any_thread(pair, monkeypatch):
    """Grad mode is per thread: a render from a fresh thread (an HTTP
    handler's) runs its tiles under inference mode all the same, and
    builds no autograd graph."""
    tsess, _ = pair
    seen = []
    termination = rv.render_ops.occupancy_to_termination

    def spy(occ):
        seen.append((torch.is_inference_mode_enabled(), occ.requires_grad))
        return termination(occ)

    monkeypatch.setattr(rv.render_ops, "occupancy_to_termination", spy)
    T = np.asarray(tsess.sample_dict[0]["T"], np.float32)
    worker = threading.Thread(target=lambda: rv.render_scene_view(
        tsess, T, CAM, near=0.1, far=6.0, n_bins=8, chunk=4096))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert seen and all(s == (True, False) for s in seen)


def test_render_cli_end_to_end(tmp_path, capsys):
    """A checkpoint of the --synthetic scene's session, then `python -m
    catnerf_torch.render_views --device cpu --scene`: orbits of every
    object, background views and scene composites, as PNG triples."""
    from catnerf_torch.loaders import load_scene
    from catnerf_torch.train.checkpoint import save_session_checkpoint

    cfg, inst_dict, sample_dict, cam = load_scene(None, synthetic=True)
    sess = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                           device="cpu")
    save_session_checkpoint(str(tmp_path / "ckpt"), sess, 5)
    out = tmp_path / "renders"
    assert rv.main(["--logdir", str(tmp_path), "--synthetic", "--device",
                    "cpu", "--out", str(out), "--n-views", "1", "--width",
                    "32", "--height", "24", "--n-bins", "8",
                    "--scene"]) == 0
    assert f"wrote {6 + 1 + 1} views to {out}" in capsys.readouterr().out
    files = sorted(os.listdir(out))
    assert len(files) == 3 * 8
    assert any(f.startswith("scene_frame") for f in files)
    assert png.imread_unchanged(str(out / files[0])).shape[:2] == (24, 32)
    with pytest.raises(SystemExit, match="no checkpoint"):
        rv.main(["--logdir", str(tmp_path / "none"), "--synthetic",
                 "--device", "cpu"])


def test_jax_is_on_the_cpu():
    assert jax.default_backend() == "cpu"


def test_render_psnr_is_the_jax_gates_formula(monkeypatch):
    """The gate's `render_psnr` (experimental/e2e_quality.py) on a session
    after two steps equals scripts/e2e_quality.py:303-317's formula on the
    JAX package's renderer, from the same weights, within 1e-3 dB (both at
    16 bins, the gate's 64 cost four times as much on one CPU core)."""
    from catnerf_torch.experimental import e2e_quality as e2e

    monkeypatch.setattr(e2e, "RENDER_BINS", 16)

    tsess, jsess = _pair(n_categories=1)
    for _ in range(2):
        tsess.step_once()
    jsess.state = jsess.state._replace(params=jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_numpy(tsess.state.params)))
    got = e2e.render_psnr(tsess)
    want = []
    frames = sorted(jsess.sample_dict.keys())
    for fr in {frames[0], frames[len(frames) // 2]}:
        T = np.asarray(jsess.sample_dict[fr]["T"], np.float32)
        img, _, _ = jrv.render_scene_view(jsess, T, jsess.cam, near=0.1,
                                          far=jrv.scene_far(jsess),
                                          n_bins=16)
        gt = np.asarray(jsess.sample_dict[fr]["image"], np.float32) / 255.0
        mse = float(np.mean((img - gt) ** 2))
        want.append(round(-10.0 * np.log10(max(mse, 1e-10)), 2))
    assert len(got) == 2 and min(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
