"""The port's mesher (`catnerf_torch/mesher/`) and 3D metrics
(`catnerf_torch/metrics/`) against the JAX package's, on the CPU.

The grid slab, the point evaluation and whole scenes go through both
packages from the same weights; the uint8 occupancy and colours and the
carve masks are held under the flip rule (`e2e_quality.count_flips`): two
float32 evaluations that sum in another order may differ by one quantum
where occ * 255 lies within 2.6e-3 (255 x 1e-5) of a .5 rounding boundary,
and a carve bit where a projected pixel coordinate lies within 1e-4 of a
.5 boundary or the depth test within 1e-5 of its margin; at most 0.1% of
the voxels. The host half (adaptive bounds, interior fill, marching cubes,
the mesh container, the metrics) is a copy and is held to the same
outputs, and to the JAX package's own tests on analytic fields.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.data.scene import OrientedBBox
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.experimental.e2e_quality import (carve_boundary,
                                                    count_flips)
from catnerf_torch.mesher import meshing
from catnerf_torch.mesher.mesh import TriMesh, load_mesh
from catnerf_torch.metrics import metrics3d, synthetic_eval
from catnerf_torch.models.codenerf import CodeNeRF
from catnerf_torch.models.embedding import ICOSAHEDRON_DIRS, UniDirsEmbed
from catnerf_torch.models.occupancy import OccupancyMap
from catnerf_torch.native.lib import geomlib
from catnerf_torch.train.loop import TrainingSession
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.mesher import meshing as jmeshing
from catnerf_tpu.metrics import metrics3d as jmetrics3d
from catnerf_tpu.metrics import synthetic_eval as jsynthetic_eval
from catnerf_tpu.models import codenerf as jcodenerf
from catnerf_tpu.models import occupancy as joccupancy
from catnerf_tpu.train.loop import TrainingSession as JSession

torch.set_num_threads(1)

FWD_TOL = 1e-5
DIM = 32
LATENT = 16


# ---------------------------------------------------------------------------
# fields: the same weights in both packages
# ---------------------------------------------------------------------------

def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def fields():
    """(jax params, port params, shape code, texture code) of a CodeNeRF
    (the JAX init, B scaled up as tests/test_mesher.py does, so that the
    grid holds surfaces) and of a 32-wide background."""
    rng = np.random.default_rng(4)
    cn = {"pe": {"B": (ICOSAHEDRON_DIRS * 3.0 + rng.normal(
              0, 0.2, (21, 3))).astype(np.float32)},
          "fc": _np_tree(jcodenerf.init_params(jax.random.PRNGKey(5),
                                               latent_dim=LATENT, W=32))}
    bg = {"pe": {"B": (ICOSAHEDRON_DIRS + rng.normal(0, 0.05, (21, 3)))
                 .astype(np.float32)},
          "fc": _np_tree(joccupancy.init_params(jax.random.PRNGKey(6),
                                                hidden_size=32))}
    sc = rng.normal(0, 0.5, LATENT).astype(np.float32)
    tc = rng.normal(0, 0.5, LATENT).astype(np.float32)
    port = {
        "cn": {"pe": UniDirsEmbed(torch.tensor(cn["pe"]["B"])),
               "fc": CodeNeRF(convert.layers_from_jax(cn["fc"]))},
        "bg": {"pe": UniDirsEmbed(torch.tensor(bg["pe"]["B"])),
               "fc": OccupancyMap(convert.layers_from_jax(bg["fc"]))},
    }
    return {"cn": cn, "bg": bg}, port, sc, tc


def _carve_views():
    """Three views of a 32 x 24 camera (W != H: a transposed depth index
    fails here), one with a blank band of depth."""
    cam = CameraInfo(32, 24, 30.0, 30.0, 16.0, 12.0)
    rng = np.random.default_rng(0)
    depths = rng.uniform(0.5, 3.0, (3, 32, 24)).astype(np.float32)
    depths[0, :4] = 0.0
    T_wc = np.stack([np.eye(4, dtype=np.float32) for _ in range(3)])
    T_wc[1][:3, 3] = [0.3, -0.2, -1.5]
    T_wc[2][:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]],
                               np.float32)
    return depths, T_wc, cam


# the slab's placement: per-axis scale, the grid's affine, grid -> world
SCALE3 = np.array([0.8, 0.7, 0.9], np.float32)
TG = np.eye(4, dtype=np.float32)
TG[:3, 3] = [0.05, -0.1, 0.2]
TW = np.eye(4, dtype=np.float32)
TW[:3, 3] = [0.1, 0.0, 1.2]


def _unit_slab():
    t = np.linspace(-1.0, 1.0, DIM, dtype=np.float32)
    gx, gy, gz = np.meshgrid(t, t, t, indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3)


@pytest.mark.parametrize("carve", [False, True], ids=["plain", "carved"])
@pytest.mark.parametrize("field", ["codenerf", "background"])
def test_grid_slab_matches_the_jax_packages(fields, field, carve):
    """One slab of a 32^3 grid: float32 occupancy within 1e-5, the uint8
    grid and the carve mask equal under the flip rule."""
    jp, tp, sc, tc = fields
    bg = field == "background"
    key = "bg" if bg else "cn"
    cfg = Config()
    scale = cfg.bg_scale if bg else cfg.obj_scale
    depths, T_wc, cam = _carve_views()
    K = np.array([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
    voxel_w = float(np.max(SCALE3)) * 2.0 / (DIM - 1)
    margin = np.float32(3.0 * voxel_w)
    slab = _unit_slab()
    args = (SCALE3, TG[:3, :3], TG[:3, 3], TW[:3, :3], TW[:3, 3], depths,
            T_wc, K, margin)
    kw = dict(is_background=bg, scale=scale, max_deg=5, carve=carve)

    j_u8, j_seen = jmeshing._eval_grid_slab(
        jp[key]["pe"], jp[key]["fc"], jnp.asarray(sc), jnp.asarray(tc),
        jnp.asarray(slab), *(jnp.asarray(a) for a in args), **kw)
    t_args = [torch.tensor(np.asarray(a)) for a in args]
    t_u8, t_seen = meshing._eval_grid_slab(
        tp[key]["pe"], tp[key]["fc"], torch.tensor(sc), torch.tensor(tc),
        torch.tensor(slab), *t_args, **kw)

    pts = slab * SCALE3 @ TG[:3, :3].T + TG[:3, 3]
    j_occ = jmeshing.field_chunk_fn(is_background=bg, scale=scale, max_deg=5,
                                    want_color=False)(
        jp[key]["pe"], jp[key]["fc"], jnp.asarray(sc), jnp.asarray(tc),
        jnp.asarray(pts))
    with torch.no_grad():
        t_occ = meshing.field_chunk_fn(is_background=bg, scale=scale,
                                       max_deg=5, want_color=False)(
            tp[key]["pe"], tp[key]["fc"], torch.tensor(sc),
            torch.tensor(tc), torch.tensor(pts))
    np.testing.assert_allclose(t_occ.numpy(), np.asarray(j_occ), rtol=0,
                               atol=FWD_TOL)
    assert t_u8.dtype == torch.uint8 and t_u8.shape == (DIM ** 3,)
    near = (carve_boundary(pts @ TW[:3, :3].T + TW[:3, 3], depths, T_wc, K,
                           float(margin)) if carve else None)
    counts = count_flips(np.asarray(j_occ), t_u8.numpy(), np.asarray(j_u8),
                         t_seen.numpy() if carve else None,
                         np.asarray(j_seen) if carve else None, near)
    print(f"{field} {'carved' if carve else 'plain'}: {counts}")
    if carve:
        seen = t_seen.numpy()
        assert seen.any() and (~seen).any()  # the views carve some voxels
        assert (t_u8.numpy()[seen] == 0).all()
    else:
        assert not t_seen.numpy().any()
    u8 = t_u8.numpy()
    assert (u8 > 128).any() and (u8 < 127).any()  # a surface in the slab


def test_codenerf_without_its_colour_branch_gives_the_same_sigma(fields):
    """The grid's occupancy-only CodeNeRF (do_color=False) runs none of
    the colour branch and returns the full forward's sigma bitwise."""
    from catnerf_torch.models import codenerf, embedding

    _, tp, sc, tc = fields
    pts = torch.tensor(_unit_slab()[:4096])
    with torch.no_grad():
        emb = embedding.apply(tp["cn"]["pe"], pts, scale=2.0)
        full = codenerf.apply(tp["cn"]["fc"], emb, torch.tensor(sc),
                              torch.tensor(tc))
        sigma, rgb = codenerf.apply(tp["cn"]["fc"], emb, torch.tensor(sc),
                                    torch.tensor(tc), do_color=False)
    assert rgb is None and full[1].shape == (4096, 3)
    assert torch.equal(sigma, full[0])


@pytest.mark.parametrize("n", [1, 4097, 8192 + 5])
@pytest.mark.parametrize("field", ["codenerf", "background"])
def test_eval_points_matches_the_jax_packages_across_tile_buckets(
        fields, field, n):
    """eval_points at lengths that take each of _tile_plan's paddings
    (a bucket, a whole chunk, a full tile and a tail) with chunk 8192:
    occupancy and colour within 1e-5, uint8 colours under the flip rule."""
    jp, tp, sc, tc = fields
    bg = field == "background"
    key = "bg" if bg else "cn"
    cfg, jcfg = Config(), JConfig()
    pts = np.random.default_rng(n).uniform(-1, 1, (n, 3)).astype(np.float32)
    codes = (None, None) if bg else (sc, tc)
    chunk = 8192
    assert meshing._tile_plan(n, chunk) == jmeshing._tile_plan(n, chunk)
    got = meshing.eval_points(pts, tp[key], cfg, *codes, is_background=bg,
                              chunk=chunk)
    want = jmeshing.eval_points(pts, jp[key], jcfg, *codes,
                                is_background=bg, chunk=chunk)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=FWD_TOL)
    _, got_u8 = meshing.eval_points(pts, tp[key], cfg, *codes,
                                    is_background=bg, chunk=chunk,
                                    want_occ=False, color_u8=True)
    _, want_u8 = jmeshing.eval_points(pts, jp[key], jcfg, *codes,
                                      is_background=bg, chunk=chunk,
                                      want_occ=False, color_u8=True)
    assert got_u8.dtype == np.uint8 and got_u8.shape == (n, 3)
    count_flips(want[1].reshape(-1), got_u8.reshape(-1),
                np.asarray(want_u8).reshape(-1))


@pytest.mark.parametrize("n,chunk", [(0, 64), (1, 64), (64, 64), (65, 64),
                                     (5000, 262144), (70000, 262144),
                                     (600000, 262144)])
def test_tile_plan_is_the_jax_packages(n, chunk):
    assert meshing._tile_plan(n, chunk) == jmeshing._tile_plan(n, chunk)


def test_marching_cubes_on_the_jax_grid_gives_identical_meshes(
        fields, monkeypatch):
    """The port's mesh_field host path (adaptive bounds, carving, interior
    fill, marching cubes, the placement transforms) on the JAX package's
    own grid — its `_grid_occ_seen` stubbed to return the JAX grid for
    each placement asked for, as tests/test_mesher.py stubs it — gives
    the JAX mesh_field's vertices and triangles exactly."""
    jp, tp, sc, tc = fields
    jcfg, cfg = JConfig(), Config()
    carve = _carve_views()
    bound = OrientedBBox(center=np.array([0.1, 0.0, 1.2]), R=np.eye(3),
                         extent=np.array([1.0, 0.8, 0.9]))
    grids = []

    def jax_grid(params, cfg_, sc_, tc_, **kw):
        kw.pop("chunk")
        out = jmeshing._grid_occ_seen(jp["cn"], jcfg, sc, tc, chunk=4096,
                                      device_mesh=None, **kw)
        grids.append(out)
        return out

    monkeypatch.setattr(meshing, "_grid_occ_seen", jax_grid)
    got = meshing.mesh_field(tp["cn"], cfg, grid_dim=DIM,
                             is_background=False, shape_code=sc,
                             texture_code=tc, bound=bound, carve=carve)
    want = jmeshing.mesh_field(jp["cn"], jcfg, grid_dim=DIM,
                               is_background=False, shape_code=sc,
                               texture_code=tc, bound=bound, carve=carve)
    assert grids and got is not None and want is not None
    assert len(got.vertices) == len(want.vertices) > 0
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.vertex_colors.dtype == np.uint8


# ---------------------------------------------------------------------------
# adaptive bounds, interior fill and carving on analytic fields (ported
# from tests/test_mesher.py)
# ---------------------------------------------------------------------------

def _sphere_stubs(monkeypatch, sphere_c, sphere_r):
    def occ_of(points):
        d = np.linalg.norm(np.asarray(points) - sphere_c, axis=-1)
        return (1.0 / (1.0 + np.exp((d - sphere_r) * 60.0))).astype(
            np.float32)

    def fake_grid(params, cfg, sc, tc, *, grid_dim, scale_np, transform_np,
                  **kw):
        pts = meshing.host_grid_points(grid_dim, scale_np, transform_np)
        return occ_of(pts), None

    def fake_eval(points, params, cfg, sc=None, tc=None, *, is_background,
                  chunk=262144, want_color=True, **kw):
        return occ_of(points), np.zeros((len(points), 3), np.uint8)

    monkeypatch.setattr(meshing, "_grid_occ_seen", fake_grid)
    monkeypatch.setattr(meshing, "eval_points", fake_eval)


def test_adaptive_bounds_recover_a_clipped_surface_world_frame(monkeypatch):
    """An analytic sphere whose surface exceeds the given OBB is clipped
    without adaptive bounds and fully enclosed with them."""
    sphere_c = np.array([0.1, 0.0, 0.25])
    sphere_r = 0.5
    _sphere_stubs(monkeypatch, sphere_c, sphere_r)
    cfg = Config()
    bound = OrientedBBox(center=np.array([0.1, 0.0, 0.1]), R=np.eye(3),
                         extent=np.array([1.0, 1.0, 0.7]))

    def max_gt_dist(mesh):
        u = np.random.default_rng(0).normal(size=(4000, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        gt = sphere_c + sphere_r * u
        dist, _ = geomlib.KDTree(mesh.vertices.astype(np.float32)).query(
            gt.astype(np.float32))
        return dist.max()

    cfg.mesh_adaptive_bounds = False
    clipped = meshing.mesh_field({}, cfg, grid_dim=64, is_background=False,
                                 shape_code=0, texture_code=0, bound=bound)
    assert clipped is not None and max_gt_dist(clipped) > 0.15
    cfg.mesh_adaptive_bounds = True
    full = meshing.mesh_field({}, cfg, grid_dim=64, is_background=False,
                              shape_code=0, texture_code=0, bound=bound)
    assert full is not None and max_gt_dist(full) < 0.03


def test_adaptive_bounds_canonical_frame(monkeypatch):
    """Growth on the canonical-frame (extent) path of multi-instance
    categories, where the grid gains a translation."""
    sphere_c = np.array([0.0, 0.0, 0.3])
    sphere_r = 0.8
    _sphere_stubs(monkeypatch, sphere_c, sphere_r)
    cfg = Config()
    cfg.mesh_adaptive_bounds = True
    mesh = meshing.mesh_field({}, cfg, grid_dim=64, is_background=False,
                              shape_code=0, texture_code=0,
                              extent=np.array([1.6, 1.6, 1.2]))
    assert mesh is not None
    r = np.linalg.norm(mesh.vertices - sphere_c, axis=-1)
    assert abs(np.median(r) - sphere_r) < 0.03
    assert (mesh.vertices[:, 2] > sphere_c[2] + 0.9 * sphere_r).any()


def test_interior_fill_removes_the_inner_shell():
    """A crust-profile occupancy yields two shells; the interior fill
    leaves only the outer surface, as the JAX package's fill does."""
    n = 64
    t = np.linspace(-1.0, 1.0, n)
    X, Y, Z = np.meshgrid(t, t, t, indexing="ij")
    d = np.sqrt(X**2 + Y**2 + Z**2)
    occ = (0.1 + 0.8 * np.exp(-((d - 0.6) / 0.1) ** 2)).astype(np.float32)
    v_raw, _ = geomlib.marching_cubes(occ, 0.5)
    r_raw = np.linalg.norm(v_raw / (n - 1) * 2 - 1, axis=1)
    assert (r_raw < 0.55).sum() > 100  # inner shell present
    filled = meshing._fill_unobservable_interior(occ.copy())
    np.testing.assert_array_equal(
        filled, jmeshing._fill_unobservable_interior_py(occ.copy()))
    v_f, _ = geomlib.marching_cubes(filled, 0.5)
    r_f = np.linalg.norm(v_f / (n - 1) * 2 - 1, axis=1)
    assert (r_f < 0.55).sum() == 0  # inner shell gone
    assert abs(np.median(r_f) - np.median(r_raw[r_raw > 0.55])) < 0.02


def test_interior_fill_keeps_an_observed_free_concavity():
    """Voxels the space carve proved free are never filled (an open cup),
    while an enclosed bubble elsewhere still is."""
    occ = np.full((16, 16, 16), 0.1, np.float32)
    occ[4:12, 4:12, 4:12] = 0.9
    cavity = np.zeros_like(occ, bool)
    cavity[6:10, 6:10, 6:12] = True
    occ[cavity] = 0.1
    assert (meshing._fill_unobservable_interior(occ.copy())[cavity]
            > 0.5).all()
    kept = meshing._fill_unobservable_interior(occ.copy(),
                                               observed_free=cavity)
    assert (kept[cavity] <= 0.5).all()
    occ2 = occ.copy()
    occ2[5, 5, 5] = 0.1
    kept2 = meshing._fill_unobservable_interior(occ2, observed_free=cavity)
    assert kept2[5, 5, 5] > 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_interior_fill_matches_the_scipy_recipe(seed):
    """The port's (C++) fill equals the JAX package's scipy+numpy oracle
    on random fields, with and without an observed-free mask."""
    rng = np.random.default_rng(seed)
    occ = np.where(rng.uniform(0, 1, (24, 20, 28)) > 0.7, 0.9, 0.1).astype(
        np.float32)
    for free in (None, rng.uniform(size=occ.shape) > 0.8):
        np.testing.assert_array_equal(
            meshing._fill_unobservable_interior(occ.copy(), free),
            jmeshing._fill_unobservable_interior_py(occ.copy(), free))


def test_device_grid_carving_matches_the_host_path(fields):
    """The grid path (unit grid, affine, carving in the slab) reproduces
    the host path (host grid points, eval_points, space_carve_mask), as
    tests/test_mesher.py holds the JAX package's."""
    _, tp, sc, tc = fields
    cfg = Config()
    carve = _carve_views()
    voxel_w = float(np.max(SCALE3)) * 2.0 / (DIM - 1)
    occ_d, seen_d = meshing._grid_occ_seen(
        tp["cn"], cfg, sc, tc, grid_dim=DIM, scale_np=SCALE3,
        transform_np=TG, world_transform=TW, carve=carve,
        is_background=False, voxel_w=voxel_w, chunk=4096)
    pts = meshing.host_grid_points(DIM, SCALE3, TG)
    occ_h, _ = meshing.eval_points(pts, tp["cn"], cfg, sc, tc,
                                   is_background=False, chunk=4096,
                                   want_color=False)
    seen_h = meshing.space_carve_mask(pts @ TW[:3, :3].T + TW[:3, 3],
                                      *carve, margin=3.0 * voxel_w)
    occ_h = np.where(seen_h, np.float32(0.0), occ_h)
    agree = seen_d == seen_h
    assert (~agree).mean() < 1e-3
    np.testing.assert_allclose(occ_d[agree], occ_h[agree], atol=1.0 / 509)
    assert seen_h.any() and (~seen_h).any()


def test_unit_grid_is_built_once_per_dim_and_device():
    a = meshing._unit_grid(DIM, torch.device("cpu"))
    assert meshing._unit_grid(DIM, torch.device("cpu")) is a
    assert a.shape == (DIM ** 3, 3) and a.dtype == torch.float32
    np.testing.assert_array_equal(
        a.numpy(), meshing.host_grid_points(DIM, np.ones(3), np.eye(4)))


# ---------------------------------------------------------------------------
# whole scenes against the JAX package
# ---------------------------------------------------------------------------

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)


def _configure(cfg):
    cfg.net_hyperparams.latent_dim = 32
    cfg.n_per_optim_bg = 240
    cfg.grid_dim = DIM
    return cfg


@pytest.fixture(scope="module")
def sessions():
    """The port's session trained 20 steps on the small scene, and a JAX
    session on the same scene holding the same weights."""
    scene = make_scene(**SCENE)
    tsess = TrainingSession(_configure(Config()), scene.inst_dict,
                            scene.sample_dict, cam=scene.cam, device="cpu")
    tsess.enable_fast_path(10)
    tsess.run_fast(20)
    js = jmake_scene(**SCENE)
    jsess = JSession(_configure(JConfig()), js.inst_dict, js.sample_dict,
                     cam=js.cam)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert.params_to_numpy(tsess.state.params))
    jsess.state = jsess.state._replace(params=params)
    return tsess, jsess


def _recorded(monkeypatch, module, log):
    """Wrap module._grid_occ_seen to record each grid it returns, keyed by
    its object (the shape code's bytes; b"bg" for the background) and its
    placement."""
    original = module._grid_occ_seen

    def wrapped(params, cfg, shape_code, texture_code, **kw):
        out = original(params, cfg, shape_code, texture_code, **kw)
        obj = (b"bg" if shape_code is None
               else np.asarray(shape_code, np.float32).tobytes())
        place = (kw["grid_dim"], np.asarray(kw["scale_np"]).tobytes(),
                 np.asarray(kw["transform_np"]).tobytes())
        log[(obj, place)] = out
        return out

    monkeypatch.setattr(module, "_grid_occ_seen", wrapped)


def _object_keys(sess) -> dict:
    """obj_id -> the key _recorded files its grids under."""
    keys = {0: b"bg"}
    for cls_id, cat in zip(sess.cls_ids, sess.categories):
        codes = sess.category_params(cls_id)["shape_codes"]
        for obj_id, k in cat.inst_id_to_index.items():
            keys[obj_id] = codes[k].numpy().tobytes()
    return keys


def test_mesh_scene_matches_the_jax_packages(sessions, tmp_path,
                                             monkeypatch):
    """The same objects are meshed; vertex and triangle counts within
    0.5%; the mean symmetric Chamfer distance below 1% of a voxel; every
    grid equal under the flip rule, and every object whose grids came out
    byte-equal has the same mesh, bitwise."""
    tsess, jsess = sessions
    t_log, j_log = {}, {}
    _recorded(monkeypatch, meshing, t_log)
    _recorded(monkeypatch, jmeshing, j_log)
    got = meshing.mesh_scene(tsess, str(tmp_path / "port"), 20)
    want = jmeshing.mesh_scene(jsess, str(tmp_path / "jax"), 20)
    assert sorted(got) == sorted(want) and len(got) == 5
    assert t_log.keys() == j_log.keys()

    flips = n_vox = 0
    unequal = set()
    for key, (occ, seen) in t_log.items():
        j_occ, j_seen = j_log[key]
        diff = occ != j_occ
        if seen is not None:
            diff |= seen != j_seen
        # where the carve bits agree, at most one quantum apart
        same_carve = (np.ones(occ.shape, bool) if seen is None
                      else seen == j_seen)
        assert (np.abs(occ - j_occ)[same_carve] <= 1.0 / 255 + 1e-7).all()
        flips += int(diff.sum())
        n_vox += occ.size
        if diff.any():
            unequal.add(key[0])
    print(f"mesh_scene: {len(t_log)} grids, {n_vox} voxels, {flips} flips")
    assert flips <= 1e-3 * n_vox

    keys = _object_keys(tsess)
    for obj_id in sorted(got):
        a, b = load_mesh(got[obj_id]), load_mesh(want[obj_id])
        for x, y in ((len(a.vertices), len(b.vertices)),
                     (len(a.faces), len(b.faces))):
            assert abs(x - y) <= 0.005 * y, (obj_id, x, y)
        voxel = _voxel_of(tsess, obj_id)
        cd = metrics3d.chamfer(b.vertices, a.vertices)
        assert cd < 0.01 * voxel, (obj_id, cd, voxel)
        if keys[obj_id] not in unequal:
            np.testing.assert_array_equal(a.vertices, b.vertices)
            np.testing.assert_array_equal(a.faces, b.faces)
            np.testing.assert_array_equal(a.vertex_colors, b.vertex_colors)


def _voxel_of(sess, obj_id):
    """An object's voxel edge in scene units at the grid's first
    placement."""
    if obj_id == 0:
        ext = np.asarray(sess.background.bound.extent)
        return float(np.max(ext)) / meshing.BOUND_EXTENT_BG / (DIM - 1)
    for cat in sess.categories:
        if obj_id in cat.inst_id_to_index:
            if cat.n_obj > 1:
                scale = float(cat.object_tensor_dict[obj_id][0])
                return 2.0 / meshing.BOUND_EXTENT_OBJ / (DIM - 1) * scale
            ext = np.asarray(cat.bound_dict[obj_id].extent)
            return float(np.max(ext)) / meshing.BOUND_EXTENT_OBJ / (DIM - 1)
    raise KeyError(obj_id)


def test_mesh_object_equals_the_mesh_scene_object(sessions, tmp_path):
    """mesh_object (one object) gives the .obj file mesh_scene wrote."""
    tsess, _ = sessions
    written = meshing.mesh_scene(tsess, str(tmp_path), 21)
    assert written
    for obj_id, path in written.items():
        with open(path, "rb") as f:
            assert meshing.mesh_object(tsess, obj_id).obj_bytes() == f.read()
    with pytest.raises(KeyError):
        meshing.mesh_object(tsess, 424242)


# ---------------------------------------------------------------------------
# the copies: the mesh container and the metrics (ported from
# tests/test_mesher.py)
# ---------------------------------------------------------------------------

def _sphere_mesh(radius=1.0, center=(0, 0, 0), n=48):
    t = np.linspace(-1.5 * radius, 1.5 * radius, n)
    X, Y, Z = np.meshgrid(t, t, t, indexing="ij")
    d = np.sqrt(X**2 + Y**2 + Z**2)
    occ = 1.0 / (1.0 + np.exp((d - radius) * 30 / radius))
    verts, tris = geomlib.marching_cubes(occ.astype(np.float32), 0.5)
    verts = verts / (n - 1) * (3 * radius) - 1.5 * radius + np.asarray(center)
    return TriMesh(verts, tris)


def test_trimesh_sample_surface():
    m = TriMesh(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
                np.array([[0, 1, 2]]))
    pts = m.sample_surface(500)
    assert pts.shape == (500, 3)
    assert (pts[:, 2] == 0).all()
    assert (pts[:, 0] >= 0).all() and (pts[:, 1] >= 0).all()
    assert (pts[:, 0] + pts[:, 1] <= 1 + 1e-9).all()
    np.testing.assert_allclose(m.area, 0.5)


@pytest.mark.parametrize("ext", ["obj", "ply"])
def test_trimesh_export_load_roundtrip_and_the_jax_packages_bytes(tmp_path,
                                                                  ext):
    from catnerf_tpu.mesher.mesh import TriMesh as JTriMesh

    m = _sphere_mesh(0.5)
    m.vertex_colors = np.full((len(m.vertices), 3), 128, np.uint8)
    path = os.path.join(tmp_path, f"m.{ext}")
    m.export(path)
    m2 = load_mesh(path)
    np.testing.assert_allclose(m2.vertices, m.vertices, atol=1e-5)
    np.testing.assert_array_equal(m2.faces, m.faces)
    np.testing.assert_array_equal(m2.vertex_colors, m.vertex_colors)
    jpath = os.path.join(tmp_path, f"j.{ext}")
    JTriMesh(m.vertices, m.faces, m.vertex_colors).export(jpath)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()


def test_trimesh_crop_to_obb():
    m = _sphere_mesh(1.0)
    half = m.crop_to_obb(center=[0, 0, 0], R=np.eye(3), extent=[2, 2, 1])
    assert len(half.faces) < len(m.faces)
    centroids = half.vertices[half.faces].mean(1)
    assert (np.abs(centroids[:, 2]) <= 0.52).all()


def test_load_obj_fan_triangulates_quads(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    m = load_mesh(str(p))
    assert m.faces.shape == (2, 3)
    np.testing.assert_allclose(m.area, 1.0, rtol=1e-6)


def test_load_ply_binary_int_list_counts_and_crlf(tmp_path):
    import struct

    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    header = ("ply\r\nformat binary_little_endian 1.0\r\n"
              f"element vertex {len(verts)}\r\n"
              "property float x\r\nproperty float y\r\nproperty float z\r\n"
              "element face 2\r\nproperty list int int vertex_indices\r\n"
              "end_header\r\n")
    body = verts.astype("<f4").tobytes()
    for tri in ([0, 1, 2], [0, 2, 3]):
        body += struct.pack("<i", 3) + struct.pack("<3i", *tri)
    p = tmp_path / "intlist.ply"
    p.write_bytes(header.encode() + body)
    m = load_mesh(str(p))
    np.testing.assert_array_equal(m.faces, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_allclose(m.vertices, verts, atol=1e-7)
    bad = tmp_path / "noheader.ply"
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 3\n")
    with pytest.raises(ValueError, match="end_header"):
        load_mesh(str(bad))


def test_metrics_identical_and_shifted():
    pts = np.random.default_rng(0).standard_normal((2000, 3))
    assert metrics3d.accuracy(pts, pts) == 0.0
    assert metrics3d.completion(pts, pts) == 0.0
    assert metrics3d.completion_ratio(pts, pts) == 1.0
    shifted = pts + np.array([0.03, 0, 0])
    acc = metrics3d.accuracy(pts, shifted)
    assert 0.0 < acc <= 0.03 + 1e-6
    assert metrics3d.completion_ratio(pts, shifted, 0.05) > 0.95
    assert metrics3d.chamfer(pts, shifted) == jmetrics3d.chamfer(pts,
                                                                 shifted)


def test_calc_3d_metric_equals_the_jax_packages():
    m = _sphere_mesh(0.5)
    rec = _sphere_mesh(0.48, center=(0.01, 0, 0))
    box = OrientedBBox(center=np.zeros(3), R=np.eye(3),
                       extent=np.full(3, 1.2))
    got = metrics3d.calc_3d_metric(rec, m, n_samples=5000, ref_obb=box)
    want = jmetrics3d.calc_3d_metric(rec, m, n_samples=5000, ref_obb=box)
    assert got == want
    assert got["accuracy"] < 2.5 and got["completion"] < 2.5
    assert got["completion_ratio"] > 99.0


def test_score_shape_equals_the_jax_packages():
    """The e2e gate's scoring: the analytic GT of a synthetic sphere and
    the reference protocol give the JAX package's numbers exactly."""
    scene = make_scene(n_frames=1, width=16, height=12, n_categories=1,
                       insts_per_cat=1, seed=0)
    js = jmake_scene(n_frames=1, width=16, height=12, n_categories=1,
                     insts_per_cat=1, seed=0)
    sp, jsp = scene.spheres[0], js.spheres[0]
    rec = _sphere_mesh(sp.radius * 0.98, center=sp.center)
    got = synthetic_eval.score_shape(rec, sp)
    want = jsynthetic_eval.score_shape(rec, jsp)
    assert got == want
    gt = synthetic_eval.gt_shape_mesh(sp)
    np.testing.assert_array_equal(gt.vertices,
                                  jsynthetic_eval.gt_shape_mesh(jsp).vertices)
