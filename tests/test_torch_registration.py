"""The port's registration (`catnerf_torch/geometry/`) against the JAX
package's, on the Replica fixture of tests/test_replica_fixture.py (96 x
72, 6 frames, 2 x 2 spheres, seed 1) as both loaders read it:

- the host stages, copies: stage 1 (`get_all_poses`, `get_obb`,
  `teaser_fpfh_icp`) bitwise; `run_registration` end to end on the
  coverage-score route, and `align_poses` fed the JAX package's
  uncertainty counts, within 1e-9;
- the device stages on the CPU: the pretraining on the JAX package's
  draws (20 steps x 64 rays), held step by step: from each state of the
  JAX package's trajectory, the port's loss terms and its AdamW step
  within PRETRAIN_TOL and LEAF_TOL (the step's leaves in units of the
  leaf's largest entry); `uncertainty_score` of one field on the JAX package's
  uniforms: termination within 1e-4, entropies 1e-4, counts equal but
  for directions whose JAX metric lies within 1e-3 of 0.5 (either
  package's float32 lies ~4e-5 from float64 there: see TERM_TOL);
- the zero-ray drop, the empty-frame_info fallback and the vMAP `.pth`
  branch (`load_pretrained=True`).

Threefry and Philox never agree, so the port is handed the JAX draws:
the pretraining's row indices and sampler uniforms on the JAX package's
key schedule (field_pretrain.py:127-185), the scoring's uniforms from
PRNGKey(obj_id).
"""

from __future__ import annotations

import copy
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from catnerf_torch.config import Config
from catnerf_torch.data import replica as treplica
from catnerf_torch.experimental import registration_check as rc
from catnerf_torch.geometry import field_pretrain as tfp
from catnerf_torch.geometry import obb as tobb
from catnerf_torch.geometry import registration as treg
from catnerf_torch.geometry import teaser as tteaser
from catnerf_torch.geometry import uncertainty as tunc
from catnerf_torch.ops.sampling import _stratified_from_u
from catnerf_torch.train.checkpoint import _occupancy_state_dict
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data import replica as jreplica
from catnerf_tpu.data.synthetic import make_scene
from catnerf_tpu.geometry import field_pretrain as jfp
from catnerf_tpu.geometry import obb as jobb
from catnerf_tpu.geometry import registration as jreg
from catnerf_tpu.geometry import teaser as jteaser
from catnerf_tpu.geometry import uncertainty as junc
from catnerf_tpu.models import embedding as jembedding
from catnerf_tpu.models import occupancy as joccupancy
from catnerf_tpu.ops import losses as jlosses
from catnerf_tpu.ops import sampling as jsampling

import test_replica_fixture

torch.set_num_threads(1)

FIXTURE = dict(n_frames=6, width=96, height=72, n_categories=2,
               insts_per_cat=2, seed=1)
HOST_TOL = 1e-9
PRETRAIN_STEPS, PRETRAIN_RAYS, PRETRAIN_KEY = 20, 64, 7
# a pretraining step from a JAX state: its colour and opacity terms
# (relative, PRETRAIN_TOL) and the leaves it lands on (in units of the
# leaf's largest entry, LEAF_TOL). optax applies the weight decay after the
# moment ratio, torch before the step: the two float32 roundings part by an
# ulp or two; and Adam's first steps move an entry by lr * g / (|g| + eps),
# so a gradient entry within float32 noise of zero (|g| ~ 1e-7) moves by a
# noisy fraction of lr (2.9e-5 on one entry of 4,096 at the first step
# here). The steps are held one at a time, each from the JAX package's
# state: run free, the two trajectories part (1.7e-3 of a leaf after 20
# steps against the JAX package run eagerly,
# tests/torch_registration_spread.py), as the ill-conditioned depth term
# (see test_pretrain_step_losses_match_jax) feeds its rounding back
PRETRAIN_TOL = 1e-5
LEAF_TOL = 1e-4
# a ReLU pre-activation this close to zero may fall on either side of it
# in two float32 evaluations, and move its unit's weight gradient far
# past LEAF_TOL (tests/test_torch_step.py)
RELU_TIE = 1e-5
# the scoring's float32 termination and entropies: each package lies
# within 4.4e-5 (termination) and 4.9e-5 (entropy) of a float64 evaluation
# of the same field (tests/torch_registration_spread.py; the positional
# encoding's frequencies up to 2^3 carry an ulp of the sample's position
# into the field), so the two are held within TERM_TOL and ENTROPY_TOL of
# each other, and the port's float32 error within F32_FACTOR times the JAX
# package's own
TERM_TOL = 1e-4
ENTROPY_TOL = 1e-4
F32_FACTOR = 1.5
# directions on either side of the reliability threshold 0.5 in the two
# packages: only where the JAX package's metric lies this close to it
# (seven times the largest metric difference, 1.4e-4,
# tests/torch_registration_spread.py)
METRIC_FLIP = 1e-3


def _configure(cfg, root):
    cam = make_scene(**FIXTURE).cam
    cfg.dataset_dir = str(root)
    cfg.width, cfg.height = FIXTURE["width"], FIXTURE["height"]
    cfg.fx = cfg.fy = cam.fx
    cfg.cx, cfg.cy = cam.cx, cam.cy
    cfg.depth_scale = 1.0 / 1000.0
    cfg.load_pretrained = False
    cfg.load_registration_result = False
    cfg.multi_init_pose = False  # 24 initial poses cost 3x on one core
    return cfg


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """Both loaders on the fixture (no registration), and both packages'
    stage 1 on their frames (with the colours of the appearance
    tie-break)."""
    root = tmp_path_factory.mktemp("replica")
    test_replica_fixture.write_replica_layout(make_scene(**FIXTURE),
                                              str(root), 1.0 / 1000.0)
    jdata = jreplica.Replica(_configure(JConfig(), root),
                             run_registration=False)
    tdata = treplica.Replica(_configure(Config(), root),
                             run_registration=False)
    jinst, tinst = copy.deepcopy(jdata.inst_dict), copy.deepcopy(
        tdata.inst_dict)
    jreg.get_all_poses(jinst, jdata.sample_dict, jdata.cam, want_color=True)
    treg.get_all_poses(tinst, tdata.sample_dict, tdata.cam, want_color=True)
    return dict(root=root, jdata=jdata, tdata=tdata, jinst=jinst,
                tinst=tinst)


def _objects(inst):
    return [(o, info["frame_info"], info["pcs"])
            for c, objs in sorted(inst.items()) if c
            for o, info in sorted(objs.items())]


# ---------------------------------------------------------------------------
# host stages
# ---------------------------------------------------------------------------

def test_stage1_clouds_are_bitwise(loaded):
    jinst, tinst = loaded["jinst"], loaded["tinst"]
    np.testing.assert_array_equal(tinst[0]["pcs"], jinst[0]["pcs"])
    jb, tb = jinst[0]["bbox3D"], tinst[0]["bbox3D"]
    for k in ("center", "R", "extent"):
        np.testing.assert_array_equal(getattr(tb, k), getattr(jb, k))
    for (o, _, tp), (oj, _, jp) in zip(_objects(tinst), _objects(jinst)):
        assert o == oj
        np.testing.assert_array_equal(tp, jp)
    for c, objs in jinst.items():
        if c:
            for o, info in objs.items():
                np.testing.assert_array_equal(tinst[c][o]["pcs_rgb"],
                                              info["pcs_rgb"])


def test_obb_and_teaser_are_bitwise(loaded):
    (o1, _, p1), (o2, _, p2) = _objects(loaded["tinst"])[:2]
    T_t, box_t = tobb.get_pose_from_pointcloud(p1)
    T_j, box_j = jobb.get_pose_from_pointcloud(p1)
    np.testing.assert_array_equal(T_t, T_j)
    np.testing.assert_array_equal(box_t.extent, box_j.extent)
    ti = {"T_obj": np.array(T_t), "pcs": p2}
    ji = {"T_obj": np.array(T_j), "pcs": p2}
    tobb.get_obb(ti)
    jobb.get_obb(ji)
    np.testing.assert_array_equal(ti["T_obj"], ji["T_obj"])
    np.testing.assert_array_equal(ti["bbox3D"].extent, ji["bbox3D"].extent)
    for spc, vox in ((True, 0.1), (False, 0.08)):
        Rt, tt = tteaser.teaser_fpfh_icp(p1 / 0.3, p2 / 0.3, voxel_size=vox,
                                         spc=spc)
        Rj, tj = jteaser.teaser_fpfh_icp(p1 / 0.3, p2 / 0.3, voxel_size=vox,
                                         spc=spc)
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
    assert treg.coverage_score(p1) == jreg.coverage_score(p1)


@pytest.mark.parametrize("spc,vox", [(True, 0.1), (False, 0.08)],
                         ids=["spc", "fpfh"])
def test_batch_teaser_is_bitwise(loaded, spc, vox):
    """BatchTeaser against the JAX class: one source onto three targets,
    the generator carried across them (the spc route draws from it)."""
    (_, _, p1), (_, _, p2) = _objects(loaded["tinst"])[:2]
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    targets = [p2 / 0.3, p1 @ rot.T / 0.3, p2 / 0.3 + 0.05]
    Rt, tt = tteaser.BatchTeaser(p1 / 0.3, voxel_size=vox, spc=spc,
                                 seed=3).forward(targets)
    Rj, tj = jteaser.BatchTeaser(p1 / 0.3, voxel_size=vox, spc=spc,
                                 seed=3).forward(targets)
    assert Rt.shape == (3, 3, 3) and tt.shape == (3, 3, 1)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)


def _assert_registered_alike(tinst, jinst):
    assert sorted(tinst) == sorted(jinst)  # the same subcategory splits
    for c, jobjs in jinst.items():
        if c == 0:
            continue
        assert sorted(tinst[c]) == sorted(jobjs)
        for o, jinfo in jobjs.items():
            tinfo = tinst[c][o]
            np.testing.assert_allclose(tinfo["T_obj"], jinfo["T_obj"],
                                       rtol=0, atol=HOST_TOL)
            for k in ("center", "R", "extent"):
                np.testing.assert_allclose(
                    getattr(tinfo["bbox3D"], k), getattr(jinfo["bbox3D"], k),
                    rtol=0, atol=HOST_TOL)


def test_run_registration_on_the_coverage_route(loaded, monkeypatch):
    """load_pretrained=False with no field pretrained (every object
    routed to the geometric coverage score): the whole of
    run_registration of both packages on the background and the second
    category (the first is aligned in test_align_poses_fed_the_jax_counts),
    within 1e-9."""
    for mod in (tfp, jfp):
        monkeypatch.setattr(mod, "pretrain_object_fields",
                            lambda objects, *a, **k: [None] * len(objects))
    jdata, tdata = loaded["jdata"], loaded["tdata"]
    cls_id = sorted(c for c in jdata.inst_dict if c)[1]
    jinst, tinst = (copy.deepcopy({c: jdata.inst_dict[c] for c in (0, cls_id)}),
                    copy.deepcopy({c: tdata.inst_dict[c] for c in (0, cls_id)}))
    jreg.run_registration(jinst, jdata.sample_dict, jdata.cam, jdata.cfg)
    counts = treg.run_registration(tinst, tdata.sample_dict, tdata.cam,
                                   tdata.cfg, device="cpu")
    want = {cls_id: {o: jreg.coverage_score(info["pcs"])
                     for o, info in loaded["jinst"][cls_id].items()}}
    assert counts == want
    _assert_registered_alike(tinst, jinst)


# ---------------------------------------------------------------------------
# device stages on the CPU, on the JAX package's draws
# ---------------------------------------------------------------------------

def _jax_superstep(cfg, n_obj, max_len, n_rays, n_inner):
    """The JAX package's pretraining superstep (field_pretrain.py:
    130-179), returning for each step the state it started from and its
    loss terms."""
    tx = optax.adamw(jfp.LR, weight_decay=cfg.weight_decay)
    sample_fn = partial(
        jsampling.sample_3d_points, n_bins_cam2surface=jfp.N_BINS_C2S,
        n_bins=jfp.N_BINS, min_depth=cfg.min_depth,
        surface_eps=cfg.surface_eps, stop_eps=cfg.stop_eps)

    @jax.jit
    def superstep(carry, k, packed_d, lengths_d, scales_d):
        def loss_fn(params, rows, k):
            keys = jax.random.split(k, n_obj)
            rays = jax.vmap(sample_fn)(
                keys, rows[..., 6:9], rows[..., 10].astype(jnp.int32),
                rows[..., 9], rows[..., 0:3], rows[..., 3:6])

            def fwd(p, pcs, scale):
                emb = jembedding.apply(p["pe"], pcs, scale=scale)
                a, c = joccupancy.apply(p["fc"], emb)
                return a[..., 0], c

            alpha, color = jax.vmap(fwd)(params, rays.input_pcs, scales_d)
            lb = jlosses.step_batch_loss(
                alpha, color, rays.gt_depth, rays.gt_rgb, rays.obj_labels,
                rays.valid_depth_mask, rays.z_vals,
                color_scaling=cfg.color_scaling,
                opacity_scaling=cfg.opacity_scaling)
            return lb.total, (lb.depth, lb.color, lb.opacity)

        def one_step(carry, k):
            params, opt_state = carry
            k_draw, k_sample = jax.random.split(k)
            idx = jax.random.randint(k_draw, (n_obj, n_rays), 0,
                                     lengths_d[:, None])
            flat = (idx + (jnp.arange(n_obj) * max_len)[:, None]).reshape(-1)
            rows = jnp.take(packed_d.reshape(n_obj * max_len, 11), flat,
                            axis=0).reshape(n_obj, n_rays, 11)
            (loss, terms), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(params, rows, k_sample)
            updates, new_opt = tx.update(grads, opt_state, params)
            return ((optax.apply_updates(params, updates), new_opt),
                    (carry, loss, terms))

        return jax.lax.scan(one_step, carry, jax.random.split(k, n_inner))

    return tx, superstep


def _jax_draws(key, lengths, n_steps, n_rays):
    """The JAX package's per-step row indices and sampler uniforms for a
    single superstep of n_steps (field_pretrain.py:127-185)."""
    n_obj = len(lengths)
    keys = jax.random.split(key, n_obj + 1)
    key = keys[0]
    _, k = jax.random.split(key)
    n_u = tfp.N_U
    draws = []
    for ks in jax.random.split(k, n_steps):
        k_draw, k_sample = jax.random.split(ks)
        idx = jax.random.randint(k_draw, (n_obj, n_rays), 0,
                                 jnp.asarray(lengths, jnp.int32)[:, None])
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (n_rays, n_u)))(
            jax.random.split(k_sample, n_obj))
        draws.append(tfp.PretrainDraws(
            torch.tensor(np.asarray(idx), dtype=torch.int64),
            torch.tensor(np.asarray(u))))
    return keys[1:], draws


def _leaf(tree, name: str):
    """The JAX leaf of a port parameter name (`in_layer.w`, `mid1.0.b`)."""
    for part in name.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return np.asarray(tree)


def _load_jax_state(trainer, params, opt_state):
    """The trainer's parameters and AdamW moments set to a JAX state
    (optax.adamw's ScaleByAdamState: count, mu, nu)."""
    adam = opt_state[0]
    named = [("pe", "B", trainer.pe.B)] + [
        ("fc", n, p) for n, p in trainer.fc.named_parameters()]
    with torch.no_grad():
        for group, name, p in named:
            p.copy_(torch.tensor(_leaf(params[group], name)))
            trainer.optimizer.state[p] = {
                "step": torch.tensor(float(adam.count)),
                "exp_avg": torch.tensor(_leaf(adam.mu[group], name)),
                "exp_avg_sq": torch.tensor(_leaf(adam.nu[group], name))}


@pytest.fixture(scope="module")
def pretrained(loaded):
    """The JAX package's pretraining (its function, and the copy of its
    superstep with each step's starting state and loss terms), and the
    port's on the same draws: run free from the same initial parameters,
    and one step from each of the JAX states."""
    jinst, tinst = loaded["jinst"], loaded["tinst"]
    jdata, tdata = loaded["jdata"], loaded["tdata"]
    cfg = Config()
    key = jax.random.PRNGKey(PRETRAIN_KEY)
    port = tfp.ObjectFieldTrainer(_objects(tinst), tdata.sample_dict,
                                  tdata.cam, cfg, n_rays=PRETRAIN_RAYS,
                                  device="cpu")
    lengths = port.lengths.numpy()
    n_obj, max_len = len(lengths), port.packed.shape[0] // len(lengths)
    init_keys, draws = _jax_draws(key, lengths, PRETRAIN_STEPS,
                                  PRETRAIN_RAYS)
    init = jax.tree.map(np.asarray,
                        jax.vmap(jfp._init_field_params)(init_keys))

    jfields = jfp.pretrain_object_fields(
        _objects(jinst), jdata.sample_dict, jdata.cam, JConfig(),
        steps=PRETRAIN_STEPS, n_rays=PRETRAIN_RAYS, key=key,
        n_inner=PRETRAIN_STEPS)
    tx, superstep = _jax_superstep(JConfig(), n_obj, max_len, PRETRAIN_RAYS,
                                   PRETRAIN_STEPS)
    _, k = jax.random.split(jax.random.split(key, n_obj + 1)[0])
    params = jax.tree.map(jnp.asarray, init)

    def trajectory():
        (p1, o1), (states, _, terms) = superstep(
            (params, tx.init(params)), k,
            jnp.asarray(port.packed.numpy().reshape(n_obj, max_len, 11)),
            jnp.asarray(lengths, jnp.int32),
            jnp.asarray(port.scales, jnp.float32))
        states = jax.tree.map(np.asarray, states)
        starts = [jax.tree.map(lambda x: x[s], states)
                  for s in range(PRETRAIN_STEPS)]
        return (p1, o1), starts, terms

    (jparams, jopt), starts, jterms = trajectory()
    ends = starts[1:] + [jax.tree.map(np.asarray, (jparams, jopt))]

    # one port step from each JAX state, on that step's draws
    steps = []
    for d, (p0, o0), (p1, _) in zip(draws, starts, ends):
        _load_jax_state(port, p0, o0)
        tied, lb = rc.relu_tied_units(port, d, RELU_TIE)
        port.step(d)
        steps.append(dict(
            terms=[t.numpy() for t in (lb.depth, lb.color, lb.opacity)],
            params=[(n, p.detach().numpy().copy(), _leaf(p1[g], n),
                     ~rc.tied_mask(n, tied, tuple(p.shape)).numpy())
                    for g, n, p in [("pe", "B", port.pe.B)] + [
                        ("fc", n, p) for n, p in port.fc.named_parameters()]]))
    tfields = tfp.pretrain_object_fields(
        _objects(tinst), tdata.sample_dict, tdata.cam, cfg,
        steps=PRETRAIN_STEPS, n_rays=PRETRAIN_RAYS, n_inner=PRETRAIN_STEPS,
        device="cpu", draws=draws, init=init)
    return dict(jfields=jfields, jparams=jparams, init=init, draws=draws,
                jterms=[np.asarray(t) for t in jterms], steps=steps,
                tfields=tfields)


def test_the_replica_superstep_is_the_jax_packages(pretrained):
    """The test's copy of the JAX superstep ends where the JAX package's
    pretrain_object_fields does, bitwise (so its states and loss terms
    are the JAX package's)."""
    for i, f in enumerate(pretrained["jfields"]):
        want = jax.tree.map(lambda x: np.asarray(x[i]),
                            pretrained["jparams"])
        jax.tree.map(np.testing.assert_array_equal,
                     {"pe": f["pe"], "fc": f["fc"]}, want)


@pytest.mark.parametrize("term", [1, 2], ids=["color", "opacity"])
def test_pretrain_step_losses_match_jax(pretrained, term):
    """Each step's colour and opacity loss of each object, from the JAX
    state the step starts from, within PRETRAIN_TOL relative. The depth
    term is weighted by 1/(sqrt(var) + 1e-4) of a termination whose
    saturated bins (1 - sigmoid(10 alpha) at float32's resolution of 1)
    set var: it is ill-conditioned, and the JAX package's own jitted and
    eager evaluations of the first step's loss part by 2.5%
    (tests/torch_registration_spread.py)."""
    want = pretrained["jterms"][term]
    got = np.stack([s["terms"][term] for s in pretrained["steps"]])
    np.testing.assert_allclose(got, want, rtol=PRETRAIN_TOL)


def test_pretrain_steps_match_jax(pretrained):
    """Each AdamW step from the JAX state it starts from lands on the
    JAX package's next state: every leaf within LEAF_TOL of the leaf's
    largest entry, but for the incoming weights of units with a ReLU tie
    at that step (the ReLU-kink rule of ROADMAP.md, "How to hold a
    float32 backward"), which are at most 5% of a leaf and are held
    within experimental/registration_check.py's TIED_LEAF_TOL."""
    for i, step in enumerate(pretrained["steps"]):
        for name, got, want, keep in step["params"]:
            assert keep.mean() >= 0.95, (i, name, keep.mean())
            np.testing.assert_allclose(
                got[keep], want[keep], rtol=0,
                atol=LEAF_TOL * np.abs(want).max(),
                err_msg=f"step {i}, {name}")
            np.testing.assert_allclose(
                got[~keep], want[~keep], rtol=0,
                atol=rc.TIED_LEAF_TOL * np.abs(want).max(),
                err_msg=f"step {i}, {name}, tied units")


def test_pretrain_object_fields_runs_the_trainer(pretrained, loaded):
    """pretrain_object_fields on injected draws and init is the
    trainer's step loop, bitwise, and returns each object's field with
    the JAX package's scale, center and box; the losses fall."""
    tdata = loaded["tdata"]
    trainer = tfp.ObjectFieldTrainer(
        _objects(loaded["tinst"]), tdata.sample_dict, tdata.cam, Config(),
        n_rays=PRETRAIN_RAYS, device="cpu", init=pretrained["init"])
    losses_ = [float(trainer.step(d)) for d in pretrained["draws"]]
    assert losses_[-1] < losses_[0]
    for a, b, jf in zip(trainer.fields(), pretrained["tfields"],
                        pretrained["jfields"]):
        jax.tree.map(np.testing.assert_array_equal,
                     {"pe": a["pe"], "fc": a["fc"]},
                     {"pe": b["pe"], "fc": b["fc"]})
        for k in ("obj_scale", "center", "bbox"):
            np.testing.assert_array_equal(b[k], jf[k])


def _flips_allowed(t_metric, j_metric):
    """Directions on either side of the 0.5 threshold in the two
    packages, all of which must lie within METRIC_FLIP of it in JAX's."""
    flipped = (t_metric < 0.5) != (j_metric < 0.5)
    assert (np.abs(j_metric[flipped] - 0.5) < METRIC_FLIP).all()
    return int(flipped.sum())


@pytest.fixture(scope="module")
def jax_scores(loaded, pretrained):
    """{obj_id: (count, entropies, metric)}: the JAX package's
    uncertainty_score of its pretrained fields of the first category, on
    PRNGKey(obj_id), computed once for the tests below."""
    jinst = loaded["jinst"]
    cls_id = sorted(c for c in jinst if c)[0]
    return {obj_id: junc.uncertainty_score(
                field, pcs, key=jax.random.PRNGKey(obj_id))
            for (obj_id, _, pcs), field in zip(_objects(jinst),
                                               pretrained["jfields"])
            if obj_id in jinst[cls_id]}


def _score_both(field, pcs, obj_id, jax_score):
    """The port's uncertainty_score on the JAX uniforms of PRNGKey(obj_id)
    against the JAX package's (`jax_score`): entropies within ENTROPY_TOL,
    counts under the flip rule."""
    key = jax.random.PRNGKey(obj_id)
    jc, je, jm = jax_score
    u = torch.tensor(np.asarray(jax.random.uniform(key, (10000,
                                                         tunc.N_BINS))))
    tc, te, tm = tunc.uncertainty_score(field, pcs, u=u, device="cpu")
    np.testing.assert_allclose(te, je, rtol=0, atol=ENTROPY_TOL)
    flips = _flips_allowed(tm, jm)
    assert abs(tc - jc) <= flips
    return u, (tc, jc)


def test_uncertainty_score_matches_jax(loaded, pretrained, jax_scores):
    """One pretrained field (the JAX package's), scored by both packages
    on the JAX uniforms: the termination of every bin within TERM_TOL,
    the entropies within ENTROPY_TOL, the count under the flip rule; and
    the port's termination no further from a float64 evaluation than
    F32_FACTOR times the JAX package's."""
    field = pretrained["jfields"][0]
    obj_id, _, pcs = _objects(loaded["tinst"])[0]
    u, _ = _score_both(field, pcs, obj_id, jax_scores[obj_id])

    # the termination of every fourth direction (the float64 evaluation
    # of all 10,000 takes 15 s on one core)
    rays_o, viewdir, r = tunc.shell_rays(field, pcs)
    n = len(rays_o)
    z = _stratified_from_u(u, torch.zeros(n), torch.full((n,), 2.0 * r))
    jz = jsampling.stratified_bins(
        jax.random.PRNGKey(obj_id), jnp.zeros((n,)), jnp.full((n,), 2.0 * r),
        tunc.N_BINS)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    rays_o, viewdir, z, jz = rays_o[::4], viewdir[::4], z[::4], jz[::4]
    pe, fc = tunc.field_modules(field, "cpu")
    tterm = tunc.term_probs_field(
        pe, fc, torch.from_numpy(rays_o), torch.from_numpy(viewdir), z,
        torch.tensor(field["obj_scale"], dtype=torch.float32)).numpy()
    jterm = np.asarray(junc._term_probs_field(
        field["pe"], field["fc"], jnp.asarray(rays_o), jnp.asarray(viewdir),
        jz, jnp.float32(field["obj_scale"])))
    np.testing.assert_allclose(tterm, jterm, rtol=0, atol=TERM_TOL)
    t64 = tunc.term_probs_field(
        pe.double(), fc.double(), torch.from_numpy(rays_o).double(),
        torch.from_numpy(viewdir).double(), z.double(),
        torch.tensor(field["obj_scale"], dtype=torch.float64)).numpy()
    assert np.abs(tterm - t64).max() <= F32_FACTOR * np.abs(
        jterm - t64).max()


def test_align_poses_fed_the_jax_counts(loaded, pretrained, jax_scores):
    """The first category's two instances, scored by the JAX package's
    uncertainty counts of its pretrained fields: both packages'
    align_poses choose the same template and poses, within 1e-9."""
    jinst = loaded["jinst"]
    cls_id = sorted(c for c in jinst if c)[0]
    counts, boxes, fields = {cls_id: {}}, {cls_id: {}}, {cls_id: {}}
    objs = _objects(jinst)
    for (obj_id, _, pcs), field in zip(objs, pretrained["jfields"]):
        if obj_id in jinst[cls_id]:
            counts[cls_id][obj_id] = jax_scores[obj_id][0]
            boxes[cls_id][obj_id] = field["bbox"]
            fields[cls_id][obj_id] = field
    one = {0: jinst[0], cls_id: jinst[cls_id]}
    out = {}
    for name, reg in (("jax", jreg), ("port", treg)):
        inst = copy.deepcopy(one)
        reg.align_poses(inst, copy.deepcopy(boxes), copy.deepcopy(counts),
                        copy.deepcopy(fields), multi_init_pose=False)
        out[name] = inst
    _assert_registered_alike(out["port"], out["jax"])


def test_zero_ray_objects_are_dropped(loaded):
    """An object whose every bbox crop is empty comes back None (the
    coverage fallback) and is not trained (tests/test_registration.py:
    410); a batch of only such objects trains nothing."""
    (obj_id, frame_info, pcs), = _objects(loaded["tinst"])[:1]
    degenerate = [{"frame": frame_info[0]["frame"], "bbox": (5, 5, 3, 7)}]
    tdata = loaded["tdata"]
    fields = tfp.pretrain_object_fields(
        [(obj_id, frame_info, pcs), (obj_id + 1, degenerate, pcs)],
        tdata.sample_dict, tdata.cam, Config(), steps=4, n_rays=32,
        n_inner=2, device="cpu")
    assert fields[0] is not None and fields[1] is None
    assert tfp.pretrain_object_fields(
        [(obj_id + 1, degenerate, pcs)], tdata.sample_dict, tdata.cam,
        Config(), steps=4, n_rays=32, n_inner=2, device="cpu") == [None]


def test_empty_frame_info_falls_back_to_coverage(loaded):
    """An object with a cloud but no frames takes the coverage score; the
    other of its category is pretrained and scored
    (tests/test_registration.py:445)."""
    inst = copy.deepcopy(loaded["tinst"])
    cls_id = sorted(c for c in inst if c)[0]
    objs = sorted(inst[cls_id])
    inst = {0: inst[0], cls_id: inst[cls_id]}
    inst[cls_id][objs[1]]["frame_info"] = []
    cfg = Config()
    cfg.pretrain_steps, cfg.pretrain_rays = 20, 64
    counts, boxes, fields = {}, {}, {}
    treg.get_uncertainty_fields(inst, boxes, counts, fields, cfg,
                                load_pretrained=False,
                                sample_dict=loaded["tdata"].sample_dict,
                                cam=loaded["tdata"].cam, device="cpu")
    assert objs[0] in fields[cls_id] and objs[1] not in fields[cls_id]
    # a category mixing the two scores is re-scored by coverage alone
    # (registration.py:189-206)
    for o in objs:
        assert counts[cls_id][o] == treg.coverage_score(inst[cls_id][o]["pcs"])


def _vmap_pth(path, rng):
    """A vMAP per-object checkpoint as tests/test_vmap_converter.py:108-136
    writes it (FC and PE state dicts, obj_scale, bbox)."""
    hidden, emb1, emb2 = 32, 87, 42

    def lin(i, o):
        return {"w": rng.normal(0, 0.3, (i, o)).astype(np.float32),
                "b": rng.normal(0, 0.1, (o,)).astype(np.float32)}

    fc = {"in_layer": lin(emb1, hidden), "mid1": [lin(hidden, hidden)],
          "cat_layer": lin(hidden + emb1, hidden),
          "mid2": [lin(hidden, hidden)], "out_alpha": lin(hidden, 1),
          "color_linear": lin(hidden + emb2, hidden),
          "out_color": lin(hidden, 3)}
    torch.save({
        "FC_state_dict": _occupancy_state_dict(torch, fc),
        "PE_state_dict": {"B_layer.weight": torch.tensor(
            rng.normal(0, 1, (21, 3)).astype(np.float32))},
        "obj_scale": 0.4,
        "bbox": rng.normal(0, 1, (2, 3)).astype(np.float32),
    }, path)


def test_load_pretrained_reads_vmap_checkpoints(tmp_path, loaded):
    """load_pretrained=True: the latest `.pth` under
    <weight_root>/ckpt/<obj_id>/ (by parsed iteration), converted and
    scored by both packages: the same field and box."""
    rng = np.random.default_rng(1)
    obj_id, _, pcs = _objects(loaded["tinst"])[0]
    ckpt_dir = tmp_path / "ckpt" / str(obj_id)
    os.makedirs(ckpt_dir)
    _vmap_pth(ckpt_dir / f"obj_{obj_id}_iteration_999.pth",
              np.random.default_rng(2))
    _vmap_pth(ckpt_dir / f"obj_{obj_id}_iteration_2000.pth", rng)
    out = {}
    for name, cfg, reg, kw in (("jax", JConfig(), jreg, {}),
                               ("port", Config(), treg, {"device": "cpu"})):
        cfg.weight_root = str(tmp_path)
        inst = {20: {obj_id: {"pcs": pcs, "frame_info": []}}}
        boxes, counts, fields = {}, {}, {}
        reg.get_uncertainty_fields(inst, boxes, counts, fields, cfg,
                                   load_pretrained=True, **kw)
        out[name] = (counts[20][obj_id], boxes[20][obj_id],
                     fields[20][obj_id])
    (tc, tb, tf), (jc, jb, jf) = out["port"], out["jax"]
    np.testing.assert_array_equal(tb, jb)
    jax.tree.map(np.testing.assert_array_equal, tf, jf)
    # each package scored on its own generator's uniforms (on the JAX
    # package's uniforms, test_uncertainty_score_matches_jax)
    assert 0 < tc <= 10000 and 0 < jc <= 10000
