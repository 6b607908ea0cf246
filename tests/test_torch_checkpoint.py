"""The port's checkpoints (`catnerf_torch/train/checkpoint.py`) on the CPU:
save and restore bitwise, the fast path after a restore, and the
reference-format `.pth` files held against the JAX package's, both ways.

The JAX session and the port's session are built on the same scene from
the same weights (the JAX init, through `convert.params_from_jax`); a 2
category x 2 instance 48x36 scene with a 32-wide background keeps it small.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

from catnerf_torch import convert
from catnerf_torch.config import Config
from catnerf_torch.data.device_buffer import FastDraws, draw_offsets
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.mesher import meshing
from catnerf_torch.models import embedding, occupancy
from catnerf_torch.train import checkpoint as ckpt
from catnerf_torch.train import step as tstep
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.train.state import make_train_state
from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_tpu.mesher import meshing as jmeshing
from catnerf_tpu.train import checkpoint as jckpt
from catnerf_tpu.train.loop import TrainingSession as JSession
from test_vmap_converter import EMB1, EMB2, _torch_fc_state, _torch_forward

torch.set_num_threads(1)

SCENE = dict(n_frames=3, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=3)
FWD_TOL = 1e-5  # relative and absolute: alpha carries the x10 logit scale


# the vMAP files' weights (std 0.3, tests/test_vmap_converter.py) drive
# |alpha| to ~80, where float32 sums in two orders differ by ~1e-5
# relative: held at that file's own tolerance
VMAP_TOL = 1e-4


def _close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _configure(cfg):
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 32
    cfg.n_per_optim = 24
    cfg.n_per_optim_bg = 64
    return cfg


def _session(params=None) -> TrainingSession:
    """A port session on the CPU; `params` (a JAX params pytree) replaces
    its initial weights."""
    scene = make_scene(**SCENE)
    cfg = _configure(Config())
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device="cpu")
    if params is not None:
        sess.state = make_train_state(cfg, convert.params_from_jax(params))
    return sess


@pytest.fixture(scope="module")
def jsession():
    scene = jmake_scene(**SCENE)
    return JSession(_configure(JConfig()), scene.inst_dict,
                    scene.sample_dict, cam=scene.cam)


def _fast_draws(sess, seed, n=1):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        offs, boff = draw_offsets(sess._store, gen)
        out.append(FastDraws(offs, boff, sess._draws(gen)))
    return out


def _state_tensors(state) -> dict:
    """Every parameter and every AdamW state tensor, by name."""
    out = {f"param/{k}": v.detach() for k, v in
           state.params.named_parameters()}
    names = dict((id(p), k) for k, p in state.params.named_parameters())
    for p, st in state.optimizer.state.items():
        for k, v in st.items():
            out[f"adamw/{names[id(p)]}/{k}"] = v
    return out


def _assert_bitwise(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].device == b[k].device, k
        assert torch.equal(a[k], b[k]), k


def _metrics_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_is_bitwise_and_so_is_the_next_step(tmp_path):
    """The counterpart of tests/test_cli_and_ckpt.py's round trip, made
    exact: every parameter, every AdamW state tensor, step and iteration
    restore bitwise into a fresh session, and one more step of each, on
    the same batch and injected draws, stays bitwise equal."""
    sess = _session()
    for _ in range(3):
        sess.step_once()
    path = ckpt.save_session_checkpoint(str(tmp_path / "ckpt"), sess, 3)
    assert path == str(tmp_path / "ckpt" / "3")
    assert ckpt.latest_checkpoint(str(tmp_path / "ckpt")) == path

    fresh = _session()
    template = fresh.state
    ckpt.restore_session_checkpoint(path, fresh)
    assert fresh.state is not template          # a new state ...
    assert template.step == 0 and not template.optimizer.state  # ... only
    assert fresh.state.step == sess.state.step == 3
    assert fresh.iteration == sess.iteration == 3
    _assert_bitwise(_state_tensors(fresh.state), _state_tensors(sess.state))
    assert [g["lr"] for g in fresh.state.optimizer.param_groups] == \
        [g["lr"] for g in sess.state.optimizer.param_groups]

    cat, bg = sess._device_batch()
    draws = sess._draws(torch.Generator().manual_seed(7))
    m1 = tstep.train_step(sess.state, cat, bg, draws, sess.cfg, sess.obj_mask)
    m2 = tstep.train_step(fresh.state, cat, bg, draws, fresh.cfg,
                          fresh.obj_mask)
    assert _metrics_equal(m1, m2)
    _assert_bitwise(_state_tensors(fresh.state), _state_tensors(sess.state))


def test_run_fast_after_a_restore_raises_until_the_fast_path_is_rebuilt(
        tmp_path):
    """A restore replaces the session's state, and the fast path built on
    the old one would step tensors the session no longer holds: run_fast
    raises until enable_fast_path is called again, and then trains from
    the restored values, bitwise as the saved session does."""
    sess = _session()
    sess.enable_fast_path(2)
    sess.run_fast(3)
    path = ckpt.save_session_checkpoint(str(tmp_path), sess, 3)
    sess.enable_fast_path(2)
    draws = _fast_draws(sess, seed=11, n=2)
    want = sess.run_fast(2, draws=draws)

    other = _session()
    other.enable_fast_path(2)
    other.run_fast(1)
    ckpt.restore_session_checkpoint(path, other)
    with pytest.raises(RuntimeError, match="enable_fast_path"):
        other.run_fast(1)
    other.enable_fast_path(2)
    got = other.run_fast(2, draws=draws)
    assert _metrics_equal(got, want)
    _assert_bitwise(_state_tensors(other.state), _state_tensors(sess.state))


def test_reference_import_keeps_the_fast_path_and_trains_the_imported_values(
        tmp_path):
    """An import writes into the parameters in place: a fast path built
    before it stays valid and steps the imported weights, bitwise as a
    fast path built after it."""
    src = _session()
    src.step_once()
    ckpt.export_reference_checkpoints(src, str(tmp_path), 1)

    kept, rebuilt = _session(), _session()
    for s in (kept, rebuilt):
        s.enable_fast_path(2)
        s.run_fast(1)  # a superstep in use, and moments
        ckpt.import_reference_checkpoints(s, str(tmp_path))
    got = convert.params_to_numpy(kept.state.params)
    want = convert.params_to_numpy(src.state.params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, got["cat_fc"],
                           want["cat_fc"])
    rebuilt.enable_fast_path(2)
    draws = _fast_draws(rebuilt, seed=5, n=2)
    assert _metrics_equal(kept.run_fast(2, draws=draws),
                          rebuilt.run_fast(2, draws=draws))
    _assert_bitwise(_state_tensors(kept.state), _state_tensors(rebuilt.state))


@pytest.mark.parametrize("direction", ["cuda_to_cpu", "cpu_to_capturable"])
def test_the_optimizer_flags_and_step_counts_follow_the_loading_optimizer(
        tmp_path, direction):
    """A capturable (CUDA) optimizer's checkpoint loads into a CPU one,
    and the reverse: the loading optimizer keeps its own `capturable`
    flag, and torch's rule places the step counts by it (on the
    parameters' device, float32, when capturable; as saved when not). The
    card's own round trip in both directions is in
    tests/test_torch_cuda_checkpoint.py and chip_smoke.py."""
    sess = _session()
    sess.step_once()
    path = ckpt.save_checkpoint(str(tmp_path), sess.state, 1)
    raw = torch.load(path, weights_only=True)
    fresh = _session()
    if direction == "cuda_to_cpu":
        for g in raw["optimizer"]["param_groups"]:
            g["capturable"] = True
        torch.save(raw, path)
    else:
        for g in fresh.state.optimizer.param_groups:
            g["capturable"] = True
    restored = ckpt.load_checkpoint(path, fresh.state)
    flags = {g["capturable"] for g in restored.optimizer.param_groups}
    assert flags == {direction != "cuda_to_cpu"}
    for st in restored.optimizer.state.values():
        assert st["step"].dtype == torch.float32
        assert st["step"].device.type == "cpu" and st["step"].dim() == 0
        assert float(st["step"]) == 1.0
    _assert_bitwise(_state_tensors(restored), _state_tensors(sess.state))


def test_a_stale_sidecar_is_removed_and_a_present_one_makes_restore_raise(
        tmp_path):
    """The adoption sidecar (the name is from when the port refused it): an
    adoptee-less save removes a stale `<it>.adopted.json`; a save with
    adopted instances writes their records, and a restore into a fresh
    session applies them before loading (fit.apply_adopted_record), so
    the grown code tables load bitwise."""
    sess = _session()
    stale = tmp_path / "4.adopted.json"
    stale.write_text('[{"obj_id": 9}]')
    path = ckpt.save_session_checkpoint(str(tmp_path), sess, 4)
    assert not stale.exists() and os.path.exists(path)
    cls_id = sess.cls_ids[0]
    rec = {"cls": cls_id, "id": 77, "extent": [0.5, 0.6, 0.7],
           "obj_tensor": [0.4, 1.0, 0.0, 0.0, 0.0, 0.1, 0.2, 0.3]}
    from catnerf_torch import fit

    fit.apply_adopted_record(sess, rec)
    sess.step_once()
    path = ckpt.save_session_checkpoint(str(tmp_path), sess, 5)
    with open(f"{path}.adopted.json") as f:
        assert json.load(f) == [rec]
    fresh = _session()
    ckpt.restore_session_checkpoint(path, fresh)
    assert fresh.adopted_instances == [rec]
    assert fresh.categories[0].obj_ids[-1] == 77
    assert tuple(fresh.state.params.codes.shape.shape) == (2, 3, 16)
    _assert_bitwise(_state_tensors(fresh.state), _state_tensors(sess.state))


def test_find_reference_checkpoints_takes_the_latest_iteration_per_class(
        tmp_path):
    for name in ("cls_3_iteration_00100.pth", "cls_3_iteration_02000.pth",
                 "cls_3_iteration_00999.pth", "cls_0_iteration_00500.pth",
                 "cls_12_iteration_7.pth", "notes.txt", "cls_x_iteration_1.pth"):
        (tmp_path / name).write_bytes(b"")
    found = ckpt.find_reference_checkpoints(str(tmp_path))
    assert found == {3: str(tmp_path / "cls_3_iteration_02000.pth"),
                     0: str(tmp_path / "cls_0_iteration_00500.pth"),
                     12: str(tmp_path / "cls_12_iteration_7.pth")}
    assert ckpt.find_reference_checkpoints(str(tmp_path), 100) == {
        3: str(tmp_path / "cls_3_iteration_00100.pth")}
    assert found == jckpt.find_reference_checkpoints(str(tmp_path))


# ---------------------------------------------------------------------------
# the reference's .pth format against the JAX package
# ---------------------------------------------------------------------------

def _assert_same(a, b, where="file"):
    """Loaded .pth contents equal: the same keys and types, tensors and
    arrays of the same dtype and shape with equal bits."""
    assert type(a) is type(b), f"{where}: {type(a)} vs {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), f"{where}: keys {list(a)} vs {list(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.device.type == "cpu" and b.device.type == "cpu", where
        assert torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


def _export_both(jsess, tmp_path, iteration=7):
    tsess = _session(jax.device_get(jsess.state.params))
    jfiles = jckpt.export_reference_checkpoints(jsess, str(tmp_path / "jax"),
                                                iteration)
    tfiles = ckpt.export_reference_checkpoints(tsess, str(tmp_path / "port"),
                                               iteration)
    return tsess, jfiles, tfiles


def test_export_equals_the_jax_packages_file_for_file(jsession, tmp_path):
    _, jfiles, tfiles = _export_both(jsession, tmp_path)
    assert [os.path.basename(f) for f in tfiles] == \
        [os.path.basename(f) for f in jfiles]
    assert len(tfiles) == len(jsession.cls_ids) + 1
    for jf, tf in zip(jfiles, tfiles):
        _assert_same(torch.load(tf, weights_only=False),
                     torch.load(jf, weights_only=False),
                     os.path.basename(tf))


def _jparams(jsess) -> dict:
    return jax.tree_util.tree_map(np.asarray, jax.device_get(
        jsess.state.params))


def _assert_params_equal(tsess, jsess):
    """The port's parameters bitwise equal to the JAX session's: every
    stacked weight, and the code rows of real instances (padded rows are
    not exported)."""
    want = _jparams(jsess)
    got = convert.params_to_numpy(tsess.state.params)
    for k in ("cat_pe", "cat_fc", "bg_pe", "bg_fc"):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got[k],
                               want[k])
    for kind in ("shape", "texture"):
        for i, cat in enumerate(tsess.categories):
            for slot in cat.inst_id_to_index.values():
                np.testing.assert_array_equal(got["codes"][kind][i, slot],
                                              want["codes"][kind][i, slot])


def _assert_forward_close(tsess, jsess):
    """The port's field (grid evaluation path) at random points matches
    the JAX package's within FWD_TOL, for every category's first instance
    and the background."""
    pts = np.random.default_rng(0).uniform(-1.0, 1.0, (500, 3)).astype(
        np.float32)
    for cls_id, cat in zip(tsess.cls_ids, tsess.categories):
        tp, jp = tsess.category_params(cls_id), jsess.category_params(cls_id)
        k = cat.inst_id_to_index[cat.obj_ids[0]]
        got = meshing.eval_points(pts, tp, tsess.cfg, tp["shape_codes"][k],
                                  tp["texture_codes"][k],
                                  is_background=False, chunk=256)
        want = jmeshing.eval_points(pts, jp, jsess.cfg,
                                    np.asarray(jp["shape_codes"][k]),
                                    np.asarray(jp["texture_codes"][k]),
                                    is_background=False, chunk=256)
        for g, w in zip(got, want):
            _close(g, w)
    got = meshing.eval_points(pts, tsess.background_params(), tsess.cfg,
                              is_background=True, chunk=256)
    want = jmeshing.eval_points(pts, jsess.background_params(), jsess.cfg,
                                is_background=True, chunk=256)
    for g, w in zip(got, want):
        _close(g, w)


def _metadata_equal(tsess, jsess):
    for tc, jc in zip(tsess.categories, jsess.categories):
        assert tc.extent_dict.keys() == jc.extent_dict.keys()
        for k in tc.extent_dict:
            np.testing.assert_array_equal(tc.extent_dict[k],
                                          jc.extent_dict[k])
        for k in tc.object_tensor_dict:
            np.testing.assert_array_equal(tc.object_tensor_dict[k],
                                          jc.object_tensor_dict[k])
    np.testing.assert_array_equal(tsess.background.bound.extent,
                                  jsess.background.bound.extent)


def test_jax_export_imports_into_the_port(jsession, tmp_path):
    path = str(tmp_path / "jax")
    jckpt.export_reference_checkpoints(jsession, path, 9)
    tsess = _session()  # the port's own init, then overwritten
    assert ckpt.import_reference_checkpoints(tsess, path) == 9
    _assert_params_equal(tsess, jsession)
    _metadata_equal(tsess, jsession)
    _assert_forward_close(tsess, jsession)


def test_port_export_imports_into_the_jax_package(jsession, tmp_path):
    """The port's export, from weights the JAX session does not hold,
    imported by the JAX package: the JAX session's parameters then equal
    the port's bitwise."""
    tsess = _session()  # the port's own init: other weights than jsession
    tsess.step_once()
    path = str(tmp_path / "port")
    ckpt.export_reference_checkpoints(tsess, path, 4)
    scene = jmake_scene(**SCENE)
    jsess = JSession(_configure(JConfig()), scene.inst_dict,
                     scene.sample_dict, cam=scene.cam)
    assert jckpt.import_reference_checkpoints(jsess, path) == 4
    _assert_params_equal(tsess, jsess)
    _assert_forward_close(tsess, jsess)


def _vmap_multi(rng):
    hidden = 32

    def lin(key, i, o):
        return {f"{key}.weight": torch.tensor(
                    rng.normal(0, 0.3, (o, i)).astype(np.float32)),
                f"{key}.bias": torch.tensor(
                    rng.normal(0, 0.1, (o,)).astype(np.float32))}

    sd = {}
    for key, i, o in (("in_layer.0", EMB1, hidden),
                      ("mid1.0.0", hidden, hidden),
                      ("mid1.1.0", hidden, hidden),
                      ("cat_layer.0", hidden + EMB1, hidden),
                      ("mid2.0.0", hidden, hidden),
                      ("mid2.1.0", hidden, hidden),
                      ("out_alpha", hidden, 1),
                      ("color_linear.0", hidden + EMB2, hidden),
                      ("out_color", hidden, 3)):
        sd.update(lin(key, i, o))
    return sd


@pytest.mark.parametrize("blocks", ["single", "multi"])
def test_load_vmap_pth_matches_the_jax_converter(tmp_path, blocks):
    """vMAP files built as tests/test_vmap_converter.py builds them convert
    to the JAX converter's tree, bitwise; the port's OccupancyMap on it
    matches the JAX package's forward (and, single-block, the independent
    torch forward of that file) within that file's 1e-4."""
    rng = np.random.default_rng(0 if blocks == "single" else 1)
    fc_sd = _torch_fc_state(rng) if blocks == "single" else _vmap_multi(rng)
    pe_B = torch.tensor(rng.normal(0, 1, (21, 3)).astype(np.float32))
    raw = {"FC_state_dict": fc_sd, "PE_state_dict": {"B_layer.weight": pe_B},
           "obj_scale": 1.7}
    if blocks == "single":
        raw["bbox"] = rng.normal(0, 1, (2, 3)).astype(np.float32)
    path = str(tmp_path / "obj.pth")
    torch.save(raw, path)

    got, want = ckpt.load_vmap_pth(path), jckpt.load_vmap_pth(path)
    assert got.keys() == want.keys()
    assert got["obj_scale"] == want["obj_scale"]
    jax.tree_util.tree_map(
        lambda a, b: (np.testing.assert_array_equal(a, b),
                      np.testing.assert_equal(a.dtype, b.dtype)),
        {k: got[k] for k in ("fc", "pe")}, {k: want[k] for k in ("fc", "pe")})
    n_mid = 1 if blocks == "single" else 2
    assert len(got["fc"]["mid1"]) == len(got["fc"]["mid2"]) == n_mid

    x = rng.normal(0, 1.2, (256, 3)).astype(np.float32)
    fc = occupancy.OccupancyMap(convert.layers_from_jax(got["fc"]))
    pe = embedding.UniDirsEmbed(torch.tensor(got["pe"]["B"]))
    with torch.no_grad():
        alpha, color = occupancy.apply(
            fc, embedding.apply(pe, torch.tensor(x), scale=1.7))
    from catnerf_tpu.models import embedding as jemb, occupancy as jocc

    ja, jc = jocc.apply(want["fc"], jemb.apply(want["pe"], x, scale=1.7))
    _close(alpha.numpy(), np.asarray(ja), VMAP_TOL)
    _close(color.numpy(), np.asarray(jc), VMAP_TOL)
    if blocks == "single":
        np.testing.assert_array_equal(got["bbox"], want["bbox"])
        with torch.no_grad():
            ta, tc = _torch_forward(fc_sd, pe_B, torch.tensor(x), 1.7)
        _close(alpha[:, 0].numpy(), ta.numpy(), VMAP_TOL)
        _close(color.numpy(), tc.numpy(), VMAP_TOL)
