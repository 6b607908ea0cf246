"""The port's latent-code editing (`catnerf_torch/edit.py`) against the JAX
package's, on the CPU: the codes equal, the render-equality invariant (the
field depends on an instance only through its codes), the renders and
meshes written, and the CLI end to end with --device cpu. The sessions are
test_torch_render_views.py's pair: the same scene and weights in both
packages."""

from __future__ import annotations

import os

import cv2
import numpy as np
import pytest
import torch

from catnerf_torch import edit
from catnerf_torch.data import png
from catnerf_torch.data.camera import CameraInfo
from catnerf_torch.mesher.mesh import load_mesh
from catnerf_torch.render_views import look_at, render_view
from catnerf_tpu import edit as jedit
from test_torch_render_views import _pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return _pair(seed=4)


def _ids(sess):
    cat = sess.categories[0]
    return sess.cls_ids[0], cat.obj_ids[0], cat.obj_ids[1]


CODE_CASES = {
    "instance": lambda m, s, c, a, b: m.instance_codes(s, c, b),
    "shape_from": lambda m, s, c, a, b: m.edit_codes(s, c, a, shape_from=b),
    "texture_from": lambda m, s, c, a, b: m.edit_codes(s, c, a,
                                                       texture_from=b),
    "both_from": lambda m, s, c, a, b: m.edit_codes(s, c, a, shape_from=b,
                                                    texture_from=b),
    "interp_shape": lambda m, s, c, a, b: m.interpolate_codes(
        s, c, a, b, 0.3, what="shape"),
    "interp_texture": lambda m, s, c, a, b: m.interpolate_codes(
        s, c, a, b, 0.7, what="texture"),
    "interp_both": lambda m, s, c, a, b: m.interpolate_codes(s, c, a, b,
                                                             0.5),
    "mean": lambda m, s, c, a, b: m.mean_codes(s, c),
    "zero": lambda m, s, c, a, b: m.mean_codes(s, c, zero=True),
}


@pytest.mark.parametrize("case", list(CODE_CASES))
def test_codes_equal_the_jax_packages(pair, case):
    tsess, jsess = pair
    got = CODE_CASES[case](edit, tsess, *_ids(tsess))
    want = CODE_CASES[case](jedit, jsess, *_ids(jsess))
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == (16,)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-7)
    if case == "zero":
        assert not got[0].any() and not got[1].any()


def test_bad_edits_raise_as_the_jax_packages(pair):
    tsess, _ = pair
    cls_id, a, b = _ids(tsess)
    with pytest.raises(ValueError, match="shape|texture|both"):
        edit.interpolate_codes(tsess, cls_id, a, b, 0.5, what="color")
    with pytest.raises(KeyError, match="category 9999"):
        edit.instance_codes(tsess, 9999, a)
    with pytest.raises(KeyError, match="object 9999"):
        edit.instance_codes(tsess, cls_id, 9999)


def test_a_full_swap_renders_the_donor(pair):
    """Swapping BOTH codes of A to B's renders B bitwise; a texture-only
    swap keeps A's depth and changes its colour."""
    tsess, _ = pair
    cls_id, a, b = _ids(tsess)
    params = tsess.category_params(cls_id)
    cam = CameraInfo(32, 24, 28.0, 28.0, 16.0, 12.0)
    T = look_at((1.2, 0.4, 0.8))

    def render(codes):
        return render_view(params, tsess.cfg, T, cam, near=0.3, far=3.0,
                           shape_code=codes[0], texture_code=codes[1],
                           n_bins=8, chunk=2048)

    img1, d1, _ = render(edit.edit_codes(tsess, cls_id, a, shape_from=b,
                                         texture_from=b))
    img2, d2, _ = render(edit.instance_codes(tsess, cls_id, b))
    np.testing.assert_array_equal(img1, img2)
    np.testing.assert_array_equal(d1, d2)
    img3, d3, _ = render(edit.edit_codes(tsess, cls_id, a, texture_from=b))
    img_a, d_a, _ = render(edit.instance_codes(tsess, cls_id, a))
    np.testing.assert_array_equal(d3, d_a)
    assert not np.array_equal(img3, img_a)


def test_render_edit_writes_the_jax_packages_files(pair, tmp_path):
    """An interpolation's orbit renders: the same names as the JAX
    package's, each PNG within 1 LSB of its file."""
    tsess, jsess = pair
    kw = dict(donors=None, n_views=2, width=32, height=24, n_bins=8)
    out = {}
    for name, mod, sess in (("port", edit, tsess), ("jax", jedit, jsess)):
        cls_id, a, b = _ids(sess)
        sc, tc = mod.interpolate_codes(sess, cls_id, a, b, 0.5)
        out[name] = mod.render_edit(sess, cls_id, a, sc, tc,
                                    str(tmp_path / name), "interp",
                                    **{**kw, "donors": [b]})
    assert out["port"] == out["jax"] and len(out["port"]) == 2
    for name in out["port"]:
        for suffix in ("_rgb.png", "_depth.png", "_alpha.png"):
            mine = png.imread_unchanged(
                str(tmp_path / "port" / (name + suffix)))
            theirs = cv2.imread(str(tmp_path / "jax" / (name + suffix)),
                                cv2.IMREAD_UNCHANGED)
            assert mine.shape == theirs.shape
            assert np.abs(mine.astype(np.int64) - theirs).max() <= 1


def test_mesh_edit_writes_the_edited_mesh(tmp_path):
    """The mean code's mesh at grid 32, from heads whose occupancy crosses
    0.5: both packages write one; it loads and its vertex count is within
    0.5% of the JAX package's."""
    tsess, jsess = _pair(seed=4, bias=0.0)
    paths = []
    for name, mod, sess in (("port", edit, tsess), ("jax", jedit, jsess)):
        cls_id, a, b = _ids(sess)
        sc, tc = mod.mean_codes(sess, cls_id)
        paths.append(mod.mesh_edit(sess, cls_id, a, sc, tc,
                                   str(tmp_path / name / "mean.obj"),
                                   donors=[b], grid_dim=32))
    assert paths[0] is not None and paths[1] is not None
    mine, theirs = load_mesh(paths[0]), load_mesh(paths[1])
    assert len(mine.vertices) > 0
    assert abs(len(mine.vertices) - len(theirs.vertices)) <= \
        0.005 * len(theirs.vertices)


@pytest.fixture(scope="module")
def logdir(tmp_path_factory):
    """A checkpoint of the --synthetic scene's session (CPU)."""
    from catnerf_torch.loaders import load_scene
    from catnerf_torch.train.checkpoint import save_session_checkpoint
    from catnerf_torch.train.loop import TrainingSession

    root = tmp_path_factory.mktemp("edit_logs")
    cfg, inst_dict, sample_dict, cam = load_scene(None, synthetic=True)
    sess = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                           device="cpu")
    save_session_checkpoint(str(root / "ckpt"), sess, 3)
    return root


@pytest.mark.parametrize("flags,tags", [
    (["--obj", "1", "--texture-from", "2"], ["original", "tex2"]),
    (["--mean", "--mesh"], ["cls80_mean"]),
], ids=["texture-from", "mean-mesh"])
def test_edit_cli_end_to_end(logdir, tmp_path, capsys, monkeypatch, flags,
                             tags):
    """The CLI on the --synthetic scene's checkpoint; --mesh at grid 32
    (its adaptive grid at 5 mm voxels takes minutes on one CPU core)."""
    from catnerf_torch.mesher import meshing

    monkeypatch.setattr(meshing, "adaptive_grid_dim", lambda *a: 32)
    out = tmp_path / "edits"
    assert edit.main(["--logdir", str(logdir), "--synthetic", "--device",
                      "cpu", "--cls", "80", "--views", "2", "--width", "32",
                      "--height", "24", "--n-bins", "8", "--out", str(out),
                      *flags]) == 0
    printed = capsys.readouterr().out
    files = os.listdir(out)
    for tag in tags:
        assert sum(tag in f for f in files if f.endswith(".png")) == 2 * 3
    if "--mesh" in flags:
        assert "mesh: " in printed
        assert ("cls80_mean.obj" in files) == ("no iso-surface"
                                               not in printed)


def test_edit_cli_refuses_conflicting_flags(logdir):
    base = ["--logdir", str(logdir), "--synthetic", "--device", "cpu",
            "--cls", "80"]
    for extra, msg in ((["--obj", "1", "--interp", "2", "--shape-from",
                         "2"], "mutually exclusive"),
                       (["--mean", "--interp", "2"], "no other edit"),
                       (["--texture-from", "2"], "--obj is required"),
                       (["--obj", "1"], "nothing to edit")):
        with pytest.raises(SystemExit, match=msg):
            edit.main(base + extra)
