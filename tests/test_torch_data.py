"""The port's numpy copies of the scene build are byte-equal to the JAX
package's, and its device-store window draw takes the same rows as
JAX's `sample_batch(..., window=True)` for the same offsets."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from catnerf_tpu.config import Config as JConfig
from catnerf_tpu.data import device_buffer as jdb
from catnerf_tpu.data import scene as jscene
from catnerf_tpu.data.synthetic import make_scene as jmake_scene
from catnerf_torch.config import Config
from catnerf_torch.data import device_buffer as tdb
from catnerf_torch.data import scene as tscene
from catnerf_torch.data.synthetic import make_scene as tmake_scene

torch.set_num_threads(1)

SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)


def _build(make_scene, scene_mod, cfg):
    s = make_scene(**SCENE)
    cls_ids = sorted(k for k in s.inst_dict if k != 0)
    cats = [scene_mod.CategoryScene(cfg, c, s.inst_dict[c], s.sample_dict,
                                    s.cam) for c in cls_ids]
    bg = scene_mod.CategoryScene(cfg, 0, s.inst_dict[0], s.sample_dict, s.cam)
    return s, cats, bg, scene_mod.SceneBatcher(cats, bg)


@pytest.fixture(scope="module")
def scenes():
    return (_build(jmake_scene, jscene, JConfig()),
            _build(tmake_scene, tscene, Config()))


def test_synthetic_scene_is_byte_equal(scenes):
    (js, *_), (ts, *_) = scenes
    assert js.sample_dict.keys() == ts.sample_dict.keys()
    for f in js.sample_dict:
        for k in ("image", "depth", "obj_mask", "T"):
            np.testing.assert_array_equal(ts.sample_dict[f][k],
                                          js.sample_dict[f][k])
    for cid, insts in js.inst_dict.items():
        # the background (cls 0) holds its frame_info directly
        pairs = ({0: insts}.items() if cid == 0 else insts.items())
        for iid, info in pairs:
            got = ts.inst_dict[cid] if cid == 0 else ts.inst_dict[cid][iid]
            for a, b in zip(got["frame_info"], info["frame_info"]):
                np.testing.assert_array_equal(a["bbox"], b["bbox"])
            if "T_obj" in info:
                np.testing.assert_array_equal(got["T_obj"], info["T_obj"])


def test_ray_buffers_are_byte_equal(scenes):
    (_, jcats, jbg, _), (_, tcats, tbg, _) = scenes
    for jc, tc in zip(jcats + [jbg], tcats + [tbg]):
        assert jc.buffer.arrays.keys() == tc.buffer.arrays.keys()
        for k, v in jc.buffer.arrays.items():
            assert v.dtype == tc.buffer.arrays[k].dtype
            assert v.tobytes() == tc.buffer.arrays[k].tobytes(), k
        for iid, t in jc.object_tensor_dict.items():
            assert t.tobytes() == tc.object_tensor_dict[iid].tobytes()


def test_next_batch_is_byte_equal_across_reshuffles(scenes):
    (*_, jb), (*_, tb) = scenes
    n = jb.rays_per_category(120)
    for _ in range(4):  # long enough to pass a reshuffle of the tiny buffers
        (jcat, jbg), (tcat, tbg) = jb.next_batch(n, 300), tb.next_batch(n, 300)
        for a, b in ((jcat, tcat), (jbg, tbg)):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes(), k


def test_window_sample_batch_matches_jax(scenes):
    (_, jcats, jbg, _), (_, tcats, tbg, _) = scenes
    n, n_bg = 64, 96
    jstore = jdb.build_device_store(jcats, jbg, window_pad=n,
                                    bg_window_pad=n_bg)
    tstore = tdb.build_device_store(tcats, tbg, window_pad=n,
                                    bg_window_pad=n_bg, device="cpu")
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jcat, jbg_b = jdb.sample_batch(jstore, key, n, n_bg, window=True)
        # JAX's own offsets for this key (device_buffer.py:201,210,235)
        k_cat, k_bg = jax.random.split(key)
        offs = jax.random.randint(k_cat, (len(jcats),), 0, jstore.lengths)
        boff = jax.random.randint(k_bg, (), 0, jstore.bg_length)
        tcat, tbg_b = tdb.sample_batch(tstore, n, n_bg,
                                       torch.tensor(np.asarray(offs)),
                                       torch.tensor(np.asarray(boff)))
        for a, b in ((jcat, tcat), (jbg_b, tbg_b)):
            for f in a._fields:
                np.testing.assert_array_equal(getattr(b, f).numpy(),
                                              np.asarray(getattr(a, f)))


def test_window_offsets_stay_in_range(scenes):
    (_, _, _, _), (_, tcats, tbg, _) = scenes
    store = tdb.build_device_store(tcats, tbg, window_pad=8, bg_window_pad=8,
                                   device="cpu")
    gen = torch.Generator().manual_seed(0)
    for _ in range(50):
        offs, boff = tdb.draw_offsets(store, gen)
        assert bool((offs >= 0).all() and (offs < store.lengths).all())
        assert 0 <= int(boff) < store.bg_length
    with pytest.raises(ValueError, match="window_pad"):
        tdb.check_window_pad(store, 16)
