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


def _f32_window_offsets(lengths, bg_length, gen):
    """The float32 draw every store below 2^24 rows takes."""
    u = torch.rand(lengths.shape[0], generator=gen)
    offs = torch.minimum((u * lengths).long(), lengths - 1)
    ub = torch.rand((), generator=gen)
    return offs, torch.clamp((ub * bg_length).long(), max=bg_length - 1)


def _f32_draw_rows(lengths, bg_length, n_per_cls, n_bg, gen):
    u = torch.rand(lengths.shape[0], n_per_cls, generator=gen)
    idx = torch.minimum((u * lengths[:, None]).long(), lengths[:, None] - 1)
    ub = torch.rand(n_bg, generator=gen)
    return idx, torch.clamp((ub * bg_length).long(), max=bg_length - 1)


@pytest.mark.parametrize("kind", ["window", "rows"])
def test_draws_below_2_24_rows_are_the_float32_stream(kind):
    lengths = torch.tensor([3_000_000, 1 << 24, 17])
    bg_length = 1 << 24
    for seed in range(3):
        got_gen = torch.Generator().manual_seed(seed)
        ref_gen = torch.Generator().manual_seed(seed)
        for _ in range(3):
            if kind == "window":
                got = tdb.window_offsets(lengths, bg_length, got_gen,
                                         1 << 24)
                ref = _f32_window_offsets(lengths, bg_length, ref_gen)
            else:
                got = tdb.draw_rows(lengths, bg_length, 64, 32, got_gen,
                                    1 << 24)
                ref = _f32_draw_rows(lengths, bg_length, 64, 32, ref_gen)
            for a, b in zip(got, ref):
                assert torch.equal(a, b)


def _spread(draws, length):
    draws = draws.reshape(-1)
    assert bool((draws >= 0).all() and (draws < length).all())
    odd = float((draws % 2).double().mean())
    eighth = float((draws % 8 == 0).double().mean())
    return odd, eighth, int(draws.max())


@pytest.mark.parametrize("kind", ["window", "rows"])
def test_draws_past_2_24_rows_are_uniform_over_rows(kind):
    """80M rows, a room's uncapped background: a float32 uniform gives
    ~10% odd rows and ~55% multiples of 8."""
    length, n = 80_000_000, 1 << 20
    gen = torch.Generator().manual_seed(0)
    if kind == "window":
        offs, _ = tdb.window_offsets(torch.full((n,), length), None, gen,
                                     length)
        boff = torch.stack([tdb.window_offsets(torch.tensor([3]), length,
                                               gen, 3)[1]
                            for _ in range(4000)])
        cat, bg = (offs, n), (boff, 4000)
    else:
        idx, bidx = tdb.draw_rows(torch.tensor([length, length]), length,
                                  n // 2, n, gen, length)
        cat, bg = (idx, n), (bidx, n)
    for draws, count in (cat, bg):
        odd, eighth, top = _spread(draws, length)
        sigma = 0.5 / count ** 0.5
        assert abs(odd - 0.5) < 5 * sigma, odd
        assert abs(eighth - 0.125) < 5 * sigma, eighth
        assert top > length * (1 - 20 / count)


def test_the_store_knows_its_longest_buffer_on_the_host(scenes):
    (_, _, _, _), (_, tcats, tbg, _) = scenes
    store = tdb.build_device_store(tcats, tbg, window_pad=8, bg_window_pad=8,
                                   device="cpu")
    assert store.max_length == int(store.lengths.max())
