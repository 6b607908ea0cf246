"""The scene generator and the plain reference on the CPU at a tiny size,
and a whole run of a cell there against them."""

from __future__ import annotations

import math

import pytest
import torch

from bench_tiny import tiny_cell
from benchlib import reference, scene, train_cell


def test_sinpi_is_sin_of_pi_x():
    x = torch.linspace(-70.0, 70.0, 100_001).float()
    want = torch.sin(math.pi * x.double())
    got = reference.sinpi(x).double()
    assert float((got - want).abs().max()) < 1e-6


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(10_000)
    r = reference.round_tf32(x)
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11
    assert torch.equal(reference.round_tf32(r), r)
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().max()) == 0


def test_fingerprint_is_order_free():
    rows = torch.randn(1000, 12)
    a = reference.fingerprint(rows)
    b = reference.fingerprint(rows[torch.randperm(1000)])
    assert reference.fingerprint_gap(b, a) < 1e-12
    rows[3, 4] += 1e-3
    assert reference.fingerprint_gap(reference.fingerprint(rows), a) > 1e-7


def test_scene_is_the_seeds_and_sizes_do_not_move():
    cell = tiny_cell("room0_train")
    cam = train_cell.camera(cell.config_raw)
    sc = cell.config_raw["benchmark"]["scene"]
    a_inst, a_frames = scene.make_scene(sc, cam, 7, "cpu")
    b_inst, b_frames = scene.make_scene(sc, cam, 7, "cpu")
    c_inst, c_frames = scene.make_scene(sc, cam, 2**31 + 5, "cpu")
    assert (a_frames[0]["image"] == b_frames[0]["image"]).all()
    assert (a_frames[0]["image"] != c_frames[0]["image"]).any()
    assert (a_frames[1]["depth"] == c_frames[1]["depth"]).all()
    for inst in (a_inst, c_inst):
        assert sorted(inst) == [0, 80, 81]
    assert [[fi["bbox"].tolist() for fi in v["frame_info"]]
            for v in a_inst[80].values()] == \
        [[fi["bbox"].tolist() for fi in v["frame_info"]]
         for v in c_inst[80].values()]


def test_every_room0_object_is_seen():
    """All 40 objects of replica_room0 get rays (at a quarter of its
    resolution, same field of view)."""
    cell = tiny_cell("room0_train")
    raw = cell.config_raw
    raw["benchmark"]["scene"].update({"frames": 6, "categories": 20})
    raw["camera"].update({"w": 300, "h": 170, "fx": 150.0, "fy": 150.0,
                          "cx": 149.5, "cy": 84.5})
    inst, _ = scene.make_scene(raw["benchmark"]["scene"],
                               train_cell.camera(raw), 3, "cpu")
    assert len([c for c in inst if c]) == 20
    assert all(len(inst[c]) == 2 for c in inst if c)


@pytest.mark.parametrize("name", ["room0_train", "room0_train_bf16"])
def test_run_on_the_cpu_is_correct(name):
    cell = tiny_cell(name)
    r = train_cell.run(cell, 2**31 + 11, 0.2, False, torch.device("cpu"),
                       0.0)
    ok, checks = __import__("benchlib.compare").compare.judge(r["values"],
                                                              cell.limits)
    assert ok, checks
    assert r["steps"] >= 100 and r["window_s"] > 0
    assert len(r["prog_losses"]) == train_cell.CHECK_STEPS


def test_view_reference_matches_a_served_view_on_the_cpu():
    from benchlib import view_cell

    cell = tiny_cell("room0_view")
    r = view_cell.run(cell, 2**31 + 13, 0.2, False, torch.device("cpu"), 0.0)
    assert r["checked_views"] >= 1
    assert r["values"]["view_mean_lsb"] <= cell.limits["view_mean_lsb"]
    assert r["view_max_lsb"] <= 1.0


def test_png_reader_reads_every_filter():
    import numpy as np

    from benchlib import png
    from catnerf_torch.data import png as program_png

    rng = np.random.default_rng(0)
    img = (rng.random((40, 56, 3)) * 255).astype(np.uint8)
    img[5:20] = np.linspace(0, 255, 56)[None, :, None].astype(np.uint8)
    assert (png.decode(program_png.imencode(img)) == img[..., ::-1]).all()
