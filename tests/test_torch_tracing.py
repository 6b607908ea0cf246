"""The port's span-and-counter recorder (`catnerf_torch/tracing.py`) and
where the port records into it: the served scene view, the training
step's phases, the graph's capture and replays, and the phase timings of
`utils` that sit on it.

The CPU tests run everywhere. The tests marked `cuda` need the card (a
CUDA graph has no CPU mode) and skip elsewhere; this file imports neither
jax nor the JAX package, so on a machine with only PyTorch run them as

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

from __future__ import annotations

import importlib.util
import json
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from catnerf_torch import serve as tserve
from catnerf_torch import tracing
from catnerf_torch import utils as tutils
from catnerf_torch.config import Config
from catnerf_torch.data.device_buffer import FastDraws, draw_offsets
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.render_views import (SLOT_ROWS, render_scene_view,
                                        scene_far)
from catnerf_torch.train.loop import TrainingSession

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCENE = dict(n_frames=2, width=48, height=36, n_categories=2,
             insts_per_cat=2, seed=0)


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty again afterwards."""
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


@pytest.fixture
def quiet():
    """The recorder off and empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.reset()


def _spans(name=None):
    return [s for s in tracing.snapshot()["spans"]
            if name is None or s.name == name]


def _session(device="cpu", latent=16, **cfg_kw):
    """(session, scene) on the synthetic scene, at a small width."""
    scene = make_scene(**SCENE)
    cfg = Config()
    cfg.net_hyperparams.latent_dim = latent
    cfg.hidden_feature_size_bg = 32
    cfg.n_per_optim_bg = 120
    for k, v in cfg_kw.items():
        setattr(cfg, k, v)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device=device)
    return sess, scene


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_with_parents_and_one_request_id(recorder):
    with tracing.span("outer", path="/x"):
        with tracing.span("mid"):
            with tracing.span("inner"):
                pass
        with tracing.span("sibling"):
            pass
    with tracing.span("next"):
        pass
    by = {s.name: s for s in _spans()}
    assert [s.name for s in _spans()] == ["inner", "mid", "sibling",
                                          "outer", "next"]
    outer = by["outer"]
    assert outer.parent is None and outer.request == outer.id
    assert outer.attrs == {"path": "/x"}
    assert by["mid"].parent == outer.id
    assert by["sibling"].parent == outer.id
    assert by["inner"].parent == by["mid"].id
    assert {by[k].request for k in ("mid", "inner", "sibling")} == {
        outer.id}
    assert by["next"].parent is None and by["next"].request != outer.id
    for s in _spans():
        assert s.end_ns >= s.start_ns and s.thread == threading.get_ident()
    assert by["inner"].start_ns >= by["mid"].start_ns
    assert by["inner"].end_ns <= by["mid"].end_ns <= outer.end_ns


def test_two_threads_keep_their_own_trees(recorder):
    barrier = threading.Barrier(2)
    idents = {}

    def work(tag: str):
        idents[tag] = threading.get_ident()
        with tracing.span(f"{tag}.root"):
            barrier.wait(timeout=30)  # both roots open at once
            for _ in range(50):
                with tracing.span(f"{tag}.child"):
                    tracing.count("both")
            barrier.wait(timeout=30)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for tag in "ab":
        (root,) = _spans(f"{tag}.root")
        children = _spans(f"{tag}.child")
        assert len(children) == 50
        assert root.thread == idents[tag] and root.parent is None
        assert all(c.parent == root.id and c.request == root.id
                   and c.thread == idents[tag] for c in children)
    assert _spans("a.root")[0].request != _spans("b.root")[0].request
    assert tracing.snapshot()["counters"]["both"] == 100


def test_off_records_nothing(quiet):
    assert not tracing.on()
    with tracing.span("x", k=1) as s:
        tracing.count("c")
        tracing.count("c", 5)
    assert s is None
    snap = tracing.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}
    # set-up is recorded whatever the recorder says
    with tracing.span("setup", always=True):
        pass
    tracing.gauge("g", 3)
    snap = tracing.snapshot()
    assert [s.name for s in snap["spans"]] == ["setup"]
    assert snap["counters"] == {"g": 3}


def test_on_under_a_profiler_from_a_worker_thread(quiet):
    """The profiler's flag is the module's: a thread the profiler does not
    profile sees it too, and records."""
    from torch.profiler import ProfilerActivity, profile

    seen = {}

    def work():
        seen["on"] = tracing.on()
        with tracing.span("worker.span"):
            tracing.count("worker.count", 2)

    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen["on"]
    assert not tracing.on()
    assert [s.name for s in _spans()] == ["worker.span"]
    assert tracing.snapshot()["counters"] == {"worker.count": 2}
    work()  # after the profiler: off again
    assert len(_spans()) == 1


def test_a_worker_threads_span_is_in_the_device_trace_export(quiet,
                                                            tmp_path):
    def work():
        with tracing.span("worker.export"):
            torch.ones(64).add_(1.0)

    with tutils.device_trace(str(tmp_path), "cpu"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    mine = [e for e in events if e.get("name") == "worker.export"]
    assert mine and all(e["tid"] != threading.get_ident() for e in mine)
    assert any(e.get("name", "").startswith("aten::add")
               and e.get("tid") == mine[0]["tid"] for e in events)


def test_phase_timings_keep_groups_keys_and_a_monotonic_clock(quiet,
                                                             monkeypatch):
    """A wall clock stepped back by an hour inside the phase changes
    nothing: the seconds come from the monotonic clock."""
    tutils.reset_phase_timings()
    wall = iter([1e9, 1e9 - 3600.0] * 4)
    monkeypatch.setattr(time, "time", lambda: next(wall))
    t0 = time.perf_counter()
    with tutils.phase_timer("a_group", "x"):
        time.sleep(0.01)
    took = time.perf_counter() - t0
    tutils.phase_add("a_group", "y", 2.0)
    got = tutils.phase_timings("a_group")
    assert list(got) == ["x", "y"] and got["y"] == 2.0
    assert 0.01 <= got["x"] <= took
    with tutils.phase_timer("a_group", "x"):
        pass
    assert tutils.phase_timings("a_group")["x"] >= got["x"]
    # the phase is a span too, recorded with the recorder off
    assert [s.name for s in _spans()] == ["a_group.x", "a_group.x"]
    tutils.phase_reset("a_group")
    assert tutils.phase_timings("a_group") == {}


def test_a_session_build_keeps_its_phase_groups_and_keys(quiet):
    tutils.reset_phase_timings()
    sess, _ = _session()
    assert set(tutils.phase_timings("session")) == {
        "buffers", "ray_build", "buffer_shuffle", "state_init"}
    sess.enable_fast_path(2, graph=False)
    assert list(tutils.phase_timings("fast_path")) == ["store_build",
                                                      "store_pack"]
    assert all(v > 0 for v in tutils.phase_timings("session").values())


def test_settle_reads_device_counts_after_the_sync(recorder):
    tracing.count_device("n", torch.tensor(3))
    tracing.count_device("n", torch.tensor(4))
    tracing.count_device("m", torch.tensor(1.5))
    assert "n" not in tracing.snapshot()["counters"]
    with tracing.settle():
        pass
    assert tracing.snapshot()["counters"] == {"n": 7, "m": 1.5}
    with tracing.settle():  # read once
        pass
    assert tracing.snapshot()["counters"] == {"n": 7, "m": 1.5}


# ---------------------------------------------------------------------------
# where the port records
# ---------------------------------------------------------------------------

def _tree_of_a_view(spans, root_id):
    """{name: [span]} of the spans of root's request."""
    out: dict[str, list] = {}
    for s in spans:
        if s.request == root_id:
            out.setdefault(s.name, []).append(s)
    return out


def test_a_scene_view_records_its_span_tree(recorder):
    sess, scene = _session()
    n_bins, chunk = 16, 2048
    cam = scene.cam
    frame = sorted(scene.sample_dict)[0]
    T = np.asarray(scene.sample_dict[frame]["T"], np.float32)
    with tracing.span("view"):
        render_scene_view(sess, T, cam, near=0.05, far=scene_far(sess),
                          n_bins=n_bins, chunk=chunk)
    rays = chunk // n_bins
    n_tiles = -(-cam.width * cam.height // rays)
    (root,) = _spans("view")
    tree = _tree_of_a_view(_spans(), root.id)
    c = tracing.snapshot()["counters"]
    assert len(tree["render.stage"]) == 1
    tiles = tree["render.tile"]
    assert len(tiles) == n_tiles == c["render.tiles"]
    assert all(t.parent == root.id for t in tiles)
    tile_ids = {t.id for t in tiles}
    objects = tree["render.objects"]
    background = tree["render.background"]
    assert len(objects) == len(background) == n_tiles
    assert {s.parent for s in objects + background} == tile_ids
    syncs = tree["render.sync"]
    assert len(syncs) == n_tiles + 1 == c["render.syncs"]
    assert {s.parent for s in syncs} == {o.id for o in objects} | {root.id}
    assert c["render.points"] == cam.width * cam.height * n_bins
    n_obj = sum(len(v) for k, v in scene.inst_dict.items() if k != 0)
    # the ensemble runs object-major slots of SLOT_ROWS rows: the hits and
    # at most SLOT_ROWS - 1 pad rows an object a tile
    hits, evals = c["render.object_hits"], c["render.object_evals"]
    assert 0 < hits <= evals
    assert evals == c["render.object_slots"] * SLOT_ROWS
    assert evals <= hits + n_obj * SLOT_ROWS * n_tiles
    # no CUDA device here: no device times
    assert "render.objects.device_ns" not in c


def test_a_scene_view_untraced_records_nothing(quiet):
    sess, scene = _session()
    frame = sorted(scene.sample_dict)[0]
    T = np.asarray(scene.sample_dict[frame]["T"], np.float32)
    render_scene_view(sess, T, scene.cam, near=0.05, far=scene_far(sess),
                      n_bins=8, chunk=4096)
    names = {s.name for s in _spans()}
    assert not any(n.startswith(("render.", "serve.")) for n in names)
    assert not any(k.startswith("render.")
                   for k in tracing.snapshot()["counters"])


@pytest.mark.parametrize("source", ["injected", "generator"])
def test_an_eager_step_records_the_four_phases_in_order(recorder, source):
    sess, _ = _session()
    sess.enable_fast_path(2, graph=False)
    draws = None
    if source == "injected":
        gen = torch.Generator().manual_seed(5)
        draws = [FastDraws(*draw_offsets(sess._store, gen),
                           sess._draws(gen))]
    tracing.reset()
    sess.run_fast(1, draws=draws)
    (root,) = _spans("train.run_fast")
    assert root.attrs == {"steps": 1}
    phases = [s for s in _spans() if s.name in tracing.STEP_PHASES]
    assert all(s.parent == root.id and s.request == root.id for s in phases)
    order = [s.name for s in sorted(phases, key=lambda s: s.start_ns)]
    # the generator's uniforms are a second stretch of the batch phase
    want = list(tracing.STEP_PHASES)
    if source == "generator":
        want.insert(1, "step.batch")
    assert order == want
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns or b.end_ns <= a.start_ns
    assert "graph.replays" not in tracing.snapshot()["counters"]


def test_a_scene_request_records_its_spans_under_serve_request(
        recorder, monkeypatch):
    sess, scene = _session()
    monkeypatch.setattr(tserve, "_SIZES", ((48, 36),) + tserve._SIZES)
    server = tserve.SceneServer(sess)
    httpd = tserve.serve(sess, port=0, scene_server=server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        frame = sorted(scene.sample_dict)[0]
        url = (f"http://127.0.0.1:{httpd.server_address[1]}/scene?"
               f"frame={frame}&w=48&h=36&bins=16")
        with urllib.request.urlopen(url, timeout=300) as resp:
            assert resp.status == 200 and resp.read()[:4] == b"\x89PNG"
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    (req,) = _spans("serve.request")
    assert req.attrs == {"path": "/scene"} and req.parent is None
    assert req.thread != threading.get_ident()
    tree = _tree_of_a_view(_spans(), req.id)
    for name in ("serve.lock_wait", "render.stage", "serve.png",
                 "serve.write"):
        (s,) = tree[name]
        assert s.parent == req.id, name
    assert tree["render.tile"] and all(t.parent == req.id
                                       for t in tree["render.tile"])
    copy_out = [s for s in tree["render.sync"] if s.parent == req.id]
    assert len(copy_out) == 1
    order = [tree[n][0].start_ns for n in
             ("serve.lock_wait", "render.stage", "render.tile",
              "serve.png", "serve.write")]
    assert order == sorted(order)
    # every span of the request's thread belongs to it
    assert all(s.request == req.id for s in _spans()
               if s.thread == req.thread)


# ---------------------------------------------------------------------------
# the phase map read through a window's device operations
# ---------------------------------------------------------------------------

def test_a_phase_owns_the_nodes_captured_since_the_mark_before():
    from catnerf_torch.train.graph import phase_map

    def k(kernel, memcpy=0, memset=0, other=0):
        return {"kernel": kernel, "memcpy": memcpy, "memset": memset,
                "other": other}

    marks = [("step.batch", k(2)), ("step.batch", k(3, 1)),
             ("step.forward", k(10, 1, 0, 2)),
             ("step.backward", k(20, 1, 2, 2)),
             ("step.optimizer", k(24, 1, 2, 3))]
    got = phase_map(marks, k(25, 2, 2, 4), copies=4)
    assert got == {"nodes": 33, "device_nodes": 29, "copies": 4, "phases": {
        "step.batch": {"kernel": 3, "memcpy": 1, "memset": 0},
        "step.forward": {"kernel": 7, "memcpy": 0, "memset": 0},
        "step.backward": {"kernel": 10, "memcpy": 0, "memset": 2},
        "step.optimizer": {"kernel": 5, "memcpy": 1, "memset": 0}}}


GRAPH = {"nodes": 9, "device_nodes": 8, "copies": 2, "phases": {
    "step.batch": {"kernel": 1, "memcpy": 0, "memset": 0},
    "step.forward": {"kernel": 2, "memcpy": 1, "memset": 0},
    "step.backward": {"kernel": 2, "memcpy": 0, "memset": 1},
    "step.optimizer": {"kernel": 1, "memcpy": 0, "memset": 0}}}
STEP = (["Memcpy DtoD in0", "Memcpy DtoD in1", "fill"]   # copies, prologue
        + ["gather"] + ["fwd_a", "Memcpy DtoD x", "fwd_b"]
        + ["bwd_a", "Memset (Device)", "bwd_b"] + ["adam"])
US = {"gather": 2.0, "fwd_a": 10.0, "fwd_b": 5.0, "Memcpy DtoD x": 1.0,
      "bwd_a": 20.0, "bwd_b": 7.0, "Memset (Device)": 0.5, "adam": 3.0}


def _window(steps, before=("rand", "rand"), after=("Memcpy DtoD out",)):
    names = list(before) + STEP * steps + list(after)
    return [(n, US.get(n, 0.25)) for n in names]


def test_the_phase_map_divides_a_window_of_replays():
    got = tracing.phase_device_ms(_window(5), 5, [GRAPH])
    assert got == pytest.approx({"step.batch": (0.75 + 2.0) / 1e3,
                                 "step.forward": 16.0 / 1e3,
                                 "step.backward": 27.5 / 1e3,
                                 "step.optimizer": 3.0 / 1e3})


@pytest.mark.parametrize("fault", ["missing_op", "moved_memset", "one_step",
                                   "other_graph"])
def test_a_window_the_phase_map_does_not_divide_reads_none(fault):
    ops, steps, graphs = _window(4), 4, [GRAPH]
    if fault == "missing_op":
        del ops[2 + len(STEP) * 2 + 5]
    elif fault == "moved_memset":
        g = json.loads(json.dumps(GRAPH))
        g["phases"]["step.backward"]["memset"] = 0
        g["phases"]["step.optimizer"]["memset"] = 1
        graphs = [g]
    elif fault == "one_step":
        ops, steps = _window(1), 1
    else:
        g = json.loads(json.dumps(GRAPH))
        g["device_nodes"] = 20
        graphs = [g]
    assert tracing.phase_device_ms(ops, steps, graphs) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graphed(fused: bool):
    sess, _ = _session("cuda", latent=32, use_fused_kernels=fused,
                       bf16_activations=False)
    sess.enable_fast_path(4, graph=True)
    sess.run_fast(4)  # three eager warm-up steps, the capture, a replay
    torch.cuda.synchronize()
    return sess, sess._superstep.captured["generator"]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla_path"])
def test_the_phase_map_adds_up_to_the_graphs_device_nodes(cuda_device,
                                                          quiet, fused):
    sess, step = _graphed(fused)
    kinds = step.node_kinds()
    pm = step.phase_map
    assert sum(kinds.values()) == step.node_count() == pm["nodes"]
    for k in ("kernel", "memcpy", "memset"):
        assert sum(p[k] for p in pm["phases"].values()) == kinds[k]
    assert pm["device_nodes"] == kinds["kernel"] + kinds["memcpy"] + \
        kinds["memset"]
    assert all(sum(p.values()) > 0 for p in pm["phases"].values())
    snap = tracing.snapshot()
    assert snap["counters"] == {"graph.nodes": step.node_count()}
    assert snap["graphs"][-1] == pm
    assert [s.name for s in snap["spans"]
            if s.name == "graph.capture"] == ["graph.capture"]


def _metric(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "xla_path"])
def test_the_phase_readers_read_three_replays_under_the_profiler(
        cuda_device, quiet, fused):
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from benchlib import trace
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    sess, step = _graphed(fused)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            sess.run_fast(3)
            torch.cuda.synchronize()
    readings = {"trace": trace.reduce_profile(prof, 3)}
    got = {p: _metric(f"{p.replace('.', '_')}_ms")(readings)
           for p in tracing.STEP_PHASES}
    assert all(v is not None and v > 0 for v in got.values()), got
    busy = readings["trace"].busy_us / 3 / 1e3
    assert sum(got.values()) == pytest.approx(busy, rel=0.05)
    c = tracing.snapshot()["counters"]
    assert c["graph.replays"] == 3 and c["graph.launch_ns"] > 0
    assert _metric("graph_nodes")(readings) == step.node_count()
    assert _metric("graph_launch_us")(readings) > 0
