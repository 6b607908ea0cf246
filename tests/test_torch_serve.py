"""The port's HTTP server (`catnerf_torch/serve.py`) against the JAX
package's, on the CPU: a real ThreadingHTTPServer of each package on a free
port, serving the same scene and weights (test_torch_render_views.py's
pair). The /object, /scene and /edit PNGs decode to pixels within 1 LSB of
the JAX server's for the same query; /ingest fits, adopts and serves a new
instance."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import cv2
import numpy as np
import pytest
import torch

from catnerf_torch import serve as tserve
from catnerf_torch.data import png
from catnerf_tpu import serve as jserve
from test_torch_render_views import _pair

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _start(module, sess):
    return _start_with(module.SceneServer(sess), sess, module)


def _start_with(server, sess, module=tserve):
    httpd = module.serve(sess, port=0, scene_server=server)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return server, httpd, thread, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, thread):
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


#: the tests' image size, added to both packages' whitelists while the
#: servers run (the whitelist's smallest, 160 x 120, is what the snapping
#: query below renders at)
SMALL = (48, 36)


@pytest.fixture(scope="module")
def servers():
    """{"port": (SceneServer, base URL), "jax": (...)} of one pair."""
    tsess, jsess = _pair()
    with pytest.MonkeyPatch.context() as mp:
        for module in (tserve, jserve):
            mp.setattr(module, "_SIZES", (SMALL,) + module._SIZES)
        started = {"port": _start(tserve, tsess),
                   "jax": _start(jserve, jsess)}
        yield {k: (v[0], v[3]) for k, v in started.items()}
        for _, httpd, thread, _ in started.values():
            _stop(httpd, thread)


def _get(url: str, timeout: float = 300):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _error(url: str, data: bytes | None = None):
    try:
        urllib.request.urlopen(urllib.request.Request(url, data=data),
                               timeout=60)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())
    raise AssertionError(f"{url} did not fail")


def test_health_and_the_viewer(servers):
    server, base = servers["port"]
    status, ctype, body = _get(f"{base}/health")
    health = json.loads(body)
    assert status == 200 and ctype == "application/json"
    assert health == {"ok": True, "objects": server.object_ids()}
    assert len(health["objects"]) == 4
    assert health == json.loads(_get(f"{servers['jax'][1]}/health")[2])
    for path in ("/", "/viewer", "/?w=abc", "/health?w=abc&bins=zzz"):
        status, ctype, page = _get(base + path)
        assert status == 200
    for path in ("/", "/viewer"):
        page = _get(base + path)[2].decode()
        assert "catnerf_torch viewer" in page
        for ep in ("/health", "/object", "/scene"):
            assert ep in page


def _queries(ids):
    a, b = ids[0], ids[1]
    small = "w=48&h=36&bins=16"
    return {
        # w/h/bins snap: 150 x 110 x 9 renders at 160 x 120 x 16
        "object_snapped": f"/object?id={b}&az=30&el=20&w=150&h=110&bins=9",
        "object": f"/object?id={a}&az=200&el=40&{small}",
        "scene_frame": f"/scene?frame=0&{small}",
        "scene_orbit": f"/scene?az=45&el=30&radius=4&{small}",
        "edit_texture": f"/edit?id={a}&texture_from={b}&{small}",
        "edit_shape": f"/edit?id={a}&shape_from={b}&az=90&{small}",
        "edit_interp": f"/edit?id={a}&interp={b}&t=0.3&{small}",
        "edit_mean": f"/edit?id={a}&mean=1&el=-10&{small}",
    }


@pytest.mark.parametrize("query", list(_queries([1, 2])))
def test_pngs_equal_the_jax_servers(servers, query):
    """The same query to both servers: a PNG of the snapped size from
    each, within 1 LSB pixel by pixel (decoded by the port's reader and by
    cv2, which agree)."""
    ids = servers["port"][0].object_ids()
    path = _queries(ids)[query]
    status, ctype, mine = _get(servers["port"][1] + path)
    assert status == 200 and ctype == "image/png"
    theirs = _get(servers["jax"][1] + path)[2]
    img = png.imdecode(mine)
    np.testing.assert_array_equal(
        img, cv2.imdecode(np.frombuffer(mine, np.uint8), cv2.IMREAD_UNCHANGED))
    want = cv2.imdecode(np.frombuffer(theirs, np.uint8), cv2.IMREAD_UNCHANGED)
    shape = (120, 160, 3) if query == "object_snapped" else (36, 48, 3)
    assert img.shape == want.shape == shape
    assert np.abs(img.astype(np.int64) - want).max() <= 1
    assert img.std() > 0  # not a blank image


@pytest.mark.parametrize("value,allowed", [
    ((100, 80), "_SIZES"), ((320, 240), "_SIZES"), ((2000, 2000), "_SIZES"),
    ((700, 10), "_SIZES"), (9, "_BINS"), (64, "_BINS"), (10000, "_BINS"),
    (112, "_BINS")])
def test_size_snapping_is_the_jax_servers(value, allowed):
    assert getattr(tserve, allowed) == getattr(jserve, allowed)
    assert tserve._snap(value, getattr(tserve, allowed)) == \
        jserve._snap(value, getattr(jserve, allowed))


def test_health_never_blocks_behind_the_device_lock(servers):
    """/health answers while the device lock is held (a long render in
    flight); /object queues behind the lock, then completes; concurrent
    renders all succeed, serialized."""
    server, base = servers["port"]
    obj = server.object_ids()[0]
    url = f"{base}/object?id={obj}&az=10&el=20&w=48&h=36&bins=16"
    with server.lock:
        t0 = time.time()
        assert json.loads(_get(f"{base}/health", timeout=10)[2])["ok"]
        assert time.time() - t0 < 10.0
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(lambda: _get(url)[2])
            time.sleep(0.3)
            assert not fut.done()  # blocked on the held lock
            server.lock.release()
            try:
                png_bytes = fut.result(timeout=300)
            finally:
                server.lock.acquire()
    assert png_bytes[:8] == png.SIGNATURE
    urls = [f"{base}/object?id={obj}&az={a}&el=20&w=48&h=36&bins=16"
            for a in (0, 40, 80)]
    with ThreadPoolExecutor(3) as pool:
        outs = list(pool.map(lambda u: _get(u)[2], urls))
    assert all(png.imdecode(o).shape == (36, 48, 3) for o in outs)


def test_mesh_is_an_obj_and_cached_per_state_version(monkeypatch):
    """/mesh of an object whose occupancy crosses 0.5, at grid 32 (the
    adaptive grid at 5 mm voxels takes seconds a mesh on one core): an
    .obj, then the cache's bytes; an unknown id is a 400."""
    from catnerf_torch.mesher import meshing

    monkeypatch.setattr(meshing, "adaptive_grid_dim", lambda *a: 32)
    tsess, _ = _pair(bias=0.0)
    server, httpd, thread, base = _start(tserve, tsess)
    try:
        _check_mesh(server, base)
    finally:
        _stop(httpd, thread)


def _check_mesh(server, base):
    obj = server.object_ids()[0]
    t0 = time.time()
    status, ctype, data = _get(f"{base}/mesh?id={obj}")
    first = time.time() - t0
    assert status == 200 and ctype == "model/obj"
    lines = data.decode().splitlines()
    assert sum(line.startswith("v ") for line in lines) > 0
    assert sum(line.startswith("f ") for line in lines) > 0
    key = (obj, (int(server.session.state.step), 0))
    assert server._mesh_cache[key] is not None
    t0 = time.time()
    assert _get(f"{base}/mesh?id={obj}")[2] == data  # the cache's bytes
    assert time.time() - t0 < first
    code, body = _error(f"{base}/mesh?id=999")
    assert code == 400 and "unknown object id 999" in body["error"]


def _ingest_session():
    """tests/test_serve.py's ingest scene on the port's CPU session: 3
    frames of 64 x 48 (at 48 x 36 the held-out sphere's box sits at the
    loaders' 10-px floor in 2 of 3 frames), one category of three spheres,
    the last held out; 3 steps; and the held-out sphere's observations as
    an .npz body."""
    import copy
    import io

    from catnerf_torch.config import Config
    from catnerf_torch.data.synthetic import make_scene
    from catnerf_torch.train.loop import TrainingSession

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 16
    cfg.hidden_feature_size_bg = 32
    scene = make_scene(n_frames=3, width=64, height=48, n_categories=1,
                       insts_per_cat=3, seed=11)
    cls_id = [c for c in scene.inst_dict if c != 0][0]
    held = sorted(scene.inst_dict[cls_id])[-1]
    train = copy.deepcopy(scene.inst_dict)
    del train[cls_id][held]
    sess = TrainingSession(cfg, train, scene.sample_dict, cam=scene.cam,
                           device="cpu")
    for _ in range(3):
        sess.step_once()
    frames = sorted(scene.sample_dict)
    buf = io.BytesIO()
    np.savez(buf,
             rgb=np.stack([scene.sample_dict[f]["image"] for f in frames]),
             depth=np.stack([scene.sample_dict[f]["depth"] for f in frames]),
             mask=np.stack([scene.sample_dict[f]["obj_mask"] == held
                            for f in frames]).astype(np.int8),
             T_wc=np.stack([scene.sample_dict[f]["T"] for f in frames]))
    return sess, scene, train, cls_id, buf.getvalue()


def _post(url: str, body: bytes, timeout: float = 600):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_ingest_answers_501_and_other_posts_404(tmp_path):
    """POST /ingest (the name is from when the port answered 501): raw
    posed RGB-D observations of an unseen instance -> register -> fit ->
    adopt, served at once on the same socket (tests/test_serve.py's
    ingest test): 200 with the summary, /health lists the new id, /object
    renders it; the adoption saved as a new checkpoint iteration with its
    sidecar, which a fresh session restores; save=0 saves none; a
    non-npz body, an npz without the arrays, an unknown category and an
    empty body answer 400; other POSTs 404."""
    import io

    from catnerf_torch.train import checkpoint as ckpt
    from catnerf_torch.train.loop import TrainingSession

    sess, scene, train, cls_id, body = _ingest_session()
    ckpt_dir = str(tmp_path / "ckpt")
    ckpt.save_session_checkpoint(ckpt_dir, sess, 3)
    server = tserve.SceneServer(sess, ckpt_dir=ckpt_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tserve, "_SIZES", (SMALL,) + tserve._SIZES)
        _, httpd, thread, base = _start_with(server, sess)
        try:
            status, out = _post(f"{base}/ingest?cls={cls_id}&steps=20"
                                f"&rays=64", body)
            assert status == 200 and out["adopted"] and out["cls"] == cls_id
            assert out["frames_used"] == 3 and out["fit_steps"] == 20
            new_id = out["id"]
            assert new_id == 3  # fresh id from the flat namespace
            assert out["checkpoint"] == os.path.join(ckpt_dir, "4")
            assert set(out) == {"id", "cls", "frames_used",
                                "registration_chamfer", "fit_steps",
                                "psnr_prior_init", "psnr_after_fit",
                                "extent", "T_obj", "adopted", "checkpoint"}
            assert new_id in json.loads(_get(f"{base}/health")[2])["objects"]
            status, ctype, img = _get(f"{base}/object?id={new_id}&az=30"
                                      f"&el=20&w=48&h=36&bins=16")
            assert status == 200 and ctype == "image/png"
            assert png.imdecode(img).shape == (36, 48, 3)

            status, out2 = _post(f"{base}/ingest?cls={cls_id}&steps=2"
                                 f"&rays=32&accumulate=tsdf&save=0", body)
            assert status == 200 and out2["id"] == 4
            assert "checkpoint" not in out2
            assert sorted(os.listdir(ckpt_dir)) == ["3", "4",
                                                    "4.adopted.json"]

            bad = io.BytesIO()
            np.savez(bad, rgb=np.zeros(3))
            for url, data, what in (
                    (f"{base}/ingest?cls={cls_id}", b"not an npz", "npz"),
                    (f"{base}/ingest?cls={cls_id}", bad.getvalue(),
                     "missing arrays"),
                    (f"{base}/ingest?cls=424242", body, "unknown category"),
                    (f"{base}/ingest?cls={cls_id}", b"", "needs an .npz")):
                code, err = _error(url, data=data)
                assert code == 400 and what in err["error"], (code, err)
            code, _ = _error(f"{base}/nope", data=b"abc")
            assert code == 404
            # the handler threads survived: the server still answers
            assert json.loads(_get(f"{base}/health")[2])["ok"]
        finally:
            _stop(httpd, thread)

    fresh = TrainingSession(sess.cfg, train, scene.sample_dict,
                            cam=scene.cam, device="cpu")
    ckpt.restore_session_checkpoint(ckpt.latest_checkpoint(ckpt_dir), fresh)
    assert fresh.categories[0].obj_ids == [1, 2, 3]
    k = fresh.categories[0].inst_id_to_index[3]
    assert torch.equal(fresh.state.params.codes.shape[0, k],
                       sess.state.params.codes.shape[0, k])


def test_bad_requests_are_structured_errors(servers):
    _, base = servers["port"]
    code, body = _error(f"{base}/object?az=1")  # no id
    assert code == 400 and "KeyError" in body["error"]
    code, body = _error(f"{base}/edit?id=1")  # no edit
    assert code == 400
    code, body = _error(f"{base}/nope")
    assert code == 404 and "/nope" in body["error"]


def test_sharded_serving_raises_and_names_its_item():
    with pytest.raises(NotImplementedError, match="parallel/"):
        tserve.main(["--logdir", "unused", "--synthetic", "--sharded",
                     "--device", "cpu"])


def test_serve_cli_end_to_end(tmp_path):
    """`python -m catnerf_torch.serve --device cpu --port 0` on a
    checkpoint of the --synthetic scene's session: it prints its port,
    answers /health with the scene's six objects and a non-npz /ingest
    body with a 400, and stops on SIGTERM."""
    from catnerf_torch.loaders import load_scene
    from catnerf_torch.train.checkpoint import save_session_checkpoint
    from catnerf_torch.train.loop import TrainingSession

    cfg, inst_dict, sample_dict, cam = load_scene(None, synthetic=True)
    sess = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                           device="cpu")
    save_session_checkpoint(str(tmp_path / "ckpt"), sess, 2)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-m", "catnerf_torch.serve", "--logdir",
         str(tmp_path), "--synthetic", "--device", "cpu", "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        assert "serving 3 categories on cpu at http://127.0.0.1:" in line, \
            (line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split(" at ")[1].split(" ")[0]
        health = json.loads(_get(f"{base}/health", timeout=60)[2])
        assert health["ok"] and len(health["objects"]) == 6
        code, err = _error(f"{base}/ingest?cls=1", data=b"npz")
        assert code == 400 and "npz" in err["error"]
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
