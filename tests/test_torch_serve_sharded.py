"""Sharded serving (`catnerf_torch/serve.py --sharded`) on two gloo ranks
on the CPU, against the port's unsharded server on the same checkpoint.

The ranks are spawned processes (tests/torch_parallel_ranks.py `serving`,
one thread each, no jax): rank 0 serves HTTP on a free port while its
client thread sends the requests below, then shuts the server down; rank
1 follows. The unsharded answers come from a `SceneServer` in this
process (tests/test_torch_serve.py holds it to the JAX package's). Every
PNG and `.obj` must be byte-identical; after `POST /ingest` both ranks
hold bitwise-equal code tables and obj_mask, the adoptee renders through
`/scene`, and the checkpoint rank 0 saved restores into an unsharded
server that answers that `/scene` byte for byte; a bad id is a 400 that
leaves the follower in step; both ranks' loops return 0.
"""

from __future__ import annotations

import json

import pytest
import torch

from catnerf_torch import serve
from catnerf_torch.train import checkpoint as ckpt
from torch_parallel_ranks import (SMALL, ingest_scene, ingest_session,
                                  launch)

torch.set_num_threads(1)

SIZE = f"w={SMALL[0]}&h={SMALL[1]}&bins=16"
#: the requests of the unsharded comparison (name -> path)
COMPARED = {
    "scene_frame": f"/scene?frame=0&{SIZE}",
    "scene_orbit": f"/scene?az=45&el=30&radius=4&{SIZE}",
    "mesh": "/mesh?id=1",
    "object": f"/object?id=2&az=30&el=20&{SIZE}",
}


def _soften(sess) -> None:
    """Each occupancy head scaled down, as tests/test_torch_render_views.py
    softens the JAX initial weights: the fields saturate every ray within
    a few bins otherwise, so no object shows in a composite. The objects'
    occupancy crosses 0.5 (a surface to mesh); the background's leaves
    part of each view empty."""
    p = sess.state.params
    with torch.no_grad():
        for head, bias in ((p.cat_fc.sigma, 0.0), (p.bg_fc.out_alpha, -0.3)):
            head.w.mul_(0.1)
            head.b.fill_(bias)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The checkpoint (3 steps of the ingest scene), the two ranks' serving
    run on it, and the unsharded server's answers."""
    tmp = tmp_path_factory.mktemp("serve_sharded")
    sess = ingest_session()
    for _ in range(3):
        sess.step_once()
    _soften(sess)
    ckpt_dir = str(tmp / "ckpt")
    ckpt.save_session_checkpoint(ckpt_dir, sess, 3)
    cfg, scene, train, cls_id, held, body = ingest_scene()
    requests = [(k, v, None) for k, v in COMPARED.items()]
    requests += [
        ("mesh_cached", "/mesh?id=1", None),
        ("bad_mesh", "/mesh?id=999", None),
        ("bad_frame", f"/scene?frame=99&{SIZE}", None),
        ("health", "/health", None),
        ("ingest", f"/ingest?cls={cls_id}&steps=20&rays=64", body),
        ("health_after", "/health", None),
        ("scene_after", f"/scene?frame=0&{SIZE}", None)]
    ranks = launch("serving", 2, str(tmp), {"ckpt_dir": ckpt_dir,
                                            "requests": requests})
    server = serve.SceneServer(sess)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "_SIZES", (SMALL,) + serve._SIZES)
        want = {
            "scene_frame": serve._png(server.render_scene_frame(
                0, *SMALL, 16)),
            "scene_orbit": serve._png(server.render_scene_orbit(
                45.0, 30.0, 4.0, (0.0, 0.0, 0.0), *SMALL, 16)),
            "mesh": server.mesh_obj(1),
            "object": serve._png(server.render_object(
                2, 30.0, 20.0, None, *SMALL, 16)),
        }
        restored = ingest_session()
        ckpt.restore_session_checkpoint(ckpt.latest_checkpoint(ckpt_dir),
                                        restored)
        want["scene_after"] = serve._png(serve.SceneServer(
            restored).render_scene_frame(0, *SMALL, 16))
    return {"ranks": ranks, "want": want, "restored": restored,
            "ckpt_dir": ckpt_dir, "cls_id": cls_id}


@pytest.mark.parametrize("name", list(COMPARED))
def test_answers_are_byte_identical_to_the_unsharded_server(run, name):
    status, data = run["ranks"][0]["answers"][name]
    assert status == 200, data[:300]
    assert data == run["want"][name]
    assert len(data) > 100


def test_a_mesh_cache_hit_broadcasts_nothing(run):
    """A cached /mesh runs on rank 0 alone: a server marked sharded with
    no process group to broadcast on (a broadcast would raise) answers
    a cached id, and raises for an uncached one."""
    class TwoProcesses:
        def size(self):
            return 2

    server = serve.SceneServer(run["restored"])
    server.device_mesh = TwoProcesses()
    ver = (int(server.session.state.step), 1)
    server._mesh_cache[(1, ver)] = b"v 0 0 0\n"
    assert server.mesh_obj(1) == b"v 0 0 0\n"
    with pytest.raises(RuntimeError, match="process group"):
        server.mesh_obj(2)


def test_the_cache_hit_and_the_bad_requests_leave_the_follower_in_step(run):
    """The second /mesh is the cache's bytes; an unknown id and an unknown
    frame answer 400 before any broadcast; the requests after them (the
    ingest, the last /scene) still run on both ranks."""
    answers = run["ranks"][0]["answers"]
    assert answers["mesh_cached"] == answers["mesh"]
    code, body = answers["bad_mesh"]
    assert code == 400 and "unknown object id 999" in json.loads(body)["error"]
    code, body = answers["bad_frame"]
    assert code == 400 and "unknown frame 99" in json.loads(body)["error"]
    assert answers["scene_after"][0] == 200


def test_ingest_adopts_on_both_ranks_and_the_adoptee_renders(run):
    ranks = run["ranks"]
    status, body = ranks[0]["answers"]["ingest"]
    assert status == 200, body[:300]
    out = json.loads(body)
    assert out["adopted"] and out["id"] == 3 and out["cls"] == run["cls_id"]
    assert out["checkpoint"].endswith("/4")
    objects = json.loads(ranks[0]["answers"]["health_after"][1])["objects"]
    assert objects == json.loads(
        ranks[0]["answers"]["health"][1])["objects"] + [3]
    for k in ("shape", "texture", "obj_mask"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k
    assert ranks[0]["shape"].shape[1] == 3  # the category grew by a slot
    assert ranks[0]["adopted"] == ranks[1]["adopted"]
    assert [r["id"] for r in ranks[0]["adopted"]] == [3]
    # the adoptee is in the frame: the composite changed, and the saved
    # checkpoint restores into an unsharded server that answers the same
    after = ranks[0]["answers"]["scene_after"][1]
    assert after != ranks[0]["answers"]["scene_frame"][1]
    assert after == run["want"]["scene_after"]
    restored = run["restored"]
    assert restored.adopted_instances == ranks[0]["adopted"]
    assert torch.equal(restored.state.params.codes.shape, ranks[0]["shape"])


def test_both_ranks_exit_0_at_shutdown(run):
    assert [r["exit"] for r in run["ranks"]] == [0, 0]


def test_one_process_sharded_serves_unsharded(tmp_path, monkeypatch,
                                              capsys):
    """`serve --sharded` in one process prints the JAX package's message
    and serves unsharded (here until its serve_forever returns, at once)."""
    from catnerf_torch.loaders import load_scene
    from catnerf_torch.train.loop import TrainingSession

    cfg, inst_dict, sample_dict, cam = load_scene(None, synthetic=True)
    sess = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                           device="cpu")
    ckpt.save_session_checkpoint(str(tmp_path / "ckpt"), sess, 2)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    built = []

    def once(*args, **kwargs):
        httpd = serve.ThreadingHTTPServer(("127.0.0.1", 0),
                                          serve.BaseHTTPRequestHandler)
        built.append(kwargs["scene_server"])
        httpd.serve_forever = lambda: None  # as if shut down at once
        return httpd

    monkeypatch.setattr(serve, "serve", once)
    assert serve.main(["--logdir", str(tmp_path), "--synthetic", "--device",
                       "cpu", "--port", "0", "--sharded"]) == 0
    out = capsys.readouterr()
    assert "--sharded: single device visible, running unsharded" in out.err
    assert "serving 3 categories on cpu" in out.out
    assert built[0].device_mesh is None and built[0]._group is None
