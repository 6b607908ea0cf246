"""The view endpoint: scene views served over HTTP by the program's
`serve.SceneServer`, reached on localhost from a closed-loop client in
the run's own process, as an interactive viewer waits for each frame.

Set-up builds the session on the seed's scene, writes the seed's weights
into it (nothing is trained), starts the server on a free port and
renders one view of the cell's size. The window sends `GET /scene` from
the scene's own camera poses (`frame=k`), each frame once a cycle in an
order drawn from the seed, one request after the other, for `--seconds`:
every seed asks for the same views. Then the server stops, the session is freed, and the plain
reference renders a sample of the window's views, drawn from the seed,
which the PNGs served are held to.
"""

from __future__ import annotations

import gc
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from benchlib import png, reference, reference_view, scene, trace
from benchlib import train_cell

MARGIN = 1.3  # the scene view's box margin


def _frames(n: int, seed: int):
    """Frame indices: cycles through all n, each in its own order."""
    rng = np.random.default_rng(seed)
    while True:
        yield from (int(k) for k in rng.permutation(n))


def _get(port: int, frame: int, tp: dict) -> bytes | None:
    """The PNG of a /scene request, or None when the server refused it."""
    url = (f"http://127.0.0.1:{port}/scene?frame={frame}"
           f"&w={tp['width']}&h={tp['height']}&bins={tp['bins']}")
    try:
        with urllib.request.urlopen(url, timeout=300) as resp:
            return resp.read()
    except urllib.error.HTTPError:
        return None


def run(cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False) -> dict:
    """One run of a view cell: the readings its metrics and checks take.
    control: the reference in the traffic's control precision is held to
    the reference in place of the served views."""
    from catnerf_torch import serve
    from catnerf_torch.data.camera import CameraInfo
    from catnerf_torch.train.loop import TrainingSession
    from catnerf_torch.utils import phase_timings, reset_phase_timings

    raw, tp = cell.config_raw, cell.traffic_params
    rcfg = train_cell.reference_config(raw)
    cfg = train_cell.program_config(cell, seed)
    cam = train_cell.camera(raw)
    inst_dict, sample_dict = scene.make_scene(raw["benchmark"]["scene"], cam,
                                              seed, device)
    arch = train_cell.architecture(raw, inst_dict)
    reset_phase_timings()
    readings: dict = {}
    t0 = time.perf_counter()
    sess = TrainingSession(cfg, inst_dict, sample_dict,
                           cam=CameraInfo(cam.width, cam.height, cam.fx,
                                          cam.fy, cam.cx, cam.cy),
                           device=device)
    readings["setup_session_s"] = time.perf_counter() - t0
    readings["session_phases"] = phase_timings("session")
    w0 = reference.init_weights(arch, seed, device)
    # the background mostly free space, as a trained room's is between
    # its walls, so that the objects show
    free = tp["background_alpha"]
    w0["bg_fc.out_alpha.w"] *= free["weight_scale"]
    w0["bg_fc.out_alpha.b"].fill_(free["bias"])
    train_cell.write_weights(sess, w0)

    server = serve.SceneServer(sess)
    httpd = serve.serve(sess, port=0, host="127.0.0.1", scene_server=server)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    frames = _frames(len(sample_dict), seed + 3)
    views, failed = [], 0
    try:
        if _get(port, next(frames), tp) is None:  # the cell's shapes, warmed
            raise RuntimeError("the warm-up view failed")
        train_cell.sync(device)
        readings["setup_s"] = time.perf_counter() - t_start
        if traced:
            frame = next(frames)
            readings["trace"], data = _traced_view(port, frame, tp, device)
            views.append((frame, data))
        else:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                frame = next(frames)
                data = _get(port, frame, tp)
                if data is None:
                    failed += 1
                else:
                    views.append((frame, data))
            readings["window_s"] = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    readings["steps"], readings["failed"] = len(views) + failed, failed
    readings["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if device.type == "cuda"
        else 0)
    far = 1.2 * float(np.linalg.norm(inst_dict[0]["bbox3D"].extent))
    del server, httpd, sess
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference renders a sample of the served views
    rng = np.random.default_rng(seed + 4)
    k = min(tp["check_views"], len(views))
    pick = sorted(rng.choice(len(views), size=k, replace=False).tolist())
    objs = reference_view.objects(inst_dict, MARGIN)
    f = 0.9 * max(tp["width"], tp["height"])
    pin = (tp["width"], tp["height"], f, f, tp["width"] / 2.0,
           tp["height"] / 2.0)
    ref_p = train_cell.precision(tp["reference"])
    t0 = time.perf_counter()
    gaps = []
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in pick:
            frame, data = views[i]
            T = np.asarray(sample_dict[frame]["T"], np.float32)
            want = reference_view.quantise(reference_view.render(
                w0, arch, rcfg, objs, pin, T, 0.05, far, tp["bins"], ref_p))
            if control:
                got = reference_view.quantise(reference_view.render(
                    w0, arch, rcfg, objs, pin, T, 0.05, far, tp["bins"],
                    train_cell.precision(tp["control"])))
            else:
                got = png.decode(data)
            gaps.append(np.abs(got.astype(np.int32) - want.astype(np.int32)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    readings["reference_s"] = time.perf_counter() - t0
    readings["checked_views"] = len(gaps)
    readings["values"] = (
        {"view_mean_lsb": float(max(g.mean() for g in gaps))} if gaps else {})
    readings["view_max_lsb"] = float(max(g.max() for g in gaps)) if gaps else None
    if not traced:
        readings["end_to_end"] = {
            "setup_s": readings["setup_s"],
            "view_ms": 1e3 * readings["window_s"] / max(1, len(views))}
    readings["unmoved_leaves"] = []
    return readings


def _traced_view(port: int, frame: int, tp: dict, device):
    """(trace, PNG) of one view under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            data = _get(port, frame, tp)
            train_cell.sync(device)
    if data is None:
        raise RuntimeError("the traced view failed")
    return trace.reduce_profile(prof, 1), data
