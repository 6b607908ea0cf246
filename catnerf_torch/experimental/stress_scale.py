"""The room_0-scale run: one synthetic scene at the reference workload's
shape, trained and meshed on the card. The counterpart of the JAX
package's `scripts/stress_scale.py`.

The shape of configs/Replica/config_replica_room0.json: a 1,200 x 680
camera, 100 frames, 20 categories x 2 instances, 10,000 iterations, and
every object meshed at up to 256 voxels a side. `make_scene`, then
`TrainingSession` on `Config()` with latent 32 (bf16 storage on the XLA
path), `enable_fast_path(n_inner=100)` (the device ray store; on the card
each step a replayed CUDA graph), `run_fast` in calls of 100, then
`mesh_scene`. It records what the small scenes never reach: the scene and
session seconds, the host ray buffers' and the device store's bytes, the
training rate sustained at that size, the mesh-all seconds, and the peak
device and host memory.

Prints ONE JSON line with the JAX script's keys (`samples_per_sec` in
millions, as there), plus `peak_device_mb` (torch.cuda.max_memory_
allocated), `device` (the card's name and power limit as nvidia-smi
gives them, or the device's name), `store_rays_capped` and `reduced`
(each flag set below the full run's value, as "name full -> value").
Fails when the loss is not finite.

    python -m catnerf_torch.experimental.stress_scale          # the card
    python -m catnerf_torch.experimental.stress_scale --device cpu \\
        --frames 2 --width 48 --height 36 --categories 2 --iters 200 \\
        --grid-dim 32 --mesh-objects 1

--cap-rays and --cap-bg subsample the store's rays a category and of the
background at build (Config.max_store_rays_per_cat / _bg, 0 keeps every
ray). The JAX script's 2,000,000 and 12,000,000 were set for a 16 GB
chip; the uncapped room stores (~30M object and ~80M background rays,
~3-4 GB a side) fit the H100's 80 GB, so both default to 0 here.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the full run's flags: a smaller value is listed under "reduced"
FULL = dict(width=1200, height=680, frames=100, categories=20, insts=2,
            iters=10000, grid_dim=256)


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def device_name(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or the device."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip()
    return out.splitlines()[device.index or 0] if out else str(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reduced(args) -> list[str]:
    """Each cut of the full run's scale."""
    cuts = [f"{k} {v} -> {getattr(args, k)}" for k, v in FULL.items()
            if getattr(args, k) < v]
    if args.mesh_objects:
        cuts.append(f"mesh_objects all -> {args.mesh_objects}")
    return cuts


def samples_per_step(sess, cfg) -> int:
    """Ray samples a step (scripts/stress_scale.py's formula)."""
    return (sess.n_per_cls * len(sess.cls_ids)
            * (cfg.n_bins + cfg.n_bins_cam2surface)
            + cfg.n_per_optim_bg * (cfg.n_bins + cfg.n_bins_cam2surface_bg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m catnerf_torch.experimental.stress_scale",
        description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=FULL["width"])
    ap.add_argument("--height", type=int, default=FULL["height"])
    ap.add_argument("--frames", type=int, default=FULL["frames"])
    ap.add_argument("--categories", type=int, default=FULL["categories"])
    ap.add_argument("--insts", type=int, default=FULL["insts"])
    ap.add_argument("--iters", type=int, default=FULL["iters"])
    ap.add_argument("--grid-dim", type=int, default=FULL["grid_dim"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shapes", choices=("sphere", "asym", "mixed"),
                    default="sphere",
                    help="sphere ray casting is closed-form; asym shapes "
                    "march numerically (slower scene build)")
    ap.add_argument("--mesh-objects", type=int, default=0,
                    help="mesh only the first N objects (0 = all)")
    ap.add_argument("--cap-rays", type=int, default=0,
                    help="max device-store rays per category (0 = all)")
    ap.add_argument("--cap-bg", type=int, default=0,
                    help="max background store rays (0 = all)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from catnerf_torch.config import Config
    from catnerf_torch.data.synthetic import make_scene
    from catnerf_torch.mesher import meshing
    from catnerf_torch.train.loop import TrainingSession
    from catnerf_torch.utils import (phase_timings, reset_phase_timings,
                                     resolve_device)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = {"metric": "room0_scale_stress", "width": args.width,
              "height": args.height, "frames": args.frames,
              "categories": args.categories,
              "instances": args.categories * args.insts,
              "iters": args.iters, "grid_dim": args.grid_dim,
              "shapes": args.shapes, "device": device_name(device),
              "reduced": reduced(args)}

    t0 = time.time()
    scene = make_scene(n_frames=args.frames, width=args.width,
                       height=args.height, n_categories=args.categories,
                       insts_per_cat=args.insts, seed=args.seed,
                       shape_family=args.shapes)
    result["scene_build_s"] = round(time.time() - t0, 1)
    frame_bytes = sum(d["image"].nbytes + d["depth"].nbytes
                      + d["obj_mask"].nbytes
                      for d in scene.sample_dict.values())
    result["frame_store_gb"] = round(frame_bytes / 1e9, 3)

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 32
    cfg.grid_dim = args.grid_dim
    cfg.seed = args.seed
    cfg.max_store_rays_per_cat = args.cap_rays
    cfg.max_store_rays_bg = args.cap_bg
    result["cap_rays_per_cat"] = args.cap_rays
    result["cap_rays_bg"] = args.cap_bg

    # the ray caches of every instance and the background over every
    # frame (the reference's sceneCategory setup,
    # src/scene_cateogries.py:119-260)
    t0 = time.time()
    reset_phase_timings()
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device=device)
    result["session_build_s"] = round(time.time() - t0, 1)
    result["session_phase_s"] = phase_timings("session")
    result["n_categories_loaded"] = len(sess.cls_ids)

    cat_rays = sum(c.buffer.n for c in sess.categories)
    bg_rays = sess.background.buffer.n if sess.background else 0
    host_bytes = sum(sum(a.nbytes for a in c.buffer.arrays.values())
                     for c in sess.categories)
    if sess.background:
        host_bytes += sum(a.nbytes
                          for a in sess.background.buffer.arrays.values())
    result["cat_rays_total"] = int(cat_rays)
    result["bg_rays_total"] = int(bg_rays)
    result["host_ray_buffer_gb"] = round(host_bytes / 1e9, 3)

    # the device ray store and the superstep (the fast path)
    t0 = time.time()
    sess.enable_fast_path(n_inner=100)
    t1 = time.time()
    sync(device)
    wait = time.time() - t1
    result["fast_path_setup_s"] = round(time.time() - t0, 1)
    fp = dict(phase_timings("fast_path"))
    fp["store_upload_wait"] = round(wait, 2)
    result["fast_phase_s"] = fp
    store = sess._store
    dev_bytes = store.packed.nbytes + (
        store.bg_packed.nbytes if store.bg_packed is not None else 0)
    result["device_store_gb"] = round(dev_bytes / 1e9, 3)
    result["store_rays_capped"] = bool(
        (args.cap_rays and any(c.buffer.n >= args.cap_rays
                               for c in sess.categories))
        or (args.cap_bg and bg_rays >= args.cap_bg))

    # training at the reference's budget, in calls of 100 steps
    iters = max(100, args.iters // 100 * 100)
    per_step = samples_per_step(sess, cfg)
    t0 = time.time()
    m = sess.run_fast(100)  # the graph's warm-up and capture
    sync(device)
    result["first_100_iters_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    for _ in range((iters - 100) // 100):
        m = sess.run_fast(100)
    psnr = float(m.cat_psnr.float().mean())
    total = float(m.total)  # a sync: the steps are done
    train_s = time.time() - t0
    result["train_iters_s"] = round(train_s, 1)
    result["steps_per_sec"] = round((iters - 100) / train_s, 1)
    result["samples_per_sec"] = round(
        (iters - 100) * per_step / train_s / 1e6, 1)
    result["samples_per_step"] = int(per_step)
    result["final_psnr"] = round(psnr, 2)
    result["final_total"] = round(total, 1)
    if not np.isfinite(total):
        raise RuntimeError(f"non-finite loss at scale: {total}")

    # every object (or the first --mesh-objects) and the background
    only = ([s.inst_id for s in scene.spheres[:args.mesh_objects]]
            if args.mesh_objects else None)
    meshing.reset_mesh_timings()
    with tempfile.TemporaryDirectory(prefix="stress_mesh_") as out_dir:
        t0 = time.time()
        written = meshing.mesh_scene(sess, out_dir, iters, only_objects=only)
        result["mesh_all_s"] = round(time.time() - t0, 1)
    result["mesh_phase_s"] = meshing.mesh_timings()
    result["n_meshed"] = len(written)
    result["peak_host_rss_gb"] = round(rss_gb(), 2)
    if device.type == "cuda":
        result["peak_device_mb"] = round(
            torch.cuda.max_memory_allocated(device) / 2**20, 1)
    else:
        result["peak_device_mb"] = None
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
