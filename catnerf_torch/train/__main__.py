"""Train the port on the synthetic scene, save and resume it, and mesh it.

    python -m catnerf_torch.train --synthetic --max-iter 200 --log-iter 50
    python -m catnerf_torch.train --synthetic --max-iter 20 --log-iter 5 \\
        --device cpu
    python -m catnerf_torch.train --synthetic --strict-parity
    python -m catnerf_torch.train --synthetic --logdir logs/synthetic \\
        --max-iter 4000 --save-iter 2000 --mesh-it 4000 --grid-dim 128
    python -m catnerf_torch.train --synthetic --logdir logs/synthetic \\
        --resume --mesh-only

It trains through the session's fast path, as the JAX package's `train.py`
does: the device ray store and the superstep (`TrainingSession.run_fast`;
on a CUDA session each step a replayed CUDA graph), in runs that end at
each log, save and mesh iteration. --strict-parity trains on host-staged
batches, one `step_once` a step (the reference's execution shape), as
`train.py --strict-parity` does. The scene and config are the JAX
package's `--synthetic` ones (ref: loaders.py:24-33): 3 categories x 2
instances, 8 frames of 160x120, `Config()` with latent_dim 32, seeded by
`Config.seed`. That is the reference's default trainer: the XLA-path
field modules with bf16 activation storage (bf16_activations=True,
use_fused_kernels=False). With --strict-parity it is the JAX package's
strict-parity configuration (`Config.apply_strict_parity()`: the XLA-path
field modules, float32 activations). The fused-kernel trainer
(use_fused_kernels=True, bf16_activations=False) is reached through
`TrainingSession` with such a config. Prints one JSON line of metrics per
log step.

As `train.py` (ref: train.py:19-146, 217-232): a checkpoint every
--save-iter steps under <logdir>/ckpt (train/checkpoint.py), the scene's
meshes every --mesh-it steps under <logdir>/scene_mesh
(mesher/meshing.py::mesh_scene, one `.obj` per object, at most --grid-dim
voxels a side); --resume restores the latest checkpoint and
--import-reference-ckpt DIR loads the reference's per-category `.pth`
files, both before the fast path is built; --mesh-only meshes the weights
so loaded (or the initial ones) and trains nothing. The device is cuda
unless --device names another. Dataset configs are not ported yet
(ROADMAP.md Queue 1, item 4).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.mesher.meshing import mesh_scene
from catnerf_torch.train import checkpoint as ckpt_mod
from catnerf_torch.train.loop import TrainingSession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m catnerf_torch.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic scene")
    ap.add_argument("--logdir", default="./logs/synthetic",
                    help="checkpoints go to <logdir>/ckpt, meshes to "
                    "<logdir>/scene_mesh")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--log-iter", type=int, default=50)
    ap.add_argument("--save-iter", type=int, default=None,
                    help="checkpoint every N steps (default "
                    "Config.save_iter)")
    ap.add_argument("--mesh-it", type=int, default=None,
                    help="mesh the scene every N steps (default "
                    "Config.mesh_it)")
    ap.add_argument("--grid-dim", type=int, default=None,
                    help="override Config.grid_dim (the most voxels a side "
                    "of a mesh grid)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in logdir")
    ap.add_argument("--import-reference-ckpt", default=None, metavar="DIR",
                    help="load the reference's per-category .pth "
                    "checkpoints (src/scene_cateogries.py:548-597 format) "
                    "from DIR before training")
    ap.add_argument("--mesh-only", action="store_true",
                    help="train nothing: mesh the current (restored or "
                    "imported) weights and exit")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--strict-parity", action="store_true",
                    help="Config.apply_strict_parity(): float32 "
                    "activations instead of bf16 storage, on host-staged "
                    "batches (step_once) instead of the fast path")
    args = ap.parse_args(argv)
    if not args.synthetic:
        ap.error("only --synthetic is ported so far (dataset configs: "
                 "ROADMAP.md Queue 1, item 4)")

    cfg = Config()
    cfg.net_hyperparams.latent_dim = 32
    if args.strict_parity:
        cfg.apply_strict_parity()
    cfg.max_iter = args.max_iter
    cfg.log_iter = args.log_iter
    if args.save_iter is not None:
        cfg.save_iter = args.save_iter
    if args.mesh_it is not None:
        cfg.mesh_it = args.mesh_it
    if args.grid_dim is not None:
        cfg.grid_dim = args.grid_dim
        cfg.live_voxel_size = max(cfg.live_voxel_size, 8.0 / args.grid_dim)
    for name in ("log_iter", "save_iter", "mesh_it", "max_iter"):
        if getattr(cfg, name) < 1:
            ap.error(f"{name} must be >= 1 (got {getattr(cfg, name)}; use "
                     f"a value > max_iter to disable an action)")

    scene = make_scene(n_frames=8, width=160, height=120, n_categories=3,
                       insts_per_cat=2, seed=cfg.seed)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device=args.device)
    ckpt_dir = os.path.join(args.logdir, "ckpt")
    mesh_dir = os.path.join(args.logdir, "scene_mesh")

    if args.import_reference_ckpt:
        step = ckpt_mod.import_reference_checkpoints(
            sess, args.import_reference_ckpt)
        # the checkpoints' iteration names the --mesh-only exports
        sess.iteration = int(step)
        print(f"imported reference checkpoints (global_step={step}) from "
              f"{args.import_reference_ckpt}", file=sys.stderr)
    if args.resume:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir)
        if latest is not None:
            ckpt_mod.restore_session_checkpoint(latest, sess)
            print(f"resumed from {latest} at iteration {sess.iteration}",
                  file=sys.stderr)

    def mesh(it: int) -> None:
        written = mesh_scene(sess, mesh_dir, it)
        print(f"exported {len(written)} meshes to {mesh_dir}",
              file=sys.stderr)

    # after --resume / --import-reference-ckpt, so that the restored
    # weights are meshed, not a fresh initialization
    if args.mesh_only:
        mesh(sess.iteration)
        return 0

    fast = not args.strict_parity
    if fast:
        sess.enable_fast_path(cfg.log_iter)
    t0 = time.time()
    while sess.iteration < cfg.max_iter:
        it = sess.iteration
        if fast:
            # one run up to the next log, save or mesh iteration
            stop = min([cfg.max_iter] + [(it // k + 1) * k for k in (
                cfg.log_iter, cfg.save_iter, cfg.mesh_it)])
            metrics = sess.run_fast(stop - it)
        else:
            metrics = sess.step_once()
        it = sess.iteration
        if it % cfg.log_iter == 0 or it == cfg.max_iter:
            row = sess.metrics_to_dict(metrics)
            row["elapsed_s"] = time.time() - t0
            row["device"] = str(sess.device)
            print(json.dumps(row), flush=True)
        if it % cfg.save_iter == 0:
            path = ckpt_mod.save_session_checkpoint(ckpt_dir, sess, it)
            print(f"saved checkpoint {path}", file=sys.stderr)
        if it % cfg.mesh_it == 0:
            mesh(it)
    return 0


if __name__ == "__main__":
    sys.exit(main())
