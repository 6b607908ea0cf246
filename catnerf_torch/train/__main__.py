"""Train the port on a Replica-layout dataset or the synthetic scene,
save and resume it, and mesh it.

    python -m catnerf_torch.train --config configs/Replica/config_replica_room0.json \\
        --logdir logs/room0
    python -m catnerf_torch.train --synthetic --max-iter 200 --log-iter 50
    python -m catnerf_torch.train --synthetic --max-iter 20 --log-iter 5 \\
        --device cpu
    python -m catnerf_torch.train --synthetic --strict-parity
    python -m catnerf_torch.train --synthetic --logdir logs/synthetic \\
        --max-iter 4000 --save-iter 2000 --mesh-it 4000 --grid-dim 128
    python -m catnerf_torch.train --synthetic --logdir logs/synthetic \\
        --resume --mesh-only

--config reads a reference-schema config JSON (`loaders.load_scene`, as
the JAX package's `train.py --config`): the Replica loader reads the
sequence under `dataset.path` and registers its instances (registration
stage 1 on the host, the per-object field pretraining and uncertainty
scoring on the device, the alignment on the host), or reads its cached
registration (`inst_dict.pkl`); the config is copied into --logdir. The
ScanNet loader is not ported yet: a ScanNet config raises
NotImplementedError. --synthetic takes the JAX package's `--synthetic`
scene and config (ref: loaders.py:24-33): 3 categories x 2 instances, 8
frames of 160x120, `Config()` with latent_dim 32, seeded by
`Config.seed`; its --max-iter and --log-iter default to 200 and 50, a
config's to its own.

It trains through the session's fast path, as the JAX package's `train.py`
does: the device ray store and the superstep (`TrainingSession.run_fast`;
on a CUDA session each step a replayed CUDA graph), in runs that end at
each log, save and mesh iteration. --strict-parity applies
`Config.apply_strict_parity()` and trains on host-staged batches, one
`step_once` a step (the reference's execution shape), as `train.py
--strict-parity` does. `Config()` is the reference's default trainer: the
XLA-path field modules with bf16 activation storage. The fused-kernel
trainer (use_fused_kernels=True, bf16_activations=False) is reached
through `TrainingSession` with such a config. Each log step prints one
JSON line of metrics and appends it to <logdir>/metrics.jsonl
(`train/logging.MetricsWriter`).

As `train.py` (ref: train.py:19-146, 217-232): a checkpoint every
--save-iter steps under <logdir>/ckpt (train/checkpoint.py), the scene's
meshes every --mesh-it steps under <logdir>/scene_mesh
(mesher/meshing.py::mesh_scene, one `.obj` per object, at most --grid-dim
voxels a side); --resume restores the latest checkpoint and
--import-reference-ckpt DIR loads the reference's per-category `.pth`
files, both before the fast path is built; --mesh-only meshes the weights
so loaded (or the initial ones) and trains nothing; --no-background
trains without the background model. The device is cuda unless --device
names another; the registration runs there too. With --config, one
line on stderr gives the seconds of loading and of each stage of the
registration (`frames`, `stage1`, `pretrain`, `uncertainty`, `align`).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

from catnerf_torch.loaders import load_scene
from catnerf_torch.mesher.meshing import mesh_scene
from catnerf_torch.train import checkpoint as ckpt_mod
from catnerf_torch.train.logging import MetricsWriter
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.utils import phase_reset, phase_timings, resolve_device

# --synthetic's defaults for --max-iter and --log-iter
SYNTHETIC_ITERS = {"max_iter": 200, "log_iter": 50}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m catnerf_torch.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None,
                    help="a reference-schema config JSON (Replica)")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic scene")
    ap.add_argument("--logdir", default=None,
                    help="metrics go to <logdir>/metrics.jsonl, checkpoints "
                    "to <logdir>/ckpt, meshes to <logdir>/scene_mesh "
                    "(default logs/synthetic, or logs/<config name>)")
    ap.add_argument("--max-iter", type=int, default=None,
                    help="override the config's max_iter (--synthetic: 200)")
    ap.add_argument("--log-iter", type=int, default=None,
                    help="override the config's log_iter (--synthetic: 50)")
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
    ap.add_argument("--no-background", action="store_true",
                    help="train without the background model")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--strict-parity", action="store_true",
                    help="Config.apply_strict_parity(): float32 "
                    "activations instead of bf16 storage, on host-staged "
                    "batches (step_once) instead of the fast path")
    args = ap.parse_args(argv)
    if args.synthetic == (args.config is not None):
        ap.error("give one of --config or --synthetic")
    if args.logdir is None:
        args.logdir = os.path.join("logs", "synthetic" if args.synthetic
                                   else os.path.splitext(
                                       os.path.basename(args.config))[0])
    if args.synthetic:
        for name, value in SYNTHETIC_ITERS.items():
            if getattr(args, name) is None:
                setattr(args, name, value)
    device = resolve_device(args.device)

    t0 = time.time()
    phase_reset("registration")
    cfg, inst_dict, sample_dict, cam = load_scene(
        args.config, args.synthetic, strict_parity=args.strict_parity,
        device=device)
    if args.config is not None:
        print(f"loaded {args.config} in {time.time() - t0:.3f} s, by stage "
              f"(s): {json.dumps(phase_timings('registration'))}",
              file=sys.stderr)
    if args.max_iter is not None:
        cfg.max_iter = args.max_iter
    if args.log_iter is not None:
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
    os.makedirs(args.logdir, exist_ok=True)
    if args.config is not None:
        dst = os.path.join(args.logdir, os.path.basename(args.config))
        if not (os.path.exists(dst) and os.path.samefile(args.config, dst)):
            shutil.copy(args.config, args.logdir)

    sess = TrainingSession(cfg, inst_dict, sample_dict, cam=cam,
                           with_background=not args.no_background,
                           device=device)
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
    writer = MetricsWriter(args.logdir)
    try:
        train(sess, cfg, fast, writer, ckpt_dir, mesh)
    finally:
        writer.close()
    return 0


def train(sess, cfg, fast: bool, writer, ckpt_dir: str, mesh) -> None:
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
            row = writer.log_step(sess, metrics, it)
            row["elapsed_s"] = time.time() - t0
            row["device"] = str(sess.device)
            print(json.dumps(row), flush=True)
        if it % cfg.save_iter == 0:
            path = ckpt_mod.save_session_checkpoint(ckpt_dir, sess, it)
            print(f"saved checkpoint {path}", file=sys.stderr)
        if it % cfg.mesh_it == 0:
            mesh(it)


if __name__ == "__main__":
    sys.exit(main())
