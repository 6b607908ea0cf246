"""Train the port on a Replica- or ScanNet-layout dataset or the
synthetic scene, save and resume it, and mesh it.

    python -m catnerf_torch.train --config configs/Replica/config_replica_room0.json \\
        --logdir logs/room0
    python -m catnerf_torch.train --config configs/ScanNet/config_scannet_0013.json \\
        --logdir logs/scannet_0013 [--device cpu]
    python -m catnerf_torch.train --synthetic --max-iter 200 --log-iter 50
    python -m catnerf_torch.train --synthetic --max-iter 20 --log-iter 5 \\
        --device cpu
    python -m catnerf_torch.train --synthetic --strict-parity
    python -m catnerf_torch.train --synthetic --parity --trace
    python -m catnerf_torch.train --synthetic --logdir logs/synthetic \\
        --max-iter 4001 --save-iter 2000 --mesh-it 4000 --grid-dim 128
    python -m catnerf_torch.train --synthetic --logdir logs/synthetic \\
        --resume --mesh-only

--config reads a reference-schema config JSON (`loaders.load_scene`, as
the JAX package's `train.py --config`): the Replica or ScanNet loader
reads the sequence under `dataset.path` and registers its instances
(registration stage 1 on the host, through TSDF fusion for ScanNet; the
per-object field pretraining and uncertainty scoring on the device; the
alignment on the host), or reads its cached registration
(`inst_dict.pkl`). A ScanNet config with `use_refined_mask` refines each
frame's instance masks by geometric segmentation (its image stages on
the device) and caches them under the dataset (`instance-refined/`,
`instance-disputed/`, `inst_to_cls/`), which `load_refined_mask` reads
back. The config is copied into --logdir. --synthetic takes the JAX package's `--synthetic`
scene and config (ref: loaders.py:24-33): 3 categories x 2 instances, 8
frames of 160x120, `Config()` with latent_dim 32, seeded by
`Config.seed`; its --max-iter and --log-iter default to 200 and 50, a
config's to its own.

It trains iterations start+1 ... max_iter-1, as the JAX package's
`train.py` (ref: train.py:157-160, 253-265): a config's max_iter 10001
trains 10,000 steps. The fast path (the device ray store and the
superstep, `TrainingSession.run_fast`; on a CUDA session each step a
replayed CUDA graph) runs when log_iter > 1, save_iter, mesh_it and the
start are multiples of log_iter, and neither --parity nor
--strict-parity is given: (max_iter-1-start) // log_iter runs of log_iter
steps, then the rest one `step_once` a step. Otherwise every step is a
`step_once` on host-staged batches (the reference's execution shape: the
epoch cursor's batches, one packed copy a step, train/packing.py). The
rule decides where the batches come from, so it decides the result.
--strict-parity also applies `Config.apply_strict_parity()`. `Config()`
is the reference's default trainer: the XLA-path field modules with bf16
activation storage. The fused-kernel trainer (use_fused_kernels=True,
bf16_activations=False) is reached through `TrainingSession` with such a
config. Each log step prints one JSON line of metrics and appends it to
<logdir>/metrics.jsonl (`train/logging.MetricsWriter`). --trace writes a
torch.profiler trace of the first run or step into <logdir>/trace
(`utils.device_trace`).

Each step's total loss is checked two steps behind (ref:
train.py:188-215): one that is not finite or over 1e8 saves a post-mortem
checkpoint labelled with the session's iteration and exits with a message
naming both iterations.

As `train.py` (ref: train.py:19-146, 217-232): a checkpoint every
--save-iter steps under <logdir>/ckpt (train/checkpoint.py), the scene's
meshes every --mesh-it steps under <logdir>/scene_mesh
(mesher/meshing.py::mesh_scene, one `.obj` per object, at most --grid-dim
voxels a side); --resume restores the latest checkpoint and
--import-reference-ckpt DIR loads the reference's per-category `.pth`
files, both before the fast path is built (--resume sets the start; an
import does not, as in train.py); --mesh-only meshes the weights so loaded
(or the initial ones) and trains nothing; --no-background trains without
the background model. The device is cuda unless --device names
another; the registration runs there too.

Under torchrun (one process per GPU; `parallel/`), as `train.py`'s
flags (ref: train.py:53-63, 128-180):

    torchrun --nproc-per-node N -m catnerf_torch.train --config <json> \
        --train-sharded [N_MODEL] --mesh-sharded

--train-sharded shards the fast path DP(rays) x EP(categories) over an
(N / N_MODEL) x N_MODEL mesh (N_MODEL 1 by default: pure data parallel;
it must divide the categories), --mesh-sharded spreads every mesh grid
and colour evaluation over the N processes. With one process each prints
that it runs unsharded; --train-sharded without the fast path trains
unsharded. The registration runs once, on rank 0, which writes its cache;
the other ranks wait, then read it. Only rank 0 prints the log lines,
writes metrics.jsonl, the checkpoints (gathered from the shards, the
unsharded format) and the meshes; the metrics are the whole step's on
every rank, so the loss guard stops every rank alike. With --config, one line on
stderr gives the seconds of loading and of each stage of the registration
(`frames`, `stage1`, `pretrain`, `uncertainty`, `align`).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time

from catnerf_torch.loaders import load_scene
from catnerf_torch.mesher.meshing import mesh_scene
from catnerf_torch.parallel import mesh as pmesh
from catnerf_torch.train import checkpoint as ckpt_mod
from catnerf_torch.train.logging import MetricsWriter
from catnerf_torch.train.loop import TrainingSession
from catnerf_torch.utils import (device_trace, phase_reset, phase_timings,
                                 resolve_device)

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
    ap.add_argument("--parity", action="store_true",
                    help="train every step with step_once on host-staged "
                    "batches (the reference's execution shape) instead of "
                    "the fast path")
    ap.add_argument("--strict-parity", action="store_true",
                    help="Config.apply_strict_parity(): float32 "
                    "activations instead of bf16 storage; implies --parity")
    ap.add_argument("--trace", action="store_true",
                    help="a torch.profiler trace of the first training run "
                    "or step into <logdir>/trace")
    ap.add_argument("--train-sharded", type=int, nargs="?", const=1,
                    default=None, metavar="N_MODEL",
                    help="shard the fast-path training DP(rays) x "
                    "EP(categories) over every process (torchrun; "
                    "parallel/sharding.py); optional value = 'model'-axis "
                    "width (default 1 = pure DP). Unsharded with one "
                    "process or without the fast path")
    ap.add_argument("--mesh-sharded", action="store_true",
                    help="shard every mesh grid/color evaluation "
                    "data-parallel over every process (torchrun; "
                    "parallel/grid_eval.py; identical output)")
    args = ap.parse_args(argv)
    if args.strict_parity:
        args.parity = True
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
    distributed = ((args.train_sharded is not None or args.mesh_sharded)
                   and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    if distributed:
        pmesh.init_distributed(device)
    try:
        return run(ap, args, device, distributed)
    finally:
        if distributed:
            pmesh.shutdown()


def run(ap, args, device, distributed: bool) -> int:
    main_rank = pmesh.is_main()

    def say(msg: str) -> None:
        if main_rank:
            print(msg, file=sys.stderr)

    t0 = time.time()
    phase_reset("registration")
    # the registration once, on rank 0, which caches it under the dataset;
    # the other ranks then read that cache
    if distributed and args.config is not None and not main_rank:
        pmesh.barrier()
    cfg, inst_dict, sample_dict, cam = load_scene(
        args.config, args.synthetic, strict_parity=args.strict_parity,
        device=device)
    if distributed and args.config is not None and main_rank:
        pmesh.barrier()
    if args.config is not None:
        say(f"loaded {args.config} in {time.time() - t0:.3f} s, by stage "
            f"(s): {json.dumps(phase_timings('registration'))}")
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
    if args.config is not None and main_rank:
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
        say(f"imported reference checkpoints (global_step={step}) from "
            f"{args.import_reference_ckpt}")
    start = 0
    if args.resume:
        latest = ckpt_mod.latest_checkpoint(ckpt_dir)
        if latest is not None:
            ckpt_mod.restore_session_checkpoint(latest, sess)
            start = sess.iteration
            say(f"resumed from {latest} at iteration {start}")

    mesh_devices = None
    if args.mesh_sharded:
        mesh_devices = pmesh.cli_mesh(device, "--mesh-sharded")
        if mesh_devices is not None:
            say(f"mesh eval sharded over {mesh_devices.size()} devices")

    def mesh(it: int) -> None:
        written = mesh_scene(sess, mesh_dir, it, device_mesh=mesh_devices)
        say(f"exported {len(written)} meshes to {mesh_dir}")

    # after --resume / --import-reference-ckpt, so that the restored
    # weights are meshed, not a fresh initialization
    if args.mesh_only:
        mesh(sess.iteration)
        return 0

    fast = uses_fast_path(cfg, start, args.parity)
    if fast:
        train_mesh = None
        if args.train_sharded is not None:
            train_mesh = pmesh.cli_mesh(device, "--train-sharded",
                                        n_model=args.train_sharded)
            if train_mesh is not None:
                say(f"training sharded over "
                    f"{dict(zip(train_mesh.mesh_dim_names, train_mesh.shape))}"
                    f" mesh")
        sess.enable_fast_path(cfg.log_iter, device_mesh=train_mesh)
    elif args.train_sharded is not None:
        say("--train-sharded requires the fast path (not --parity, and "
            "save/mesh iters multiples of log_iter); running unsharded")
    # the other ranks make the rows and write nothing
    writer = (MetricsWriter(args.logdir) if main_rank
              else MetricsWriter(args.logdir, write=False))
    trace_dir = (os.path.join(args.logdir, "trace")
                 if args.trace and main_rank else None)
    try:
        train(sess, cfg, start, fast, writer, ckpt_dir, mesh, trace_dir)
    finally:
        sess.release_prefetch()
        writer.close()
    return 0


def uses_fast_path(cfg, start: int, parity: bool) -> bool:
    """train.py's rule (ref: train.py:157-160): the fast path only where
    every periodic action lands on a run's end."""
    return (not parity and cfg.log_iter > 1
            and cfg.save_iter % cfg.log_iter == 0
            and cfg.mesh_it % cfg.log_iter == 0
            and start % cfg.log_iter == 0)


def schedule(cfg, start: int, fast: bool) -> list[tuple[int, str]]:
    """(iteration, "run_fast" or "step_once") of each training call, in
    order (ref: train.py:253-265): a run_fast call stands for the
    log_iter steps that end at its iteration."""
    if not fast:
        return [(it, "step_once") for it in range(start + 1, cfg.max_iter)]
    n_runs = (cfg.max_iter - 1 - start) // cfg.log_iter
    it = start + n_runs * cfg.log_iter
    return ([(start + (c + 1) * cfg.log_iter, "run_fast")
             for c in range(n_runs)]
            + [(j, "step_once") for j in range(it + 1, cfg.max_iter)])


class LossGuard:
    """Loss-explosion detection (ref: train.py:188-215; the reference
    calls exit(-1) from inside the loss, src/render_rays.py:87-89). Reading
    a step's total waits for the device, so the check runs two steps
    behind and the host keeps queueing. On a total that is not finite or
    over 1e8 it saves a post-mortem checkpoint labelled with the
    session's iteration (up to two updates past the explosion) and exits
    naming both iterations."""

    SLACK = 2
    LIMIT = 1e8

    def __init__(self, sess, ckpt_dir: str, writer):
        self.sess, self.ckpt_dir, self.writer = sess, ckpt_dir, writer
        self.pending = []

    def __call__(self, it: int | None, metrics, flush: bool = False):
        if metrics is not None:
            self.pending.append((it, metrics))
        while len(self.pending) > (0 if flush else self.SLACK):
            it0, m0 = self.pending.pop(0)
            total = float(m0.total)
            if math.isfinite(total) and total < self.LIMIT:
                continue
            it_state = self.sess.iteration
            self.sess.settle_prefetch()
            path = ckpt_mod.save_session_checkpoint(self.ckpt_dir,
                                                    self.sess, it_state)
            self.writer.close()
            raise SystemExit(
                f"loss explosion detected at iteration {it0} "
                f"(total={total}); post-mortem state snapshot (iteration "
                f"{it_state}, {it_state - it0} steps past the explosion — "
                f"may be poisoned) saved to {path}")


def train(sess, cfg, start: int, fast: bool, writer, ckpt_dir: str, mesh,
          trace_dir: str | None = None) -> None:
    t0 = time.time()
    guard = LossGuard(sess, ckpt_dir, writer)
    for n, (it, how) in enumerate(schedule(cfg, start, fast)):
        step = ((lambda: sess.run_fast(cfg.log_iter)) if how == "run_fast"
                else sess.step_once)
        if n == 0 and trace_dir is not None:
            with device_trace(trace_dir, sess.device):
                metrics = step()
            print(f"device trace written to {trace_dir}", file=sys.stderr)
        else:
            metrics = step()
        guard(it, metrics)
        if it % cfg.log_iter == 0:
            row = writer.log_step(sess, metrics, it)
            row["elapsed_s"] = time.time() - t0
            row["device"] = str(sess.device)
            if pmesh.is_main():
                print(json.dumps(row), flush=True)
        if it % cfg.save_iter == 0 or it % cfg.mesh_it == 0:
            sess.settle_prefetch()
        if it % cfg.save_iter == 0:
            path = ckpt_mod.save_session_checkpoint(ckpt_dir, sess, it)
            if pmesh.is_main():
                print(f"saved checkpoint {path}", file=sys.stderr)
        if it % cfg.mesh_it == 0:
            mesh(it)
    guard(None, None, flush=True)


if __name__ == "__main__":
    sys.exit(main())
