"""Train the port on the synthetic scene.

    python -m catnerf_torch.train --synthetic --max-iter 200 --log-iter 50
    python -m catnerf_torch.train --synthetic --max-iter 20 --log-iter 5 \\
        --device cpu
    python -m catnerf_torch.train --synthetic --strict-parity

It trains through the session's fast path, as the JAX package's `train.py`
does: the device ray store and the superstep, `--log-iter` steps a call
(`TrainingSession.run_fast`; on a CUDA session each step a replayed CUDA
graph). --strict-parity trains on host-staged batches, one `step_once` a
step (the reference's execution shape), as `train.py --strict-parity`
does. The scene and config are the JAX package's `--synthetic` ones (ref:
loaders.py:24-33): 3 categories x 2 instances, 8 frames of 160x120,
`Config()` with latent_dim 32, seeded by `Config.seed`. That is the
reference's default trainer: the XLA-path field modules with bf16
activation storage (bf16_activations=True, use_fused_kernels=False).
With --strict-parity it is the JAX package's strict-parity configuration
(`Config.apply_strict_parity()`, train.py --strict-parity: the XLA-path
field modules, float32 activations). The fused-kernel trainer
(use_fused_kernels=True, bf16_activations=False) is reached through
`TrainingSession` with such a config. Prints one JSON line of metrics per
log step. The device is cuda unless --device names
another. Dataset configs and meshing are not ported yet (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from catnerf_torch.config import Config
from catnerf_torch.data.synthetic import make_scene
from catnerf_torch.train.loop import TrainingSession


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m catnerf_torch.train",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--synthetic", action="store_true",
                    help="train on the synthetic scene")
    ap.add_argument("--max-iter", type=int, default=200)
    ap.add_argument("--log-iter", type=int, default=50)
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
    scene = make_scene(n_frames=8, width=160, height=120, n_categories=3,
                       insts_per_cat=2, seed=cfg.seed)
    sess = TrainingSession(cfg, scene.inst_dict, scene.sample_dict,
                           cam=scene.cam, device=args.device)
    fast = not args.strict_parity
    if fast:
        sess.enable_fast_path(args.log_iter)
    t0 = time.time()
    while sess.iteration < args.max_iter:
        if fast:
            metrics = sess.run_fast(min(args.log_iter,
                                        args.max_iter - sess.iteration))
        else:
            metrics = sess.step_once()
        it = sess.iteration
        if it % args.log_iter == 0 or it == args.max_iter:
            row = sess.metrics_to_dict(metrics)
            row["elapsed_s"] = time.time() - t0
            row["device"] = str(sess.device)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
