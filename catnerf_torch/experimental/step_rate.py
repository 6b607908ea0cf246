"""Steps/s of the port's training paths on the card, for comparing two
checkouts of the repo in one call.

    python catnerf_torch/experimental/step_rate.py [--root DIR] [--steps N]

Imports `catnerf_torch` from DIR (default: the checkout that holds this
file), so that one copy of the script times an older checkout too (unpack
it with `git archive` under the ignored `build/`, then run the script with
`--root build/parent`). For each trainer the port runs (the fused float32
one on kernels 1-4, the strict-parity one and the default `Config()` one
with bf16 storage, both on the XLA path), on the bench scene of
`chip_smoke.py` at `Config()` widths: the host-staged step
(`TrainingSession.step_once`, what `python -m catnerf_torch.train
--strict-parity` runs), the fast path's eager loop (`run_fast` with
`graph=False`, or the plain loop of a checkout without the graph) and,
where the checkout has it, the fast path as a replayed CUDA graph (what
the training CLI runs on the card otherwise). Each after 5 warm-up steps,
then two runs of N steps each, in turns (a fast run is one
`run_fast(N)`). steps/s: the host clock around a window that begins and
ends with a device sync. Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

N_WARMUP = 5
N_INNER = 100


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from catnerf_torch.config import Config
    from catnerf_torch.data.synthetic import make_scene
    from catnerf_torch.train.loop import TrainingSession

    if not torch.cuda.is_available():
        print("step_rate: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0],
          flush=True)

    def fused():
        cfg = Config()
        cfg.use_fused_kernels = True
        cfg.bf16_activations = False
        return cfg

    trainers = {"fused": fused,
                "strict": lambda: Config().apply_strict_parity(),
                "default": Config}
    has_graph = "graph" in inspect.signature(
        TrainingSession.enable_fast_path).parameters
    scene = make_scene(n_frames=4, width=96, height=72, n_categories=8,
                       insts_per_cat=3, seed=0)

    def timed(run, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    def staged_run(sess):
        def run(n):
            for _ in range(n):
                sess.step_once()
        return run

    out = {"root": str(Path(args.root).resolve()), "steps": args.steps,
           "graph_api": has_graph}
    for name, make_cfg in trainers.items():
        staged = TrainingSession(make_cfg(), scene.inst_dict,
                                 scene.sample_dict, cam=scene.cam)
        runs = {"staged": (staged_run(staged), [])}
        for kind in ("fast_eager", "fast_graph") if has_graph else (
                "fast_eager",):
            fast = TrainingSession(make_cfg(), scene.inst_dict,
                                   scene.sample_dict, cam=scene.cam)
            fast.enable_fast_path(N_INNER, **({"graph": kind == "fast_graph"}
                                              if has_graph else {}))
            runs[kind] = (fast.run_fast, [])
        for run, _ in runs.values():
            timed(run, N_WARMUP)
        for kind in list(runs) * 2:
            run, rates = runs[kind]
            rates.append(timed(run, args.steps))
        out[name] = {k: v[1] for k, v in runs.items()}
        print(f"{name}: " + "; ".join(
            f"{k} " + ", ".join(f"{r:.2f}" for r in v[1])
            for k, v in runs.items()) + " steps/s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
