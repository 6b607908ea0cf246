"""Seconds of the Replica loader's host stages, the JAX package's and the
port's, on the CPU: reading the frames, stage 1 (`get_all_poses`, with the
colours of the appearance tie-break) and the multi-init alignment
(`align_poses`) on the geometric coverage scores, for a layout of
`make_scene(n_frames=N, width=W, height=H, n_categories=3,
insts_per_cat=2, seed=1)` (chip_smoke.py phase 12's scene is 4 frames of
600 x 340). The device stages are left out: they are the card's, timed by
chip_smoke.py.

    JAX_PLATFORMS=cpu python tests/torch_registration_timing.py 1200 680 8
    JAX_PLATFORMS=cpu python tests/torch_registration_timing.py 600 340 4
"""

from __future__ import annotations

import copy
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from catnerf_torch.config import Config  # noqa: E402
from catnerf_torch.data import replica as treplica  # noqa: E402
from catnerf_torch.data.synthetic import make_scene  # noqa: E402
from catnerf_torch.geometry import registration as treg  # noqa: E402
from catnerf_tpu.config import Config as JConfig  # noqa: E402
from catnerf_tpu.data import replica as jreplica  # noqa: E402
from catnerf_tpu.geometry import registration as jreg  # noqa: E402


def host_stages(replica, reg, cfg) -> dict:
    out = {}
    t0 = time.time()
    data = replica.Replica(cfg, run_registration=False)
    out["frames"] = time.time() - t0
    inst = copy.deepcopy(data.inst_dict)
    t0 = time.time()
    reg.get_all_poses(inst, data.sample_dict, data.cam, want_color=True)
    out["stage1"] = time.time() - t0
    out["points"] = {int(o): len(i["pcs"]) for c, v in inst.items() if c
                     for o, i in v.items()}
    boxes, counts, fields = {}, {}, {}
    reg.get_uncertainty_fields(inst, boxes, counts, fields, cfg,
                               load_pretrained=False)  # coverage scores
    t0 = time.time()
    reg.align_poses(inst, boxes, counts, fields)
    out["align"] = time.time() - t0
    return out


def main() -> None:
    width, height, n_frames = map(int, sys.argv[1:4])
    scene = make_scene(n_frames=n_frames, width=width, height=height,
                       n_categories=3, insts_per_cat=2, seed=1)
    root = tempfile.mkdtemp(prefix="replica_timing_")
    treplica.write_replica_layout(scene, root, 1.0 / 1000.0)
    result = {"width": width, "height": height, "n_frames": n_frames}
    for name, cfg, replica, reg in (
            ("jax", JConfig(), jreplica, jreg),
            ("port", Config(), treplica, treg)):
        cfg.dataset_dir = root
        cfg.width, cfg.height = width, height
        cfg.fx = cfg.fy = scene.cam.fx
        cfg.cx, cfg.cy = scene.cam.cx, scene.cam.cy
        cfg.load_registration_result = False
        result[name] = host_stages(replica, reg, cfg)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
