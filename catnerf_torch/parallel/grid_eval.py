"""Multi-process grid and field evaluation: data parallel over tiles.

The port's counterpart of the JAX package's `parallel/grid_eval.py`.
Mesh extraction and the evaluation CLIs push millions of points through
the trained fields (the reference: a single-GPU 500k-point chunk loop,
ref: src/trainer.py:125-151). The work is embarrassingly parallel over
points, with no category structure and no reduction across points, so
the tiles are spread over every process of the mesh (its 'data' and
'model' axes together): tile i to rank i mod the process count.

Each rank evaluates the unsharded path's own tiles, at their own shapes
(`mesher/meshing.py`: `_tile_plan`'s tiles for eval_points, the
`chunk`-long slabs of the grid with their carving): on the card a GEMM's
rounding can depend on its row count, so re-chunking would change bits.
Only the uint8 occupancies, the seen masks and the colours cross, over
the CPU group, and every rank assembles them in tile order: the output is
bitwise the unsharded path's. The parameters come in whole on every rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from catnerf_torch.config import Config
from catnerf_torch.mesher import meshing
from catnerf_torch.parallel.mesh import all_gather_objects


def _mine(device_mesh):
    """pick(i): whether tile i is this rank's."""
    n, r = device_mesh.size(), device_mesh.get_rank()
    return lambda i: i % n == r


def _in_order(parts: list, device_mesh) -> list:
    """Every rank's list of tile results (this rank's `parts`, in its
    tiles' order), merged into tile order on every rank."""
    per_rank = all_gather_objects(parts)
    n = device_mesh.size()
    total = sum(len(p) for p in per_rank)
    return [per_rank[i % n][i // n] for i in range(total)]


@torch.no_grad()
def eval_points_sharded(points: np.ndarray, params: dict, cfg: Config,
                        device_mesh, shape_code=None, texture_code=None, *,
                        is_background: bool, chunk: int = 262144,
                        want_color: bool = True, want_occ: bool = True,
                        color_u8: bool = False):
    """The sharded counterpart of `meshing.eval_points` (same arguments,
    same result, bitwise): every rank calls it and gets (occ, color)."""
    n = len(points)
    parts = meshing._eval_tiles(
        points, params, cfg, shape_code, texture_code,
        is_background=is_background, chunk=chunk, want_color=want_color,
        color_u8=color_u8, pick=_mine(device_mesh))
    host = [(o[:m].cpu().numpy() if want_occ else None,
             r[:m].cpu().numpy() if want_color else None)
            for m, o, r in parts]
    tiles = _in_order(host, device_mesh)
    occ = np.concatenate([o for o, _ in tiles])[:n] if want_occ else None
    rgb = np.concatenate([r for _, r in tiles])[:n] if want_color else None
    return occ, rgb


def grid_occ_seen_sharded(params, cfg, shape_code, texture_code, *,
                          grid_dim, scale_np, transform_np, world_transform,
                          carve, is_background, voxel_w, chunk,
                          device_mesh):
    """The sharded counterpart of `meshing._grid_occ_seen`: the grid's
    slabs spread over the mesh's processes, carving on the card, the
    uint8 occupancy and seen mask gathered; every rank gets (occ,
    seen_empty), bitwise the unsharded ones."""
    t0 = time.time()
    outs = meshing._grid_slabs(
        params, cfg, shape_code, texture_code, grid_dim=grid_dim,
        scale_np=scale_np, transform_np=transform_np,
        world_transform=world_transform, carve=carve,
        is_background=is_background, voxel_w=voxel_w, chunk=chunk,
        pick=_mine(device_mesh))
    host = [(o.cpu().numpy(), s.cpu().numpy() if carve is not None else None)
            for o, s in outs]
    slabs = _in_order(host, device_mesh)
    occ = np.concatenate([o for o, _ in slabs]).astype(np.float32) / 255.0
    seen_empty = (np.concatenate([s for _, s in slabs])
                  if carve is not None else None)
    meshing._grid_timing(grid_dim, is_background, carve, t0)
    return occ, seen_empty
