"""Processes, process groups and the ('data', 'model') device mesh.

The port's counterpart of the JAX package's `parallel/mesh.py` (the
reference is strictly single-device: SURVEY.md §2.2). The design scales
along the two axes the workload has:

  'data'  — the ray batch (data parallel); gradients all-reduce over it
  'model' — the category axis (expert parallel: each category's model is
            an expert with static routing)

JAX drives every device from one controller; the port runs one process
per GPU under torchrun, and its mesh is a torch DeviceMesh over those
processes (rank = d * n_model + m). NCCL carries CUDA tensors, gloo CPU
tensors; a second gloo group over every rank, `cpu_group()`, carries the
host-bound results of the sharded mesher and renders. The collectives the
parallel layer issues go through `all_reduce` and `all_gather`, which
tally their bytes when asked (`tally_collectives`).
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import sys

import torch
import torch.distributed as dist

from catnerf_torch.utils import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_CPU_GROUP = None
_DEVICE: torch.device | None = None
_TALLY: list | None = None


def init_distributed(device=None, *, backend: str | None = None,
                     init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None) -> torch.device:
    """Join the process group and return this process's device (cuda, the
    process's own card under torchrun, unless `device` names another).
    The backend is NCCL for a CUDA device and gloo for the CPU unless
    `backend` names one (gloo also carries CUDA tensors for all_reduce and
    broadcast). Rank, world size and rendezvous come from the arguments,
    else from torchrun's environment. A CUDA run without NCCL raises."""
    global _CPU_GROUP, _DEVICE
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA run needs NCCL, which this torch build "
                           "lacks")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw["init_method"] = init_method
        if world_size is not None:
            kw.update(world_size=world_size, rank=rank)
        dist.init_process_group(backend, **kw)
    _DEVICE = device
    _CPU_GROUP = (dist.group.WORLD if dist.get_backend() == "gloo"
                  else dist.new_group(backend="gloo"))
    return device


def shutdown() -> None:
    """Leave the process group (every rank)."""
    global _CPU_GROUP, _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _CPU_GROUP = _DEVICE = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, or no process group: the process that prints and writes."""
    return rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier(group=cpu_group())


def cpu_group():
    if _CPU_GROUP is None:
        raise RuntimeError("no process group: call "
                           "parallel.mesh.init_distributed() first")
    return _CPU_GROUP


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """('data', 'model') DeviceMesh over the processes; defaults to every
    process on 'data'. As in the JAX package, a bad n_model raises a
    ValueError; the mesh must also cover every process (one per GPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.mesh.init_distributed() first "
                           "(torchrun starts one process per GPU)")
    from torch.distributed.device_mesh import init_device_mesh

    n_total = dist.get_world_size()
    if n_model < 1:
        raise ValueError(f"n_model must be >= 1, got {n_model}")
    if n_data is None:
        if n_total % n_model != 0:
            raise ValueError(
                f"n_model={n_model} does not divide the {n_total} visible "
                f"devices; pick a divisor of {n_total} (e.g. "
                f"{[d for d in range(1, n_total + 1) if n_total % d == 0]})")
        n_data = n_total // n_model
    if n_data * n_model > n_total:
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"only {n_total} visible")
    if n_data * n_model < n_total:
        raise ValueError(
            f"mesh {n_data}x{n_model} covers {n_data * n_model} of the "
            f"{n_total} processes: start one process per device of the "
            f"mesh (torchrun --nproc-per-node {n_data * n_model})")
    return init_device_mesh(_DEVICE.type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def single_device_mesh():
    return make_mesh(n_data=1, n_model=1)


def cli_mesh(device, flag: str, n_model: int = 1):
    """The mesh a CLI's sharding flag asks for: under torchrun with more
    than one process, the process group joined (init_distributed) and
    make_mesh(n_model=n_model); with one process None, and the JAX
    package's message that it runs unsharded."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        print(f"{flag}: single device visible, running unsharded",
              file=sys.stderr)
        return None
    if not dist.is_initialized():
        init_distributed(device)
    return make_mesh(n_model=n_model)


def mesh_shape(mesh) -> tuple[int, int]:
    """(n_data, n_model)."""
    return mesh.size(0), mesh.size(1)


def coords(mesh) -> tuple[int, int]:
    """This process's (data, model) coordinates in the mesh."""
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tally_collectives():
    """Yields a list that collects (op, group size, bytes, shape) for each
    collective `all_reduce` / `all_gather` issue in the block: what this
    process hands to the collective, once per call."""
    global _TALLY
    outer, _TALLY = _TALLY, []
    try:
        yield _TALLY
    finally:
        _TALLY = outer


def _tally(op: str, t: torch.Tensor, group) -> None:
    if _TALLY is not None:
        _TALLY.append((op, dist.get_world_size(group),
                       t.numel() * t.element_size(), tuple(t.shape)))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` in place over `group` (every rank of it calls this)."""
    _tally("all_reduce", t, group)
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The group's `t`s concatenated along dim 0, in rank order, bitwise.
    Gloo gathers no CUDA tensor: there the gather goes through CPU
    copies."""
    _tally("all_gather", t, group)
    n = dist.get_world_size(group)
    via_cpu = t.is_cuda and dist.get_backend(group) == "gloo"
    x = t.detach().cpu() if via_cpu else t.detach().contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    out = torch.cat(out)
    return out.to(t.device) if via_cpu else out


def all_gather_objects(obj) -> list:
    """Every rank's picklable `obj`, in rank order, over the CPU group."""
    if _TALLY is not None:
        _TALLY.append(("all_gather_object", world_size(),
                       len(pickle.dumps(obj)), ()))
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=cpu_group())
    return out


def broadcast_object(obj, src: int = 0, group=None):
    """Rank `src`'s picklable `obj` on every rank, over `group` (a gloo
    group: by default the CPU group)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src,
                               group=cpu_group() if group is None else group)
    return box[0]


def new_cpu_group(timeout: datetime.timedelta):
    """A new gloo group over every rank whose collectives wait up to
    `timeout` (every rank calls this, in the same order)."""
    return dist.new_group(backend="gloo", timeout=timeout)
