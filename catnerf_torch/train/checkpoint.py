"""Checkpoint / resume, and the reference's per-category `.pth` format.

The port's counterpart of the JAX package's `train/checkpoint.py`. A
checkpoint is one `torch.save` file `<ckpt_dir>/<iteration>` holding the
whole train state: the `FieldParams` state dict, the AdamW state dict
(moments and the per-parameter step counts) and `TrainState.step`, every
tensor on the CPU. Restore is exact, every tensor bitwise, and works across
devices: a checkpoint written by a CUDA session loads into a CPU session
and the reverse, the optimizer state going onto the parameters' device and
each step count where torch's AdamW keeps it (on the device when the
optimizer is capturable, on the CPU when not).

A restore builds a new `TrainState` and leaves the one it was given as it
was (the JAX package's orbax restore returns a new state too). A session's
fast path captured before the restore reads the old tensors, so its
`run_fast` raises until `enable_fast_path` is called again.

Also the reference's per-category checkpoint schema (ref:
src/scene_cateogries.py:548-597): export, import (written into the
session's parameters in place, so a captured fast path stays valid and
trains from the imported values), and the pretrained vMAP OccupancyMap
converter (ref: src/category_registration.py:76-92).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from catnerf_torch.convert import tree_of
from catnerf_torch.data.scene import OrientedBBox
from catnerf_torch.parallel import mesh as pmesh
from catnerf_torch.train.state import TrainState, load_state, state_dict


def _cpu(x):
    """Every tensor in a state dict (nested dicts and lists) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_cpu(v) for v in x]
    return x


def save_checkpoint(ckpt_dir: str, state: TrainState, iteration: int,
                    shard=None) -> str:
    """Write <ckpt_dir>/<iteration> with the full train state; in a
    process group only rank 0 writes. On a sharded state (`shard`,
    parallel/sharding.py) every rank calls this: the category shards and
    their AdamW moments are gathered over 'model' and rank 0 writes the
    unsharded file before any rank returns. Every rank returns its
    path."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"{iteration}")
    if shard is None:
        raw = state_dict(state)
    else:
        from catnerf_torch.parallel import sharding

        raw = sharding.gather_state_dict(state, shard)
    if pmesh.is_main():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(_cpu(raw), tmp)
        os.replace(tmp, path)
    if shard is not None:
        pmesh.barrier()
    return path


def load_checkpoint(path: str, template: TrainState,
                    shard=None) -> TrainState:
    """A new TrainState restored from a file save_checkpoint wrote;
    `template` (an initialised state works) supplies the modules, the
    optimizer's groups and the device, and is left unchanged. With a
    `shard`, `template` is the rank's shard of a state, and the rank keeps
    its categories of the file's (unsharded) state."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if shard is not None:
        from catnerf_torch.parallel import sharding

        raw = sharding.shard_state_dict(raw, template.params, shard)
    return load_state(raw, template)


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps, key=int))


def save_session_checkpoint(ckpt_dir: str, session, iteration: int) -> str:
    """save_checkpoint of the session's state + an
    `<iteration>.adopted.json` sidecar recording instances written
    post-training by fit.adopt_instance, in adoption order (the JAX
    package's records: cls, id, extent, obj_tensor). Without the sidecar a
    restart loses adoptees entirely: the fresh session's code tables have
    neither their (possibly grown) shape nor their sim(3)/extent
    metadata. A sharded session (every rank calls this) writes the same
    sidecar, from rank 0."""
    path = save_checkpoint(ckpt_dir, session.state, iteration,
                           shard=getattr(session, "shard", None))
    if not pmesh.is_main():
        return path
    adopted = getattr(session, "adopted_instances", [])
    sidecar = f"{path}.adopted.json"
    if adopted:
        with open(sidecar, "w") as f:
            json.dump(adopted, f)
    elif os.path.exists(sidecar):
        # a stale sidecar from an earlier same-iteration save (e.g. the
        # ckpt dir was rolled back by hand) would re-grow the restored
        # session's code tables past the saved state's shapes
        os.remove(sidecar)
    return path


def restore_session_checkpoint(path: str, session) -> None:
    """Restore a session from a checkpoint saved by save_session_checkpoint
    (or plain save_checkpoint): re-applies any persisted adoption records
    to the freshly built session FIRST — growing its code tables (and the
    optimizer's moments, where it has any) and registering pose/extent
    metadata, so the template's shapes match the saved state — then loads
    the train state. The state is replaced (so a fast path enabled before
    must be enabled again) and the iteration set to the restored step. A
    sharded session (every rank calls this) keeps its categories of the
    file's state."""
    sidecar = f"{path}.adopted.json"
    if os.path.exists(sidecar):
        from catnerf_torch.fit import apply_adopted_record

        with open(sidecar) as f:
            for rec in json.load(f):
                apply_adopted_record(session, rec)
    session.state = load_checkpoint(path, session.state,
                                    shard=getattr(session, "shard", None))
    session.iteration = session.state.step


# ---------------------------------------------------------------------------
# Reference-format conversion
# ---------------------------------------------------------------------------

def _t2np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy())


def load_vmap_pth(path: str) -> dict[str, Any]:
    """Convert a pretrained vMAP per-object `.pth` checkpoint into the JAX
    package's parameter pytree, numpy leaves (ref format keys:
    FC_state_dict, PE_state_dict, obj_scale, bbox —
    src/category_registration.py:81-92); `convert.layers_from_jax` makes
    the port's modules of it.

    torch Linear weights are (out, in); ours are (in, out) — transposed here.
    """
    raw = torch.load(path, map_location="cpu", weights_only=False)
    fc_sd = raw["FC_state_dict"]
    pe_sd = raw["PE_state_dict"]

    # OccupancyMap layer graph (ref: src/model.py:86-122): the shared
    # converter infers the mid1/mid2 block COUNTS from the keys
    fc_params = occupancy_params_from_state_dict(fc_sd)

    pe_params = {"B": _t2np(pe_sd["B_layer.weight"])}
    out = {
        "fc": fc_params,
        "pe": pe_params,
        "obj_scale": float(np.asarray(pe_sd.get("scale", raw.get("obj_scale", 1.0)))),
    }
    if "bbox" in raw:
        out["bbox"] = np.asarray(raw["bbox"])
    return out


# ---------------------------------------------------------------------------
# Reference-format export: per-category .pth checkpoints with the exact key
# schema the reference writes (ref: src/scene_cateogries.py:548-571), so
# reference-side tooling can consume models trained here. Linear weights are
# transposed back to torch's (out, in).
# ---------------------------------------------------------------------------


def _torch_lin(t, p: dict) -> dict:
    return {"weight": t.tensor(np.asarray(p["w"]).T.copy()),
            "bias": t.tensor(np.asarray(p["b"]).copy())}


def _codenerf_state_dict(t, fc: dict) -> dict:
    """A CodeNeRF pytree ({"w", "b"} numpy leaves, one category) ->
    reference state_dict names (ref: src/model.py:36-54; Sequential wraps
    put Linear at index 0; encoding_shape is a bare Linear; rgb is
    Sequential(Linear,ReLU,Linear))."""
    sd = {}

    def put(prefix, p):
        for k, v in _torch_lin(t, p).items():
            sd[f"{prefix}.{k}"] = v

    put("encoding_xyz.0", fc["encoding_xyz"])
    # Reference block attrs are 1-indexed SINGULAR names set via setattr
    # (src/model.py:37-41,49-53): shape_latent_layer_1.0.weight etc.
    for j, p in enumerate(fc["shape_latent_layers"]):
        put(f"shape_latent_layer_{j + 1}.0", p)
    for j, p in enumerate(fc["shape_layers"]):
        put(f"shape_layer_{j + 1}.0", p)
    put("cat_layer.0", fc["cat_layer"])
    put("cat_latent_layer.0", fc["cat_latent_layer"])
    put("encoding_shape", fc["encoding_shape"])
    put("sigma.0", fc["sigma"])
    put("encoding_viewdir.0", fc["encoding_viewdir"])
    for j, p in enumerate(fc["texture_latent_layers"]):
        put(f"texture_latent_layer_{j + 1}.0", p)
    for j, p in enumerate(fc["texture_layers"]):
        put(f"texture_layer_{j + 1}.0", p)
    put("rgb.0", fc["rgb_0"])
    put("rgb.2", fc["rgb_1"])
    return sd


def _occupancy_state_dict(t, fc: dict) -> dict:
    """(ref: src/model.py:96-122; inverse of load_vmap_pth's mapping)."""
    sd = {}

    def put(prefix, p):
        for k, v in _torch_lin(t, p).items():
            sd[f"{prefix}.{k}"] = v

    put("in_layer.0", fc["in_layer"])
    for j, p in enumerate(fc["mid1"]):
        put(f"mid1.{j}.0", p)
    put("cat_layer.0", fc["cat_layer"])
    for j, p in enumerate(fc["mid2"]):
        put(f"mid2.{j}.0", p)
    put("out_alpha", fc["out_alpha"])
    if "color_linear" in fc:
        put("color_linear.0", fc["color_linear"])
        put("out_color", fc["out_color"])
    return sd


def export_reference_checkpoints(session, path: str, iteration: int) -> list[str]:
    """Write per-category reference-schema checkpoints
    `<path>/cls_<id>_iteration_<it>.pth` (+ cls_0 for the background),
    every tensor a CPU float32 one whatever the session's device. A
    sharded session's categories are gathered first (every rank calls
    this) and rank 0 writes.

    Schema parity (ref: src/scene_cateogries.py:548-571): for object
    categories `bound` holds the trainer's extent_dict ({obj_id: extent}),
    exactly as the reference writes it; the background's `bound` (an Open3D
    OBB object in the reference) is stored as a plain {center, R, extent}
    dict loadable without Open3D. The full OBBs are additionally exported
    under the extension key `obb_dict`.
    """
    if getattr(session, "shard", None) is not None:
        session.full_params()  # the gather, on every rank
        written = (_export_reference(session, path, iteration)
                   if pmesh.is_main() else None)
        return pmesh.broadcast_object(written)
    return _export_reference(session, path, iteration)


def _export_reference(session, path: str, iteration: int) -> list[str]:
    t = torch
    os.makedirs(path, exist_ok=True)
    written = []

    def bound_dict(b):
        return (None if b is None else
                {"center": np.asarray(b.center), "R": np.asarray(b.R),
                 "extent": np.asarray(b.extent)})

    for cls_id in session.cls_ids:
        cat = session.categories[session.cls_ids.index(cls_id)]
        p = session.category_params(cls_id)
        save = {
            "global_step": iteration,
            "PE_state_dict": {"B_layer.weight": t.tensor(
                _t2np(p["pe"].B).copy())},
            "FC_state_dict": _codenerf_state_dict(t, tree_of(p["fc"])),
            "cls_id": cls_id,
            "instance_id_to_index": dict(cat.inst_id_to_index),
            "obj_scale": float(session.cfg.obj_scale),
            "obj_tensor_dict": {k: t.tensor(np.asarray(v))
                                for k, v in cat.object_tensor_dict.items()},
            "shape_code_state_dict": {"weight": t.tensor(
                _t2np(p["shape_codes"]).copy())},
            "texture_code_state_dict": {"weight": t.tensor(
                _t2np(p["texture_codes"]).copy())},
            # ref stores bound = trainer.extent_dict for object categories
            "bound": {k: np.asarray(v) for k, v in cat.extent_dict.items()},
            "obb_dict": {k: bound_dict(v) for k, v in cat.bound_dict.items()},
        }
        if cat.n_obj > 1:
            save["extent_dict"] = {k: np.asarray(v)
                                   for k, v in cat.extent_dict.items()}
        f = os.path.join(path, f"cls_{cls_id}_iteration_{iteration:05d}.pth")
        t.save(save, f)
        written.append(f)

    if session.background is not None:
        bp = session.background_params()
        save = {
            "global_step": iteration,
            "PE_state_dict": {"B_layer.weight": t.tensor(
                _t2np(bp["pe"].B).copy())},
            "FC_state_dict": _occupancy_state_dict(t, tree_of(bp["fc"])),
            "cls_id": 0,
            "instance_id_to_index": {0: 0},
            "obj_scale": float(session.cfg.bg_scale),
            "bound": bound_dict(session.background.bound),
        }
        f = os.path.join(path, f"cls_0_iteration_{iteration:05d}.pth")
        t.save(save, f)
        written.append(f)
    return written


# ---------------------------------------------------------------------------
# Reference-format import: the inverse of export_reference_checkpoints.
# Loads reference-trained per-category `.pth` checkpoints (schema:
# src/scene_cateogries.py:548-597) into a TrainingSession's stacked params,
# so reference-trained weights can be meshed and evaluated through the port.
# ---------------------------------------------------------------------------


def _np(v) -> np.ndarray:
    """Tolerant tensor/array/list -> numpy (torch tensors included)."""
    if hasattr(v, "detach"):
        return np.asarray(v.detach().cpu().numpy())
    return np.asarray(v)


def codenerf_params_from_state_dict(fc_sd: dict) -> dict:
    """Reference CodeNeRF state_dict -> the JAX package's parameter pytree,
    numpy leaves (inverse of _codenerf_state_dict; layer names per
    src/model.py:30-54). Block counts are inferred from the keys, torch
    (out, in) weights transposed."""

    def lin(prefix: str) -> dict:
        return {"w": _np(fc_sd[f"{prefix}.weight"]).T.copy(),
                "b": _np(fc_sd[f"{prefix}.bias"]).copy()}

    def blocks(name: str) -> list:
        # Reference naming (src/model.py:37-41,49-53): 1-indexed singular
        # `<name>_<j+1>.0.*`. Older exports of the JAX package used a
        # plural 0-indexed `<name>s.<j>.0.*` — accepted as a fallback.
        out = []
        j = 0
        while f"{name}_{j + 1}.0.weight" in fc_sd:
            out.append(lin(f"{name}_{j + 1}.0"))
            j += 1
        if not out:
            while f"{name}s.{j}.0.weight" in fc_sd:
                out.append(lin(f"{name}s.{j}.0"))
                j += 1
        return out

    return {
        "encoding_xyz": lin("encoding_xyz.0"),
        "cat_layer": lin("cat_layer.0"),
        "cat_latent_layer": lin("cat_latent_layer.0"),
        "encoding_shape": lin("encoding_shape"),
        "sigma": lin("sigma.0"),
        "encoding_viewdir": lin("encoding_viewdir.0"),
        "rgb_0": lin("rgb.0"),
        "rgb_1": lin("rgb.2"),
        "shape_latent_layers": blocks("shape_latent_layer"),
        "shape_layers": blocks("shape_layer"),
        "texture_latent_layers": blocks("texture_latent_layer"),
        "texture_layers": blocks("texture_layer"),
    }


def occupancy_params_from_state_dict(fc_sd: dict) -> dict:
    """Reference OccupancyMap state_dict -> the JAX package's pytree
    (inverse of _occupancy_state_dict; src/model.py:86-122)."""

    def lin(prefix: str) -> dict:
        return {"w": _np(fc_sd[f"{prefix}.weight"]).T.copy(),
                "b": _np(fc_sd[f"{prefix}.bias"]).copy()}

    def blocks(name: str) -> list:
        out = []
        j = 0
        while f"{name}.{j}.0.weight" in fc_sd:
            out.append(lin(f"{name}.{j}.0"))
            j += 1
        return out

    params = {
        "in_layer": lin("in_layer.0"),
        "mid1": blocks("mid1"),
        "cat_layer": lin("cat_layer.0"),
        "mid2": blocks("mid2"),
        "out_alpha": lin("out_alpha"),
    }
    if "out_color.weight" in fc_sd:
        params["color_linear"] = lin("color_linear.0")
        params["out_color"] = lin("out_color")
    return params


def find_reference_checkpoints(path: str, iteration: int | None = None
                               ) -> dict[int, str]:
    """Map cls_id -> checkpoint file under `path`, picking the latest
    iteration (or the given one) per category. Filename convention:
    cls_<id>_iteration_<it>.pth (ref: src/scene_cateogries.py:549)."""
    found: dict[int, tuple[int, str]] = {}
    for fn in os.listdir(path):
        m = re.match(r"cls_(\d+)_iteration_(\d+)\.pth$", fn)
        if not m:
            continue
        cls_id, it = int(m.group(1)), int(m.group(2))
        if iteration is not None and it != iteration:
            continue
        if cls_id not in found or it > found[cls_id][0]:
            found[cls_id] = (it, os.path.join(path, fn))
    return {cls_id: fp for cls_id, (_, fp) in found.items()}


def _module_pairs(module: torch.nn.Module, tree, what: str) -> list:
    """(parameter, numpy array) for each {"w", "b"} leaf of `tree` against
    the same-named layers of `module` (one category's rows of a stacked
    module, or the background's), the layer lists of equal length."""
    if isinstance(module, torch.nn.ModuleList):
        if len(module) != len(tree):
            raise ValueError(f"{what}: {len(tree)} blocks in the checkpoint, "
                             f"{len(module)} in the session")
        return [pair for j, (m, t) in enumerate(zip(module, tree))
                for pair in _module_pairs(m, t, f"{what}[{j}]")]
    if hasattr(module, "w"):
        return [(module.w.detach(), tree["w"], f"{what}.w"),
                (module.b.detach(), tree["b"], f"{what}.b")]
    names = {name for name, _ in module.named_children()}
    if names != set(tree):
        raise ValueError(f"{what}: layers {sorted(tree)} in the checkpoint, "
                         f"{sorted(names)} in the session")
    return [pair for name, m in module.named_children()
            for pair in _module_pairs(m, tree[name], f"{what}.{name}")]


def import_reference_checkpoints(session, path: str,
                                 iteration: int | None = None) -> int:
    """Load reference-schema per-category checkpoints into `session`'s
    stacked params (PE basis, CodeNeRF/OccupancyMap weights, latent codes)
    and per-category metadata (object tensors, extents, bounds). The values
    are copied into the session's parameters in place, under no_grad, all
    shapes checked before the first copy; the optimizer's moments are left
    as they were. Returns the checkpoints' global_step."""
    if getattr(session, "shard", None) is not None:
        raise ValueError("import the reference checkpoints before "
                         "enable_fast_path(device_mesh=...) shards the "
                         "session")
    files = find_reference_checkpoints(path, iteration)
    if not files:
        raise FileNotFoundError(f"no cls_*_iteration_*.pth under {path}")

    params = session.state.params
    B, codes = params.cat_pe.B.detach(), params.codes
    shape_codes, texture_codes = codes.shape.detach(), codes.texture.detach()
    writes: list[tuple[torch.Tensor, np.ndarray, str]] = []
    global_step = 0

    def put(dest: torch.Tensor, src, what: str):
        src = np.asarray(src, np.float32)
        if tuple(dest.shape) != src.shape:
            raise ValueError(f"shape mismatch at {what}: session "
                             f"{tuple(dest.shape)} vs checkpoint {src.shape}")
        writes.append((dest, src, what))

    meta = []
    for i, cls_id in enumerate(session.cls_ids):
        if cls_id not in files:
            print(f"no reference checkpoint for cls {cls_id}; keeping "
                  f"current params")
            continue
        raw = torch.load(files[cls_id], map_location="cpu",
                         weights_only=False)
        global_step = max(global_step, int(raw.get("global_step", 0)))
        cat = session.categories[i]

        put(B[i], _np(raw["PE_state_dict"]["B_layer.weight"]),
            f"cat_pe[{i}].B")
        fc = codenerf_params_from_state_dict(raw["FC_state_dict"])
        for dest, src, what in _module_pairs(params.cat_fc, fc,
                                             f"cat_fc[{i}]"):
            put(dest[i], src, what)

        # Latent codes: remap checkpoint rows -> session slots by obj_id.
        ck_map = {int(k): int(v)
                  for k, v in raw["instance_id_to_index"].items()}
        sc = _np(raw["shape_code_state_dict"]["weight"])
        tc = _np(raw["texture_code_state_dict"]["weight"])
        for obj_id, slot in cat.inst_id_to_index.items():
            if obj_id not in ck_map:
                print(f"cls {cls_id}: obj {obj_id} missing from checkpoint")
                continue
            put(shape_codes[i, slot], sc[ck_map[obj_id]],
                f"codes.shape[{i}, {slot}]")
            put(texture_codes[i, slot], tc[ck_map[obj_id]],
                f"codes.texture[{i}, {slot}]")
        meta.append((cat, raw))

    bg_bound = None
    if session.background is not None and 0 in files:
        raw = torch.load(files[0], map_location="cpu", weights_only=False)
        global_step = max(global_step, int(raw.get("global_step", 0)))
        put(params.bg_pe.B.detach(), _np(raw["PE_state_dict"]["B_layer.weight"]),
            "bg_pe.B")
        fc = occupancy_params_from_state_dict(raw["FC_state_dict"])
        for dest, src, what in _module_pairs(params.bg_fc, fc, "bg_fc"):
            put(dest, src, what)
        b = raw.get("bound")
        if isinstance(b, dict) and "center" in b:
            bg_bound = OrientedBBox(center=_np(b["center"]), R=_np(b["R"]),
                                    extent=_np(b["extent"]))

    with torch.no_grad():
        for dest, src, _ in writes:
            dest.copy_(torch.from_numpy(src))

    # Per-category metadata used by meshing/eval.
    for cat, raw in meta:
        if "obj_tensor_dict" in raw:
            cat.object_tensor_dict = {
                int(k): _np(v) for k, v in raw["obj_tensor_dict"].items()}
        if "extent_dict" in raw:
            cat.extent_dict = {int(k): _np(v)
                               for k, v in raw["extent_dict"].items()}
        elif isinstance(raw.get("bound"), dict) and raw["bound"] and \
                not any(isinstance(v, dict) for v in raw["bound"].values()):
            # single-instance categories: ref stores bound = extent_dict
            cat.extent_dict = {int(k): _np(v)
                               for k, v in raw["bound"].items()}
        if "obb_dict" in raw:  # the extension key: full OBBs
            cat.bound_dict = {
                int(k): (None if v is None else OrientedBBox(
                    center=_np(v["center"]), R=_np(v["R"]),
                    extent=_np(v["extent"])))
                for k, v in raw["obb_dict"].items()}
    if bg_bound is not None:
        session.background.bound = bg_bound
    return global_step
