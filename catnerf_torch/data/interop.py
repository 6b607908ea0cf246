"""Tolerant reader for reference-preprocessed registration caches.

The reference pickles `inst_dict` to `<dataset>/inst_dict.pkl`
(ref: src/dataset.py:67-88) after deleting the point clouds; what remains
is frame_info (numpy), T_obj (numpy) and `bbox3D` values that are
open3d.geometry.OrientedBoundingBox objects (ref: src/utils.py:249-268).
Unpickling those requires open3d, which this framework does not depend on.

`load_reference_inst_dict` unpickles WITHOUT the reference's dependencies:
unimportable classes (open3d.*, torch storage, ...) resolve to recording
stubs, then a conversion pass maps OBB-like stubs to our OrientedBBox and
torch tensors to numpy. Anything unrecoverable becomes None, and
`repair_inst_dict` recomputes missing bounds from the frames themselves —
so a reference-preprocessed dataset drops in even when its pickled
geometry objects cannot be reconstructed bit-for-bit.

A copy of the JAX package's `data/interop.py`, which also reads the caches
that package writes: they name `catnerf_tpu.data.scene.OrientedBBox`.
Such names never reach the import machinery (importing them would load
the JAX package, and jax with it): the port's OrientedBBox stands in for
that class, and every other name of the JAX package (or of jax, jaxlib,
optax, flax) resolves to a stub.
"""

from __future__ import annotations

import io
import pickle

import numpy as np

from catnerf_torch.data.scene import OrientedBBox


class _Stub:
    """Records constructor args / setstate payloads of unresolvable
    pickled objects."""

    _module = _name = ""
    # class-level defaults: pickle NEWOBJ calls __new__ without __init__
    _args: tuple = ()
    _kw: dict = {}
    _state = None

    def __init__(self, *args, **kw):
        self._args, self._kw, self._state = args, kw, None

    def __setstate__(self, state):
        self._state = state

    def __call__(self, *args, **kw):  # stubbed module-level factory fns
        out = _Stub(*args, **kw)
        out._module, out._name = self._module, self._name
        return out


# classes of the JAX package that its caches hold, and their stand-ins
_PORTED = {("catnerf_tpu.data.scene", "OrientedBBox"): OrientedBBox}
# packages whose names are never imported while a cache is read
_NOT_IMPORTED = ("catnerf_tpu", "jax", "jaxlib", "optax", "flax")


def _stub(module: str, name: str) -> type:
    return type(f"Stub_{name}", (_Stub,), {"_module": module, "_name": name})


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _PORTED:
            return _PORTED[module, name]
        if module.split(".")[0] in _NOT_IMPORTED:
            return _stub(module, name)
        try:
            return super().find_class(module, name)
        except Exception:
            return _stub(module, name)


def _arrays_in(obj, out: list) -> None:
    if isinstance(obj, np.ndarray):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _arrays_in(v, out)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _arrays_in(v, out)
    elif isinstance(obj, _Stub):
        _arrays_in(obj._args, out)
        _arrays_in(obj._kw, out)
        _arrays_in(obj._state, out)


def _stub_to_obb(stub: _Stub) -> OrientedBBox | None:
    """Best-effort OrientedBoundingBox recovery from a stub's recorded
    state: named fields first, then shape heuristics (one (3,3) rotation,
    (3,) center + strictly-positive (3,) extent)."""
    named = {}
    for src in (stub._kw, stub._state):
        if isinstance(src, dict):
            for k in ("center", "R", "extent"):
                if k in src:
                    named[k] = np.asarray(src[k], np.float64)
    if {"center", "R", "extent"} <= set(named):
        return OrientedBBox(center=named["center"].reshape(3),
                            R=named["R"].reshape(3, 3),
                            extent=named["extent"].reshape(3))

    arrs: list[np.ndarray] = []
    _arrays_in(stub, arrs)
    arrs = [np.asarray(a, np.float64) for a in arrs]
    Rs = [a for a in arrs if a.shape == (3, 3)]
    vecs = [a.reshape(3) for a in arrs if a.size == 3]
    if not Rs or len(vecs) < 2:
        return None
    R = Rs[0]
    # attribute order in the reference's OBB is (center, R, extent);
    # extent must be strictly positive
    center, extent = None, None
    for v in vecs:
        if extent is None and (v > 0).all() and center is not None:
            extent = v
        elif center is None:
            center = v
    if center is None or extent is None:
        pos = [v for v in vecs if (v > 0).all()]
        if len(vecs) >= 2 and pos:
            extent = pos[-1]
            center = next(v for v in vecs if v is not extent)
        else:
            return None
    return OrientedBBox(center=center, R=R, extent=extent)


def _convert(obj):
    if isinstance(obj, _Stub):
        return _stub_to_obb(obj)
    if hasattr(obj, "detach"):  # torch tensor
        return np.asarray(obj.detach().cpu().numpy())
    if isinstance(obj, dict):
        return {k: _convert(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_convert(v) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_convert(v) for v in obj)
    return obj


def load_reference_inst_dict(path: str) -> dict:
    """Unpickle a reference (or our) inst_dict.pkl without open3d/torch
    availability; see module docstring."""
    with open(path, "rb") as f:
        raw = _TolerantUnpickler(io.BufferedReader(f)).load()
    return _convert(raw)


def repair_inst_dict(inst_dict: dict, sample_dict: dict, cam,
                     name: str = "replica") -> int:
    """Recompute bounds that did not survive cache conversion: accumulate
    the instance's cloud from frames and redo get_obb / get_bound (the same
    stage-1 math the cache was built from). Returns the number repaired."""
    from catnerf_torch.geometry.obb import get_bound, get_obb
    from catnerf_torch.geometry.pointcloud import accumulate_pointcloud

    repaired = 0
    for cls_id, inst_cls in inst_dict.items():
        if cls_id == 0:
            if inst_cls.get("bbox3D") is None and inst_cls.get("frame_info"):
                pcs = accumulate_pointcloud(0, inst_cls["frame_info"],
                                            sample_dict, cam)
                inst_cls["bbox3D"] = get_bound(pcs)
                repaired += 1
            continue
        for obj_id, info in inst_cls.items():
            if info.get("bbox3D") is not None or info.get("T_obj") is None:
                continue
            if not info.get("frame_info"):
                continue
            info["pcs"] = accumulate_pointcloud(obj_id, info["frame_info"],
                                                sample_dict, cam)
            get_obb(info)  # recomputes bbox3D + rescales T_obj
            info.pop("pcs", None)
            repaired += 1
    return repaired
