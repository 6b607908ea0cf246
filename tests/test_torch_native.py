"""The port's copy of the C++ geometry library (`catnerf_torch/native/`)
against the JAX package's: the same sources, byte for byte, built by the
port's own loader, and every binding the mesher and the metrics use giving
identical outputs on the same inputs through both libraries."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import pytest

from catnerf_torch.native import lib as tlib
from catnerf_tpu.native import lib as jlib

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("geomlib.cpp", "registration.cpp", "tsdf.cpp", "mc_table.h")


@pytest.mark.parametrize("name", SOURCES)
def test_sources_equal_the_jax_packages_byte_for_byte(name):
    ours = (ROOT / "catnerf_torch/native/src" / name).read_bytes()
    theirs = (ROOT / "catnerf_tpu/native/src" / name).read_bytes()
    assert hashlib.sha256(ours).hexdigest() == \
        hashlib.sha256(theirs).hexdigest()


# the port's own sources beside the copies: the PNG reader's row filters
# and the JPEG codec
OWN_SOURCES = ("png.cpp", "jpeg.cpp")


def test_the_sources_are_all_there_and_all_built():
    every = SOURCES + OWN_SOURCES
    assert sorted(p.name for p in (ROOT / "catnerf_torch/native/src")
                  .iterdir()) == sorted(every)
    assert sorted(tlib.SOURCES) == sorted(s for s in every
                                          if s.endswith(".cpp"))


def _grid(seed, shape=(24, 20, 28)):
    rng = np.random.default_rng(seed)
    t = [np.linspace(-1, 1, n) for n in shape]
    X, Y, Z = np.meshgrid(*t, indexing="ij")
    d = np.sqrt(X**2 + (1.2 * Y)**2 + Z**2)
    occ = 1.0 / (1.0 + np.exp((d - 0.6) * 12.0))
    return (occ + 0.05 * rng.standard_normal(occ.shape)).astype(np.float32)


def _points(seed, n=3000):
    return np.random.default_rng(seed).normal(0, 0.5, (n, 3)).astype(
        np.float32)


def _case_mc(g, method):
    return g.marching_cubes(_grid(0), 0.5, method=method)


def _case_cavity(g, with_free):
    occ = _grid(1)
    free = (_grid(2) > 0.7) if with_free else None
    return g.interior_cavity_mask(occ > 0.5, free, min_blocked=4)


def _case_query(g):
    return g.KDTree(_points(3)).query(_points(4, 2000))


def _case_radius(g):
    return g.KDTree(_points(5)).radius_counts(_points(6, 1000), 0.1)


def _case_voxel(g):
    return g.voxel_downsample(_points(7, 5000), 0.05)


CASES = {
    "marching_cubes_mc": lambda g: _case_mc(g, "mc"),
    "marching_cubes_tetra": lambda g: _case_mc(g, "tetra"),
    "interior_cavity_mask": lambda g: _case_cavity(g, False),
    "interior_cavity_mask_observed_free": lambda g: _case_cavity(g, True),
    "kdtree_query": _case_query,
    "kdtree_radius_counts": _case_radius,
    "voxel_downsample": _case_voxel,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_binding_outputs_equal_the_jax_packages(case):
    ours = CASES[case](tlib.geomlib)
    theirs = CASES[case](jlib.geomlib)
    ours = ours if isinstance(ours, tuple) else (ours,)
    theirs = theirs if isinstance(theirs, tuple) else (theirs,)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours[0].size > 0


def test_the_library_is_built_under_build_keyed_by_its_inputs():
    tlib._load()
    path = tlib.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "catnerf_torch" / "native"
    assert path.name.startswith("libgeom_") and path.suffix == ".so"


def test_a_missing_compiler_raises_naming_it(monkeypatch, tmp_path):
    """With no library built and no compiler, the loader raises and names
    the compiler it looked for; it builds nothing and falls back to
    nothing."""
    monkeypatch.setattr(tlib, "_lib", None)
    monkeypatch.setattr(tlib, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "no-such-cxx-compiler")
    with pytest.raises(RuntimeError, match="no-such-cxx-compiler"):
        tlib._load()
    assert not list(tmp_path.glob("*.so"))


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch,
                                                         tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in SOURCES:
        (src / name).write_text("this is not C++\n")
    monkeypatch.setattr(tlib, "_lib", None)
    monkeypatch.setattr(tlib, "SRC_DIR", src)
    monkeypatch.setattr(tlib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed(.|\n)*"
                       "error"):
        tlib._load()
