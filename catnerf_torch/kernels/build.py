"""Build and load the port's CUDA kernels.

Each source under `catnerf_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use,
into `build/catnerf_torch/` of the checkout (cached by the hash of the
source, the headers beside it and the flags), and bound with ctypes.
`load_all` starts one `nvcc` per source, all at once. Nothing here runs
at import time: the CPU tests import every module on a machine with no
`nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "catnerf_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# source name -> (ctypes.CDLL, build log); one entry per built library
_LIBS: dict[str, tuple[ctypes.CDLL, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(source: Path) -> Path:
    data = b"".join(p.read_bytes()
                    for p in [source, *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(
        data + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def load_all(names) -> list[ctypes.CDLL]:
    """The ctypes libraries of csrc/<name>.cu for each name, building the
    missing ones with one nvcc process each, all running at once."""
    if all(name in _LIBS for name in names):  # the launch path: no hashing
        return [_LIBS[name][0] for name in names]
    builds = {}
    try:
        for name in names:
            if name in _LIBS or name in builds:
                continue
            source = CSRC / f"{name}.cu"
            target = _target(source)
            if target.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            # nvcc's output goes to a file, not a pipe that nobody drains
            # while another build is waited for
            out_file = tempfile.TemporaryFile("w+")
            proc = subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                stdout=out_file, stderr=subprocess.STDOUT, text=True)
            builds[name] = (source, target, tmp, proc, time.time(), out_file)
        logs = {}
        for name, (source, target, tmp, proc, t0, out_file) in builds.items():
            proc.wait()
            out_file.seek(0)
            out = out_file.read()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {source}:\n{out}")
            os.replace(tmp, target)
            logs[name] = (f"built {target.name} in {time.time() - t0:.1f} s"
                          f"\n{out}")
    finally:
        for _, _, tmp, proc, _, out_file in builds.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
            out_file.close()
    for name in names:
        if name not in _LIBS:
            target = _target(CSRC / f"{name}.cu")
            _LIBS[name] = (ctypes.CDLL(str(target)), logs.get(name, ""))
    return [_LIBS[name][0] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, building it if needed."""
    return load_all([name])[0]


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and spill report) of the build
    this process made, or '' when the library was already built."""
    return _LIBS[name][1] if name in _LIBS else ""
