"""Build and load the port's CUDA kernels.

Each source under `catnerf_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, at first use,
into `build/catnerf_torch/` of the checkout (cached by the source's
hash), and bound with ctypes. Nothing here runs at import time: the CPU
tests import every module on a machine with no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, building it if needed."""
    if name in _LIBS:
        return _LIBS[name][0]
    source = CSRC / f"{name}.cu"
    target = _target(source)
    log = ""
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.time()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}")
        os.replace(tmp, target)
        log = (f"built {target.name} in {time.time() - t0:.1f} s\n"
               f"{proc.stdout}")
    lib = ctypes.CDLL(str(target))
    _LIBS[name] = (lib, log)
    return lib


def build_log(name: str) -> str:
    """nvcc's output (with ptxas' register and spill report) of the build
    this process made, or '' when the library was already built."""
    return _LIBS[name][1] if name in _LIBS else ""
