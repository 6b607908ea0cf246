"""ctypes bindings for the C++ geometry library (marching cubes, the
KD-tree, point-cloud operations, registration solvers, TSDF fusion), the
PNG reader's row unfiltering and the JPEG codec.

The geometry sources under `src/` are byte-for-byte copies of the JAX
package's `native/src/`, and their bindings below are its
`native/lib.py`'s; `src/png.cpp` and `src/jpeg.cpp` are the port's own
(the JAX package reads PNG and JPEG files with OpenCV). The library is
built at first use, never at import: `g++` (or `$CXX`) with the JAX
package's Makefile flags compiles the five sources into one
shared library under `build/catnerf_torch/native/` of the checkout, named
by the hash of the sources and the flags, so an edit rebuilds and a
library built on another machine is never loaded. A cross-process `flock`
is held around the build and the `dlopen`. A build that fails raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent / "src"
SOURCES = ("geomlib.cpp", "registration.cpp", "tsdf.cpp", "png.cpp",
           "jpeg.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "catnerf_torch" \
    / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
_LOCK = threading.Lock()
_lib = None
#: seconds of the build this process made (None: found already built)
BUILD_SECONDS: float | None = None


def cxx_path() -> str:
    """The C++ compiler: $CXX, else g++ (the host compiler nvcc uses)."""
    name = os.environ.get("CXX") or "g++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"C++ compiler {name!r} not found: the geometry "
                           f"library builds with it (set CXX)")
    return found


def _cpu_key() -> bytes:
    """What -march=native compiles for: the CPU's model and flags."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep))) or os.uname().machine.encode()


def library_path() -> Path:
    """The library's file for these sources, these flags and this CPU (a
    library built for another CPU is never loaded)."""
    h = hashlib.sha256()
    for name in sorted(p.name for p in SRC_DIR.iterdir()):
        h.update(name.encode() + (SRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_key())
    return BUILD_DIR / f"libgeom_{h.hexdigest()[:12]}.so"


def _build(target: Path) -> float:
    import time

    t0 = time.time()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx_path(), *CXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)
    return time.time() - t0


def _load() -> ctypes.CDLL:
    global _lib, BUILD_SECONDS
    with _LOCK:
        if _lib is not None:
            return _lib
        import fcntl

        target = library_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # cross-process exclusion: two processes must not build at once,
        # nor dlopen a library another process is still writing
        with open(BUILD_DIR / ".build.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if not target.exists():
                    BUILD_SECONDS = _build(target)
                lib = ctypes.CDLL(str(target))
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

        c_fp = ctypes.POINTER(ctypes.c_float)
        c_ip = ctypes.POINTER(ctypes.c_int)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)

        lib.geom_free.argtypes = [ctypes.c_void_p]
        lib.geom_free.restype = None

        lib.interior_cavity_mask.argtypes = [
            c_u8p, c_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, c_u8p]
        lib.interior_cavity_mask.restype = None
        lib.marching_tetrahedra.argtypes = [
            c_fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(c_fp), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(c_ip), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.marching_tetrahedra.restype = ctypes.c_int

        lib.marching_cubes_classic.argtypes = lib.marching_tetrahedra.argtypes
        lib.marching_cubes_classic.restype = ctypes.c_int

        lib.kd_build.argtypes = [c_fp, ctypes.c_int]
        lib.kd_build.restype = ctypes.c_void_p
        lib.kd_destroy.argtypes = [ctypes.c_void_p]
        lib.kd_query_nn.argtypes = [ctypes.c_void_p, c_fp, ctypes.c_int,
                                    c_ip, c_fp]
        lib.kd_query_radius_count.argtypes = [
            ctypes.c_void_p, c_fp, ctypes.c_int, ctypes.c_float, c_ip]

        lib.voxel_downsample.argtypes = [
            c_fp, ctypes.c_int, ctypes.c_float, ctypes.POINTER(c_fp),
            ctypes.POINTER(ctypes.c_int64)]
        lib.voxel_downsample.restype = ctypes.c_int

        lib.radius_outlier_mask.argtypes = [
            c_fp, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]

        lib.estimate_normals.argtypes = [c_fp, ctypes.c_int, ctypes.c_float,
                                         ctypes.c_int, c_fp]
        lib.compute_fpfh.argtypes = [c_fp, c_fp, ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, c_fp]

        lib.icp_point_to_point.argtypes = [
            c_fp, ctypes.c_int, c_fp, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
        lib.icp_point_to_point.restype = ctypes.c_int

        lib.max_clique_inliers.argtypes = [c_fp, c_fp, ctypes.c_int,
                                           ctypes.c_float, c_ip]
        lib.max_clique_inliers.restype = ctypes.c_int

        lib.max_clique_graph.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                         ctypes.c_int, c_ip]
        lib.max_clique_graph.restype = ctypes.c_int

        lib.gnc_tls_solve.argtypes = [
            c_fp, c_fp, ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8)]
        lib.gnc_tls_solve.restype = ctypes.c_int

        lib.tsdf_create.argtypes = [ctypes.c_float, ctypes.c_float]
        lib.tsdf_create.restype = ctypes.c_void_p
        lib.tsdf_destroy.argtypes = [ctypes.c_void_p]
        lib.tsdf_integrate.argtypes = [
            ctypes.c_void_p, c_fp, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_double),
            ctypes.c_float]
        lib.tsdf_extract_points.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(c_fp), ctypes.POINTER(c_fp)]
        lib.tsdf_extract_points.restype = ctypes.c_int64

        lib.png_unfilter.argtypes = [c_u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, c_u8p]
        lib.png_unfilter.restype = ctypes.c_int64

        lib.jpeg_last_error.argtypes = []
        lib.jpeg_last_error.restype = ctypes.c_char_p
        lib.jpeg_info.argtypes = [c_u8p, ctypes.c_int64, c_ip, c_ip, c_ip]
        lib.jpeg_info.restype = ctypes.c_int
        lib.jpeg_decode_bgr.argtypes = [c_u8p, ctypes.c_int64, c_u8p,
                                        ctypes.c_int, ctypes.c_int]
        lib.jpeg_decode_bgr.restype = ctypes.c_int
        lib.jpeg_encode.argtypes = [c_u8p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
        lib.jpeg_encode.restype = ctypes.c_int64
        lib.jpeg_encoded.argtypes = [c_u8p]
        lib.jpeg_encoded.restype = None

        _lib = lib
        return lib


def _as_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class geomlib:
    """Static namespace over the C ABI."""

    @staticmethod
    def interior_cavity_mask(solid: np.ndarray,
                             observed_free: np.ndarray | None = None,
                             min_blocked: int = 4) -> np.ndarray:
        """Cavity mask for the mesher's interior fill: empty voxels that
        are either holes (not border-connected through empty space,
        scipy binary_fill_holes semantics, 6-connectivity) or blocked by
        solid in >= min_blocked of the 6 axis directions, minus
        observed_free. solid: (nx, ny, nz) bool/uint8. ~50x the
        scipy+numpy recipe at 256^3 (single-core box)."""
        lib = _load()
        s = np.ascontiguousarray(solid, dtype=np.uint8)
        nx, ny, nz = s.shape
        cavity = np.empty_like(s)
        if observed_free is not None:
            of = np.ascontiguousarray(observed_free, dtype=np.uint8)
            of_ptr = of.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        else:
            of_ptr = None
        lib.interior_cavity_mask(
            s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), of_ptr,
            nx, ny, nz, min_blocked,
            cavity.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return cavity.astype(bool)

    # -------------------------------------------------- PNG rows
    @staticmethod
    def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
        """(H, 1 + row_bytes) uint8 rows of a PNG's inflated image data,
        each led by its filter type -> (H, row_bytes) uint8 with the
        filters undone. Raises ValueError on a filter type above 4."""
        r = np.ascontiguousarray(rows, dtype=np.uint8)
        if r.ndim != 2 or r.shape[1] < 2 or bpp < 1:
            raise ValueError(f"PNG rows of shape {r.shape} with {bpp} bytes "
                             f"a pixel")
        lib = _load()
        out = np.empty((r.shape[0], r.shape[1] - 1), np.uint8)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        bad = lib.png_unfilter(r.ctypes.data_as(u8), r.shape[0],
                               r.shape[1] - 1, bpp, out.ctypes.data_as(u8))
        if bad >= 0:
            raise ValueError(f"unknown row filter {int(r[bad, 0])} in row "
                             f"{bad}")
        return out

    # -------------------------------------------------- JPEG
    @staticmethod
    def jpeg_decode(data: bytes) -> np.ndarray:
        """A JPEG file's bytes -> (H, W, 3) uint8 in BGR order (a grey
        file's samples in all three). Raises ValueError with the decoder's
        message on a file it does not take."""
        lib = _load()
        buf = np.frombuffer(data, np.uint8)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        if lib.jpeg_info(buf.ctypes.data_as(u8), len(buf), ctypes.byref(w),
                         ctypes.byref(h), ctypes.byref(c)):
            raise ValueError(lib.jpeg_last_error().decode())
        out = np.empty((h.value, w.value, 3), np.uint8)
        if lib.jpeg_decode_bgr(buf.ctypes.data_as(u8), len(buf),
                               out.ctypes.data_as(u8), w.value, h.value):
            raise ValueError(lib.jpeg_last_error().decode())
        return out

    @staticmethod
    def jpeg_encode(img: np.ndarray, quality: int) -> bytes:
        """(H, W, 3) BGR uint8 -> the bytes of a baseline JPEG file
        (YCbCr 4:2:0) at `quality` (1-100)."""
        lib = _load()
        a = np.ascontiguousarray(img, dtype=np.uint8)
        if a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"cannot encode an image of shape {a.shape} "
                             f"(BGR only)")
        u8 = ctypes.POINTER(ctypes.c_uint8)
        n = lib.jpeg_encode(a.ctypes.data_as(u8), a.shape[1], a.shape[0],
                            int(quality))
        if n < 0:
            raise ValueError(lib.jpeg_last_error().decode())
        out = np.empty(n, np.uint8)
        lib.jpeg_encoded(out.ctypes.data_as(u8))
        return out.tobytes()

    # -------------------------------------------------- marching cubes
    @staticmethod
    def marching_cubes(grid: np.ndarray, level: float = 0.5,
                       method: str = "mc"):
        """(nx, ny, nz) scalar field -> (verts (n,3) float32 in grid-index
        units, tris (m,3) int32), or None when no surface crosses `level`
        (matching the reference's None-on-failure contract,
        ref: src/vis.py:6-19).

        method="mc" (default): table-driven classic marching cubes — the
        reference's skimage.measure.marching_cubes vertex set exactly
        (sign-change cube edges, linear interpolation; ref: src/vis.py:8-9),
        crack-free table generated by scripts/gen_mc_table.py.
        method="tetra": the 6-tetrahedra decomposition (~2x triangles,
        extra vertices on cell diagonals; kept for A/B)."""
        lib = _load()
        g = _as_f32(grid)
        nx, ny, nz = g.shape
        vp = ctypes.POINTER(ctypes.c_float)()
        tp = ctypes.POINTER(ctypes.c_int)()
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        fn = (lib.marching_cubes_classic if method == "mc"
              else lib.marching_tetrahedra)
        rc = fn(_fp(g), nx, ny, nz, level,
                ctypes.byref(vp), ctypes.byref(nv),
                ctypes.byref(tp), ctypes.byref(nt))
        if rc != 0 or nv.value == 0 or nt.value == 0:
            for p in (vp, tp):
                if p:
                    lib.geom_free(p)
            return None
        verts = np.ctypeslib.as_array(vp, shape=(nv.value, 3)).copy()
        tris = np.ctypeslib.as_array(tp, shape=(nt.value, 3)).copy()
        lib.geom_free(vp)
        lib.geom_free(tp)
        return verts, tris

    # -------------------------------------------------- KD-tree
    class KDTree:
        """Replaces scipy cKDTree for 3D NN queries
        (ref: metric/metrics.py:10-28)."""

        def __init__(self, points: np.ndarray):
            self._lib = _load()
            self._pts = _as_f32(points)
            assert self._pts.ndim == 2 and self._pts.shape[1] == 3
            if len(self._pts) == 0:
                # querying an empty tree would return idx=-1 (which numpy
                # fancy-indexing silently wraps) and dist~1.8e19 — a
                # silent-garbage contract; scipy's cKDTree equivalent
                # raises on use, so fail loudly at build
                raise ValueError("KDTree: empty point set")
            self._h = self._lib.kd_build(_fp(self._pts), len(self._pts))

        def query(self, queries: np.ndarray):
            q = _as_f32(queries)
            n = len(q)
            idx = np.empty(n, np.int32)
            dist = np.empty(n, np.float32)
            self._lib.kd_query_nn(
                self._h, _fp(q), n,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _fp(dist))
            return dist, idx

        def radius_counts(self, queries: np.ndarray, radius: float):
            q = _as_f32(queries)
            n = len(q)
            counts = np.empty(n, np.int32)
            self._lib.kd_query_radius_count(
                self._h, _fp(q), n, radius,
                counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
            return counts

        def __del__(self):
            if getattr(self, "_h", None):
                self._lib.kd_destroy(self._h)
                self._h = None

    # -------------------------------------------------- point cloud ops
    @staticmethod
    def voxel_downsample(points: np.ndarray, voxel: float) -> np.ndarray:
        """Centroid-per-voxel downsample (Open3D semantics,
        ref: src/utils.py:209)."""
        lib = _load()
        p = _as_f32(points)
        out = ctypes.POINTER(ctypes.c_float)()
        n_out = ctypes.c_int64()
        rc = lib.voxel_downsample(_fp(p), len(p), voxel, ctypes.byref(out),
                                  ctypes.byref(n_out))
        assert rc == 0
        pts = np.ctypeslib.as_array(out, shape=(n_out.value, 3)).copy()
        lib.geom_free(out)
        return pts

    @staticmethod
    def remove_radius_outliers(points: np.ndarray, nb_points: int,
                               radius: float):
        """(kept_points, keep_mask) (ref: src/utils.py:241)."""
        lib = _load()
        p = _as_f32(points)
        keep = np.empty(len(p), np.uint8)
        lib.radius_outlier_mask(
            _fp(p), len(p), radius, nb_points,
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        mask = keep.astype(bool)
        return p[mask], mask

    @staticmethod
    def estimate_normals(points: np.ndarray, radius: float = 0.1,
                         max_nn: int = 100) -> np.ndarray:
        lib = _load()
        p = _as_f32(points)
        normals = np.empty_like(p)
        lib.estimate_normals(_fp(p), len(p), radius, max_nn, _fp(normals))
        return normals

    @staticmethod
    def compute_fpfh(points: np.ndarray, normals: np.ndarray, radius: float,
                     max_nn: int = 100) -> np.ndarray:
        lib = _load()
        p = _as_f32(points)
        nrm = _as_f32(normals)
        out = np.empty((len(p), 33), np.float32)
        lib.compute_fpfh(_fp(p), _fp(nrm), len(p), radius, max_nn, _fp(out))
        return out

    # -------------------------------------------------- registration
    @staticmethod
    def icp(src: np.ndarray, dst: np.ndarray, max_corr_dist: float,
            init: np.ndarray | None = None, max_iter: int = 100):
        """Point-to-point ICP. Returns (T 4x4, fitness, rmse)."""
        lib = _load()
        s = _as_f32(src)
        d = _as_f32(dst)
        # always copy: the C side writes the result into this buffer, and
        # np.ascontiguousarray would alias an already-contiguous float64
        # init, mutating the CALLER's matrix (which broke teaser.py's
        # restore-pre-ICP-pose fallback on degenerate solves)
        T = np.array(init if init is not None else np.eye(4),
                     dtype=np.float64, order="C", copy=True)
        fitness = ctypes.c_double(0)
        rmse = ctypes.c_double(0)
        lib.icp_point_to_point(
            _fp(s), len(s), _fp(d), len(d), max_corr_dist, max_iter,
            T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.byref(fitness), ctypes.byref(rmse))
        return T, fitness.value, rmse.value

    @staticmethod
    def max_clique(src_corr: np.ndarray, dst_corr: np.ndarray,
                   noise_bound: float) -> np.ndarray:
        """Indices of the consistency-graph max clique (TEASER inlier
        selection, ref: helpers.py:62-64)."""
        lib = _load()
        a = _as_f32(src_corr)
        b = _as_f32(dst_corr)
        out = np.empty(len(a), np.int32)
        n = lib.max_clique_inliers(
            _fp(a), _fp(b), len(a), noise_bound,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out[:n].copy()

    @staticmethod
    def max_clique_graph(adj: np.ndarray) -> np.ndarray:
        """EXACT max clique over a dense (n, n) bool/uint8 adjacency matrix
        (branch & bound with coloring bounds; parity target: the PMC exact
        solver TEASER uses, ref: helpers.py:62-64)."""
        lib = _load()
        a = np.ascontiguousarray(adj, dtype=np.uint8)
        assert a.ndim == 2 and a.shape[0] == a.shape[1]
        n = a.shape[0]
        out = np.empty(max(n, 1), np.int32)
        k = lib.max_clique_graph(
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out[:k].copy()

    @staticmethod
    def gnc_tls(src_corr: np.ndarray, dst_corr: np.ndarray,
                noise_bound: float):
        """GNC-TLS rigid solve dst ~ R src + t. Returns (T 4x4, inlier_mask)
        or (None, None) on degenerate input."""
        lib = _load()
        a = _as_f32(src_corr)
        b = _as_f32(dst_corr)
        T = np.zeros((4, 4), np.float64)
        mask = np.zeros(len(a), np.uint8)
        rc = lib.gnc_tls_solve(
            _fp(a), _fp(b), len(a), noise_bound,
            T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            return None, None
        return T, mask.astype(bool)

    # -------------------------------------------------- TSDF
    class TSDFVolume:
        """Replaces Open3D ScalableTSDFVolume (ref: src/utils.py:212-247)."""

        def __init__(self, voxel_length: float, sdf_trunc: float):
            self._lib = _load()
            self._h = self._lib.tsdf_create(voxel_length, sdf_trunc)

        def integrate(self, depth_wh: np.ndarray, color_wh3: np.ndarray | None,
                      fx: float, fy: float, cx: float, cy: float,
                      T_CW: np.ndarray, max_depth: float = 6.0):
            d = _as_f32(depth_wh)
            w, h = d.shape
            cptr = None
            if color_wh3 is not None:
                c = np.ascontiguousarray(color_wh3, dtype=np.uint8)
                cptr = c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            T = np.ascontiguousarray(T_CW, dtype=np.float64)
            self._lib.tsdf_integrate(
                self._h, _fp(d), cptr, w, h, fx, fy, cx, cy,
                T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_depth)

        def extract_point_cloud(self):
            pp = ctypes.POINTER(ctypes.c_float)()
            cp = ctypes.POINTER(ctypes.c_float)()
            n = self._lib.tsdf_extract_points(self._h, ctypes.byref(pp),
                                              ctypes.byref(cp))
            pts = np.ctypeslib.as_array(pp, shape=(n, 3)).copy() if n else np.zeros((0, 3), np.float32)
            cols = np.ctypeslib.as_array(cp, shape=(n, 3)).copy() if n else np.zeros((0, 3), np.float32)
            self._lib.geom_free(pp)
            self._lib.geom_free(cp)
            return pts, cols

        def __del__(self):
            if getattr(self, "_h", None):
                self._lib.tsdf_destroy(self._h)
                self._h = None
