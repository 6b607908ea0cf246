"""Triangle mesh container + IO + sampling (a copy of the JAX package's
`mesher/mesh.py`).

First-party replacement for the trimesh surface the reference leans on
(apply_scale / apply_transform / apply_translation / export / surface
sampling / OBB cropping — ref: train.py:233-243, src/trainer.py:102-121,
metric/eval_3D_obj.py:10-39).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class TriMesh:
    vertices: np.ndarray                 # (n, 3) float
    faces: np.ndarray                    # (m, 3) int
    vertex_colors: np.ndarray | None = None  # (n, 3) uint8

    # -------------------------------------------------- transforms
    def apply_translation(self, t) -> "TriMesh":
        self.vertices = self.vertices + np.asarray(t, dtype=self.vertices.dtype)
        return self

    def apply_scale(self, s) -> "TriMesh":
        """Scalar or per-axis scale (trimesh.apply_scale semantics)."""
        self.vertices = self.vertices * np.asarray(s, dtype=self.vertices.dtype)
        return self

    def apply_transform(self, T: np.ndarray) -> "TriMesh":
        self.vertices = self.vertices @ np.asarray(T)[:3, :3].T + np.asarray(T)[:3, 3]
        return self

    def copy(self) -> "TriMesh":
        return TriMesh(
            self.vertices.copy(), self.faces.copy(),
            None if self.vertex_colors is None else self.vertex_colors.copy(),
        )

    # -------------------------------------------------- properties
    def face_areas(self) -> np.ndarray:
        v0 = self.vertices[self.faces[:, 0]]
        v1 = self.vertices[self.faces[:, 1]]
        v2 = self.vertices[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)

    @property
    def area(self) -> float:
        return float(self.face_areas().sum())

    def sample_surface(self, n: int, rng: np.random.Generator | None = None
                       ) -> np.ndarray:
        """Area-weighted uniform surface sampling (replaces
        trimesh.sample.sample_surface, ref: metric/eval_3D_obj.py:141-149)."""
        rng = rng if rng is not None else np.random.default_rng(0)
        areas = self.face_areas()
        total = areas.sum()
        if total <= 0 or len(self.faces) == 0:
            return np.zeros((0, 3), self.vertices.dtype)
        probs = areas / total
        fi = rng.choice(len(self.faces), size=n, p=probs)
        u = rng.random(n)
        v = rng.random(n)
        flip = u + v > 1.0
        u[flip] = 1.0 - u[flip]
        v[flip] = 1.0 - v[flip]
        v0 = self.vertices[self.faces[fi, 0]]
        v1 = self.vertices[self.faces[fi, 1]]
        v2 = self.vertices[self.faces[fi, 2]]
        return v0 + u[:, None] * (v1 - v0) + v[:, None] * (v2 - v0)

    def crop_to_obb(self, center, R, extent, pad: float = 0.0) -> "TriMesh":
        """Keep faces whose centroid lies inside the oriented box (the eval
        protocol's accuracy crop, ref: metric/eval_3D_obj.py:15-27 uses plane
        slicing; face-level cropping is the same statistical protocol)."""
        centroids = self.vertices[self.faces].mean(axis=1)
        local = (centroids - np.asarray(center)) @ np.asarray(R)
        half = np.asarray(extent) / 2.0 + pad
        keep = np.all(np.abs(local) <= half, axis=-1)
        return self._submesh(keep)

    def _submesh(self, face_mask: np.ndarray) -> "TriMesh":
        faces = self.faces[face_mask]
        used = np.unique(faces)
        remap = np.full(len(self.vertices), -1, np.int64)
        remap[used] = np.arange(len(used))
        return TriMesh(
            self.vertices[used],
            remap[faces],
            None if self.vertex_colors is None else self.vertex_colors[used],
        )

    # -------------------------------------------------- IO
    def export(self, path: str) -> None:
        ext = os.path.splitext(path)[1].lower()
        if ext == ".obj":
            self.export_obj(path)
        elif ext == ".ply":
            self.export_ply(path)
        else:
            raise ValueError(f"unsupported mesh format {ext}")

    def export_obj(self, path: str) -> None:
        with open(path, "w") as f:
            self._write_obj(f)

    def obj_bytes(self) -> bytes:
        """The .obj file as bytes (for serving without touching disk)."""
        import io

        s = io.StringIO()
        self._write_obj(s)
        return s.getvalue().encode()

    def _write_obj(self, f) -> None:
        f.write("# catnerf_tpu mesh\n")
        if self.vertex_colors is not None:
            c = self.vertex_colors.astype(np.float64) / 255.0
            for v, col in zip(self.vertices, c):
                f.write(f"v {v[0]} {v[1]} {v[2]} {col[0]} {col[1]} {col[2]}\n")
        else:
            for v in self.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in self.faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")

    def export_ply(self, path: str) -> None:
        n_v, n_f = len(self.vertices), len(self.faces)
        has_color = self.vertex_colors is not None
        with open(path, "wb") as f:
            header = ["ply", "format binary_little_endian 1.0",
                      f"element vertex {n_v}",
                      "property float x", "property float y", "property float z"]
            if has_color:
                header += ["property uchar red", "property uchar green",
                           "property uchar blue"]
            header += [f"element face {n_f}",
                       "property list uchar int vertex_indices", "end_header"]
            f.write(("\n".join(header) + "\n").encode())
            if has_color:
                vdata = np.empty(
                    n_v, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
                vdata["xyz"] = self.vertices.astype(np.float32)
                vdata["rgb"] = self.vertex_colors
            else:
                vdata = self.vertices.astype(np.float32)
            f.write(vdata.tobytes())
            fdata = np.empty(n_f, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
            fdata["n"] = 3
            fdata["idx"] = self.faces.astype(np.int32)
            f.write(fdata.tobytes())


def load_mesh(path: str) -> TriMesh:
    """Load OBJ (ascii) or PLY (ascii/binary_le) meshes — needed by the eval
    CLI to read GT meshes (ref: metric/eval_3D_obj.py:143-149)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return _load_obj(path)
    if ext == ".ply":
        return _load_ply(path)
    raise ValueError(f"unsupported mesh format {ext}")


def _load_obj(path: str) -> TriMesh:
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) - 1 for p in parts[1:]]
                for j in range(1, len(idx) - 1):  # fan-triangulate n-gons
                    faces.append([idx[0], idx[j], idx[j + 1]])
    vc = None
    if colors and len(colors) == len(verts):
        vc = (np.asarray(colors) * 255).clip(0, 255).astype(np.uint8)
    return TriMesh(np.asarray(verts, np.float64),
                   np.asarray(faces, np.int64), vc)


def _load_ply(path: str) -> TriMesh:
    with open(path, "rb") as f:
        data = f.read()
    # accept \n and \r\n header line endings; a missing terminator must be a
    # loud parse error, not a silently-empty mesh (find()==-1 would slice a
    # 10-byte "header" and yield n_v=n_f=0)
    marker = data.find(b"end_header")
    if marker < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.index(b"\n", marker) + 1
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    fmt = "ascii"
    n_v = n_f = 0
    v_props: list[tuple[str, str]] = []
    cur = None
    f_count_t, f_index_t = "uchar", "int"  # PLY defaults if no face list
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_v = int(parts[2])
            elif cur == "face":
                n_f = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            v_props.append((parts[1], parts[2]))
        elif parts[0] == "property" and cur == "face" and parts[1] == "list":
            f_count_t, f_index_t = parts[2], parts[3]

    _types = {"float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
              "uchar": ("u1", 1), "uint8": ("u1", 1), "char": ("i1", 1),
              "short": ("i2", 2), "ushort": ("u2", 2), "int": ("i4", 4),
              "uint": ("u4", 4), "int32": ("i4", 4)}

    if fmt == "ascii":
        lines = data[header_end:].decode().splitlines()
        vrows = [list(map(float, ln.split())) for ln in lines[:n_v]]
        varr = np.asarray(vrows)
        names = [p[1] for p in v_props]
        xi = [names.index(c) for c in ("x", "y", "z")]
        verts = varr[:, xi]
        vc = None
        if "red" in names:
            ci = [names.index(c) for c in ("red", "green", "blue")]
            vc = varr[:, ci].astype(np.uint8)
        faces = []
        for ln in lines[n_v:n_v + n_f]:
            parts = ln.split()
            k = int(parts[0])
            idx = list(map(int, parts[1:1 + k]))
            for j in range(1, k - 1):  # fan-triangulate
                faces.append([idx[0], idx[j], idx[j + 1]])
        return TriMesh(verts, np.asarray(faces, np.int64), vc)

    assert fmt == "binary_little_endian", f"unsupported ply format {fmt}"
    dt = np.dtype([(name, _types[t][0]) for t, name in v_props])
    body = data[header_end:]
    varr = np.frombuffer(body, dtype=dt, count=n_v)
    verts = np.stack([varr["x"], varr["y"], varr["z"]], -1).astype(np.float64)
    vc = None
    if "red" in dt.names:
        vc = np.stack([varr["red"], varr["green"], varr["blue"]], -1).astype(np.uint8)
    off = dt.itemsize * n_v
    # face list dtypes come from the header's 'property list <count> <index>'
    # declaration (hardcoding uchar/int32 desynchronizes the parse for e.g.
    # 'property list int int vertex_indices')
    cnt_dt = np.dtype("<" + _types[f_count_t][0])
    idx_dt = np.dtype("<" + _types[f_index_t][0])
    n_body = len(body) - off

    # fast path: uniform triangles (the overwhelmingly common GT-mesh case;
    # the per-face Python loop costs seconds on million-face backgrounds)
    rec = np.dtype([("k", cnt_dt), ("v", idx_dt, (3,))])
    if n_f > 0 and n_body == n_f * rec.itemsize:
        fa = np.frombuffer(body, dtype=rec, count=n_f, offset=off)
        if (fa["k"] == 3).all():
            return TriMesh(verts, fa["v"].astype(np.int64), vc)

    faces = []
    pos = off
    for _ in range(n_f):
        k = int(np.frombuffer(body, dtype=cnt_dt, count=1, offset=pos)[0])
        pos += cnt_dt.itemsize
        idx = np.frombuffer(body, dtype=idx_dt, count=k, offset=pos)
        pos += idx_dt.itemsize * k
        for j in range(1, k - 1):
            faces.append([idx[0], idx[j], idx[j + 1]])
    return TriMesh(verts, np.asarray(faces, np.int64), vc)
