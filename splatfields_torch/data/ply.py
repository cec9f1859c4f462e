"""Minimal PLY reader and writer (counterpart of ``splatfields_tpu/data/
ply.py``): the vertex element of binary_little_endian and ascii files with
scalar properties. ``store_pointcloud`` writes the same bytes as the JAX
package's."""
from __future__ import annotations

import os

import numpy as np

_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_ply_vertices(path: str) -> tuple[list[str], np.ndarray]:
    """The vertex element -> (property names, [N, P] float32)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt, n_vertex, props, in_vertex = None, 0, [], False
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_vertex = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported in the "
                                     "vertex element")
                props.append((parts[-1], _DTYPES[parts[1]]))
        names = [p[0] for p in props]
        if fmt == "binary_little_endian":
            data = np.fromfile(f, dtype=np.dtype(props), count=n_vertex)
            out = np.stack([data[n].astype(np.float32) for n in names], -1)
        elif fmt == "ascii":
            out = np.asarray([[float(v) for v in f.readline().split()]
                              for _ in range(n_vertex)], np.float32)
        else:
            raise ValueError(f"unsupported ply format {fmt}")
    return names, out


def fetch_pointcloud(path: str):
    """PLY -> (points [N,3], colors [N,3] in [0,1], normals [N,3])
    (reference ``fetchPly``)."""
    names, data = read_ply_vertices(path)
    col = {n: data[:, i] for i, n in enumerate(names)}
    points = np.stack([col["x"], col["y"], col["z"]], -1)
    if "red" in col:
        colors = np.stack([col["red"], col["green"], col["blue"]], -1) / 255.0
    else:
        colors = np.full_like(points, 0.5)
    if "nx" in col:
        normals = np.stack([col["nx"], col["ny"], col["nz"]], -1)
    else:
        normals = np.zeros_like(points)
    return (points.astype(np.float32), colors.astype(np.float32),
            normals.astype(np.float32))


def store_pointcloud(path: str, points: np.ndarray, colors: np.ndarray):
    """xyz + zero normals + uint8 rgb PLY (reference ``storePly``)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    n = points.shape[0]
    rec = np.empty(n, dtype=np.dtype([
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
        ("red", "u1"), ("green", "u1"), ("blue", "u1")]))
    rgb = np.clip(colors * 255, 0, 255).astype(np.uint8)
    for i, nm in enumerate(("x", "y", "z")):
        rec[nm] = points[:, i]
    for nm in ("nx", "ny", "nz"):
        rec[nm] = 0.0
    for i, nm in enumerate(("red", "green", "blue")):
        rec[nm] = rgb[:, i]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)
