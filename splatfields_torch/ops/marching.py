"""Iso-surface extraction: batched field evaluation + marching tetrahedra
(counterpart of ``splatfields_tpu/ops/marching.py``, whose NumPy meshing
is copied here unchanged, so both packages give the same mesh bytes).

The reference defines ``extract_geometry`` / ``extract_fields``
(``utils/general_utils.py:38-65``) but never calls them; the extract-geo
CLI wires them to a splat-mixture density (``--mesh_resolution``).
Upstream meshes with the ``mcubes`` marching-cubes library; this meshes
with marching TETRAHEDRA (each cell split into 6 tets, 16 unambiguous
sign cases derived in code): no dependency, no lookup tables, no
ambiguous cases, about twice the triangles of marching cubes.

``extract_fields`` hands the field query torch chunks of the grid on the
query's device; the meshing is host NumPy, as upstream's CPU mcubes.
"""
from __future__ import annotations

import numpy as np
import torch

from splatfields_torch.device import resolve_device

# The 6-tetrahedra decomposition of a unit cell. Cube corners are indexed
# 0..7 as (x, y, z) bits: corner c = (c & 1, (c >> 1) & 1, (c >> 2) & 1).
# All 6 tets share the main diagonal 0-7, which makes faces of adjacent
# CELLS match up (the decomposition is translation-consistent), so the
# extracted surface is crack-free.
_CUBE_CORNERS = np.array(
    [[(c & 1), ((c >> 1) & 1), ((c >> 2) & 1)] for c in range(8)],
    np.int32)
_TETS = np.array([
    [0, 5, 1, 7],
    [0, 1, 3, 7],
    [0, 3, 2, 7],
    [0, 2, 6, 7],
    [0, 6, 4, 7],
    [0, 4, 5, 7],
], np.int32)


def _tet_case_table():
    """For each of the 16 inside-masks of a tet's 4 vertices, the list of
    triangles, each triangle a triple of edges, each edge a (vertex,
    vertex) pair crossing the surface. Derived, not transcribed."""
    cases = {}
    for mask in range(16):
        inside = [i for i in range(4) if mask & (1 << i)]
        outside = [i for i in range(4) if not mask & (1 << i)]
        if len(inside) in (0, 4):
            cases[mask] = []
        elif len(inside) == 1:
            a = inside[0]
            b, c, d = outside
            cases[mask] = [((a, b), (a, c), (a, d))]
        elif len(inside) == 3:
            a = outside[0]
            b, c, d = inside
            cases[mask] = [((b, a), (c, a), (d, a))]
        else:  # 2-2: quad on the four crossing edges -> two triangles
            a, b = inside
            c, d = outside
            cases[mask] = [((a, c), (a, d), (b, c)),
                           ((b, c), (a, d), (b, d))]
    return cases


_CASES = _tet_case_table()


def marching_tetrahedra(u: np.ndarray, threshold: float):
    """Extract the ``u == threshold`` iso-surface of a dense scalar grid.

    Args:
        u: [Rx, Ry, Rz] scalar field (inside = u > threshold).
        threshold: iso value.
    Returns:
        (vertices [V, 3] float32 in VOXEL coordinates, triangles [T, 3]
        int32). Vertices are deduplicated (shared across triangles).
    """
    u = np.asarray(u, np.float32)
    rx, ry, rz = u.shape
    if min(rx, ry, rz) < 2:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    # cell origins and the 8 corner values per cell, flattened
    cx, cy, cz = np.meshgrid(np.arange(rx - 1), np.arange(ry - 1),
                             np.arange(rz - 1), indexing="ij")
    origins = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3)  # [C, 3]
    corner_vals = np.empty((origins.shape[0], 8), np.float32)
    for c in range(8):
        off = _CUBE_CORNERS[c]
        corner_vals[:, c] = u[off[0]:off[0] + rx - 1,
                              off[1]:off[1] + ry - 1,
                              off[2]:off[2] + rz - 1].reshape(-1)

    # drop cells the surface cannot cross
    inside8 = corner_vals > threshold
    active = inside8.any(axis=1) & ~inside8.all(axis=1)
    origins = origins[active]
    corner_vals = corner_vals[active]
    if origins.shape[0] == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))

    tri_pts = []  # list of [n, 3, 3] vertex-position blocks
    for tet in _TETS:
        vals = corner_vals[:, tet]                      # [C, 4]
        mask = ((vals > threshold) << np.arange(4)).sum(axis=1)
        pos = (origins[:, None, :]
               + _CUBE_CORNERS[tet][None]).astype(np.float32)  # [C, 4, 3]
        for m in range(1, 15):
            sel = np.nonzero(mask == m)[0]
            if sel.size == 0:
                continue
            for tri in _CASES[m]:
                pts = np.empty((sel.size, 3, 3), np.float32)
                for e, (p, q) in enumerate(tri):
                    up = vals[sel, p]
                    uq = vals[sel, q]
                    t = (threshold - up) / np.where(
                        uq == up, 1.0, uq - up)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pts[:, e] = (pos[sel, p] * (1 - t) + pos[sel, q] * t)
                tri_pts.append(pts)

    pts = np.concatenate(tri_pts, axis=0)               # [T, 3, 3]
    flat = pts.reshape(-1, 3)
    # dedup shared vertices (edge crossings are computed identically by
    # the tets on either side, so exact quantization merges them)
    keys = np.round(flat * 4096.0).astype(np.int64)
    _, idx, inv = np.unique(
        keys.view([("x", np.int64), ("y", np.int64), ("z", np.int64)]),
        return_index=True, return_inverse=True)
    vertices = flat[idx]
    triangles = inv.reshape(-1, 3).astype(np.int32)
    # drop degenerate triangles (two corners merged)
    ok = ((triangles[:, 0] != triangles[:, 1])
          & (triangles[:, 1] != triangles[:, 2])
          & (triangles[:, 0] != triangles[:, 2]))
    return vertices.astype(np.float32), triangles[ok]


def extract_fields(bound_min, bound_max, resolution: int, query_func,
                   chunk: int = 64 ** 3, device=None) -> np.ndarray:
    """Evaluate ``query_func(torch [n, 3] on device) -> [n]`` on a dense
    grid in chunks (reference ``extract_fields``, general_utils.py:50-65,
    which loops 64^3 sub-blocks; here one flat chunked sweep) -> the
    [R, R, R] float32 field. The grid is the JAX package's (NumPy f32
    ``linspace`` axes); ``device=None`` means the GPU."""
    dev = resolve_device(device)
    bound_min = np.asarray(bound_min, np.float32)
    bound_max = np.asarray(bound_max, np.float32)
    axes = [np.linspace(bound_min[i], bound_max[i], resolution,
                        dtype=np.float32) for i in range(3)]
    xx, yy, zz = np.meshgrid(*axes, indexing="ij")
    pts = torch.as_tensor(np.stack([xx, yy, zz], axis=-1).reshape(-1, 3),
                          device=dev)
    out = torch.empty(pts.shape[0], dtype=torch.float32, device=dev)
    for s in range(0, pts.shape[0], chunk):
        out[s:s + chunk] = query_func(pts[s:s + chunk]).reshape(-1)
    return out.cpu().numpy().reshape(resolution, resolution, resolution)


def extract_geometry(bound_min, bound_max, resolution: int,
                     threshold: float, query_func, device=None):
    """Reference-shaped entry (general_utils.py:38-49): evaluate the field
    and mesh the iso-surface; vertices mapped to world coordinates.

    Returns (vertices [V, 3] float32 world-space, triangles [T, 3] int32).
    """
    u = extract_fields(bound_min, bound_max, resolution, query_func,
                       device=device)
    vertices, triangles = marching_tetrahedra(u, threshold)
    bmin = np.asarray(bound_min, np.float32)
    bmax = np.asarray(bound_max, np.float32)
    if len(vertices) > 0:
        vertices = vertices / (resolution - 1.0) * (bmax - bmin)[None] \
            + bmin[None]
    return vertices.astype(np.float32), triangles


def write_mesh_ply(path, vertices: np.ndarray, triangles: np.ndarray):
    """Minimal binary-LE PLY mesh writer (vertex + face elements)."""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(triangles)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n")
    face = np.empty(
        len(triangles),
        dtype=[("n", np.uint8), ("idx", np.int32, (3,))])
    face["n"] = 3
    face["idx"] = triangles
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(np.ascontiguousarray(vertices, np.float32).tobytes())
        f.write(face.tobytes())
