"""Point-cloud initialisation on the host (counterpart of
``splatfields_tpu/data/point_init.py``): projective mask filtering of a
loaded PLY (``pts_samples='load'``), 256^3 visual-hull carving from the
train masks (``'hull'``), the random cube (``'random'``), the NeuS-style
hull samples through 3x4 projections and depth-map unprojection.

Carving takes the multithreaded C++ carver by default
(``native/hullcarve.cpp``, mode 0), as the JAX package does; its keep
mask equals the JAX package's native one exactly. ``use_native=False``
is the NumPy route, which keeps exactly the points the JAX NumPy route
keeps: a point survives when it projects inside the mask of every
camera, so each camera projects only the points still alive, with the
same float32 product per point, a chunk of the grid at a time. The two
routes can differ on a band of rounding ties (under 1e-3 of the grid).

As in the JAX package, u is bounded by the width and v by the height
(the reference bounds u by the height; its datasets are square).
"""
from __future__ import annotations

import numpy as np

from splatfields_torch import native
from splatfields_torch.data.cameras import camera_matrices


def _project_full(xyz: np.ndarray, full_proj: np.ndarray,
                  width: int, height: int):
    """Integer pixel coordinates through the transposed full projection,
    and whether they fall inside the image."""
    ones = np.ones((xyz.shape[0], 1), xyz.dtype)
    clip = np.concatenate([xyz, ones], 1) @ full_proj
    uv = clip[:, :2] / clip[:, 2:3]
    u = np.round(((uv[:, 0] + 1) * width - 1) * 0.5).astype(int)
    v = np.round(((uv[:, 1] + 1) * height - 1) * 0.5).astype(int)
    inb = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return u, v, inb


def _camera_full_proj(cam):
    if getattr(cam, "full_proj_transform", None) is not None:
        return cam.full_proj_transform
    # a CameraInfo: build the matrices from R, T and the fovs
    return camera_matrices(cam.R, cam.T, cam.FovX, cam.FovY)[1]


def _camera_mask(cam):
    mask = cam.mask
    if mask is None:
        raise ValueError("hull carving requires masks")
    if not isinstance(mask, np.ndarray):  # a Camera's mask tensor
        mask = mask.detach().cpu().numpy()
    if mask.ndim == 3:
        mask = mask[0] if mask.shape[0] == 1 else mask[..., 0]
    h, w = mask.shape
    return w, h, mask


def mask_filter_points(xyz: np.ndarray, cameras: list,
                       use_native: bool = True,
                       chunk: int = 1 << 18) -> np.ndarray:
    """[N] bool: the points whose projection lands inside the mask of every
    camera (``Camera`` with ``full_proj_transform`` and a [1,H,W] mask, or
    ``CameraInfo`` with an [H,W] mask). ``use_native``: the C++ carver;
    else NumPy, ``chunk`` points at a time, each camera projecting the
    chunk's points still alive."""
    views = [(_camera_full_proj(c),) + _camera_mask(c) for c in cameras]
    if use_native:
        mats = np.stack([np.asarray(v[0], np.float32) for v in views])
        return native.carve_points(xyz.astype(np.float32), mats,
                                   [v[3] for v in views], mode=0)
    keep = np.zeros(xyz.shape[0], bool)
    for start in range(0, xyz.shape[0], chunk):
        pts = xyz[start:start + chunk]
        alive = np.arange(start, start + pts.shape[0])
        for full_proj, w, h, mask in views:
            u, v, inb = _project_full(pts, full_proj, w, h)
            sel = np.flatnonzero(inb)
            sel = sel[mask[v[sel], u[sel]] > 0]
            pts, alive = pts[sel], alive[sel]
        keep[alive] = True
    return keep


def _grid_points(aabb, grid_resolution: int) -> np.ndarray:
    """``np.stack(np.meshgrid(g, g, g), -1).reshape(-1, 3)`` in float32
    (point [i, j, k] = (g[j], g[i], g[k])), built without the float64
    copies."""
    g = np.linspace(aabb[0], aabb[1], grid_resolution).astype(np.float32)
    r = grid_resolution
    pts = np.empty((r, r, r, 3), np.float32)
    pts[..., 0] = g[None, :, None]
    pts[..., 1] = g[:, None, None]
    pts[..., 2] = g[None, None, :]
    return pts.reshape(-1, 3)


def visual_hull_from_grid(cameras: list, aabb=(-1.0, 1.0),
                          grid_resolution: int = 256,
                          num_pts: int = 100_000,
                          rng: np.random.RandomState | None = None):
    """Carve a dense grid by the cameras' masks -> [M, 3] points, drawn
    down to ``num_pts`` without replacement."""
    rng = rng or np.random
    pts = _grid_points(aabb, grid_resolution)
    pts = pts[mask_filter_points(pts, cameras)]
    if pts.shape[0] > num_pts:
        pts = pts[rng.choice(pts.shape[0], num_pts, replace=False)]
    return pts


def random_cube_points(num_pts: int, low: float = -1.3, high: float = 1.3,
                       rng: np.random.RandomState | None = None):
    """Uniform points in [low, high]^3 and colours in [0, 1/255]."""
    rng = rng or np.random
    xyz = rng.random((num_pts, 3)) * (high - low) + low
    colors = rng.random((num_pts, 3)) / 255.0
    return xyz.astype(np.float32), colors.astype(np.float32)


def visual_hull_samples_krt(masks: np.ndarray, KRT: np.ndarray,
                            n_pts: int = 100_000,
                            grid_resolution: int = 64,
                            aabb=(-1.0, 1.0), seed: int = 0):
    """NeuS-style hull samples (reference ``visual_hull_samples``): carve a
    coarse grid by every mask through its 3x4 pixel projection, then draw
    ``n_pts`` points jittered inside the surviving voxels (the random cube
    when none survives). masks [C, H, W] binary, KRT [C, 3, 4]."""
    rng = np.random.RandomState(seed)
    grid = np.linspace(aabb[0], aabb[1], grid_resolution)
    gx, gy, gz = np.meshgrid(grid, grid, grid, indexing="ij")
    pts = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    hom = np.concatenate([pts, np.ones((pts.shape[0], 1))], 1).T
    keep = np.ones(pts.shape[0], bool)
    h, w = masks.shape[1:]
    for ci in range(KRT.shape[0]):
        pix = (KRT[ci] @ hom).T
        u = np.round(pix[:, 0] / np.maximum(pix[:, 2], 1e-8)).astype(int)
        v = np.round(pix[:, 1] / np.maximum(pix[:, 2], 1e-8)).astype(int)
        inb = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (pix[:, 2] > 0)
        idx = np.flatnonzero(inb)
        m = inb.copy()
        m[idx] = masks[ci][v[idx], u[idx]] > 0
        keep &= m
    occupied = pts[keep]
    if occupied.shape[0] == 0:
        return random_cube_points(n_pts, aabb[0], aabb[1],
                                  np.random.RandomState(seed))[0]
    voxel = (aabb[1] - aabb[0]) / (grid_resolution - 1)
    choice = rng.choice(occupied.shape[0], n_pts, replace=True)
    jitter = (rng.random((n_pts, 3)) - 0.5) * voxel
    return (occupied[choice] + jitter).astype(np.float32)


def unproject_depths(depths: np.ndarray, masks: np.ndarray, K: np.ndarray,
                     c2w: np.ndarray, max_pts: int = 200_000,
                     seed: int = 0):
    """Depth maps -> world points (reference ``_gen_3dpoints``): every
    masked pixel with a positive depth through its pixel centre, drawn
    down to ``max_pts`` without replacement. depths, masks [C, H, W]; K
    [C, 3, 3]; c2w [C, 4, 4]."""
    rng = np.random.RandomState(seed)
    out = []
    for ci in range(depths.shape[0]):
        d = depths[ci]
        v, u = np.nonzero((masks[ci] > 0) & (d > 0))
        z = d[v, u]
        uv1 = np.stack([u + 0.5, v + 0.5, np.ones_like(z)], 0)
        cam_pts = np.linalg.inv(K[ci]) @ (uv1 * z)
        world = c2w[ci] @ np.concatenate(
            [cam_pts, np.ones_like(cam_pts[:1])], 0)
        out.append(world[:3].T)
    pts = np.concatenate(out, 0).astype(np.float32)
    if pts.shape[0] > max_pts:
        pts = pts[rng.choice(pts.shape[0], max_pts, replace=False)]
    return pts
