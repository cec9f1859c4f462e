"""Camera matrices (NumPy, host side), the port's own copy of the 3DGS
conventions in ``splatfields_tpu/utils/camera_math.py``."""
from __future__ import annotations

import math

import numpy as np


def get_world2view(R: np.ndarray, t: np.ndarray,
                   translate: np.ndarray | None = None,
                   scale: float = 1.0) -> np.ndarray:
    """World-to-view 4x4 from COLMAP-style (R camera-to-world rotation,
    t world-to-camera translation)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def get_projection_matrix(znear: float, zfar: float, fovx: float,
                          fovy: float) -> np.ndarray:
    """Perspective projection of the 3DGS rasterizer: view z to
    [0, zfar/(zfar-znear)], w = z."""
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4))
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return np.float32(P)


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_nerfpp_norm(w2c_list: list[np.ndarray]) -> dict:
    """Camera-centre bounding sphere -> {translate, radius}: the centres'
    mean, and 1.1 times the largest distance from it."""
    cam_centers = np.hstack([np.linalg.inv(w2c)[:3, 3:4] for w2c in w2c_list])
    avg = np.mean(cam_centers, axis=1, keepdims=True)
    dist = np.linalg.norm(cam_centers - avg, axis=0, keepdims=True)
    return {"translate": -avg[:, 0], "radius": np.max(dist) * 1.1}
