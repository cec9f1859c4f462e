"""Interactive orbit camera (counterpart of ``splatfields_tpu/utils/
gui.py``; the reference's ``utils/gui_utils.py``). Vestigial there too:
no GUI entry point ships with either package, but the camera math is part
of the API surface."""
from __future__ import annotations

import numpy as np


class OrbitCamera:
    def __init__(self, W, H, r=2.0, fovy=60.0):
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = fovy
        self.center = np.array([0, 0, 0], dtype=np.float32)
        self.rot = np.eye(3, dtype=np.float32)
        self.up = np.array([0, 1, 0], dtype=np.float32)

    @property
    def pose(self) -> np.ndarray:
        """c2w 4x4."""
        res = np.eye(4, dtype=np.float32)
        res[2, 3] -= self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def view(self) -> np.ndarray:
        return np.linalg.inv(self.pose)

    @property
    def intrinsics(self) -> np.ndarray:
        focal = self.H / (2 * np.tan(np.radians(self.fovy) / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2],
                        dtype=np.float32)

    def orbit(self, dx, dy):
        def rotvec(axis, angle):
            axis = axis / np.linalg.norm(axis)
            K = np.array([
                [0, -axis[2], axis[1]],
                [axis[2], 0, -axis[0]],
                [-axis[1], axis[0], 0]])
            return (np.eye(3) + np.sin(angle) * K
                    + (1 - np.cos(angle)) * K @ K).astype(np.float32)

        side = self.rot[:3, 0]
        rotvec_x = rotvec(self.up, -0.05 * dx)
        rotvec_y = rotvec(side, -0.05 * dy)
        self.rot = rotvec_x @ rotvec_y @ self.rot

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        self.center += 0.0005 * self.rot[:3, :3] @ np.array([dx, -dy, dz],
                                                            dtype=np.float32)
