"""Host-side dataset types (counterpart of ``splatfields_tpu/data/types.py``).

``CameraInfo`` is what a reader returns for one view, in NumPy; ``Scene``
turns it into a ``data.cameras.Camera`` whose image lives on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class BasicPointCloud:
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray             # [3,3] cam-to-world rotation
    T: np.ndarray             # [3] world-to-cam translation
    FovY: float
    FovX: float
    image: Optional[np.ndarray]       # [H,W,3] float in [0,1] or None
    image_path: str
    image_name: str
    width: int
    height: int
    fid: float = 0.0                  # normalized time id
    mask: Optional[np.ndarray] = None  # [H,W] float
    depth: Optional[np.ndarray] = None  # [H,W] float
    K: Optional[np.ndarray] = None     # [3,3] intrinsics
    cx: Optional[float] = None
    cy: Optional[float] = None
    KRT: Optional[np.ndarray] = None   # [3,4] pixel projection
    pose: Optional[np.ndarray] = None  # [3,4] c2w


@dataclasses.dataclass
class SceneInfo:
    point_cloud: BasicPointCloud
    train_cameras: list
    test_cameras: list
    pred_cameras: list
    nerf_normalization: dict
    ply_path: str
    extra: dict = dataclasses.field(default_factory=dict)
