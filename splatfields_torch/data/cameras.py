"""Cameras and the resolution policy (counterpart of ``splatfields_tpu/
data/cameras.py``).

``Camera`` keeps the JAX package's NumPy matrices (world_view_transform
stored transposed, full_proj = view @ proj, znear 0.01, zfar 100) and
holds its image, mask and depth as tensors on the device, where
``load_cam`` puts them once: the reference's ``data_device``. A training
step then indexes them and copies nothing from the host.

``load_cam`` keeps the reference's uint8 round trip of the image
(``(clip(img, 0, 1) * 255).astype(uint8) / 255``). At an unchanged size it
does not resample (PIL's ``resize`` to the same size is a copy). When the
size changes it resamples as PIL does, width then height, each pass with
torch's antialiased bicubic (``interpolate(mode="bicubic",
antialias=True)``, PIL's a = -0.5 kernel) rounded to uint8;
tests/test_torch_data.py states its worst difference to PIL's
``resize``. Depth resizes nearest-neighbour,
as cv2's ``INTER_NEAREST``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from splatfields_torch.device import resolve_device
from splatfields_torch.utils.camera_math import (
    fov2focal,
    get_projection_matrix,
    get_world2view,
)

ZNEAR, ZFAR = 0.01, 100.0


def camera_matrices(R, T, FoVx, FoVy, trans=None, scale=1.0):
    """(world_view_transform, full_proj_transform, projection_matrix,
    camera_center) as float32 NumPy, the reference's conventions. The
    view matrix goes through the camera-to-world inverse and back even for
    a zero ``trans``, as the reference's ``Camera`` does."""
    trans = np.zeros(3) if trans is None else trans
    world_view = get_world2view(R, T, trans, scale).T.astype(np.float32)
    proj = get_projection_matrix(ZNEAR, ZFAR, FoVx, FoVy).T.astype(np.float32)
    full = (world_view @ proj).astype(np.float32)
    center = np.linalg.inv(world_view.T)[:3, 3].astype(np.float32)
    return world_view, full, proj, center


@dataclasses.dataclass
class Camera:
    uid: int
    colmap_id: int
    R: np.ndarray
    T: np.ndarray
    FoVx: float
    FoVy: float
    image_name: str
    image_width: int
    image_height: int
    fid: float
    image: Optional[torch.Tensor] = None    # [3,H,W] float32, on the device
    mask: Optional[torch.Tensor] = None     # [1,H,W] float32, on the device
    depth: Optional[torch.Tensor] = None    # [H,W] float32, on the device
    world_view_transform: np.ndarray = None  # [4,4] transposed W2V
    projection_matrix: np.ndarray = None
    full_proj_transform: np.ndarray = None
    camera_center: np.ndarray = None
    trans: np.ndarray = None
    scale: float = 1.0
    # viewmatrix, projmatrix, campos as tensors on the image's device
    device_consts: Optional[dict] = None

    def __post_init__(self):
        if self.trans is None:
            self.trans = np.zeros(3)
        if self.world_view_transform is None:
            (self.world_view_transform, self.full_proj_transform,
             self.projection_matrix, self.camera_center) = camera_matrices(
                self.R, self.T, self.FoVx, self.FoVy, self.trans, self.scale)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.FoVy * 0.5)


def resize_uint8(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """uint8 [H,W] or [H,W,C] -> uint8 at (new_h, new_w), as PIL resizes:
    antialiased bicubic (a = -0.5), the width first and then the height,
    each pass rounded and clipped to uint8. A copy when the size is
    unchanged."""
    x = torch.from_numpy(img.astype(np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    for size in ((x.shape[2], new_w), (new_h, new_w)):
        if tuple(x.shape[2:]) != size:
            x = F.interpolate(x, size=size, mode="bicubic",
                              align_corners=False, antialias=True)
            x = torch.round(x.clamp(0, 255))
    x = x[0, 0] if img.ndim == 2 else x[0].permute(1, 2, 0)
    return x.numpy().astype(np.uint8)


def resize_nearest(a: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """cv2 ``INTER_NEAREST``: source index floor(dst * src / dst_size)."""
    h, w = a.shape[:2]
    ys = np.minimum((np.arange(new_h) * (h / new_h)).astype(int), h - 1)
    xs = np.minimum((np.arange(new_w) * (w / new_w)).astype(int), w - 1)
    return a[ys[:, None], xs[None, :]]


def _to_uint8(a: np.ndarray) -> np.ndarray:
    return (np.clip(a, 0, 1) * 255).astype(np.uint8)


def load_cam(cam_info, resolution: int, uid: int,
             resolution_scale: float = 1.0, max_resolution: int = 800,
             device=None) -> Camera:
    """Resolution policy and resize (reference ``utils/camera_utils.py:
    21-81``): ``resolution`` in {1, 2, 4, 8} divides; -1 caps the width at
    ``max_resolution`` (1600 for inputs wider than 1600); any other value
    is the target width. The image, mask and depth go to ``device``
    (None means the GPU)."""
    dev = resolve_device(device)
    orig_w, orig_h = cam_info.width, cam_info.height
    if resolution in (1, 2, 4, 8):
        scale = resolution_scale * resolution
        new_w, new_h = round(orig_w / scale), round(orig_h / scale)
    else:
        if resolution == -1:
            global_down = (orig_w / 1600 if orig_w > 1600
                           else orig_w / min(orig_w, max_resolution))
        else:
            global_down = orig_w / resolution
        scale = float(global_down) * resolution_scale
        new_w, new_h = int(orig_w / scale), int(orig_h / scale)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    image = mask = depth = None
    if cam_info.image is not None:
        img = resize_uint8(_to_uint8(cam_info.image), new_w, new_h)
        image = put(img.astype(np.float32).transpose(2, 0, 1)[:3] / 255.0)
    if cam_info.mask is not None:
        m = resize_uint8(_to_uint8(cam_info.mask), new_w, new_h)
        mask = put((m.astype(np.float32) / 255.0)[None])
    if cam_info.depth is not None:
        depth = put(resize_nearest(cam_info.depth, new_w, new_h))
    cam = Camera(
        uid=uid, colmap_id=cam_info.uid, R=cam_info.R, T=cam_info.T,
        FoVx=cam_info.FovX, FoVy=cam_info.FovY, image=image, mask=mask,
        depth=depth, image_name=cam_info.image_name,
        image_width=new_w, image_height=new_h, fid=cam_info.fid)
    cam.device_consts = {
        "viewmatrix": put(cam.world_view_transform),
        "projmatrix": put(cam.full_proj_transform),
        "campos": put(cam.camera_center)}
    return cam


def camera_list_from_cam_infos(cam_infos, resolution_scale, resolution,
                               max_resolution: int = 800, device=None):
    return [load_cam(c, resolution, idx, resolution_scale, max_resolution,
                     device=device)
            for idx, c in enumerate(cam_infos)]


def camera_to_json(idx: int, camera) -> dict:
    """reference ``camera_to_JSON`` (``utils/camera_utils.py:93-113``)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = camera.R.transpose()
    Rt[:3, 3] = camera.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    return {
        "id": idx,
        "img_name": camera.image_name,
        "width": camera.width,
        "height": camera.height,
        "position": W2C[:3, 3].tolist(),
        "rotation": [r.tolist() for r in W2C[:3, :3]],
        "fy": fov2focal(camera.FovY, camera.height),
        "fx": fov2focal(camera.FovX, camera.width),
    }


def stack_cameras(cams: list) -> dict:
    """Per-camera render constants stacked into float32 arrays."""
    return {
        "viewmatrix": np.stack([c.world_view_transform for c in cams]),
        "projmatrix": np.stack([c.full_proj_transform for c in cams]),
        "campos": np.stack([c.camera_center for c in cams]),
        "tanfovx": np.array([c.tanfovx for c in cams], np.float32),
        "tanfovy": np.array([c.tanfovy for c in cams], np.float32),
        "fid": np.array([c.fid for c in cams], np.float32),
    }


@dataclasses.dataclass
class MiniCam:
    """Image-less render camera from precomputed matrices (reference
    ``scene/cameras.py:164-175``); it has the ``Camera`` attributes the
    render path reads."""
    image_width: int
    image_height: int
    FoVy: float
    FoVx: float
    znear: float
    zfar: float
    world_view_transform: np.ndarray   # [4,4], transposed W2V
    full_proj_transform: np.ndarray    # [4,4]
    camera_center: np.ndarray = None
    fid: float = 0.0
    image_name: str = "minicam"

    def __post_init__(self):
        if self.camera_center is None:
            self.camera_center = np.linalg.inv(
                np.asarray(self.world_view_transform).T)[:3, 3].astype(
                    np.float32)

    @property
    def tanfovx(self) -> float:
        return math.tan(self.FoVx * 0.5)

    @property
    def tanfovy(self) -> float:
        return math.tan(self.FoVy * 0.5)
