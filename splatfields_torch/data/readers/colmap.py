"""COLMAP scene readers, host NumPy (counterpart of
``splatfields_tpu/data/readers/colmap.py``; the reference's
``scene/dataset_readers.py``).

- ``read_colmap_cameras``: PINHOLE / SIMPLE_PINHOLE only; ``uid`` is the
  camera's id, not the image's; ``fid = int(image_name) / (num_frames -
  1)``, 0 when the name is not a number; with a masks folder the image
  is composited over the background with its alpha as the mask.
- ``read_colmap_scene_sparse``, the registered "Colmap": the pixelNeRF
  DTU split (the first ``n_views`` of ``PIXELNERF_TRAIN_IDX`` for
  training, in the camera list's order, 25 test views), points from
  ``--pc_path`` (|xyz| < 1, subsampled, random colours / 255) or from
  COLMAP's points3D, written to ``sparse/0/points3D.ply`` (a temporary
  file when the dataset is read-only).
- ``read_colmap_scene`` ("ColmapHold"): every 8th image held out.

Images are PNG or baseline JPEG, told apart by their first bytes
(``data/images.py``); the float32 arithmetic runs in the JAX reader's
order, so images and masks equal PIL's bit for bit. Any other format
raises NotImplementedError naming the file.
"""
from __future__ import annotations

import os
import struct
import tempfile
import uuid

import numpy as np

from splatfields_torch.data import colmap_io, images
from splatfields_torch.data.ply import fetch_pointcloud, store_pointcloud
from splatfields_torch.data.readers.blender import nerfpp_norm_from_infos
from splatfields_torch.data.types import BasicPointCloud, CameraInfo, SceneInfo
from splatfields_torch.utils.camera_math import focal2fov

PIXELNERF_TRAIN_IDX = [25, 22, 28, 40, 44, 48, 0, 8, 13]
PIXELNERF_EXCLUDE_IDX = [3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 36, 37, 38, 39]


def read_image_rgba(path: str) -> np.ndarray:
    """uint8 RGBA [H, W, 4] of a PNG or JPEG, as PIL's ``convert("RGBA")``
    gives it (``images.read_rgba``; its RGB is ``convert("RGB")``); any
    other format raises."""
    return images.read_rgba(path)


def read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder,
                        masks_folder=None, white_background=False):
    cam_infos = []
    num_frames = len(cam_extrinsics)
    for key in sorted(cam_extrinsics):
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        R = np.transpose(colmap_io.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise AssertionError(
                "only undistorted PINHOLE/SIMPLE_PINHOLE supported")

        image_path = os.path.join(images_folder, os.path.basename(extr.name))
        image_name = os.path.basename(image_path).split(".")[0]
        rgba = read_image_rgba(image_path)
        mask = None
        if masks_folder is not None:
            # the reference's DTU data carries the mask in the alpha channel
            im = np.array(rgba, np.float32) / 255.0
            bg = np.array([1, 1, 1] if white_background else [0, 0, 0],
                          np.float32)
            mask = im[..., 3]
            image = im[..., :3] * im[..., 3:4] + bg * (1 - im[..., 3:4])
        else:
            image = np.array(rgba[..., :3], np.float32) / 255.0
        try:
            fid = int(image_name) / (num_frames - 1)
        except ValueError:
            fid = 0
        cam_infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, FovY=fovy, FovX=fovx, image=image,
            image_path=image_path, image_name=image_name,
            width=intr.width, height=intr.height, fid=fid, mask=mask))
    return cam_infos


def _load_colmap_model(path, images_dir, white_background, with_masks=True):
    """The cameras of ``sparse/0``: the binary model, or the text one when
    the binary is missing or truncated."""
    sparse = os.path.join(path, "sparse/0")
    try:
        extr = colmap_io.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap_io.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except (FileNotFoundError, struct.error):
        extr = colmap_io.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap_io.read_cameras_text(os.path.join(sparse, "cameras.txt"))
    masks_folder = os.path.join(path, "mask") if with_masks else None
    return read_colmap_cameras(
        extr, intr, os.path.join(path, images_dir), masks_folder,
        white_background)


def _load_points(path, pc_path, num_pts, seed=0):
    rng = np.random.RandomState(seed)
    sparse = os.path.join(path, "sparse/0")
    if pc_path:
        assert os.path.exists(pc_path), f"missing {pc_path}"
        xyz, _, _ = fetch_pointcloud(pc_path)
        xyz = xyz[np.all(np.abs(xyz) < 1, axis=1)]
        if 0 < num_pts < xyz.shape[0]:
            xyz = xyz[rng.choice(xyz.shape[0], num_pts, replace=False)]
        colors = rng.random((xyz.shape[0], 3)).astype(np.float32) / 255.0
        return xyz, colors
    try:
        xyz, rgb, _ = colmap_io.read_points3d_binary(
            os.path.join(sparse, "points3D.bin"))
    except FileNotFoundError:
        xyz, rgb, _ = colmap_io.read_points3d_text(
            os.path.join(sparse, "points3D.txt"))
    return xyz.astype(np.float32), (rgb / 255.0).astype(np.float32)


def read_colmap_scene_sparse(path, images="images", eval_mode=True,
                             white_background=False, num_pts=300_000,
                             pc_path="", n_views=6, **_):
    """The registered "Colmap" loader (the pixelNeRF DTU split)."""
    cam_infos = _load_colmap_model(path, images, white_background)
    test_idx = [i for i in range(49)
                if i not in PIXELNERF_TRAIN_IDX + PIXELNERF_EXCLUDE_IDX]
    selected = PIXELNERF_TRAIN_IDX[:n_views]
    train_cam_infos = [cam_infos[i] for i in range(len(cam_infos))
                       if i in selected]
    test_cam_infos = [cam_infos[i] for i in range(len(cam_infos))
                      if i in test_idx]
    nerf_normalization = nerfpp_norm_from_infos(train_cam_infos)
    xyz, colors = _load_points(path, pc_path, num_pts)
    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    try:
        store_pointcloud(ply_path, xyz, colors)
    except OSError:
        ply_path = os.path.join(
            tempfile.gettempdir(), f"splatfields_init_{uuid.uuid4().hex}.ply")
        store_pointcloud(ply_path, xyz, colors)
    pcd = BasicPointCloud(points=xyz, colors=colors,
                          normals=np.zeros_like(xyz))
    return SceneInfo(
        point_cloud=pcd, train_cameras=train_cam_infos,
        test_cameras=test_cam_infos, pred_cameras=test_cam_infos,
        nerf_normalization=nerf_normalization, ply_path=ply_path)


def read_colmap_scene(path, images="images", eval_mode=False,
                      white_background=False, llffhold=8, pc_path="",
                      num_pts=300_000, **_):
    """The llffhold split ("ColmapHold"): with ``eval_mode`` every
    ``llffhold``-th image by name is a test view."""
    cam_infos = _load_colmap_model(path, images, white_background,
                                   with_masks=False)
    cam_infos = sorted(cam_infos, key=lambda c: c.image_name)
    if eval_mode:
        train_cam_infos = [c for i, c in enumerate(cam_infos)
                           if i % llffhold != 0]
        test_cam_infos = [c for i, c in enumerate(cam_infos)
                          if i % llffhold == 0]
    else:
        train_cam_infos, test_cam_infos = cam_infos, []
    nerf_normalization = nerfpp_norm_from_infos(train_cam_infos)
    xyz, colors = _load_points(path, pc_path, num_pts)
    ply_path = os.path.join(path, "sparse/0/points3D.ply")
    pcd = BasicPointCloud(points=xyz, colors=colors,
                          normals=np.zeros_like(xyz))
    return SceneInfo(
        point_cloud=pcd, train_cameras=train_cam_infos,
        test_cameras=test_cam_infos, pred_cameras=test_cam_infos,
        nerf_normalization=nerf_normalization, ply_path=ply_path)
