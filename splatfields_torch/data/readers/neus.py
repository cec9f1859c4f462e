"""NeuS-convention DTU reader, host NumPy (counterpart of the DTU part of
``splatfields_tpu/data/readers/neus.py``; reference
``scene/dataset_readers.py:118-138, 874-990``).

- ``load_k_rt_from_p``: K and the camera-to-world pose from a 3x4
  projection. The JAX package calls ``cv2.decomposeProjectionMatrix``;
  here ``rq_decomp3x3`` replays cv2's ``RQDecomp3x3`` (three Givens
  rotations, then cv2's own sign fixes) in float64, so K and R equal
  cv2's, signs included, and the camera centre is the projection's null
  vector (cv2 takes it from a float32 SVD; they agree to f32 rounding).
- ``read_dtu_cameras`` / ``read_neus_dtu_scene``: ``cameras_sphere.npz``
  (``world_mat_i``, ``scale_mat_i``), ``image/*.png`` multiplied by
  ``mask/*.png``, the reference's axis-flip chain, and a random-cube
  ``points3d.ply`` written beside the data on first use with the JAX
  reader's draws (``np.random.RandomState(seed)``).

Images and masks are read by ``data/png.py``, where the JAX package uses
PIL and imageio.
"""
from __future__ import annotations

import os
from glob import glob
from pathlib import Path

import numpy as np

from splatfields_torch.data import png
from splatfields_torch.data.ply import fetch_pointcloud, store_pointcloud
from splatfields_torch.data.readers.blender import nerfpp_norm_from_infos
from splatfields_torch.data.types import BasicPointCloud, CameraInfo, SceneInfo
from splatfields_torch.ops.sh import sh_to_rgb
from splatfields_torch.utils.camera_math import focal2fov

_DBL_EPS = np.finfo(np.float64).eps


def _givens(c: float, s: float) -> tuple[float, float]:
    z = 1.0 / np.sqrt(c * c + s * s + _DBL_EPS)
    return c * z, s * z


def rq_decomp3x3(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """cv2's ``RQDecomp3x3``: M = R Q with R upper triangular (R[0,0] and
    R[1,1] made positive by a 180-degree turn, as cv2 does) and Q
    orthogonal, in float64 -> (R, Q)."""
    m = np.asarray(m, np.float64)
    c, s = _givens(m[2, 2], m[2, 1])
    qx = np.array([[1, 0, 0], [0, c, s], [0, -s, c]])
    r = m @ qx
    r[2, 1] = 0
    c, s = _givens(r[2, 2], -r[2, 0])
    qy = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    r = r @ qy
    r[2, 0] = 0
    c, s = _givens(r[1, 1], r[1, 0])
    qz = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    r = r @ qz
    r[1, 0] = 0
    if r[0, 0] < 0:
        if r[1, 1] < 0:     # turn about z
            r[0, :2] *= -1
            r[1, 1] *= -1
            qz[:2, :2] *= -1
        else:               # turn about y
            r[0, 0] *= -1
            r[:, 2] *= -1
            qz = qz.T.copy()
            qy[0::2, 0::2] *= -1
    elif r[1, 1] < 0:       # turn about x
        r[0, 1:] *= -1
        r[1, 1:] *= -1
        r[2, 2] *= -1
        qz, qy = qz.T.copy(), qy.T.copy()
        qx[1:, 1:] *= -1
    return r, qz.T @ qy.T @ qx.T


def load_k_rt_from_p(P: np.ndarray):
    """K (float32, K[2,2] = 1) and the camera-to-world pose (float32 4x4)
    from a 3x4 projection (reference :118-138)."""
    P = np.asarray(P, np.float64)
    K, R = rq_decomp3x3(P[:, :3])
    K = K / K[2, 2]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])
    return K.astype(np.float32), pose


def parse_cam(scale_mats, world_mats):
    """Per-frame P = world_mat @ scale_mat -> (K [N,3,3], pose [N,4,4])."""
    intr, poses = [], []
    for sm, wm in zip(scale_mats, world_mats):
        K, pose = load_k_rt_from_p((wm @ sm)[:3, :4])
        intr.append(K)
        poses.append(pose)
    return np.stack(intr), np.stack(poses)


def read_dtu_cameras(path, render_camera="cameras_sphere.npz"):
    """reference ``readDTUCameras`` (:874-947): the masked images and the
    cameras of a DTU scan, through the reference's axis-flip chain."""
    cam_dict = np.load(os.path.join(path, render_camera))
    images_lis = sorted(glob(os.path.join(path, "image/*.png")))
    masks_lis = sorted(glob(os.path.join(path, "mask/*.png")))
    n_images = len(images_lis)
    cam_infos = []
    for idx in range(n_images):
        image = png.read(images_lis[idx])
        mask = png.read(masks_lis[idx]) / 255.0
        image = (image * mask).astype(np.uint8)
        world_mat = cam_dict[f"world_mat_{idx}"].astype(np.float32)
        if f"fid_{idx}" in cam_dict:
            fid = cam_dict[f"fid_{idx}"] / (n_images / 12 - 1)
        else:
            fid = 0
        scale_mat = cam_dict[f"scale_mat_{idx}"].astype(np.float32)
        K, pose = load_k_rt_from_p((world_mat @ scale_mat)[:3, :4])

        pose = np.concatenate([pose[0:1], -pose[2:3], -pose[1:2], pose[3:]], 0)
        S = np.eye(3)
        S[1, 1] = -1
        S[2, 2] = -1
        pose[1, 3] = -pose[1, 3]
        pose[2, 3] = -pose[2, 3]
        pose[:3, :3] = S @ pose[:3, :3] @ S
        pose = np.concatenate([pose[0:1], pose[2:3], pose[1:2], pose[3:]], 0)
        pose[:, 3] *= 0.5

        matrix = np.linalg.inv(pose)
        R = -np.transpose(matrix[:3, :3])
        R[:, 0] = -R[:, 0]
        T = -matrix[:3, 3]

        h, w = image.shape[:2]
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=focal2fov(K[0, 0], h),
            FovX=focal2fov(K[0, 0], w),
            image=image.astype(np.float32) / 255.0,
            image_path=images_lis[idx],
            image_name=Path(images_lis[idx]).stem, width=w, height=h,
            fid=fid, mask=mask[..., 0].astype(np.float32)))
    return cam_infos


def read_neus_dtu_scene(path, render_camera="cameras_sphere.npz",
                        num_pts=100_000, seed=0, **_):
    """reference ``readNeuSDTUInfo`` (:950-990): every view a train view,
    no test views, a random-cube init of ``num_pts`` points in
    [-1.3, 1.3]^3 (``points3d.ply`` beside the data, written once)."""
    train_cam_infos = read_dtu_cameras(path, render_camera)
    nerf_normalization = nerfpp_norm_from_infos(train_cam_infos)
    rng = np.random.RandomState(seed)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        store_pointcloud(ply_path, xyz.astype(np.float32),
                         sh_to_rgb(shs.astype(np.float32)))
    p, c, nrm = fetch_pointcloud(ply_path)
    return SceneInfo(
        point_cloud=BasicPointCloud(points=p, colors=c, normals=nrm),
        train_cameras=train_cam_infos, test_cameras=[], pred_cameras=[],
        nerf_normalization=nerf_normalization, ply_path=ply_path)
