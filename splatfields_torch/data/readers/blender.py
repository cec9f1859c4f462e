"""Blender synthetic (NeRF-synthetic) readers, host NumPy (counterpart of
``splatfields_tpu/data/readers/blender.py``).

- ``read_cameras_from_transforms_cv`` / ``read_nerf_synthetic_cv``, the
  "Blender_cv" loader of the reproduction protocol: OpenCV-convention
  poses (c2w @ diag(1,-1,-1,1)), the per-scene world rescale
  (2 / MODEL_SCALE[scene]), alpha composited over the background, the
  focal from camera_angle_x applied at the image height (a reference
  quirk), k-means selection of ``n_views`` train cameras, and point init
  by ``load`` / ``random`` / ``hull``;
- ``read_cameras_from_transforms`` / ``read_nerf_synthetic``, the D-NeRF
  convention ("Blender").

Images are read by the port's own PNG decoder (``data/images.read_rgba``) and the
views picked by its own k-means (``kmeans``), where the JAX package uses
PIL and ``sklearn.cluster.KMeans``.
"""
from __future__ import annotations

import json
import os
import tempfile
import uuid
from pathlib import Path

import numpy as np

from splatfields_torch.data import images
from splatfields_torch.data.ply import fetch_pointcloud, store_pointcloud
from splatfields_torch.data.point_init import (
    mask_filter_points,
    random_cube_points,
    visual_hull_from_grid,
)
from splatfields_torch.data.types import BasicPointCloud, CameraInfo, SceneInfo
from splatfields_torch.utils.camera_math import (
    focal2fov,
    fov2focal,
    get_nerfpp_norm,
    get_world2view,
)

BLENDER_TO_OPENCV = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)

MODEL_SCALE = dict(chair=2.1, drums=2.3, ficus=2.3, hotdog=3.0, lego=2.4,
                   materials=2.4, mic=2.5, ship=2.75)


def _sq_dists(a, b, b_sq):
    """Squared distances [len(a), len(b)] as sklearn forms them:
    -2 a.b + |a|^2 + |b|^2, clipped at 0."""
    d = -2 * (a @ b.T)
    d += np.einsum("ij,ij->i", a, a)[:, None]
    d += b_sq[None, :]
    return np.maximum(d, 0)


def kmeans(points: np.ndarray, n: int, seed: int = 0, max_iter: int = 300,
           tol: float = 1e-4) -> np.ndarray:
    """[n, D] cluster centres by the algorithm of ``sklearn.cluster.KMeans
    (n, random_state=seed)``: the data centred on its mean, greedy
    k-means++ seeding (2 + floor(ln n) local trials a centre, draws from
    ``RandomState(seed)``), then Lloyd iterations until the labels repeat
    or the centres move less than ``tol`` times the mean variance."""
    x = np.array(points, np.float64)
    mean = x.mean(axis=0)
    x -= mean
    n_pts = x.shape[0]
    rng = np.random.RandomState(seed)
    w = np.ones(n_pts)
    x_sq = np.einsum("ij,ij->i", x, x)
    tol = float(np.mean(np.var(x, axis=0)) * tol)

    # k-means++ seeding
    trials = 2 + int(np.log(n))
    centers = np.empty((n, x.shape[1]))
    first = rng.choice(n_pts, p=w / w.sum())
    centers[0] = x[first]
    closest = _sq_dists(centers[0:1], x, x_sq)
    pot = closest @ w
    for c in range(1, n):
        vals = rng.uniform(size=trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        d = np.minimum(closest, _sq_dists(x[cand], x, x_sq))
        cand_pot = d @ w.reshape(-1, 1)
        best = int(np.argmin(cand_pot))
        pot, closest = cand_pot[best], d[best]
        centers[c] = x[cand[best]]

    # Lloyd
    labels_old = np.full(n_pts, -1)
    for _ in range(max_iter):
        labels = np.argmin(-2 * (x @ centers.T)
                           + np.einsum("ij,ij->i", centers, centers)[None],
                           axis=1)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, x)
        counts = np.bincount(labels, minlength=n).astype(np.float64)
        empty = np.flatnonzero(counts == 0)
        if empty.size:
            # sklearn's relocation: the points farthest from their centres
            far = np.argsort(-((x - centers[labels]) ** 2).sum(1),
                             kind="stable")[:empty.size]
            for e, f in zip(empty, far):
                sums[labels[f]] -= x[f]
                counts[labels[f]] -= 1
                sums[e], counts[e] = x[f], 1
        new = sums / np.maximum(counts, 1)[:, None]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if np.array_equal(labels, labels_old):
            break
        if shift <= tol:
            break
        labels_old = labels
    return centers + mean


def kmeans_downsample(points: np.ndarray, n: int) -> list[int]:
    """The index of the point nearest each of ``n`` k-means centres
    (reference :40-42)."""
    centers = kmeans(points, n)
    return ((points - centers[..., None, :]) ** 2).sum(-1).argmin(-1).tolist()


def nerfpp_norm_from_infos(cam_infos) -> dict:
    return get_nerfpp_norm([get_world2view(c.R, c.T).astype(np.float64)
                            for c in cam_infos])


def _read_rgba(image_path: str) -> np.ndarray:
    return images.read_rgba(image_path).astype(np.float32) / 255.0


def _composite(im: np.ndarray, white_background: bool):
    bg = np.array([1, 1, 1] if white_background else [0, 0, 0], np.float32)
    return im[..., :3] * im[..., 3:4] + bg * (1 - im[..., 3:4]), im[..., 3]


def read_cameras_from_transforms_cv(path, transformsfile, white_background,
                                    extension=".png", load_time_step=10**6):
    """OpenCV-convention Blender loader -> (cam_infos, camera positions)."""
    obj_name = os.path.basename(os.path.normpath(path))
    world_scale = 2.0 / MODEL_SCALE.get(obj_name, 2.0)
    cam_infos, cam_pos = [], []
    with open(os.path.join(path, transformsfile)) as jf:
        contents = json.load(jf)
    for idx, frame in enumerate(contents["frames"][:load_time_step]):
        cam_name = frame["file_path"] + extension
        tfm = (np.array(frame["transform_matrix"], np.float64)
               @ BLENDER_TO_OPENCV)
        tfm[:3, :4] *= world_scale
        cam_pos.append(tfm[:3, 3].copy())
        w2c = np.linalg.inv(tfm)
        R, T = np.transpose(w2c[:3, :3]), w2c[:3, 3]

        image_path = os.path.join(path, cam_name)
        im = _read_rgba(image_path)
        rgb, mask = _composite(im, white_background)
        h, w = im.shape[:2]
        # reference quirk: the focal from camera_angle_x applied at h / 2
        focal = (h / 2) / np.tan(contents["camera_angle_x"] / 2)
        K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=focal2fov(focal, h),
            FovX=focal2fov(focal, w), image=rgb, image_path=image_path,
            image_name=Path(cam_name).stem, width=w, height=h,
            fid=frame.get("time", 0), mask=mask, K=K))
    return cam_infos, np.stack(cam_pos, 0)


def read_cameras_from_transforms(path, transformsfile, white_background,
                                 extension=".png", load_time_step=10**6):
    """D-NeRF convention loader (reference :414-449): c2w with y and z
    flipped before the inversion, fovy through the fov2focal round trip."""
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as jf:
        contents = json.load(jf)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"][:load_time_step]):
        cam_name = frame["file_path"] + extension
        c2w = np.array(frame["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R, T = np.transpose(w2c[:3, :3]), w2c[:3, 3]
        image_path = os.path.join(path, cam_name)
        im = _read_rgba(image_path)
        rgb, mask = _composite(im, white_background)
        h, w = im.shape[:2]
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=focal2fov(fov2focal(fovx, w), h),
            FovX=fovx, image=rgb, image_path=image_path,
            image_name=Path(cam_name).stem, width=w, height=h,
            fid=frame.get("time", 0), mask=mask))
    return cam_infos


def _build_point_cloud(pts_samples, train_cams, num_pts, max_num_pts,
                       pc_path, scene_dir, seed=0):
    rng = np.random.RandomState(seed)
    if pts_samples == "load":
        if not (pc_path and os.path.exists(pc_path)):
            raise FileNotFoundError(f"missing pc_path {pc_path!r}")
        xyz, _, _ = fetch_pointcloud(pc_path)
        xyz = xyz[mask_filter_points(xyz, train_cams)]
        if 0 < max_num_pts < xyz.shape[0]:
            xyz = xyz[rng.choice(xyz.shape[0], max_num_pts, replace=False)]
        colors = rng.random((xyz.shape[0], 3)).astype(np.float32) / 255.0
    elif pts_samples == "random":
        xyz, colors = random_cube_points(num_pts, rng=rng)
    elif pts_samples == "hull":
        xyz = visual_hull_from_grid(train_cams, (-1.0, 1.0), 256, num_pts,
                                    rng=rng)
        colors = rng.random((xyz.shape[0], 3)).astype(np.float32) / 255.0
    else:
        raise NotImplementedError(f"pts_samples='{pts_samples}'")
    return xyz.astype(np.float32), colors


def _scene_info(train_cam_infos, test_cam_infos, xyz, colors,
                output_ply_path):
    ply_path = output_ply_path or os.path.join(
        tempfile.gettempdir(), f"splatfields_init_{uuid.uuid4().hex}.ply")
    store_pointcloud(ply_path, xyz, colors)
    pcd = BasicPointCloud(points=xyz, colors=colors,
                          normals=np.zeros_like(xyz))
    return SceneInfo(
        point_cloud=pcd, train_cameras=train_cam_infos,
        test_cameras=test_cam_infos, pred_cameras=test_cam_infos,
        nerf_normalization=nerfpp_norm_from_infos(train_cam_infos),
        ply_path=ply_path)


def read_nerf_synthetic_cv(path, white_background, eval_mode,
                           extension=".png", load_time_step=10**6,
                           n_views=6, num_pts=100_000, max_num_pts=-1,
                           pts_samples="load", pc_path="",
                           output_ply_path=None):
    """The "Blender_cv" scene loader (reference :662-871)."""
    train_cam_infos, cam_pose = read_cameras_from_transforms_cv(
        path, "transforms_train.json", white_background, extension)
    selected = sorted(kmeans_downsample(cam_pose, n_views))
    train_cam_infos = [train_cam_infos[i] for i in selected]
    test_cam_infos, _ = read_cameras_from_transforms_cv(
        path, "transforms_test.json", white_background, extension)
    if not eval_mode:
        train_cam_infos = train_cam_infos + test_cam_infos
        test_cam_infos = []
    xyz, colors = _build_point_cloud(
        pts_samples, train_cam_infos, num_pts, max_num_pts, pc_path, path)
    return _scene_info(train_cam_infos, test_cam_infos, xyz, colors,
                       output_ply_path)


def read_nerf_synthetic(path, white_background, eval_mode, extension=".png",
                        load_time_step=10**6, num_pts=100_000,
                        max_num_pts=-1, pts_samples="random", pc_path="",
                        output_ply_path=None, **_):
    """The D-NeRF-convention "Blender" loader (reference :519-659)."""
    train_cam_infos = read_cameras_from_transforms(
        path, "transforms_train.json", white_background, extension,
        load_time_step)
    test_cam_infos = read_cameras_from_transforms(
        path, "transforms_test.json", white_background, extension,
        load_time_step)
    if not eval_mode:
        train_cam_infos = train_cam_infos + test_cam_infos
        test_cam_infos = []
    xyz, colors = _build_point_cloud(
        pts_samples, train_cam_infos, num_pts, max_num_pts, pc_path, path)
    return _scene_info(train_cam_infos, test_cam_infos, xyz, colors,
                       output_ply_path)
