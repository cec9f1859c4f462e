"""Nerfies / HyperNeRF multi-view reader, host NumPy (counterpart of
``splatfields_tpu/data/readers/nerfies.py``; the reference's
``scene/dataset_readers.py:1695-1891``, registered "nerfies").

``scene.json``'s scale and centre, ``metadata.json``'s time and camera
ids, ``dataset.json``'s split, by the name of the scene's parent
directory (``path.split("/")[-2]``; the CLI makes the path absolute):
``vrig*`` / ``NeRF*`` take the train and val ids at ratio 1, ``interp*``
every 4th id for training and every 4th from 2 for testing at ratio 0.5,
anything else (HyperNeRF) every 4th id at ratio 0.5 with no test set.
``load_time_step`` keeps the frames before it. The DUSt3R cloud
``duster_points3d.ply`` is subsampled to ``max_pts`` by
``RandomState(seed)``, shifted and scaled like the cameras, and given
random colours. The pred cameras follow a spline
(``utils/camera_paths.generate_interpolated_path``) through the fid-0
cameras of the rig in ``VIS_CAM_ORDER``, or are the test cameras when a
rig id is missing. Images, PNG or JPEG by their first bytes, are read
by ``data/images.read_pil`` and divided by 255, as the JAX reader's PIL
array (a palette PNG's indices, a 1-bit PNG's 0 / 1).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from splatfields_torch.data import images
from splatfields_torch.data.ply import fetch_pointcloud
from splatfields_torch.data.readers.blender import nerfpp_norm_from_infos
from splatfields_torch.data.types import BasicPointCloud, CameraInfo, SceneInfo
from splatfields_torch.utils.camera_math import focal2fov
from splatfields_torch.utils.camera_paths import generate_interpolated_path

# the spline's keyframes: rig camera ids, closed by the first two again
VIS_CAM_ORDER = [10, 6, 8, 12, 7, 3, 0, 9, 2, 5, 4, 11] + [10, 6]
N_INTERP = 50


def camera_nerfies_from_json(path, scale):
    """One nerfies camera JSON, its focal, principal point and image size
    scaled by ``scale`` (reference ``utils/camera_utils.py:116-136``)."""
    with open(path) as fp:
        cj = json.load(fp)
    if "tangential" in cj:
        cj["tangential_distortion"] = cj["tangential"]
    return dict(
        orientation=np.array(cj["orientation"]),
        position=np.array(cj["position"]),
        focal_length=cj["focal_length"] * scale,
        principal_point=np.array(cj["principal_point"]) * scale,
        image_size=np.array(
            (int(round(cj["image_size"][0] * scale)),
             int(round(cj["image_size"][1] * scale)))),
    )


def _read_image(path: str) -> np.ndarray:
    """float32 [H, W, C] / 255 of a PNG or JPEG, as ``np.array(PIL.Image.
    open(path), np.float32) / 255`` (one channel squeezed)."""
    img = images.read_pil(path)
    if img.shape[-1] == 1:
        img = img[..., 0]
    return np.array(img, np.float32) / 255.0


def read_nerfies_cameras_mv(path, load_time_step=10000):
    """-> (cam_infos, train_num, scene_center, coord_scale, camera_dict):
    the train cameras first, ``camera_dict`` the fid-0 camera of each rig
    id."""
    with open(f"{path}/scene.json") as f:
        scene_json = json.load(f)
    with open(f"{path}/metadata.json") as f:
        meta_json = json.load(f)
    with open(f"{path}/dataset.json") as f:
        dataset_json = json.load(f)

    coord_scale = scene_json["scale"]
    scene_center = scene_json["center"]

    name = path.split("/")[-2]
    if name.startswith(("vrig", "NeRF")):
        train_img = dataset_json["train_ids"]
        val_img = dataset_json["val_ids"]
        all_img = train_img + val_img
        ratio = 1.0
    elif name.startswith("interp"):
        all_id = dataset_json["ids"]
        train_img = all_id[::4]
        val_img = all_id[2::4]
        all_img = train_img + val_img
        ratio = 0.5
    else:  # hypernerf
        train_img = dataset_json["ids"][::4]
        all_img = train_img
        ratio = 0.5
    train_num = len(train_img)

    all_time = [meta_json[i]["time_id"] for i in all_img]
    camera_ids = [meta_json[i]["camera_id"] for i in all_img]
    if load_time_step < np.max(all_time):
        sel = [i for i, t in enumerate(all_time) if t < load_time_step]
        train_num = len([i for i, t in enumerate(all_time[:train_num])
                         if t < load_time_step])
        all_img = [all_img[i] for i in sel]
        all_time = [all_time[i] for i in sel]
        camera_ids = [camera_ids[i] for i in sel]
    max_time = max(max(all_time), 1)
    all_time = [meta_json[i]["time_id"] / max_time for i in all_img]

    cam_params = []
    for im in all_img:
        cam = camera_nerfies_from_json(f"{path}/camera/{im}.json", ratio)
        cam["position"] = (cam["position"] - scene_center) * coord_scale
        cam_params.append(cam)
    img_paths = [f"{path}/rgb/{int(1 / ratio)}x/{i}.png" for i in all_img]

    cam_infos = []
    camera_dict = {}
    for idx, image_path in enumerate(img_paths):
        image = _read_image(image_path)
        orientation = cam_params[idx]["orientation"].T
        position = -cam_params[idx]["position"] @ orientation
        focal = cam_params[idx]["focal_length"]
        h, w = image.shape[:2]
        info = CameraInfo(
            uid=idx, R=orientation, T=position,
            FovY=focal2fov(focal, h), FovX=focal2fov(focal, w),
            image=image[..., :3], image_path=image_path,
            image_name=Path(image_path).stem, width=w, height=h,
            fid=all_time[idx])
        if all_time[idx] == 0:
            camera_dict[camera_ids[idx]] = info
        cam_infos.append(info)
    return cam_infos, train_num, scene_center, coord_scale, camera_dict


def spline_cameras(camera_dict, like: CameraInfo):
    """The pred cameras: ``N_INTERP`` poses a segment of the spline
    through ``camera_dict``'s cameras in ``VIS_CAM_ORDER`` (650 for its 14
    keyframes), at fid 0 with ``like``'s field of view and size. Raises
    KeyError when a rig id is missing."""
    c2ws = []
    for cam in (camera_dict[i] for i in VIS_CAM_ORDER):
        Rt = np.eye(4)
        Rt[:3, :3] = cam.R
        Rt[:3, 3] = cam.T
        c2ws.append(np.linalg.inv(Rt))
    poses = generate_interpolated_path(
        np.stack(c2ws)[:, :3, :4], N_INTERP, spline_degree=3,
        smoothness=0.0, rot_weight=0.01)
    cams = []
    for i, pose in enumerate(poses):
        Rt = np.eye(4)
        Rt[:3, :4] = pose
        inv = np.linalg.inv(Rt)
        cams.append(CameraInfo(
            uid=i, fid=0, R=inv[:3, :3], T=inv[:3, 3],
            FovY=like.FovY, FovX=like.FovX, image=None, image_path=None,
            image_name=f"{i:06}", width=like.width, height=like.height))
    return cams


def read_nerfies_scene_mv(path, eval_mode=True, load_time_step=10000,
                          max_pts=300_000, seed=0, **_):
    """The registered "nerfies" loader."""
    rng = np.random.RandomState(seed)
    cam_infos, train_num, center, scale, camera_dict = read_nerfies_cameras_mv(
        path, load_time_step)
    train_cam_infos = cam_infos[:train_num]
    test_cam_infos = cam_infos[train_num:]
    nerf_normalization = nerfpp_norm_from_infos(train_cam_infos)

    ply_path = os.path.join(path, "duster_points3d.ply")
    xyz, colors, _ = fetch_pointcloud(ply_path)
    if 0 < max_pts < xyz.shape[0]:
        xyz = xyz[rng.choice(xyz.shape[0], max_pts, replace=False)]
    xyz = (xyz - center) * scale
    pcd = BasicPointCloud(
        points=xyz.astype(np.float32),
        colors=rng.random((xyz.shape[0], 3)).astype(np.float32),
        normals=np.zeros_like(xyz, dtype=np.float32))

    try:
        video_cameras = spline_cameras(camera_dict, train_cam_infos[0])
    except (KeyError, IndexError):
        video_cameras = test_cam_infos

    return SceneInfo(
        point_cloud=pcd, train_cameras=train_cam_infos,
        test_cameras=test_cam_infos, pred_cameras=video_cameras,
        nerf_normalization=nerf_normalization, ply_path=ply_path)
