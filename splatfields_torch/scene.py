"""Scene orchestration: dataset loading, cameras on the device, splat init
(counterpart of ``splatfields_tpu/scene.py``).

Marker-file dataset sniffing, ``input.ply`` and ``cameras.json`` written
into the model directory, the camera lists shuffled with the caller's
``random.Random`` (drawing what the JAX package's global ``random``
draws after the same seed), ``cameras_extent`` from the NeRF++ radius,
the camera lists at scale 1 with their images on ``device``, and
splats created from the point cloud or loaded from an iteration's PLY.
"""
from __future__ import annotations

import json
import os
import random
import shutil

from splatfields_torch.data.cameras import (
    camera_list_from_cam_infos,
    camera_to_json,
)
from splatfields_torch.data.registry import SCENE_LOADERS, sniff_scene_type
from splatfields_torch.device import resolve_device
from splatfields_torch.models import splats as splats_lib
from splatfields_torch.utils.system import search_for_max_iteration


class Scene:
    def __init__(self, cfg, load_iteration=None, shuffle=True,
                 rng: random.Random | None = None, device=None):
        """``cfg`` is a ``ModelConfig``. ``rng`` shuffles the camera lists
        (a fresh ``random.Random(0)`` when None); ``device=None`` means
        the GPU."""
        self.device = resolve_device(device)
        self.model_path = cfg.model_path
        self.loaded_iter = None
        if load_iteration:
            self.loaded_iter = (search_for_max_iteration(
                os.path.join(self.model_path, "point_cloud"))
                if load_iteration == -1 else load_iteration)
            print(f"Loading trained model at iteration {self.loaded_iter}")

        scene_type = sniff_scene_type(cfg.source_path)
        loader = SCENE_LOADERS[scene_type]
        if scene_type == "Colmap":
            scene_info = loader(
                cfg.source_path, images=cfg.images, eval_mode=cfg.eval,
                white_background=cfg.white_background, pc_path=cfg.pc_path,
                n_views=cfg.n_views, num_pts=cfg.max_num_pts)
        elif scene_type == "Blender_cv":
            scene_info = loader(
                cfg.source_path, cfg.white_background, cfg.eval,
                load_time_step=cfg.load_time_step, n_views=cfg.n_views,
                num_pts=cfg.num_pts, max_num_pts=cfg.max_num_pts,
                pts_samples=cfg.pts_samples, pc_path=cfg.pc_path)
        elif scene_type == "DTU":
            scene_info = loader(cfg.source_path, num_pts=cfg.num_pts)
        elif scene_type == "nerfies":
            scene_info = loader(
                cfg.source_path, eval_mode=cfg.eval,
                load_time_step=cfg.load_time_step,
                max_pts=cfg.max_num_pts if cfg.max_num_pts > 0 else 300_000)
        else:  # ResFields
            scene_info = loader(
                cfg.source_path, cfg.white_background,
                train_cam_names=cfg.train_cam_names,
                test_cam_names=cfg.test_cam_names,
                pred_cam_names=cfg.pred_cam_names,
                load_time_step=cfg.load_time_step, num_pts=cfg.num_pts,
                pts_samples=cfg.pts_samples)
        self.scene_info = scene_info
        self.scene_type = scene_type

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            if os.path.exists(scene_info.ply_path):
                shutil.copyfile(scene_info.ply_path,
                                os.path.join(self.model_path, "input.ply"))
            cam_json = [camera_to_json(idx, cam) for idx, cam in enumerate(
                scene_info.test_cameras + scene_info.train_cameras)]
            with open(os.path.join(self.model_path, "cameras.json"),
                      "w") as f:
                json.dump(cam_json, f)
        if os.path.basename(scene_info.ply_path).startswith(
                "splatfields_init_"):
            os.remove(scene_info.ply_path)  # the reader's temporary file

        if shuffle:
            rng = rng if rng is not None else random.Random(0)
            rng.shuffle(scene_info.train_cameras)
            rng.shuffle(scene_info.test_cameras)

        self.cameras_extent = float(scene_info.nerf_normalization["radius"])
        self.train_cameras, self.test_cameras, self.pred_cameras = (
            camera_list_from_cam_infos(infos, 1.0, cfg.resolution,
                                       device=self.device)
            for infos in (scene_info.train_cameras, scene_info.test_cameras,
                          scene_info.pred_cameras))

        isotropic = getattr(cfg, "use_isotropic", False)
        if self.loaded_iter:
            ply = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{self.loaded_iter}",
                               "point_cloud.ply")
            self.splats, self.splat_stats, self.loaded_sh_degree = (
                splats_lib.load_ply(ply, isotropic=isotropic,
                                    device=self.device))
        else:
            self.splats, self.splat_stats = splats_lib.create_from_pcd(
                scene_info.point_cloud.points, scene_info.point_cloud.colors,
                cfg.sh_degree, isotropic=isotropic, device=self.device)
            self.loaded_sh_degree = None

    def get_train_cameras(self):
        return self.train_cameras

    def get_test_cameras(self):
        return self.test_cameras

    def get_pred_cameras(self):
        return self.pred_cameras

    def save(self, iteration, params, stats):
        path = os.path.join(self.model_path, "point_cloud",
                            f"iteration_{iteration}", "point_cloud.ply")
        splats_lib.save_ply(path, params, stats.valid)
