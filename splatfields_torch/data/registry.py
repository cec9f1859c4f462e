"""Dataset-type registry and marker-file sniffing (counterpart of
``splatfields_tpu/data/registry.py``): every loader of the JAX package."""
from __future__ import annotations

import os

from splatfields_torch.data.readers.blender import (
    read_nerf_synthetic,
    read_nerf_synthetic_cv,
)
from splatfields_torch.data.readers.colmap import (
    read_colmap_scene,
    read_colmap_scene_sparse,
)
from splatfields_torch.data.readers.nerfies import read_nerfies_scene_mv
from splatfields_torch.data.readers.neus import (
    read_neus_dtu_scene,
    read_resfield_scene,
)

SCENE_LOADERS = {
    "Colmap": read_colmap_scene_sparse,
    "ColmapHold": read_colmap_scene,
    "Blender_cv": read_nerf_synthetic_cv,
    "Blender": read_nerf_synthetic,
    "DTU": read_neus_dtu_scene,
    "nerfies": read_nerfies_scene_mv,
    "ResFields": read_resfield_scene,
}


def sniff_scene_type(source_path: str) -> str:
    """Marker-file dataset detection (reference ``scene/__init__.py:
    46-103``); the plenopticVideo, dynamic360 and PenopticSports markers
    are unsupported upstream too."""
    j = os.path.join
    if os.path.exists(j(source_path, "sparse")):
        return "Colmap"
    if os.path.exists(j(source_path, "transforms_train.json")):
        return "Blender_cv"
    if os.path.exists(j(source_path, "cameras_sphere.npz")):
        return "DTU"
    if os.path.exists(j(source_path, "dataset.json")):
        return "nerfies"
    if os.path.exists(j(source_path, "poses_bounds.npy")):
        raise NotImplementedError(
            "plenopticVideo marker found: unsupported in the reference "
            "(SceneInfo misses pred_cameras) and out of scope here")
    if os.path.exists(j(source_path, "transforms.json")):
        raise NotImplementedError("dynamic360 marker: dead path upstream")
    if os.path.exists(j(source_path, "init_pt_cld.npz")):
        raise NotImplementedError("PenopticSports marker: dead path upstream")
    return "ResFields"
