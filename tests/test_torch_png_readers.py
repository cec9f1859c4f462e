"""The port's Blender and Colmap readers against the JAX package's on PNG
frames of every kind whose ``PIL.Image.convert`` differs from libpng's
expansion: 16-bit gray (clipped at 255), gray+alpha, RGB and RGBA (each
sample's high byte), 16-bit gray and RGB with a ``tRNS`` key (ignored),
2- and 4-bit gray with a ``tRNS`` key (PIL holds the unscaled key
against the scaled samples), and the 8-bit kinds with ``tRNS`` or alpha
(gray, RGB, palette, gray+alpha). Each kind is one 7x9 frame of a tiny
scene, read by both Blender loaders (``read_cameras_from_transforms_cv``,
``read_cameras_from_transforms``) and by ``read_colmap_cameras`` with
and without a masks folder, white and black backgrounds: images and
masks equal, 0 levels of difference."""
import json
import os
import struct
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_png import _samples, _write  # noqa: E402

from splatfields_torch.data import colmap_io as tcolmap_io  # noqa: E402
from splatfields_torch.data import png  # noqa: E402
from splatfields_torch.data.readers import blender as tblender  # noqa: E402
from splatfields_torch.data.readers import colmap as tcolmap  # noqa: E402
from splatfields_tpu.data.readers import blender as jblender  # noqa: E402
from splatfields_tpu.data.readers import colmap as jcolmap  # noqa: E402

# name: (colour type, depth, tRNS key)
KINDS = {
    "gray16": (0, 16, False), "gray_alpha16": (4, 16, False),
    "rgb16": (2, 16, False), "rgba16": (6, 16, False),
    "gray16-trns": (0, 16, True), "rgb16-trns": (2, 16, True),
    "gray2-trns": (0, 2, True), "gray4-trns": (0, 4, True),
    "gray8-trns": (0, 8, True), "rgb8-trns": (2, 8, True),
    "palette8-trns": (3, 8, True), "gray_alpha8": (4, 8, False)}


def _frame(kind, seed=3):
    """PNG bytes of ``kind``: 7x9 samples at the file's depth, the
    ``tRNS`` key (palette: an alpha a entry) taken from the first pixel so
    it matches."""
    ctype, depth, trns = KINDS[kind]
    s, pal = _samples(ctype, depth, (7, 9), seed)
    data = _write(s, depth, ctype, False, 0, pal)
    if not trns:
        return data
    if ctype == 0:
        key = struct.pack(">H", int(s[0, 0, 0]))
    elif ctype == 2:
        key = struct.pack(">3H", *(int(v) for v in s[0, 0]))
    else:
        key = bytes(range(0, 256, 7))[:2 ** depth]
    at = data.index(b"IDAT") - 4
    return data[:at] + png._chunk(b"tRNS", key) + data[at:]


def _blender_scene(root, data):
    os.makedirs(os.path.join(root, "train"))
    with open(os.path.join(root, "train", "r_0.png"), "wb") as f:
        f.write(data)
    pose = np.eye(4)
    pose[:3, 3] = [0.0, -4.0, 0.5]
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump({"camera_angle_x": 0.8, "frames": [
            {"file_path": "./train/r_0", "transform_matrix": pose.tolist()}]},
            f)


@pytest.mark.parametrize("kind", list(KINDS))
def test_readers_see_the_frame_as_the_jax_readers(kind, tmp_path):
    data = _frame(kind)
    root = str(tmp_path / "lego")
    _blender_scene(root, data)
    for white in (True, False):
        for name in ("read_cameras_from_transforms_cv",
                     "read_cameras_from_transforms"):
            got = getattr(tblender, name)(root, "transforms_train.json",
                                          white)
            want = getattr(jblender, name)(root, "transforms_train.json",
                                           white)
            if name.endswith("_cv"):
                got, want = got[0], want[0]
            np.testing.assert_array_equal(got[0].image, want[0].image)
            np.testing.assert_array_equal(got[0].mask, want[0].mask)

    images = os.path.join(root, "train")
    extr = {1: tcolmap_io.ColmapImage(
        1, np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3), 1, "r_0.png",
        np.zeros((0, 2)), np.zeros(0, np.int64))}
    intr = {1: tcolmap_io.ColmapCamera(1, "PINHOLE", 9, 7,
                                       np.array([5.0, 5.0, 4.5, 3.5]))}
    for masks in (None, images):
        for white in (True, False):
            got = tcolmap.read_colmap_cameras(extr, intr, images, masks,
                                              white)[0]
            want = jcolmap.read_colmap_cameras(extr, intr, images, masks,
                                               white)[0]
            np.testing.assert_array_equal(got.image, want.image)
            if masks is None:
                assert got.mask is None and want.mask is None
            else:
                np.testing.assert_array_equal(got.mask, want.mask)
