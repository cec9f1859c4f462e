"""COLMAP model files, binary and text (counterpart of
``splatfields_tpu/data/colmap_io.py``; the reference's
``scene/colmap_loader.py``).

The camera-model table, ``qvec2rotmat`` / ``rotmat2qvec``, the readers of
``cameras``, ``images`` and ``points3D`` in both forms, and the two text
writers, per the public COLMAP model format. Records, ids and float64
values equal the JAX package's on every file it parses, with two
differences of method and one of behaviour:

- ``read_points3d_binary`` walks the track lengths alone and reads the
  fixed part of every record with one ``np.frombuffer`` gather, where the
  JAX reader unpacks the points one at a time;
- ``read_images_text`` reads each image's POINTS2D line as the line right
  after it, as upstream's ``read_extrinsics_text`` does, so an image
  without 2-D points (COLMAP writes an empty line for it, and so does
  ``write_images_text``) reads as an image with none. The JAX reader
  drops blank lines before it pairs the lines, so it raises on such a
  file (ROADMAP, "Differences kept on purpose").
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_BY_NAME = {v[0]: (k, v[1]) for k, v in CAMERA_MODELS.items()}

# points3D.bin: id u64, xyz 3 x f64, rgb 3 x u8, error f64, track length
# u64, then track length x (image id i32, point2D index i32)
_POINT_HEAD = 8 + 24 + 3 + 8 + 8


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def qvec2rotmat(qvec):
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y**2 - 2 * z**2, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x**2 - 2 * z**2, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x**2 - 2 * y**2],
    ])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * n_params, "d" * n_params))
            cams[cid] = ColmapCamera(cid, name, w, h, params)
    return cams


def read_cameras_text(path):
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid = int(parts[0])
        cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]), int(parts[3]),
                                 np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (num,) = _read(f, 8, "Q")
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            ch = f.read(1)
            while ch != b"\x00":
                name += ch
                ch = f.read(1)
            (n_pts,) = _read(f, 8, "Q")
            data = np.frombuffer(f.read(24 * n_pts),
                                 dtype=[("xy", "<f8", 2), ("id", "<i8")])
            images[iid] = ColmapImage(
                iid, qvec, tvec, cam_id, name.decode("utf-8"),
                np.array(data["xy"]), np.array(data["id"]))
    return images


def read_images_text(path):
    """Each image line is followed by its POINTS2D line, which may be
    empty (upstream's ``read_extrinsics_text``)."""
    images = {}
    with open(path) as f:
        while True:
            line = f.readline()
            if not line:
                break
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            iid = int(parts[0])
            qvec = np.array([float(p) for p in parts[1:5]])
            tvec = np.array([float(p) for p in parts[5:8]])
            cam_id = int(parts[8])
            name = parts[9]
            elems = f.readline().split()
            xys = np.array([float(e) for e in elems]).reshape(-1, 3)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name,
                                      xys[:, :2], xys[:, 2].astype(np.int64))
    return images


def read_points3d_binary(path):
    """(xyz [N, 3], rgb [N, 3], error [N]), float64. The tracks' lengths
    are walked to find each record; the records' fixed parts are read
    in one gather."""
    with open(path, "rb") as f:
        data = f.read()
    (num,) = struct.unpack_from("<Q", data, 0)
    offsets = np.empty(num, np.int64)
    pos = 8
    for i in range(num):
        offsets[i] = pos
        (track_len,) = struct.unpack_from("<Q", data, pos + _POINT_HEAD - 8)
        pos += _POINT_HEAD + 8 * track_len
    buf = np.frombuffer(data, np.uint8)

    def field(start, n_bytes, dtype):
        idx = offsets[:, None] + np.arange(start, start + n_bytes)
        return buf[idx].copy().view(dtype)

    xyz = field(8, 24, "<f8").astype(np.float64)
    rgb = field(32, 3, np.uint8).astype(np.float64)
    err = field(35, 8, "<f8")[:, 0].astype(np.float64)
    return xyz, rgb, err


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        xyz.append([float(p) for p in parts[1:4]])
        rgb.append([float(p) for p in parts[4:7]])
        err.append(float(parts[7]))
    return np.array(xyz), np.array(rgb), np.array(err)


def write_cameras_text(path, cams):
    with open(path, "w") as f:
        for c in cams.values():
            params = " ".join(str(p) for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def write_images_text(path, images):
    with open(path, "w") as f:
        for im in images.values():
            q = " ".join(str(v) for v in im.qvec)
            t = " ".join(str(v) for v in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")
