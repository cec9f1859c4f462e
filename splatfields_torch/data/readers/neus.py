"""NeuS-convention readers, host NumPy: DTU static scans and the
ResFields/Owlii multi-camera video (counterpart of
``splatfields_tpu/data/readers/neus.py``; reference
``scene/dataset_readers.py:118-138, 874-990, 1287-1690``).

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

- ``read_cameras_from_neus``: one camera directory of a ResFields scene
  (``cameras_sphere.npz``, ``image/`` or ``rgb/``, ``mask/``, ``depth/``):
  the masks composited onto the background, depth (16-bit, millimetres)
  scaled by ``1 / scale_mat[0, 0]`` with zero and masked-out depths at
  -1, ``fid = int(name) / max(n - 1, 1)`` over the frames kept.
- ``visual_hull_samples``: the reference's carve of a 256^3 grid by the
  frame-0 masks, then a seeded permutation of the survivors.
- ``read_neus_scene`` / ``read_resfield_scene``: train, test and pred
  camera lists, the ``f < load_time_step`` filter, radius 1, and the
  point init (``vertices``, ``random``, ``hull``, ``depth``).

Images, masks and depths are read by ``data/images.py`` and
``data/png.py``, where the JAX package uses PIL, imageio and cv2, each
as the library the JAX reader calls sees it: a DTU scan's images as
PIL's array and its masks as imageio's (``images.read_pil``); the
ResFields frames (``rgb/*.jpg`` too) as cv2's ``imread`` colour route
(grey replicated, alpha dropped, 16-bit samples shifted to 8 bits; the
mask is its blue channel) and ``IMREAD_UNCHANGED``'s uint16 depth. The
JAX reader stacks a camera's frames in float64 before it casts each to
float32; here each frame is computed in float64 and cast on its own, so
the values are equal and a directory never sits in memory in float64.
"""
from __future__ import annotations

import os
import tempfile
import uuid
from glob import glob
from pathlib import Path

import numpy as np

from splatfields_torch.data import images, png
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
        image = images.read_pil(images_lis[idx])
        mask = images.read_pil(masks_lis[idx], palette=True) / 255.0
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


# ---------------------------------------------------------------------------
# ResFields / Owlii multi-camera video
# ---------------------------------------------------------------------------

def _imread_unchanged(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_UNCHANGED)``: one channel squeezed, more
    in cv2's BGR(A) order (gray+alpha as BGRA)."""
    img = png.read(path)
    if img.shape[-1] == 1:
        return img[..., 0]
    if img.shape[-1] == 2:
        return img[..., [0, 0, 0, 1]]
    return np.concatenate([img[..., 2::-1], img[..., 3:]], -1)


def read_cameras_from_neus(data_dir, white_background, keep_fid=None,
                           fid_value=None):
    """One NeuS-style camera directory -> (cam_infos, all_pc): all_pc the
    depth maps' points and colours (xyz, rgb), or None without depth.
    ``keep_fid(frame index) -> bool`` filters the frames; ``fid_value``
    fixes every frame's fid (None: derived from the frame index)."""
    if not os.path.exists(data_dir):
        raise FileNotFoundError(data_dir)
    images_lis = sorted(
        glob(os.path.join(data_dir, "image/*.png"))
        + glob(os.path.join(data_dir, "rgb/*.png"))
        + glob(os.path.join(data_dir, "rgb/*.jpg")))
    frame_ids = [int(os.path.splitext(os.path.basename(p))[0])
                 for p in images_lis]
    cam_dict = np.load(os.path.join(data_dir, "cameras_sphere.npz"))

    def _sample(lst):
        if keep_fid is None:
            return lst
        return [x for x, f in zip(lst, frame_ids) if keep_fid(f)]

    world_mats = _sample([cam_dict[f"world_mat_{i}"].astype(np.float32)
                          for i in frame_ids])
    scale_mats = _sample([cam_dict[f"scale_mat_{i}"].astype(np.float32)
                          for i in frame_ids])
    intr, poses = parse_cam(scale_mats, world_mats)

    img_paths = _sample(images_lis)
    mask_paths = _sample(sorted(glob(os.path.join(data_dir, "mask/*.png"))))
    depth_paths = _sample(sorted(glob(os.path.join(data_dir,
                                                   "depth/*.png"))))
    c2w = poses[:, :3, :4]
    w2c_all = np.linalg.inv(poses)[:, :3, :4]
    KRT = intr[:, :3, :3] @ w2c_all
    has_masks = len(mask_paths) > 0
    has_depth = len(depth_paths) > 0
    bg = np.array([1, 1, 1] if white_background else [0, 0, 0])
    depth_scale = 1.0 / scale_mats[0][0, 0]
    n = len(img_paths)
    cam_infos, pc_xyz, pc_rgb = [], [], []
    for ci in range(n):
        # one frame in float64, as the JAX reader's stacked arrays hold it
        image = images.read_color(img_paths[ci]) / 255.0
        mask = None
        if has_masks:
            mask = images.read_color(mask_paths[ci])[..., 2:3] / 255.0
            image = image * mask + (1 - mask) * bg
        depth = None
        if has_depth:
            depth = _imread_unchanged(depth_paths[ci]) / 1000.0
            depth = depth * depth_scale
            depth[depth == 0] = -1.0
            if has_masks:
                depth[~(mask[..., 0] > 0)] = -1.0
            depth = depth.astype(np.float32)
        h, w = image.shape[:2]
        w2c = w2c_all[ci]
        K = intr[ci]
        name = Path(img_paths[ci]).stem
        fid = fid_value if fid_value is not None else int(name) / max(n - 1,
                                                                      1)
        cam_infos.append(CameraInfo(
            uid=ci, R=np.transpose(w2c[:3, :3]), T=w2c[:3, 3],
            FovY=focal2fov(K[1, 1], h), FovX=focal2fov(K[0, 0], w),
            image=image.astype(np.float32), image_path=img_paths[ci],
            image_name=name, width=w, height=h, fid=fid,
            mask=mask[..., 0].astype(np.float32) if has_masks else None,
            depth=depth, K=K, KRT=KRT[ci], pose=c2w[ci]))
        if depth is not None:
            xyz, rgb = _depth_to_points(depth, K, poses[ci], image)
            pc_xyz.append(xyz)
            pc_rgb.append(rgb)
    all_pc = None
    if pc_xyz:
        all_pc = (np.concatenate(pc_xyz), np.concatenate(pc_rgb))
    return cam_infos, all_pc


def _depth_to_points(depth, K, pose, image):
    """Reference ``_gen_3dpoints`` (:1476-1491): unit ray directions scaled
    by the depth (depth along the ray, not z) -> (xyz, rgb) float32."""
    h, w = depth.shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    p = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
    rays = p @ np.linalg.inv(K[:3, :3]).T
    rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
    rays_w = rays @ pose[:3, :3].T
    origin = pose[:3, 3]
    m = depth > 0
    pts = origin[None] + depth[m, None] * rays_w[m]
    return pts.astype(np.float32), image[m].astype(np.float32)


def visual_hull_samples(masks, KRT, n_pts=100_000, grid_resolution=256,
                        aabb=(-1.0, 1.0), seed=None, chunk=1 << 20):
    """Hull carving by nearest-mask sampling (reference :1385-1417): the
    points of a ``grid_resolution``^3 ``meshgrid`` (xy indexing) over
    ``aabb`` that project (rounded, in bounds) into every mask, permuted
    by ``RandomState(seed)``, the first ``n_pts``, float32.

    The grid goes ``chunk`` points at a time and each camera projects
    only the points still alive, with the JAX reader's own product per
    point, so the survivors are the same points in the same order."""
    grid = np.linspace(aabb[0], aabb[1], grid_resolution)
    g = grid_resolution
    kept = []
    for lo in range(0, g ** 3, chunk):
        r = np.arange(lo, min(lo + chunk, g ** 3))
        # meshgrid's xy indexing: flat index (i, j, k) -> (x_j, y_i, z_k)
        pts = np.stack([grid[(r // g) % g], grid[r // (g * g)],
                        grid[r % g]], -1)
        for ci in range(KRT.shape[0]):
            mask = masks[ci]
            if mask.ndim == 3:
                mask = mask[..., 0]
            h, w = mask.shape
            proj = (np.concatenate([pts, np.ones_like(pts[:, :1])], 1)
                    @ KRT[ci].T)
            u = proj[:, 0] / proj[:, 2]
            v = proj[:, 1] / proj[:, 2]
            ui = np.clip(np.round(u).astype(int), 0, w - 1)
            vi = np.clip(np.round(v).astype(int), 0, h - 1)
            inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
            pts = pts[np.where(inb, mask[vi, ui] > 0, False)]
        kept.append(pts)
    out = np.concatenate(kept)
    rng = np.random.RandomState(seed) if seed is not None else np.random
    perm = rng.permutation(out.shape[0])
    return out[perm][:n_pts].astype(np.float32)


def read_neus_scene(path, white_background, train_cam_names, test_cam_names,
                    pred_cam_names, resfield=False, load_time_step=10000,
                    num_pts=100_000, pts_samples="random", seed=0):
    """reference ``readNeuSceneInfo``: a ResFields scene (one directory
    per camera, ``resfield=True``) or one NeuS directory. The point
    init's colours come from ``RandomState(seed)``, the hull's order from
    a second ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    fid_value = 0 if load_time_step == 1 else None
    keep = (lambda f: f < load_time_step) if resfield else None

    def read_cams(names, keep_fid):
        infos, pcs = [], []
        for nm in names:
            ci, pc = read_cameras_from_neus(
                os.path.join(path, nm), white_background, keep_fid, fid_value)
            infos.extend(ci)
            if pc is not None:
                pcs.append(pc)
        all_pc = None
        if pcs:
            all_pc = (np.concatenate([p[0] for p in pcs]),
                      np.concatenate([p[1] for p in pcs]))
        return infos, all_pc

    if resfield:
        train_cam_infos, all_pc = read_cams(train_cam_names, keep)
        test_cam_infos, _ = read_cams(test_cam_names, keep)
        pred_cam_infos, _ = read_cams(pred_cam_names, None)
    else:
        train_cam_infos, all_pc = read_cameras_from_neus(
            path, white_background, None, fid_value)
        test_cam_infos, pred_cam_infos = [], []

    if pts_samples == "vertices":
        data = np.load(os.path.join(path, "vertices.npz"))
        xyz = data["vertices"][data["seg"] == 1.0]
        colors = rng.random((xyz.shape[0], 3)) / 255.0
    elif pts_samples == "random":
        xyz = rng.random((num_pts, 3)) * 1.8 - 1.0  # [-1, 0.8) per reference
        colors = rng.random((num_pts, 3)) / 255.0
    elif pts_samples == "hull":
        aabb = (-1.0, 1.0)
        if all_pc is not None:
            aabb = (all_pc[0].min(), all_pc[0].max())
        frame0 = [c for c in train_cam_infos if c.fid == 0]
        xyz = visual_hull_samples(
            np.stack([c.mask for c in frame0]),
            np.stack([c.KRT for c in frame0]), n_pts=num_pts,
            grid_resolution=256, aabb=aabb, seed=seed)
        colors = rng.random((xyz.shape[0], 3)) / 255.0
    elif pts_samples == "depth":
        if all_pc is None:
            raise ValueError("pts_samples 'depth' needs depth maps")
        xyz, colors = all_pc
        if xyz.shape[0] > num_pts:
            ind = rng.choice(xyz.shape[0], num_pts, replace=False)
            xyz, colors = xyz[ind], colors[ind]
    else:
        raise NotImplementedError(pts_samples)

    ply_path = os.path.join(
        tempfile.gettempdir(), f"splatfields_init_{uuid.uuid4().hex}.ply")
    store_pointcloud(ply_path, xyz, colors)
    return SceneInfo(
        point_cloud=BasicPointCloud(
            points=xyz.astype(np.float32), colors=colors.astype(np.float32),
            normals=np.zeros_like(xyz, dtype=np.float32)),
        train_cameras=train_cam_infos, test_cameras=test_cam_infos,
        pred_cameras=pred_cam_infos,
        nerf_normalization={"translate": np.zeros(3, np.float32),
                            "radius": 1.0},
        ply_path=ply_path, extra={"penoptic": pts_samples == "vertices"})


def read_resfield_scene(path, white_background, train_cam_names,
                        test_cam_names, pred_cam_names, load_time_step=10000,
                        num_pts=100_000, pts_samples="random", **_):
    """reference ``readResFieldSceneInfo``: the Owlii layout, one
    directory per camera."""
    return read_neus_scene(
        path, white_background, train_cam_names, test_cam_names,
        pred_cam_names, resfield=True, load_time_step=load_time_step,
        num_pts=num_pts, pts_samples=pts_samples)
