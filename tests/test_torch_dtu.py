"""The port's DTU reader (``splatfields_torch/data/readers/neus.py``) and its
place in ``Scene`` against the JAX package's, on the CPU.

``load_k_rt_from_p``: the port replays cv2's ``RQDecomp3x3`` in NumPy.
Over seeded DTU-form projections (K [R|t] times a scale, rotations
proper and improper, focal and scale signs flipped, so that cv2's
180-degree fixes are taken) K and the rotation equal cv2's to 1e-12 (both
float64, the same Givens steps); the camera centre is the projection's
null vector, which cv2 takes from a float32 SVD, so it agrees to f32
rounding (rtol 1e-6). Needs cv2 (the JAX reader's route), so it skips
where cv2 is absent.

``read_neus_dtu_scene`` on tests/test_protocol_scripts.py's synthetic
DTU scan (its fixture's construction, copied below: six 48x48 views of
``cameras_sphere.npz`` cameras, ground truth rendered by the JAX
rasterizer, RGB masks), and on a non-square 64x40 scan: every
``CameraInfo`` field (images and masks exactly, matrices to f32
rounding, rtol 1e-6 with an absolute 1e-6) and the random-cube
``points3d.ply`` byte for byte, each package writing its own into its
own copy of the scan.

The half-resolution DTU frames have a partial bottom row of tiles (600 of
1600x1200 / 2 is 37.5 tiles): the rasterizer's upstream gradient reaches
the blend as zero on every off-image pixel (checked at 45x37 here, and
on the card by tests/test_torch_partial_tiles_cuda.py).
"""
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_torch.config import ModelConfig
from splatfields_torch.data import png
from splatfields_torch.data.cameras import camera_matrices
from splatfields_torch.data.readers import neus as tneus
from splatfields_torch.ops.raster import api as tapi
from splatfields_torch.ops.raster import blend_cuda
from splatfields_torch.scene import Scene

cv2 = pytest.importorskip("cv2")
jneus = pytest.importorskip("splatfields_tpu.data.readers.neus")


# --- tests/test_protocol_scripts.py's DTU fixture, copied -----------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_png(path, arr):
    import PIL.Image
    PIL.Image.fromarray(arr).save(path)


def _camera_npz_entry(theta, radius=4.0, res=48, focal=55.0):
    """One camera: K and a w2c looking at the origin from angle theta."""
    c, s = np.cos(theta), np.sin(theta)
    center = np.array([radius * s, 0.35, radius * c], np.float32)
    fwd = -center / np.linalg.norm(center)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R_c2w = np.stack([right, up2, fwd], axis=1)  # columns
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R_c2w.T
    w2c[:3, 3] = -R_c2w.T @ center
    K4 = np.eye(4, dtype=np.float32)
    K4[0, 0] = K4[1, 1] = focal
    K4[0, 2] = K4[1, 2] = res / 2.0
    return (K4 @ w2c).astype(np.float32)


def _gt_splats(seed=5, n=250):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    scales = (0.05 + 0.05 * rng.rand(n, 3)).astype(np.float32)
    rots = rng.randn(n, 4).astype(np.float32)
    ops = rng.uniform(0.6, 0.95, n).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    return base, scales, rots, ops, cols


def _render_through_reader(cam_info, splats):
    from splatfields_tpu.data.cameras import load_cam
    from splatfields_tpu.ops.raster.api import rasterize

    base, scales, rots, ops, cols = splats
    cam = load_cam(cam_info, -1, 0, 1.0, max_resolution=4096)
    out = rasterize(
        jnp.asarray(base), jnp.asarray(scales), jnp.asarray(rots),
        jnp.asarray(ops), jnp.asarray(cam.world_view_transform),
        jnp.asarray(cam.full_proj_transform), jnp.asarray(cam.camera_center),
        jnp.asarray(np.zeros(3, np.float32)),
        cam.tanfovx, cam.tanfovy, cam.image_width, cam.image_height,
        colors_precomp=jnp.asarray(cols), tile_cap=256, k_chunk=64,
        blend_impl="jax")
    rgb = np.clip(np.asarray(out.color).transpose(1, 2, 0), 0, 1)
    alpha = np.clip(np.asarray(out.alpha)[0], 0, 1)
    return rgb, alpha


def _fill_dir(cam_dir, entries, splats, res):
    os.makedirs(os.path.join(cam_dir, "image"), exist_ok=True)
    os.makedirs(os.path.join(cam_dir, "mask"), exist_ok=True)
    npz = {}
    for i, wm in enumerate(entries):
        npz[f"world_mat_{i}"] = wm
        npz[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        _write_png(os.path.join(cam_dir, "image", f"{i:03d}.png"),
                   np.zeros((res, res, 3), np.uint8))
        _write_png(os.path.join(cam_dir, "mask", f"{i:03d}.png"),
                   np.full((res, res, 3), 255, np.uint8))
    np.savez(os.path.join(cam_dir, "cameras_sphere.npz"), **npz)
    infos, _ = jneus.read_cameras_from_neus(cam_dir, False)
    for i, info in enumerate(infos):
        rgb, alpha = _render_through_reader(info, splats)
        _write_png(os.path.join(cam_dir, "image", f"{i:03d}.png"),
                   (rgb * 255).astype(np.uint8))
        _write_png(os.path.join(cam_dir, "mask", f"{i:03d}.png"),
                   np.repeat((alpha > 0.2)[..., None], 3, -1).astype(
                       np.uint8) * 255)


@pytest.fixture(scope="module")
def dtu_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("dtu") / "scan_t"
    root.mkdir()
    entries = [_camera_npz_entry(th, res=48)
               for th in (0.0, 0.9, 1.8, 2.7, 3.6, 4.5)]
    _fill_dir(str(root), entries, _gt_splats(), 48)
    return str(root)


# --- the tests ------------------------------------------------------------

def _projections(n=400, seed=0):
    """DTU-form 3x4 projections: K [R | t] times a scale, f32."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        q = -q if i % 3 == 0 else q
        k = np.array([[rng.uniform(500, 3000), rng.uniform(-5, 5),
                       rng.uniform(300, 900)],
                      [0, rng.uniform(500, 3000), rng.uniform(200, 700)],
                      [0, 0, 1]])
        k[0] *= -1 if i % 5 == 1 else 1
        k[1] *= -1 if i % 7 == 2 else 1
        rt = np.concatenate([q, rng.randn(3, 1) * 3], 1)
        sign = -1 if i % 11 == 3 else 1
        out.append((k @ rt * rng.uniform(0.1, 10) * sign).astype(np.float32))
    return out


def test_rq_matches_cv2():
    signs = set()
    for P in _projections():
        K, R, t = cv2.decomposeProjectionMatrix(P)[:3]
        m = P[:, :3].astype(np.float64)
        k, r = tneus.rq_decomp3x3(m)
        np.testing.assert_allclose(k, K, rtol=0, atol=1e-12 * np.abs(K).max())
        np.testing.assert_allclose(r, R, rtol=0, atol=1e-12)
        signs.add(tuple(np.sign(np.diag(K)).astype(int)))
        kk, pose = tneus.load_k_rt_from_p(P)
        np.testing.assert_allclose(kk, (K / K[2, 2]).astype(np.float32),
                                   rtol=1e-6)
        np.testing.assert_allclose(pose[:3, 3], (t[:3] / t[3])[:, 0],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pose[:3, :3], R.T.astype(np.float32),
                                   rtol=0, atol=1e-7)
    # the Givens rotations give a proper R, so the projection's sign
    # lands in K[2, 2]; cv2's fixes keep K[0, 0] and K[1, 1] positive
    assert signs == {(1, 1, 1), (1, 1, -1)}


def test_load_k_rt_from_p_matches_jax():
    for P in _projections(60, seed=1):
        kt, pt = tneus.load_k_rt_from_p(P)
        kj, pj = jneus.load_k_rt_from_p(P)
        assert kt.dtype == kj.dtype == np.float32
        assert pt.dtype == pj.dtype == np.float32
        np.testing.assert_array_equal(kt, kj)
        np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-6)


def _copy(src, dst):
    shutil.copytree(src, dst)
    if os.path.exists(os.path.join(dst, "points3d.ply")):
        os.remove(os.path.join(dst, "points3d.ply"))
    return str(dst)


def _compare_scans(src, tmp_path, num_pts):
    t_dir = _copy(src, tmp_path / "torch")
    j_dir = _copy(src, tmp_path / "jax")
    got = tneus.read_neus_dtu_scene(t_dir, num_pts=num_pts)
    want = jneus.read_neus_dtu_scene(j_dir, num_pts=num_pts)
    assert len(got.train_cameras) == len(want.train_cameras) > 0
    assert got.test_cameras == want.test_cameras == []
    for g, w in zip(got.train_cameras, want.train_cameras):
        assert type(g).__name__ == type(w).__name__ == "CameraInfo"
        names = [f.name for f in dataclasses.fields(w)]
        assert [f.name for f in dataclasses.fields(g)] == names
        for f in names:
            gv, wv = getattr(g, f), getattr(w, f)
            if f == "image_path":
                gv, wv = os.path.relpath(gv, t_dir), os.path.relpath(wv, j_dir)
            if f in ("image", "mask"):
                assert gv.dtype == wv.dtype, f
                np.testing.assert_array_equal(gv, wv, err_msg=f)
            elif f in ("R", "T", "FovX", "FovY"):
                np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6,
                                           err_msg=f)
            else:
                assert gv == wv, f
    np.testing.assert_allclose(got.nerf_normalization["radius"],
                               want.nerf_normalization["radius"], rtol=1e-6)
    np.testing.assert_allclose(got.nerf_normalization["translate"],
                               want.nerf_normalization["translate"],
                               rtol=1e-6, atol=1e-6)
    with open(got.ply_path, "rb") as f, open(want.ply_path, "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(got.point_cloud.points,
                                  want.point_cloud.points)
    np.testing.assert_array_equal(got.point_cloud.colors,
                                  want.point_cloud.colors)
    return got


def test_read_neus_dtu_scene(dtu_scene, tmp_path):
    info = _compare_scans(dtu_scene, tmp_path, 500)
    assert len(info.train_cameras) == 6
    assert info.point_cloud.points.shape == (500, 3)
    assert 0.02 < float(info.train_cameras[0].mask.mean()) < 0.9


def test_non_square_scan(tmp_path):
    src = tmp_path / "scan_ns"
    rng = np.random.RandomState(7)
    os.makedirs(src / "image")
    os.makedirs(src / "mask")
    npz = {}
    for i, th in enumerate((0.2, 1.4, 2.9)):
        npz[f"world_mat_{i}"] = _camera_npz_entry(th, res=64)
        npz[f"scale_mat_{i}"] = np.diag([1.5, 1.5, 1.5, 1.0]).astype(
            np.float32)
        png.write(str(src / "image" / f"{i:03d}.png"),
                  rng.randint(0, 256, (40, 64, 3)).astype(np.uint8))
        png.write(str(src / "mask" / f"{i:03d}.png"),
                  (rng.rand(40, 64, 3) > 0.4).astype(np.uint8) * 255)
    np.savez(src / "cameras_sphere.npz", **npz)
    info = _compare_scans(str(src), tmp_path, 300)
    cam = info.train_cameras[0]
    assert (cam.width, cam.height) == (64, 40)
    # Scene's DTU branch: every view a train view, at -r 2
    cfg = ModelConfig(source_path=str(src), model_path=str(tmp_path / "out"),
                      resolution=2, num_pts=300, sh_degree=0)
    scene = Scene(cfg, device="cpu")
    assert scene.scene_type == "DTU"
    assert len(scene.get_train_cameras()) == 3 and not scene.get_test_cameras()
    assert scene.get_train_cameras()[0].image.shape == (3, 20, 32)
    assert scene.splats.capacity == 300


def test_partial_tiles_get_zero_upstream_gradient(monkeypatch):
    """45x37 at tile 16: the last tile column and row lie partly off the
    image; their off-image pixels reach the blend's VJP as zero."""
    w, h = 45, 37
    rng = np.random.RandomState(0)
    n = 400
    means = torch.tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32)
    scales = torch.full((n, 3), 0.08)
    rots = torch.tensor(rng.randn(n, 4), dtype=torch.float32)
    opac = torch.full((n,), 0.5, requires_grad=True)
    cols = torch.tensor(rng.rand(n, 3), dtype=torch.float32)
    fov = 2 * np.arctan(0.5)
    view, full, _, center = camera_matrices(
        np.eye(3), np.array([0.0, 0.0, 4.0]), fov, fov)
    seen = {}
    plain = blend_cuda.blend_bwd_plain

    def spy(*args):
        seen["g"] = args[4:7]
        return plain(*args)

    monkeypatch.setattr(blend_cuda, "blend_bwd_plain", spy)
    out = tapi.rasterize(means, scales, rots, opac, torch.as_tensor(view),
                         torch.as_tensor(full), torch.as_tensor(center),
                         torch.ones(3), 0.5, 0.5, w, h, colors_precomp=cols,
                         k_chunk=64)
    assert out.color.shape == (3, h, w)
    g = torch.tensor(rng.randn(3, h, w), dtype=torch.float32)
    (out.color * g).sum().add(out.alpha.sum()).backward()
    assert float(opac.grad.abs().max()) > 0
    g_color, g_depth, g_tfinal = seen["g"]
    tiles_x, tiles_y = -(-w // 16), -(-h // 16)
    ys, xs = np.divmod(np.arange(256), 16)
    off = 0
    for t in range(tiles_x * tiles_y):
        ty, tx = divmod(t, tiles_x)
        outside = torch.as_tensor((ty * 16 + ys >= h) | (tx * 16 + xs >= w))
        off += int(outside.sum())
        for gg in (g_color[t], g_depth[t], g_tfinal[t]):
            assert float(gg[..., outside].abs().sum()) == 0.0
        inside = ~outside
        assert float(g_color[t][..., inside].abs().max()) > 0
    assert off == tiles_x * tiles_y * 256 - w * h
