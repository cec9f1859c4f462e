"""The port's C++ hull carver and the NeuS point helpers against the JAX
package on the CPU.

The camera set-ups are tests/test_native.py's, rebuilt here. Held
exactly: the port's native keep mask against the JAX native one in modes
0 and 1, ``visual_hull_samples_krt`` and ``unproject_depths``. Against
the NumPy routes the native mask stays within the band of rounding ties
that tests/test_native.py allows (under 1e-3 of the points).
"""
import numpy as np
import pytest
import torch

from splatfields_torch import native as tnative
from splatfields_torch.data import point_init as tpi
from splatfields_torch.data.cameras import Camera as TCamera
from splatfields_tpu import native as jnative
from splatfields_tpu.data import point_init as jpi
from splatfields_tpu.data.cameras import Camera as JCamera

TIE_BAND = 1e-3


def _poses(n, res, seed):
    rng = np.random.RandomState(seed)
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([3 * np.cos(ang), 3 * np.sin(ang), 0.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        R_c2w = np.stack([right, -np.cross(right, fwd), fwd], axis=1)
        mask = (rng.rand(res, res) > 0.3).astype(np.float32)
        yield i, R_c2w, -R_c2w.T @ pos, mask


def make_cams(n=4, res=48, seed=0):
    """(JAX cameras, port cameras) of tests/test_native.py's orbit."""
    jc, tc = [], []
    for i, R, T, mask in _poses(n, res, seed):
        kw = dict(uid=i, colmap_id=i, R=R, T=T, FoVx=0.9, FoVy=0.9,
                  image_name=f"c{i}", image_width=res, image_height=res,
                  fid=0.0)
        jc.append(JCamera(**kw, mask=mask[None]))
        tc.append(TCamera(**kw, mask=torch.tensor(mask[None])))
    return jc, tc


def krt_setup(n_cams=3, res=40, seed=2):
    rng = np.random.RandomState(seed)
    masks = (rng.rand(n_cams, res, res) > 0.3).astype(np.float32)
    KRT = []
    for i in range(n_cams):
        K = np.array([[40.0, 0, res / 2], [0, 40.0, res / 2], [0, 0, 1]])
        ang = 2 * np.pi * i / n_cams
        Rw = np.array([[np.cos(ang), -np.sin(ang), 0],
                       [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
        KRT.append(K @ np.concatenate([Rw, [[0], [0], [3.0]]], 1))
    return masks, np.stack(KRT).astype(np.float32), rng


def test_mode0_equals_jax_native_and_the_numpy_routes():
    jc, tc = make_cams()
    pts = np.random.RandomState(1).uniform(-1, 1, (5000, 3)).astype(
        np.float32)
    got = tpi.mask_filter_points(pts, tc)
    np.testing.assert_array_equal(
        got, jpi.mask_filter_points(pts, jc, use_native=True))
    mats = np.stack([c.full_proj_transform for c in jc]).astype(np.float32)
    np.testing.assert_array_equal(
        tnative.carve_points(pts, mats, [c.mask[0] for c in jc], 0),
        jnative.carve_points(pts, mats, [c.mask[0] for c in jc], 0))
    numpy_route = tpi.mask_filter_points(pts, tc, use_native=False)
    np.testing.assert_array_equal(
        numpy_route, jpi.mask_filter_points(pts, jc, use_native=False))
    assert (got != numpy_route).mean() < TIE_BAND
    assert 0 < got.sum() < len(got)


def test_hull_grid_on_the_native_route():
    jc, tc = make_cams(seed=3)
    want = jpi.visual_hull_from_grid(jc, (-1.0, 1.0), 48, 2000,
                                     rng=np.random.RandomState(0))
    got = tpi.visual_hull_from_grid(tc, (-1.0, 1.0), 48, 2000,
                                    rng=np.random.RandomState(0))
    np.testing.assert_array_equal(got, want)


def test_mode1_equals_jax_native():
    masks, KRT, rng = krt_setup()
    pts = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    got = tnative.carve_points(pts, KRT, list(masks), mode=1, n_threads=3)
    np.testing.assert_array_equal(
        got, jnative.carve_points(pts, KRT, list(masks), mode=1))
    # tests/test_native.py's NumPy mirror of the NeuS test
    keep = np.ones(pts.shape[0], bool)
    res = masks.shape[1]
    for ci in range(len(KRT)):
        proj = np.concatenate([pts, np.ones_like(pts[:, :1])], 1) @ KRT[ci].T
        u, v = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
        ui = np.clip(np.round(u).astype(int), 0, res - 1)
        vi = np.clip(np.round(v).astype(int), 0, res - 1)
        inb = (u >= 0) & (u <= res - 1) & (v >= 0) & (v <= res - 1)
        keep &= np.where(inb, masks[ci][vi, ui] > 0, False)
    assert (got != keep).mean() < TIE_BAND
    assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("masked", [True, False])
def test_visual_hull_samples_krt(masked):
    masks, KRT, _ = krt_setup(seed=4)
    if not masked:   # nothing survives: the random cube
        masks = np.zeros_like(masks)
    kw = dict(n_pts=3000, grid_resolution=24, seed=5)
    np.testing.assert_array_equal(
        tpi.visual_hull_samples_krt(masks, KRT.astype(np.float64), **kw),
        jpi.visual_hull_samples_krt(masks, KRT.astype(np.float64), **kw))


@pytest.mark.parametrize("max_pts", [200_000, 500])
def test_unproject_depths(max_pts):
    rng = np.random.RandomState(6)
    depths = rng.uniform(0.5, 3.0, (3, 20, 24)) * (rng.rand(3, 20, 24) > 0.2)
    masks = (rng.rand(3, 20, 24) > 0.3).astype(np.float32)
    K = np.tile(np.array([[30.0, 0, 12], [0, 30.0, 10], [0, 0, 1]]),
                (3, 1, 1))
    c2w = np.tile(np.eye(4), (3, 1, 1))
    c2w[:, :3, 3] = rng.randn(3, 3)
    got = tpi.unproject_depths(depths, masks, K, c2w, max_pts, seed=7)
    np.testing.assert_array_equal(
        got, jpi.unproject_depths(depths, masks, K, c2w, max_pts, seed=7))
    assert got.shape[0] == min(max_pts, int(((masks > 0) & (depths > 0))
                                            .sum()))


def test_library_named_by_source_and_failed_build_raises(tmp_path,
                                                          monkeypatch):
    path = tnative.lib_path("hullcarve")
    assert path.parent == tnative.BUILD_DIR and path.name.startswith(
        "libhullcarve-")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SRC_DIR", tmp_path)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on broken.cpp"):
        tnative.library("broken", {})
