"""The nerfies reader against the JAX package's on the CPU, its spline
path, ``Scene``'s nerfies branch, and ``ops/ssim.masked_ssim``.

The capture is ``chip_smoke.write_nerfies_scene`` at 64x36: 13 rig
cameras (ids 0-12, so the spline path's keyframes all exist) over 4
times, camera 12 the val camera, ``rgb/1x`` and ``rgb/2x``, a DUSt3R cloud
of 800 points. The reader takes the dataset branch from the name of the
scene's parent directory, so the same scene is linked under ``interp_t``
and ``hyper_t`` for the other two branches. Held equal on each branch,
with and without ``load_time_step``'s filter: every ``CameraInfo`` field
(images bit for bit against PIL's decode, R and T within 1e-9; the 650
spline cameras are the same float64 arithmetic), the split, the points
(subsampled, shifted and scaled) and their random colours; the fallback
to the test cameras when a rig id is missing at time 0. ``masked_ssim``
within 1e-6 of the JAX function.
"""
import dataclasses
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import config as tcfg
from splatfields_torch.data import registry
from splatfields_torch.data.readers import nerfies
from splatfields_torch.ops.ssim import masked_ssim
from splatfields_torch.scene import Scene
from splatfields_tpu.data.readers import nerfies as jax_nerfies
from splatfields_tpu.ops import ssim as jax_ssim

W, H, TIMES, POINTS = 64, 36, 4, 800


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (see tests/test_torch_owlii.py:
    the suite's workers share the CPU's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """{branch: scene path}: the vrig scene and its links."""
    base = tmp_path_factory.mktemp("nerfies")
    vrig = chip_smoke.write_nerfies_scene(base, W, H, TIMES, "cpu",
                                          n_splats=1000, n_points=POINTS,
                                          scales=(1, 2))
    out = {"vrig": vrig}
    for branch in ("interp_t", "hyper_t"):
        os.makedirs(base / branch)
        out[branch] = str(base / branch / chip_smoke.NERFIES_SCENE)
        os.symlink(vrig, out[branch])
    return out


def _same_infos(got, want, tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if f.name in ("R", "T"):
                assert a.dtype == b.dtype
                np.testing.assert_allclose(a, b, rtol=0, atol=tol)
            elif isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


def _same_scene(got, want):
    for split in ("train_cameras", "test_cameras"):
        _same_infos(getattr(got, split), getattr(want, split))
    _same_infos(got.pred_cameras, want.pred_cameras, tol=1e-9)
    for k in ("points", "colors", "normals"):
        a, b = getattr(got.point_cloud, k), getattr(want.point_cloud, k)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(got.nerf_normalization[k],
                                      want.nerf_normalization[k])
    assert got.ply_path == want.ply_path


@pytest.mark.parametrize("load_time_step", [10000, 2])
@pytest.mark.parametrize("branch", ["vrig", "interp_t", "hyper_t"])
def test_reader_matches_jax(capture, branch, load_time_step):
    path = capture[branch]
    kw = dict(load_time_step=load_time_step, max_pts=500)
    got = nerfies.read_nerfies_scene_mv(path, **kw)
    want = jax_nerfies.read_nerfies_scene_mv(path, **kw)
    _same_scene(got, want)
    times = min(TIMES, load_time_step)
    n_train, n_test, n_pred = {
        "vrig": (12 * times, times, 650),
        "interp_t": (-(-13 * times // 4), (13 * times + 1) // 4, None),
        "hyper_t": (-(-13 * times // 4), 0, 0)}[branch]
    assert (len(got.train_cameras), len(got.test_cameras)) == (n_train,
                                                               n_test)
    # the spline over the rig, or (a rig id missing) the test cameras
    assert len(got.pred_cameras) == (n_pred if n_pred is not None
                                     else n_test)
    fids = sorted({c.fid for c in got.train_cameras})
    assert fids == [t / max(times - 1, 1) for t in range(times)]
    assert got.point_cloud.points.shape == (500, 3)
    scale = 1 if branch == "vrig" else 2
    assert got.train_cameras[0].image.shape == (H // scale, W // scale, 3)


def test_spline_path_and_whole_cloud(capture):
    """The default point cap keeps the whole cloud; the 650 pred cameras
    start at the first keyframe's camera, at fid 0, with the first train
    camera's field of view and size."""
    path = capture["vrig"]
    got = nerfies.read_nerfies_scene_mv(path)
    want = jax_nerfies.read_nerfies_scene_mv(path)
    _same_scene(got, want)
    assert got.point_cloud.points.shape == (POINTS, 3)
    first = {c.image_name: c for c in got.train_cameras}[
        chip_smoke.nerfies_id(nerfies.VIS_CAM_ORDER[0], 0)]
    np.testing.assert_allclose(got.pred_cameras[0].R, first.R, atol=1e-9)
    np.testing.assert_allclose(got.pred_cameras[0].T, first.T, atol=1e-9)
    ref = got.train_cameras[0]
    for pred in got.pred_cameras:
        assert (pred.fid, pred.image, pred.FovX, pred.width, pred.height) == (
            0, None, ref.FovX, ref.width, ref.height)


def test_missing_rig_id_falls_back_to_the_test_cameras(capture, tmp_path):
    path = str(tmp_path / "vrig" / chip_smoke.NERFIES_SCENE)
    shutil.copytree(capture["vrig"], path)
    with open(os.path.join(path, "dataset.json")) as f:
        ds = json.load(f)
    ds["train_ids"].remove(chip_smoke.nerfies_id(5, 0))
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump(ds, f)
    got = nerfies.read_nerfies_scene_mv(path)
    _same_scene(got, jax_nerfies.read_nerfies_scene_mv(path))
    assert got.pred_cameras is got.test_cameras and len(got.test_cameras)


def test_scene_branch(capture, tmp_path):
    """``Scene`` sniffs the capture as nerfies, passes ``max_num_pts`` (or
    the 300,000 default) and ``load_time_step``, and puts the spline's
    cameras in its pred list."""
    assert registry.sniff_scene_type(capture["vrig"]) == "nerfies"
    assert registry.SCENE_LOADERS["nerfies"] is nerfies.read_nerfies_scene_mv
    for max_num_pts, n in ((-1, POINTS), (300, 300)):
        cfg = tcfg.ModelConfig(source_path=capture["vrig"],
                               model_path=str(tmp_path / str(n)),
                               eval=True, load_time_step=2,
                               max_num_pts=max_num_pts)
        scene = Scene(cfg, device="cpu")
        assert scene.splats.capacity == n
        assert len(scene.get_pred_cameras()) == 650
        assert len(scene.get_train_cameras()) == 24
        assert {c.fid for c in scene.get_train_cameras()} == {0.0, 1.0}


@pytest.mark.parametrize("mask_kind", ["blob", "full", "sparse"])
def test_masked_ssim_matches_jax(mask_kind):
    rng = np.random.RandomState(0)
    a = rng.rand(37, 29, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(37, 29, 3), 0, 1).astype(np.float32)
    yy, xx = np.mgrid[:37, :29]
    mask = {"blob": ((yy - 18) ** 2 + (xx - 12) ** 2 < 120),
            "full": np.ones((37, 29), bool),
            "sparse": rng.rand(37, 29) > 0.6}[mask_kind]
    mask = mask[..., None].astype(np.float32)
    want = float(jax_ssim.masked_ssim(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(mask)))
    got = masked_ssim(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    # identical images: each channel's mean SSIM is 1, and the JAX
    # function (so the port) sums the channels' means: 3 for RGB
    same = masked_ssim(torch.from_numpy(a), torch.from_numpy(a),
                       torch.from_numpy(mask))
    want = float(jax_ssim.masked_ssim(jnp.asarray(a), jnp.asarray(a),
                                      jnp.asarray(mask)))
    assert abs(float(same) - want) <= 1e-6 * want
    assert abs(want - 3.0) <= 1e-5
