"""The Owlii protocol's host side on the CPU: the ResFields reader against
the JAX package's, its visual hull, the 16-bit depth decode, and
``scripts/run_owlii.sh``'s two command lines through the port's CLIs.

The scene is ``chip_smoke.write_owlii_scene`` at 48x48 with 2 frames:
``cam_train_0 .. 9`` and ``cam_test``, images, 8-bit masks and 16-bit
depth maps written by the port's ``data/png.py``, the ground truth
rendered by the port's rasterizer from seeded splats that move with the
frame. The reader's images, masks, depths and fids must equal the JAX
reader's (cv2) bit for bit; K and R within 1e-12; T, the translation of
the inverse of a pose whose centre cv2 takes from a float32 SVD (the port
from the projection's null vector, ``rq_decomp3x3``), within f32 rounding
(rtol 1e-6, atol 1e-6), as tests/test_torch_dtu.py holds it. The hull at
a 64^3 grid, carved in chunks of 5,000 points, must be the JAX reader's
points, bit for bit and in order.
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_tpu.data.readers import neus as jax_neus
from splatfields_torch import render, train
from splatfields_torch.data import png
from splatfields_torch.data.readers import neus
from splatfields_torch.metrics import read_results

cv2 = pytest.importorskip("cv2")

RES, FRAMES = 48, 2
CAMS = [f"cam_train_{i}" for i in range(10)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them, slowing these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return chip_smoke.write_owlii_scene(tmp_path_factory.mktemp("owlii"), RES,
                                        FRAMES, "cpu", depth=True)


def _read(reader, scene):
    return reader.read_resfield_scene(scene, True, CAMS, ["cam_test"],
                                      ["cam_test"], load_time_step=FRAMES,
                                      num_pts=500, pts_samples="random")


def test_reader_matches_jax(scene):
    got, want = _read(neus, scene), _read(jax_neus, scene)
    for split in ("train_cameras", "test_cameras", "pred_cameras"):
        g_list, w_list = getattr(got, split), getattr(want, split)
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            assert (g.image_name, g.width, g.height, g.fid) == (
                w.image_name, w.width, w.height, w.fid)
            for k in ("image", "mask", "depth"):
                a, b = getattr(g, k), getattr(w, k)
                assert a.dtype == b.dtype and np.array_equal(a, b), k
            np.testing.assert_allclose(g.K, w.K, rtol=0, atol=1e-12 * np.abs(
                w.K).max())
            np.testing.assert_allclose(g.R, w.R, rtol=0, atol=1e-12)
            np.testing.assert_allclose(g.T, w.T, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(g.FovX, w.FovX, rtol=1e-12)
    assert len(got.train_cameras) == 10 * FRAMES
    assert sorted({c.fid for c in got.train_cameras}) == [0.0, 1.0]
    depth = got.train_cameras[0].depth
    mask = got.train_cameras[0].mask
    assert (depth[mask == 0] == -1).all() and (depth[mask > 0] > 0).any()
    # the colours and points of the init: the same draws
    for k in ("points", "colors"):
        np.testing.assert_array_equal(getattr(got.point_cloud, k),
                                      getattr(want.point_cloud, k))
    for info in (got, want):
        os.remove(info.ply_path)


def test_load_time_step_filter(scene):
    info = neus.read_resfield_scene(scene, False, CAMS[:2], ["cam_test"],
                                    ["cam_test"], load_time_step=1,
                                    num_pts=10, pts_samples="random")
    assert len(info.train_cameras) == 2 and len(info.pred_cameras) == FRAMES
    assert {c.fid for c in info.train_cameras} == {0}
    # masked onto black
    img, mask = info.train_cameras[0].image, info.train_cameras[0].mask
    assert (img[mask == 0] == 0).all()
    os.remove(info.ply_path)


def test_visual_hull_matches_jax(scene):
    cams = [c for c in _read(jax_neus, scene).train_cameras if c.fid == 0]
    masks = np.stack([c.mask for c in cams])
    krt = np.stack([c.KRT for c in cams])
    for aabb in ((-1.0, 1.0), (np.float32(-0.7), np.float32(0.9))):
        want = jax_neus.visual_hull_samples(masks, krt, n_pts=3000,
                                            grid_resolution=64, aabb=aabb,
                                            seed=0)
        got = neus.visual_hull_samples(masks, krt, n_pts=3000,
                                       grid_resolution=64, aabb=aabb, seed=0,
                                       chunk=5000)
        assert got.dtype == want.dtype and 1000 < len(got) <= 3000
        np.testing.assert_array_equal(got, want)


def test_16bit_depth_decode_matches_cv2(scene):
    path = os.path.join(scene, "cam_train_3", "depth", "001.png")
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read(path)
    assert want.dtype == np.uint16 and want.max() > 255
    np.testing.assert_array_equal(got[..., 0], want)
    rng = np.random.RandomState(0)
    for ftype in range(5):
        img = rng.randint(0, 65536, (7, 5, 3)).astype(np.uint16)
        np.testing.assert_array_equal(png.decode(png.encode(img, ftype)),
                                      img)


def test_run_owlii_command_lines(scene, tmp_path):
    """``run_owlii.sh``'s train and render lines, 3 iterations of 2
    frames with 2,000 hull points (the 256^3 carve), on the CPU."""
    train_argv, render_argv = chip_smoke.owlii_command_lines(dict(
        DATASET_ROOT=os.path.dirname(scene), SCENE=os.path.basename(scene),
        OUT=str(tmp_path), ITERS=3, TIME_STEP=FRAMES, NUM_PTS=2000))
    res = train.main(train_argv, device="cpu")
    assert res.deform.n_frames == FRAMES
    net = res.deform.net
    assert net.mlp_flow_head.flow_model == "offset"
    assert net.mlp_rgb.net_2.weights_t.shape == (FRAMES, 40)
    assert int(res.stats.valid.sum()) == 2000
    run = os.path.join(str(tmp_path), "8views", "dancer_t", "SplatFields4D")
    for rel in ("deform/iteration_3/deform.msgpack",
                "point_cloud/iteration_3/point_cloud.ply",
                "train_state/iteration_3/state.pt"):
        assert os.path.exists(os.path.join(run, rel)), rel
    out = render.main(render_argv, device="cpu")
    assert set(out) == {"train", "test"}
    yaml = read_results(os.path.join(run, "test", "ours_3", "results.yaml"))
    assert np.isfinite(yaml["psnr"]) and yaml["psnr"] > 5
    assert len(os.listdir(os.path.join(run, "train", "ours_3",
                                       "renders"))) == 10 * FRAMES
