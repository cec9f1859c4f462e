"""The Colmap datasets' host side on the CPU: ``data/colmap_io.py`` and
both Colmap readers against the JAX package's, run_dtu.sh's first line
through the port's train CLI on a COLMAP scan, and the train CLI's
``--watchdog_min`` and ``--profile``.

The scan is ``chip_smoke.write_colmap_scene`` at 64x48 with 49 views
(the pixelNeRF split: 9 train ids, 15 excluded, 25 test), 500 points
with tracks, written by the script's own packer and the port's PNG
encoder. Held equal: the model files' records, ids and float64 values
(binary and text), every ``CameraInfo`` field of both readers (images and
masks bit for bit against PIL's decode, R, T and FoV to the bit, so well
within the 1e-12 asked), the split, the points and colours with and
without ``--pc_path``, and the bytes of the written ``points3D.ply``;
``qvec2rotmat`` / ``rotmat2qvec`` within 1e-12. One difference is kept on
purpose: an image line followed by an empty POINTS2D line, as
``write_images_text`` writes it, which the JAX reader cannot pair.
"""
import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import train
from splatfields_torch.data import colmap_io
from splatfields_torch.data import registry
from splatfields_torch.data.ply import fetch_pointcloud, store_pointcloud
from splatfields_torch.data.readers import colmap
from splatfields_torch.utils.system import StallWatchdog
from splatfields_tpu.data import colmap_io as jax_io
from splatfields_tpu.data.readers import colmap as jax_colmap
from splatfields_tpu.utils.system import StallWatchdog as JaxStallWatchdog

W, H, POINTS = 64, 48, 500


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module (see tests/test_torch_owlii.py:
    the suite's workers share the CPU's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    return chip_smoke.write_colmap_scene(tmp_path_factory.mktemp("colmap"),
                                         W, H, "cpu", n_splats=3000,
                                         n_points=POINTS)


def _sparse(scan, name):
    return os.path.join(scan, "sparse", "0", name)


def _same_records(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


def _same_points(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _floats(values):
    """Shortest round-trip decimals: the text holds the binary's values."""
    return " ".join(repr(float(v)) for v in values)


def _write_text_model(src, dst):
    """The binary model of ``src`` as COLMAP's text model in ``dst``, every
    image with its POINTS2D line (the layout both readers parse)."""
    cams = colmap_io.read_cameras_binary(_sparse(src, "cameras.bin"))
    images = colmap_io.read_images_binary(_sparse(src, "images.bin"))
    xyz, rgb, err = colmap_io.read_points3d_binary(
        _sparse(src, "points3D.bin"))
    colmap_io.write_cameras_text(os.path.join(dst, "cameras.txt"), cams)
    with open(os.path.join(dst, "images.txt"), "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        for im in images.values():
            f.write(f"{im.id} {_floats(im.qvec)} {_floats(im.tvec)} "
                    f"{im.camera_id} {im.name}\n")
            f.write(" ".join(f"{_floats(xy)} {i}" for xy, i in zip(
                im.xys, im.point3d_ids)) + "\n")
    with open(os.path.join(dst, "points3D.txt"), "w") as f:
        f.write("# 3D point list\n")
        for i in range(len(xyz)):
            f.write(f"{i + 1} {_floats(xyz[i])} "
                    f"{' '.join(str(int(v)) for v in rgb[i])} "
                    f"{_floats([err[i]])} 1 0\n")


def test_binary_model_matches_jax(scan):
    for fn, name in (("read_cameras_binary", "cameras.bin"),
                     ("read_images_binary", "images.bin")):
        got = getattr(colmap_io, fn)(_sparse(scan, name))
        want = getattr(jax_io, fn)(_sparse(scan, name))
        _same_records(got, want)
        assert len(got) == 49
    images = colmap_io.read_images_binary(_sparse(scan, "images.bin"))
    assert sum(len(im.xys) for im in images.values()) > 2 * POINTS
    path = _sparse(scan, "points3D.bin")
    got, want = colmap_io.read_points3d_binary(path), \
        jax_io.read_points3d_binary(path)
    _same_points(got, want)
    assert got[0].shape == (POINTS, 3)


def test_text_model_matches_jax(scan, tmp_path):
    _write_text_model(scan, str(tmp_path))
    for fn, name in (("read_cameras_text", "cameras.txt"),
                     ("read_images_text", "images.txt")):
        path = os.path.join(str(tmp_path), name)
        _same_records(getattr(colmap_io, fn)(path),
                      getattr(jax_io, fn)(path))
    path = os.path.join(str(tmp_path), "points3D.txt")
    _same_points(colmap_io.read_points3d_text(path),
                 jax_io.read_points3d_text(path))
    # the text model holds the binary one's values
    _same_records(
        colmap_io.read_images_text(os.path.join(str(tmp_path), "images.txt")),
        colmap_io.read_images_binary(_sparse(scan, "images.bin")))


def test_blank_points2d_line_kept_on_purpose(scan, tmp_path):
    """An image without 2-D points has an empty POINTS2D line (COLMAP's
    layout, and ``write_images_text``'s for every image): the port pairs
    the lines as upstream does and reads the images; the JAX reader drops
    the blank lines first and raises."""
    images = colmap_io.read_images_binary(_sparse(scan, "images.bin"))
    path = os.path.join(str(tmp_path), "images.txt")
    jax_io.write_images_text(path, images)
    with pytest.raises(ValueError):
        jax_io.read_images_text(path)
    got = colmap_io.read_images_text(path)
    assert list(got) == list(images)
    for k, im in got.items():
        assert im.name == images[k].name and im.camera_id == images[k].camera_id
        np.testing.assert_array_equal(im.qvec, images[k].qvec)
        np.testing.assert_array_equal(im.tvec, images[k].tvec)
        assert im.xys.shape == (0, 2) and im.point3d_ids.shape == (0,)
        assert im.point3d_ids.dtype == np.int64


def test_quaternions_match_jax():
    rng = np.random.RandomState(0)
    for q in rng.randn(50, 4):
        q = q / np.linalg.norm(q)
        R = colmap_io.qvec2rotmat(q)
        np.testing.assert_allclose(R, jax_io.qvec2rotmat(q), rtol=0,
                                   atol=1e-12)
        got, want = colmap_io.rotmat2qvec(R), jax_io.rotmat2qvec(R)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, q * np.sign(q[0]), rtol=0,
                                   atol=1e-12)


def _same_infos(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert type(a) is type(b) and a == b, (f.name, a, b)


def _read_both(reader, *args, **kw):
    """The JAX reader, its PLY's bytes, then the port's and its bytes (both
    write the same ``sparse/0/points3D.ply``)."""
    out = []
    for mod in (jax_colmap, colmap):
        info = getattr(mod, reader)(*args, **kw)
        with open(info.ply_path, "rb") as f:
            out.append((info, f.read() if reader.endswith("sparse") else None))
    return out


@pytest.mark.parametrize("pc", [False, True])
def test_sparse_reader_matches_jax(scan, tmp_path, pc):
    kw = dict(white_background=True, n_views=3)
    if pc:
        rng = np.random.RandomState(3)
        pts = rng.uniform(-1.3, 1.3, (4000, 3)).astype(np.float32)
        path = str(tmp_path / "pc.ply")
        store_pointcloud(path, pts, rng.rand(4000, 3))
        kw.update(pc_path=path, num_pts=700)
    (want, want_ply), (got, got_ply) = _read_both(
        "read_colmap_scene_sparse", scan, **kw)
    for split in ("train_cameras", "test_cameras", "pred_cameras"):
        _same_infos(getattr(got, split), getattr(want, split))
    # the pixelNeRF split, in the camera list's order
    assert [c.image_name for c in got.train_cameras] == ["022", "025", "028"]
    assert len(got.test_cameras) == 25
    # uid is the camera's id (49 - image index), fid the name's number
    assert [c.uid for c in got.train_cameras] == [27, 24, 21]
    assert got.train_cameras[0].fid == 22 / 48
    mask = got.train_cameras[0].mask
    assert mask.dtype == np.float32 and 0 < (mask > 0).mean() < 1
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, k),
                                      getattr(want.point_cloud, k))
    n = got.point_cloud.points.shape[0]
    assert n == (700 if pc else POINTS)
    if pc:
        assert np.abs(got.point_cloud.points).max() < 1
        assert got.point_cloud.colors.max() < 1 / 255
    assert got_ply == want_ply and len(got_ply) > 27 * n
    for k in ("translate", "radius"):
        np.testing.assert_array_equal(got.nerf_normalization[k],
                                      want.nerf_normalization[k])


@pytest.mark.parametrize("eval_mode", [False, True])
def test_hold_reader_matches_jax(scan, eval_mode):
    (want, _), (got, _) = _read_both("read_colmap_scene", scan,
                                     eval_mode=eval_mode)
    for split in ("train_cameras", "test_cameras"):
        if getattr(want, split):
            _same_infos(getattr(got, split), getattr(want, split))
    assert len(got.test_cameras) == (7 if eval_mode else 0)
    assert got.train_cameras[0].mask is None
    np.testing.assert_array_equal(got.point_cloud.points,
                                  want.point_cloud.points)


@pytest.mark.parametrize("how", ["missing", "truncated"])
def test_text_fallback_matches_jax(scan, tmp_path, how):
    """A missing or truncated binary model falls back to the text one."""
    root = str(tmp_path / "scan")
    shutil.copytree(scan, root)
    _write_text_model(scan, os.path.join(root, "sparse", "0"))
    images_bin = _sparse(root, "images.bin")
    if how == "missing":
        os.remove(images_bin)
        os.remove(_sparse(root, "points3D.bin"))
    else:
        with open(images_bin, "r+b") as f:
            f.truncate(20)   # inside the first image record
    (want, _), (got, _) = _read_both("read_colmap_scene_sparse", root,
                                     n_views=3)
    _same_infos(got.train_cameras + got.test_cameras,
                want.train_cameras + want.test_cameras)
    np.testing.assert_array_equal(got.point_cloud.points,
                                  want.point_cloud.points)


def test_jpeg_raises_naming_the_file(scan, tmp_path):
    """A baseline JPEG frame, named .png (the format goes by the first
    bytes, as in PIL), reads as the JAX reader reads it; a CMYK one (a
    kind the port still refuses) raises naming the file and the
    marker."""
    PIL = pytest.importorskip("PIL.Image")
    root = str(tmp_path / "scan")
    shutil.copytree(scan, root)
    path = os.path.join(root, "images", "025.png")
    frame = np.random.RandomState(7).randint(0, 256, (H, W, 3), np.uint8)
    PIL.fromarray(frame).save(path, "JPEG", quality=80)
    (want, _), (got, _) = _read_both("read_colmap_scene_sparse", root,
                                     n_views=3)
    assert "025" in [c.image_name for c in want.train_cameras]  # the JPEG
    for split in ("train_cameras", "test_cameras"):
        _same_infos(getattr(got, split), getattr(want, split))
    PIL.fromarray(frame).convert("CMYK").save(path, "JPEG")
    with pytest.raises(NotImplementedError,
                       match="025.png.*CMYK / YCCK JPEG .4 components, "
                             "SOF0 marker"):
        colmap.read_colmap_scene_sparse(root, n_views=3)


def test_run_dtu_first_line_on_the_scan(scan, tmp_path):
    """run_dtu.sh's 3DGS line, 2 iterations on the CPU, with
    ``--watchdog_min``: the scan sniffs as Colmap, the splats start from
    points3D.bin, the mask loss runs, and the watchdog ends with the
    run."""
    assert registry.sniff_scene_type(scan) == "Colmap"
    assert registry.SCENE_LOADERS["Colmap"] is colmap.read_colmap_scene_sparse
    (_, argv), = chip_smoke.script_command_lines("run_dtu.sh", dict(
        DATASET_ROOT=os.path.dirname(scan), SCENE=chip_smoke.COLMAP_SCAN,
        OUT=str(tmp_path), ITERS=2))[:1]
    res = train.main(argv + ["--watchdog_min", "30"], device="cpu")
    assert not [t for t in threading.enumerate()
                if t.name == "StallWatchdog"]
    run = argv[argv.index("-m") + 1]
    init = fetch_pointcloud(os.path.join(run, "input.ply"))[0]
    want = colmap_io.read_points3d_binary(_sparse(scan, "points3D.bin"))[0]
    np.testing.assert_array_equal(init, want.astype(np.float32))
    assert res.deform is None and int(res.stats.valid.sum()) == POINTS
    assert os.path.exists(os.path.join(run, "point_cloud", "iteration_2",
                                       "point_cloud.ply"))


def test_watchdog_stops_when_the_loop_raises(scan, tmp_path):
    """A failing progress callback propagates out of ``training``, and the
    watchdog's thread ends with it."""
    args = train.build_train_parser().parse_args(
        ["-s", scan, "-m", str(tmp_path), "--is_static", "--iterations",
         "3"])
    model, pipe, hidden, opt = train.cfg_lib.extract_configs(args)

    def fail(it, *_):
        raise RuntimeError(f"callback failed at {it}")

    with pytest.raises(RuntimeError, match="callback failed at 1"):
        train.training(model, hidden, opt, pipe, [], [], quiet=True,
                       progress_callback=fail, device="cpu",
                       watchdog_min=30)
    assert not [t for t in threading.enumerate()
                if t.name == "StallWatchdog"]


def _fire(cls):
    """A watchdog with an injected clock: a beat, 0.9 of the timeout
    without a beat (it must not fire), then past it -> the exits it
    made."""
    now, fired = [100.0], []
    dog = cls(0.5, clock=lambda: now[0], exit_fn=lambda: fired.append(
        now[0]), poll_s=0.002).start()
    dog.beat()
    now[0] = 127.0
    time.sleep(0.05)
    assert fired == []
    dog.beat()
    now[0] = 157.5
    deadline = time.time() + 5
    while not fired and time.time() < deadline:
        time.sleep(0.005)
    dog.stop()
    return fired


def test_watchdog_fires_as_the_jax_one(capsys):
    assert StallWatchdog.EXIT_CODE == JaxStallWatchdog.EXIT_CODE == 114
    assert _fire(StallWatchdog) == [157.5]
    got = capsys.readouterr().out.strip().splitlines()
    assert _fire(JaxStallWatchdog) == [157.5]
    want = capsys.readouterr().out.strip().splitlines()
    assert got == want and json.loads(got[0])["idle_s"] == 30.5
    # stopped, it never fires
    now, fired = [0.0], []
    dog = StallWatchdog(0.5, clock=lambda: now[0], exit_fn=lambda: fired.append(
        1), poll_s=0.002).start()
    dog.stop()
    now[0] = 1e6
    time.sleep(0.02)
    assert fired == [] and not dog._thread.is_alive()


def test_profile_callback_writes_a_trace(tmp_path, capsys):
    """``--profile``'s callback driven by hand at iterations 20 and 30: a
    Chrome trace of the work between them."""
    trace = str(tmp_path / "trace")
    cb = train.profile_callback(trace)
    for it in range(1, 20):
        cb(it, 0.0, None, None)
    assert not os.path.exists(trace)
    cb(20, 0.0, None, None)
    x = torch.randn(64, 64)
    for _ in range(3):
        x = torch.tanh(x @ x)
    cb(30, 0.0, None, None)
    with open(os.path.join(trace, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::matmul" in e.get("name", "") for e in events)
    assert f"profiler trace written to {trace}" in capsys.readouterr().out
    cb(31, 0.0, None, None)   # after the window nothing more is written
