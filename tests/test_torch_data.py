"""The port's host data path against the JAX package's, on the CPU.

The dataset is ``chip_smoke.write_blender_scene`` at the size of
tests/test_train_e2e.py's fixture (64x64, 5 train and 2 test views, the
same poses and ground-truth splats), written by the port's PNG encoder.
Held equal bit for bit: every ``CameraInfo`` field of both Blender
readers, the point clouds of the random / load / hull routes (both
packages' NumPy routes: the C++ carvers are switched off), ``load_cam`` at
full size, ``Scene`` (camera order, ``cameras.json``, ``input.ply``;
its splats within create_from_pcd's KNN tolerance of
tests/test_torch_fields.py), PLY files read and written across, ``cfg_args`` across, and
the k-means view picks against sklearn's. ``load_cam`` at half size is
within RESIZE_LEVELS of PIL's bicubic ``resize``. The hull is compared
on a 128^3 grid (the readers carve 256^3, the same code at 8 times the
points and time).
"""
import dataclasses
import os
import random
import re

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import config as tcfg
from splatfields_torch import train as ttrain
from splatfields_torch import render as trender
from splatfields_torch.data import cameras as tcam
from splatfields_torch.data import point_init as tpi
from splatfields_torch.data import registry as treg
from splatfields_torch.data.ply import store_pointcloud
from splatfields_torch.data.readers import blender as tb
from splatfields_torch.models import splats as tsplats
from splatfields_torch.scene import Scene as TScene
from splatfields_tpu import config as jcfg
from splatfields_tpu import native
from splatfields_tpu.data import cameras as jcam
from splatfields_tpu.data import point_init as jpi
from splatfields_tpu.data.readers import blender as jb
from splatfields_tpu.models import splats as jsplats
from splatfields_tpu.scene import Scene as JScene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# load_cam at resolution 2 against PIL's resize, in levels of 255
# (measured on this scene; upsampled noise reaches 2)
RESIZE_LEVELS = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return chip_smoke.write_blender_scene(
        tmp_path_factory.mktemp("data"), 64, 5, [0.3, 2.5],
        torch.device("cpu"))


@pytest.fixture
def numpy_carver(monkeypatch):
    """Both packages' NumPy carving routes (the native carvers are held
    against each other in tests/test_torch_native.py)."""
    monkeypatch.setattr(native, "available", lambda: False)
    numpy_route = tpi.mask_filter_points

    def mask_filter_points(xyz, cameras, use_native=True, chunk=1 << 18):
        return numpy_route(xyz, cameras, False, chunk)

    monkeypatch.setattr(tpi, "mask_filter_points", mask_filter_points)
    monkeypatch.setattr(tb, "mask_filter_points", mask_filter_points)


def _same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_infos(ja, ta):
    assert len(ja) == len(ta)
    for j, t in zip(ja, ta):
        for f in dataclasses.fields(j):
            _same(getattr(j, f.name), getattr(t, f.name), f.name)


@pytest.mark.parametrize("reader", ["cv", "dnerf"])
def test_readers_bitwise(scene_dir, reader):
    if reader == "cv":
        j = jb.read_nerf_synthetic_cv(scene_dir, True, True, n_views=4,
                                      num_pts=500, pts_samples="random")
        t = tb.read_nerf_synthetic_cv(scene_dir, True, True, n_views=4,
                                      num_pts=500, pts_samples="random")
    else:
        j = jb.read_nerf_synthetic(scene_dir, False, False, num_pts=500)
        t = tb.read_nerf_synthetic(scene_dir, False, False, num_pts=500)
    for split in ("train_cameras", "test_cameras", "pred_cameras"):
        _same_infos(getattr(j, split), getattr(t, split))
    for f in ("points", "colors", "normals"):
        _same(getattr(j.point_cloud, f), getattr(t.point_cloud, f), f)
    for k in ("translate", "radius"):
        _same(j.nerf_normalization[k], t.nerf_normalization[k], k)
    with open(j.ply_path, "rb") as fj, open(t.ply_path, "rb") as ft:
        assert fj.read() == ft.read()
    for p in (j.ply_path, t.ply_path):
        os.remove(p)


def _hemisphere(seed, n=100):
    rng = np.random.RandomState(seed)
    th = rng.uniform(0, 2 * np.pi, n)
    ph = rng.uniform(0.05, np.pi / 2, n)
    return 4.0311 * np.stack([np.cos(ph) * np.cos(th),
                              np.cos(ph) * np.sin(th), np.sin(ph)], 1)


@pytest.mark.parametrize("n_views", [4, 6, 8, 10, 12])
def test_kmeans_picks_match_sklearn(n_views):
    for seed in range(4):
        pts = _hemisphere(seed)
        assert tb.kmeans_downsample(pts, n_views) == \
            jb.kmeans_downsample(pts, n_views), seed


def test_kmeans_picks_on_the_scene(scene_dir):
    _, pos = tb.read_cameras_from_transforms_cv(
        scene_dir, "transforms_train.json", True)
    for n in (2, 3, 4):
        assert tb.kmeans_downsample(pos, n) == jb.kmeans_downsample(pos, n)


def _infos(scene_dir):
    return (jb.read_cameras_from_transforms_cv(
                scene_dir, "transforms_train.json", True)[0][:4],
            tb.read_cameras_from_transforms_cv(
                scene_dir, "transforms_train.json", True)[0][:4])


def test_point_init_random_and_load(scene_dir, tmp_path, numpy_carver):
    ji, ti = _infos(scene_dir)
    for a, b in zip(jb._build_point_cloud("random", ji, 700, -1, "", ""),
                    tb._build_point_cloud("random", ti, 700, -1, "", "")):
        _same(a, b, "random")
    rng = np.random.RandomState(1)
    ply = str(tmp_path / "pc.ply")
    store_pointcloud(ply, rng.uniform(-0.6, 0.6, (5000, 3)).astype(
        np.float32), rng.rand(5000, 3).astype(np.float32))
    for max_pts in (-1, 300):
        j = jb._build_point_cloud("load", ji, 0, max_pts, ply, "")
        t = tb._build_point_cloud("load", ti, 0, max_pts, ply, "")
        assert 0 < t[0].shape[0] < 5000
        for a, b in zip(j, t):
            _same(a, b, f"load {max_pts}")


def test_hull_matches_the_numpy_route(scene_dir, numpy_carver):
    ji, ti = _infos(scene_dir)
    j = jpi.visual_hull_from_grid(ji, (-1.0, 1.0), 128, 3000,
                                  rng=np.random.RandomState(0))
    t = tpi.visual_hull_from_grid(ti, (-1.0, 1.0), 128, 3000,
                                  rng=np.random.RandomState(0))
    _same(j, t, "hull")
    grid = np.linspace(-1, 1, 128)
    pts = np.stack(np.meshgrid(grid, grid, grid), -1).reshape(-1, 3)
    pts = pts.astype(np.float32)
    np.testing.assert_array_equal(tpi._grid_points((-1.0, 1.0), 128), pts)
    keep = jpi.mask_filter_points(pts, ji, use_native=False)
    assert 0 < keep.sum() < len(keep)
    for chunk in (1 << 12, 1 << 18):
        np.testing.assert_array_equal(
            tpi.mask_filter_points(pts, ti, use_native=False,
                                   chunk=chunk), keep)


def test_load_cam(scene_dir):
    ji, ti = _infos(scene_dir)
    worst = 0
    for j, t in zip(ji, ti):
        full_j, full_t = jcam.load_cam(j, -1, 3), tcam.load_cam(
            t, -1, 3, device="cpu")
        for f in ("image", "mask"):
            _same(getattr(full_j, f), getattr(full_t, f).numpy(), f)
        for f in ("world_view_transform", "projection_matrix",
                  "full_proj_transform", "camera_center"):
            _same(getattr(full_j, f), getattr(full_t, f), f)
        for k, f in (("viewmatrix", "world_view_transform"),
                     ("projmatrix", "full_proj_transform"),
                     ("campos", "camera_center")):
            _same(full_t.device_consts[k].numpy(), getattr(full_t, f), k)
        assert (full_j.tanfovx, full_j.image_width) == (
            full_t.tanfovx, full_t.image_width)
        half_j, half_t = jcam.load_cam(j, 2, 3), tcam.load_cam(
            t, 2, 3, device="cpu")
        assert half_t.image.shape == (3, 32, 32)
        for f in ("image", "mask"):
            worst = max(worst, float(np.abs(
                getattr(half_j, f) - getattr(half_t, f).numpy()).max()))
    assert worst * 255 <= RESIZE_LEVELS + 1e-3, worst * 255


def test_resize_nearest_is_cv2():
    import cv2
    a = np.random.RandomState(0).rand(37, 53).astype(np.float32)
    for w, h in ((20, 15), (53, 37), (90, 70), (26, 40)):
        np.testing.assert_array_equal(
            tcam.resize_nearest(a, w, h),
            cv2.resize(a, (w, h), interpolation=cv2.INTER_NEAREST))


def test_scene_same_seed(scene_dir, tmp_path):
    def cfg(mod, name):
        return mod.ModelConfig(
            source_path=scene_dir, model_path=str(tmp_path / name),
            white_background=True, eval=True, n_views=4, num_pts=800,
            pts_samples="random", load_time_step=0)
    random.seed(0)
    js = JScene(cfg(jcfg, "jax"))
    ts = TScene(cfg(tcfg, "torch"), rng=random.Random(0), device="cpu")
    assert [c.image_name for c in js.get_train_cameras()] == \
        [c.image_name for c in ts.get_train_cameras()]
    assert [c.image_name for c in js.get_test_cameras()] == \
        [c.image_name for c in ts.get_test_cameras()]
    assert js.cameras_extent == ts.cameras_extent
    for name in ("cameras.json", "input.ply"):
        with open(tmp_path / "jax" / name, "rb") as fj, \
                open(tmp_path / "torch" / name, "rb") as ft:
            assert fj.read() == ft.read(), name
    for f in ("xyz", "features_dc", "features_rest", "rotation", "opacity",
              "scaling"):
        # create_from_pcd's KNN scale: test_torch_fields' tolerance
        np.testing.assert_allclose(
            getattr(ts.splats, f).numpy(), np.asarray(getattr(js.splats, f)),
            rtol=1e-5, atol=1e-5, err_msg=f)
    _same(np.asarray(js.splat_stats.valid), ts.splat_stats.valid.numpy(),
          "valid")
    for jc_, tc_ in zip(js.get_train_cameras(), ts.get_train_cameras()):
        _same(jc_.image, tc_.image.numpy(), "image")


def _random_splats(n=300, cap=360, seed=0, sh=3):
    rng = np.random.RandomState(seed)
    k = (sh + 1) ** 2
    f = {"xyz": (cap, 3), "features_dc": (cap, 1, 3),
         "features_rest": (cap, k - 1, 3), "scaling": (cap, 3),
         "rotation": (cap, 4), "opacity": (cap, 1)}
    arrays = {name: rng.randn(*shape).astype(np.float32)
              for name, shape in f.items()}
    valid = np.zeros(cap, bool)
    valid[rng.choice(cap, n, replace=False)] = True
    return arrays, valid


def test_ply_across_both_ways(tmp_path):
    arrays, valid = _random_splats()
    jp = jsplats.SplatParams(**arrays)
    tp = tsplats.SplatParams(**{k: torch.from_numpy(v)
                                for k, v in arrays.items()})
    jsplats.save_ply(str(tmp_path / "j" / "p.ply"), jp, valid)
    tsplats.save_ply(str(tmp_path / "t" / "p.ply"), tp, torch.from_numpy(
        valid))
    with open(tmp_path / "j" / "p.ply", "rb") as fj, \
            open(tmp_path / "t" / "p.ply", "rb") as ft:
        assert fj.read() == ft.read()
    jl, js_, jdeg = jsplats.load_ply(str(tmp_path / "t" / "p.ply"),
                                     capacity=400)
    tl, ts_, tdeg = tsplats.load_ply(str(tmp_path / "j" / "p.ply"),
                                     capacity=400, device="cpu")
    assert jdeg == tdeg == 3
    for k in arrays:
        _same(np.asarray(getattr(jl, k)), getattr(tl, k).numpy(), k)
        np.testing.assert_array_equal(getattr(tl, k).numpy()[:300],
                                      arrays[k][valid])
    _same(np.asarray(js_.valid), ts_.valid.numpy(), "valid")


def test_cfg_args_across(tmp_path):
    argv = ["-s", "/data/lego", "-m", str(tmp_path), "--white_background",
            "--eval", "--is_static", "--n_views", "10",
            "--train_cam_names", "a", "b"]
    ja = jcfg.build_parser().parse_args(argv)
    ta = tcfg.build_parser().parse_args(argv)
    assert vars(ja) == vars(ta)
    jcfg.save_cfg_args(str(tmp_path / "j"), ja)
    tcfg.save_cfg_args(str(tmp_path / "t"), ta)
    assert tcfg.load_cfg_args(str(tmp_path / "j")) == vars(ja)
    assert jcfg.load_cfg_args(str(tmp_path / "t")) == vars(ta)
    # the reference's Namespace repr reads the same in both
    (tmp_path / "ns").mkdir()
    (tmp_path / "ns" / "cfg_args").write_text(
        "Namespace(eval=True, n_views=10, sh_degree=3, "
        "source_path='/data/lego', train_cam_names=['a', 'b'])")
    assert tcfg.load_cfg_args(str(tmp_path / "ns")) == \
        jcfg.load_cfg_args(str(tmp_path / "ns"))
    render_argv = ["-s", "/data/lego", "-m", str(tmp_path / "j")]
    jr = jcfg.get_combined_args(jcfg.build_parser(sentinel=True),
                                render_argv)
    tr = tcfg.get_combined_args(tcfg.build_parser(sentinel=True),
                                render_argv)
    assert vars(jr) == vars(tr)
    assert tcfg.extract_configs(tr) == tuple(
        type(t)(**dataclasses.asdict(j)) for j, t in zip(
            jcfg.extract_configs(jr), tcfg.extract_configs(tr)))


def _protocol_commands():
    """The first two train and render command lines of
    scripts/run_blender.sh, with its defaults substituted."""
    text = open(os.path.join(ROOT, "scripts", "run_blender.sh")).read()
    text = text.replace("\\\n", " ")
    env = {"SCENE": "lego", "N_VIEWS": "10", "DATASET_ROOT": "/data/ns",
           "OUT": "./output_rep/Blender"}
    cmds = {"train": [], "render": []}
    for line in text.splitlines():
        m = re.match(r"\s*\$PY\.(train|render)\s+(.*)", line)
        if not m or len(cmds[m.group(1)]) == 2:
            continue
        args = re.sub(r"\$\{?(\w+)\}?", lambda v: env[v.group(1)],
                      m.group(2)).split()
        cmds[m.group(1)].append(args)
    return cmds["train"][:2], cmds["render"][:2]


def test_protocol_command_lines_parse():
    """Parse only: the port's train and render parsers take the command
    lines verbatim, and every flag group reads as the JAX parser reads
    it."""
    trains, renders = _protocol_commands()
    assert len(trains) == len(renders) == 2
    for argv, parser, jparser in (
            *((a, ttrain.build_train_parser(), jcfg.build_parser())
              for a in trains),
            *((a, trender.build_render_parser(),
               jcfg.build_parser(sentinel=True)) for a in renders)):
        mine = vars(parser.parse_args(argv))
        theirs = vars(jparser.parse_known_args(argv)[0])
        assert {k: mine[k] for k in theirs} == theirs
        if "--iterations" in argv:
            ttrain.check_mesh_flags(parser.parse_args(argv))
    assert vars(ttrain.build_train_parser().parse_args(trains[0]))[
        "is_static"]
    field = vars(ttrain.build_train_parser().parse_args(trains[1]))
    assert field["encoder_type"] == "VarTriPlaneEncoder"
    assert field["pts_samples"] == "load" and field["max_num_pts"] == 100000


@pytest.mark.parametrize("flags,item", [
    (["--mesh_model", "2"], 9), (["--mesh_data", "2"], 9), (["--ring"], 9),
    (["--num_processes", "2"], 9), (["--coordinator_address", "h:1"], 9),
    (["--profile"], 5), (["--watchdog_min", "5"], 5)])
def test_unported_flags_raise(flags, item):
    """Every flag of the JAX CLI is ported now: item 5's reach training
    (tests/test_torch_colmap.py runs them), item 9's (multi-device) pass
    the mesh checks and give the JAX CLI's mesh shape: a mesh only with
    ``--mesh_model`` or ``--num_processes`` (tests/test_torch_parallel.py
    holds the refusals and the sharded step)."""
    args = ttrain.build_train_parser().parse_args(["-s", "x"] + flags)
    ttrain.check_mesh_flags(args)
    if item == 5:
        assert args.profile or args.watchdog_min == 5.0
    else:
        want = {"--mesh_model": (1, 2), "--num_processes": (1, 2)}
        assert ttrain.mesh_shape(args) == want.get(flags[0])
    args = ttrain.build_train_parser().parse_args(["-s", "x", "--scan_k",
                                                   "4"])
    ttrain.check_mesh_flags(args)


@pytest.mark.parametrize("kind,item", [
    ("Colmap", 5), ("ColmapHold", 5), ("nerfies", 5), ("ResFields", 6)])
def test_unported_readers_raise(kind, item):
    """Every reader is ported now: the registry holds the port's reader,
    which finds no dataset at a missing path (tests/test_torch_owlii.py,
    tests/test_torch_colmap.py and tests/test_torch_nerfies.py read
    scenes)."""
    from splatfields_torch.data.readers import colmap, nerfies
    from splatfields_torch.data.readers.neus import read_resfield_scene
    want, args = {
        "Colmap": (colmap.read_colmap_scene_sparse, ("somewhere",)),
        "ColmapHold": (colmap.read_colmap_scene, ("somewhere",)),
        "nerfies": (nerfies.read_nerfies_scene_mv, ("somewhere",)),
        "ResFields": (read_resfield_scene,
                      ("somewhere", True, ["cam_train_0"], [], []))}[kind]
    assert treg.SCENE_LOADERS[kind] is want
    with pytest.raises(FileNotFoundError):
        treg.SCENE_LOADERS[kind](*args)


def test_sniffing_matches(scene_dir, tmp_path):
    from splatfields_tpu.data.registry import sniff_scene_type
    for marker in ("sparse", "cameras_sphere.npz", "dataset.json", None):
        d = tmp_path / str(marker)
        d.mkdir()
        if marker:
            (d / marker).write_text("")
        assert treg.sniff_scene_type(str(d)) == sniff_scene_type(str(d))
    assert treg.sniff_scene_type(scene_dir) == "Blender_cv"


def test_grow_capacity_pads_every_tree():
    arrays, valid = _random_splats(n=10, cap=12, sh=0)
    p = tsplats.SplatParams(**{k: torch.from_numpy(v)
                               for k, v in arrays.items()})
    stats = tsplats.SplatStats(
        valid=torch.from_numpy(valid), max_radii2d=torch.ones(12),
        xyz_gradient_accum=torch.ones(12), denom=torch.ones(12))
    opt = tsplats.AdamState(count=3, mu=p, nu=p)
    p2, s2, o2 = tsplats.grow_capacity(p, stats, opt, 20)
    assert p2.capacity == 20 and o2.count == 3
    for tree in (p2, s2, o2.mu, o2.nu):
        for k, v in tsplats.tree_items(tree).items():
            assert v.shape[0] == 20 and not v[12:].any(), k
    np.testing.assert_array_equal(p2.xyz[:12].numpy(), arrays["xyz"])
