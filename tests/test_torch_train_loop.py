"""The port's training loop and render CLI against the JAX package's, on
the CPU.

The dataset is tests/test_train_e2e.py's synthetic Blender scene (64x64,
5 train and 2 test views, ``chip_smoke.write_blender_scene``), trained in
static mode for 6 iterations with the protocol's flags (4 k-means views,
white background, random init of 2,000 points: the hull route is held to
the JAX package's in test_torch_data.py), ``random.seed(0)`` on the JAX
side and ``random.Random(0)`` on the port's, so both loops draw the same
views. Both start from the same points and zero Adam states; the splats'
KNN scales agree to create_from_pcd's rounding (test_torch_data.py).

Tolerances, after tests/test_torch_train.py: the per-iteration loss rtol
1e-5 and the test PSNR (a log of the same mean) 1e-4 dB. The scene stays
below the 0.99 alpha clamp (asserted), where the JAX autodiff and the
port's closed-form blend VJP agree. The saved PLY: the port's step agrees
with the JAX step to ~1e-6 of each gradient's largest value, but Adam's
first steps from zero moments move a parameter by lr * m_hat /
sqrt(v_hat), which is +-lr for any gradient, so a gradient at rounding
noise (the rotation of an isotropic splat, a splat barely in view) moves
by +-lr in either package. So every entry is held to rtol 1e-6 plus
2 lr per step (the most two Adam trajectories from one start can part),
and the share of entries past test_torch_train's bound (rtol 1e-6 plus
1e-4 lr a step) to NOISE_SHARE per attribute.

``render.py`` of both packages on the JAX run's directory: results.yaml
PSNR within 1e-3 dB and SSIM (x100) within 1e-3: the frames agree to
~1e-6 before their uint8 rounding, which flips a few pixels by one level.
The event function is held to the JAX loop's conditions over iterations
1-40,000 for the protocol's configurations.
"""
import os
import random
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import config as tcfg
from splatfields_torch import metrics as tmetrics
from splatfields_torch import render as trender
from splatfields_torch import train as ttrain
from splatfields_torch.data import gif as tgif
from splatfields_torch.data import png as tpng
from splatfields_torch.data.ply import read_ply_vertices
from splatfields_torch.models import splats as tsplats
from splatfields_tpu import config as jcfg
from splatfields_tpu import metrics as jmetrics
from splatfields_tpu import render as jrender
from splatfields_tpu import train as jtrain

ITERS = 6
NOISE_SHARE = 0.25
ARGV = ["--white_background", "--eval", "--n_views", "4", "--pts_samples",
        "random", "--num_pts", "2000", "--load_time_step", "0",
        "--composition_rank", "0", "--tile_cap", "128", "--k_chunk", "32",
        "--is_static", "--iterations", str(ITERS)]


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


def _configs(cfg_mod, scene_dir, model_path):
    args = cfg_mod.build_parser().parse_args(
        ["-s", scene_dir, "-m", model_path] + ARGV)
    return args, cfg_mod.extract_configs(args)


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    """One JAX and one port training run: losses, test PSNR, run dir."""
    out = {}
    base = tmp_path_factory.mktemp("runs")
    random.seed(0)
    args, (m, p, h, o) = _configs(jcfg, scene_dir, str(base / "jax"))
    losses = []
    *_, psnr = jtrain.training(
        m, h, o, p, [ITERS], [ITERS], args=args, quiet=True,
        progress_callback=lambda it, loss, *_: losses.append(loss))
    out["jax"] = (losses, psnr, m.model_path)
    args, (m, p, h, o) = _configs(tcfg, scene_dir, str(base / "torch"))
    losses = []
    res = ttrain.training(
        m, h, o, p, [ITERS], [ITERS], args=args, quiet=True,
        rng=random.Random(0), device="cpu",
        progress_callback=lambda it, loss, *_: losses.append(loss))
    out["torch"] = (losses, res.best_psnr, m.model_path)
    out["max_opacity"] = float(
        tsplats.get_opacity(res.params)[res.stats.valid].max())
    return out


def test_losses_and_test_psnr(runs):
    jl, jpsnr, _ = runs["jax"]
    tl, tpsnr, _ = runs["torch"]
    assert len(jl) == len(tl) == ITERS
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert abs(tpsnr - jpsnr) <= 1e-4, (tpsnr, jpsnr)
    # below the 0.99 clamp: applied alpha <= opacity < 0.99
    assert runs["max_opacity"] < 0.99


def _lr(name):
    o = tcfg.OptimizationConfig()
    lrs = {"x": o.position_lr_init * 5.0, "y": o.position_lr_init * 5.0,
           "z": o.position_lr_init * 5.0, "f_dc": o.feature_lr,
           "f_rest": o.feature_lr / 20.0, "opacity": o.opacity_lr,
           "scale": o.scaling_lr, "rot": o.rotation_lr}
    return next(v for k, v in lrs.items() if name.startswith(k))


def test_saved_ply(runs):
    rel = f"point_cloud/iteration_{ITERS}/point_cloud.ply"
    nj, dj = read_ply_vertices(f"{runs['jax'][2]}/{rel}")
    nt, dt = read_ply_vertices(f"{runs['torch'][2]}/{rel}")
    assert nj == nt and dj.shape == dt.shape
    for i, name in enumerate(nj):
        if name.startswith("n"):  # normals: zeros in both
            assert not dj[:, i].any() and not dt[:, i].any()
            continue
        lr = _lr(name)
        err = np.abs(dt[:, i] - dj[:, i]) - 1e-6 * np.abs(dj[:, i])
        assert err.max() <= 2 * lr * ITERS, name
        share = float(np.mean(err > 1e-4 * lr * ITERS))
        assert share <= NOISE_SHARE, (name, share)


def test_render_cli_on_the_jax_run(runs, scene_dir, tmp_path):
    """Both render CLIs on one JAX-trained directory (a copy each)."""
    src = runs["jax"][2]
    results = {}
    for name, main, kw in (("jax", jrender.main, {}),
                           ("torch", trender.main, {"device": "cpu"})):
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        main(["-s", scene_dir, "-m", d, "--skip_train"], **kw)
        results[name] = tmetrics.read_results(
            f"{d}/test/ours_{ITERS}/results.yaml")
    assert abs(results["torch"]["psnr"] - results["jax"]["psnr"]) <= 1e-3
    assert abs(results["torch"]["ssim"] - results["jax"]["ssim"]) <= 1e-3
    assert results["torch"]["lpips"] is None
    # the port's video.gif: every render, in order, within the fixed
    # palette's error (tests/test_torch_video.py holds it against PIL's)
    base = f"{tmp_path}/torch/test/ours_{ITERS}"
    frames, delays, loop = tgif.read(f"{base}/video.gif")
    renders = sorted(os.listdir(f"{base}/renders"))
    assert len(frames) == len(renders) > 0 and loop == 0
    for frame, name in zip(frames, renders):
        png = tpng.read(f"{base}/renders/{name}")
        err = np.abs(frame.astype(np.int64) - png).mean()
        assert err <= chip_smoke.fixed_palette_mae(png), name


def test_channel_order_does_not_move_the_metrics():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 256, (40, 36, 3)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-20, 20, a.shape), 0,
                255).astype(np.uint8)
    rgb = tmetrics.eval_imgs(a, b)
    bgr = tmetrics.eval_imgs(a[..., ::-1], b[..., ::-1])
    assert rgb == pytest.approx(bgr, rel=1e-12)
    want = jmetrics.eval_imgs(a, b)
    assert rgb == pytest.approx(want, rel=1e-12)


def _jax_conditions(it, is_static, o, tests, saves):
    """The JAX loop's own tests, as written in splatfields_tpu/train.py."""
    enable_g_opt = not o.disable_gaussian_opt
    field_mode = (not is_static) and not (
        o.warm_up is not None and 0 < o.warm_up and it < o.warm_up)
    densify = (enable_g_opt and it < o.densify_until_iter
               and it > o.densify_from_iter
               and it % o.densification_interval == 0)
    return ttrain.IterationEvents(
        field_mode=field_mode, sh_bump=enable_g_opt and it % 1000 == 0,
        densify=densify,
        size_threshold=20.0 if it > o.opacity_reset_interval else 0.0,
        overwrite_loc=bool(it > 1500 and o.overwrite_loc and field_mode),
        test=it in tests, save=it in saves)


@pytest.mark.parametrize("flags", [
    ["--is_static"],                                # 3DGS baseline
    ["--encoder_type", "VarTriPlaneEncoder", "--lambda_norm", "0.01",
     "--test_iterations", "-1"],                    # SplatFields3D
    ["--warm_up", "3000", "--overwrite_loc"],
    ["--disable_gaussian_opt", "--densify_until_iter", "15000"]])
def test_iteration_events_match_the_jax_loop(flags):
    args = ttrain.build_train_parser().parse_args(
        ["-s", "x", "--iterations", "40000", "--load_time_step", "0"]
        + flags)
    args.save_iterations.append(args.iterations)
    _, _, _, o = tcfg.extract_configs(args)
    tests, saves = set(args.test_iterations), set(args.save_iterations)
    counts = {"densify": 0, "test": 0, "save": 0, "sh_bump": 0}
    for it in range(1, 40_001):
        got = ttrain.iteration_events(it, args.is_static, o, tests, saves)
        assert got == _jax_conditions(it, args.is_static, o, tests,
                                      saves), it
        for k in counts:
            counts[k] += bool(getattr(got, k))
    if "--disable_gaussian_opt" not in flags:
        # every 100 from 600 to 40,000 (densify_until_iter 45,000)
        assert counts["densify"] == 395
        assert counts["sh_bump"] == 40
    assert counts["save"] == 8  # 100, 500, 1000, 7000, 10000-40000
