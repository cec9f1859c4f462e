"""The port's quality tooling against the JAX repo's, on the CPU:
``scripts/longrun_torch.py`` against ``scripts/longrun_30k.py`` and
``scripts/quality_gate_torch.py``'s new variants against
``scripts/quality_gate.py``.

- The long run's scene at 32x32: the transforms JSONs equal, every frame
  within 1 level of the JAX script's (its XLA blend against the port's
  plain blend, both quantized by truncation).
- The long run's command line: the JAX script's own argv (caught as it
  reaches the parser) equals the port's, and both packages' configs
  from it are equal.
- Legs: one run of 4 iterations equals two legs of 2 + 2 through
  ``--resume`` (32x32, 300 hull points, ``dup_factor`` 1 so it grows in
  the first leg, a densify-and-prune pass every iteration from 2 with a
  capacity growth in each leg): the same loss at every step, the same
  evaluation lines and the same final PLY and field weights, byte for
  byte. Torch runs on one thread, where its CPU kernels are
  deterministic.
- The 4-D gate's scene (``--variant owlii4d``) at 1 and 4 views a step,
  and the field gate at 2: the cameras (azimuth, elevation, time, split),
  the cloud at each view's time and the camera matrices equal the JAX
  gate's, read from its ``main`` as it reaches the trainee; each step's
  views share a time, and the groups cover the train views.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from splatfields_torch import config as tcfg
from splatfields_torch import train_lib
from splatfields_torch.data import png
from splatfields_tpu import config as jcfg
from splatfields_tpu.utils import system as jsystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import longrun_torch  # noqa: E402
import quality_gate_torch  # noqa: E402

LEG_FLAGS = ["--device", "cpu", "--res", "32", "--num_pts", "300",
             "--iters", "4", "--eval_every", "4", "--save_every", "2",
             "--dup_factor", "1", "--densify_from_iter", "1",
             "--densification_interval", "1"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_script(name, monkeypatch):
    """``scripts/<name>.py`` of the JAX repo as a module, without its
    persistent compile cache."""
    monkeypatch.setattr(jsystem, "enable_persistent_compile_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Reached(Exception):
    """Raised where a JAX script's ``main`` is stopped."""


def _main_locals(exc):
    tb = exc.__traceback__
    while tb is not None:
        if tb.tb_frame.f_code.co_name == "main":
            return tb.tb_frame.f_locals
        tb = tb.tb_next
    raise AssertionError("main's frame not found")


def test_scene_matches_the_jax_scene(tmp_path, monkeypatch):
    jax_script = _jax_script("longrun_30k", monkeypatch)
    jax_script.build_scene(str(tmp_path / "jax"), 32)
    longrun_torch.build_scene(str(tmp_path / "port"), 32,
                              torch.device("cpu"))
    for split, n in (("train", 10), ("test", 2)):
        name = f"transforms_{split}.json"
        with open(tmp_path / "jax" / name) as a, \
                open(tmp_path / "port" / name) as b:
            assert json.load(a) == json.load(b)
        for i in range(n):
            want = np.array(PIL.Image.open(
                tmp_path / "jax" / split / f"r_{i}.png")).astype(int)
            got = png.read(str(tmp_path / "port" / split / f"r_{i}.png"))
            assert got.shape == want.shape == (32, 32, 4)
            assert np.abs(got.astype(int) - want).max() <= 1
            assert want[..., 3].max() > 0 and want[..., 3].min() < 255


def test_argv_matches_the_jax_script(monkeypatch):
    jax_script = _jax_script("longrun_30k", monkeypatch)
    caught = {}

    class Parser:
        def parse_args(self, argv):
            caught["argv"] = argv
            raise Reached

    monkeypatch.setattr(jcfg, "build_parser", lambda *a, **k: Parser())
    monkeypatch.setattr(jax_script, "build_scene", lambda *a, **k: None)
    # --resume: the JAX script keeps (does not delete) its run directory
    monkeypatch.setattr(sys, "argv", ["longrun_30k.py", "--resume"])
    with pytest.raises(Reached):
        jax_script.main()
    argv = caught["argv"]
    assert argv == longrun_torch.train_argv(argv[1], argv[3], 20_000, 64,
                                            30_000)
    monkeypatch.undo()
    got = tcfg.extract_configs(tcfg.build_parser().parse_args(argv))
    want = jcfg.extract_configs(jcfg.build_parser().parse_args(argv))
    assert got == tuple(type(t)(**dataclasses.asdict(j))
                        for j, t in zip(want, got))


def _leg(argv, losses):
    """``longrun_torch.main`` with each train step's loss appended to
    ``losses``."""
    make = train_lib.make_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def run(*sa):
            out = step(*sa)
            losses.append(float(out[-1].loss))
            return out
        return run

    train_lib.make_train_step = recording
    try:
        return longrun_torch.main(argv)
    finally:
        train_lib.make_train_step = make


def test_two_legs_equal_one_run(tmp_path):
    base = LEG_FLAGS + ["--scene_dir", str(tmp_path / "scene")]
    one_run, legs = str(tmp_path / "one"), str(tmp_path / "legs")
    one_losses, leg_losses = [], []
    whole = _leg(base + ["--run_dir", one_run], one_losses)
    first = _leg(base + ["--run_dir", legs, "--leg_until", "2"], leg_losses)
    assert not first["done"] and first["legs"][0]["until"] == 2
    joined = _leg(base + ["--run_dir", legs, "--resume"], leg_losses)

    assert len(one_losses) == 4 and leg_losses == one_losses
    a, b = joined["legs"]
    assert (a["from"], a["until"], b["from"], b["until"]) == (1, 2, 3, 4)
    assert b["view_rng_start"] == a["view_rng_end"]
    assert b["view_rng_end"] == whole["legs"][0]["view_rng_end"]
    assert a["dup_factor_start"] == 1 and a["dup_growth"]
    assert b["dup_factor_start"] == a["dup_factor_end"]
    assert b["dup_factor_end"] == whole["dup_factor"]
    assert (a["densify_passes"], b["densify_passes"]) == (1, 2)
    assert a["capacity_growths"] >= 1 and b["capacity_growths"] >= 1
    for key in ("trajectory", "final_points", "capacity", "dup_factor"):
        assert joined[key] == whole[key], key

    def records(run):
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            r.pop("iter_time", None)
        return recs

    assert records(legs) == records(one_run)
    for rel in ("point_cloud/iteration_4/point_cloud.ply",
                "deform/iteration_4/deform.msgpack"):
        with open(os.path.join(one_run, rel), "rb") as f, \
                open(os.path.join(legs, rel), "rb") as g:
            assert f.read() == g.read(), rel


@pytest.mark.parametrize("variant,num_views",
                         [("owlii4d", 1), ("owlii4d", 4), ("field", 2)])
def test_gate_scene_matches_the_jax_gate(variant, num_views, monkeypatch):
    import jax

    from splatfields_tpu.models import splats as jsplats
    from splatfields_tpu.ops.raster import api as japi
    gate = _jax_script("quality_gate", monkeypatch)
    drawn = []

    def record(*args, **kw):
        drawn.append([np.asarray(a) for a in args[:7]])

        class Out:
            color = np.zeros((3, 1, 1), np.float32)
        return Out()

    def trainee(*a, **k):
        raise Reached

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(japi, "rasterize", record)
    monkeypatch.setattr(jsplats, "create_from_pcd", trainee)
    monkeypatch.setattr(sys, "argv", ["quality_gate.py", "--variant",
                                      variant, "--num_views",
                                      str(num_views)])
    with pytest.raises(Reached) as exc:
        gate.main()
    want = _main_locals(exc.value)

    specs, n_frames = quality_gate_torch.scene_spec(variant, num_views)
    assert n_frames == want["n_frames"]
    assert specs == want["cam_specs"]
    assert len(drawn) == len(specs)
    pts = want["pts"]
    for (az, el, fid, _), (cloud, _, _, _, w2v, full, campos) in zip(
            specs, drawn):
        np.testing.assert_array_equal(
            quality_gate_torch.cloud_at(pts, fid, n_frames), cloud)
        cam = quality_gate_torch.OrbitCam(az, el, 4.0, 0.8, 400, 400)
        np.testing.assert_allclose(cam.world_view_transform, w2v,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(cam.full_proj_transform, full,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(cam.camera_center, campos, rtol=1e-6,
                                   atol=1e-6)
    groups = quality_gate_torch.view_groups(specs, n_frames, num_views)
    assert all(len(g) == num_views for g in groups)
    assert all(len({specs[v][2] for v in g}) == 1 for g in groups)
    assert sorted({v for g in groups for v in g}) == want["train_v"]
    assert [v for v, s in enumerate(specs) if s[3] == "test"] == \
        want["test_v"]
