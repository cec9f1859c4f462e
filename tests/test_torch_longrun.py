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
- The 4-D gate's scene and trainee (``--variant owlii4d``) at 1 and 4
  views a step, and the field gate's at 2, as ``quality_gate_torch.Gate``
  builds them: the cameras (azimuth, elevation, time, split), the cloud at
  each view's time, the camera matrices, the initial cloud, the configs,
  the learning rates and the first batch equal the JAX gate's, read from
  its ``main`` as it reaches its first step; each step's views share a
  time, and the groups cover the train views.
"""
import dataclasses
import importlib.util
import inspect
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
    """``quality_gate_torch.Gate`` (the builder of the card's gate, of
    ``scripts/gate_parity_cpu.py`` and of ``chip_smoke.py`` phase 47)
    against the JAX gate's ``main`` at its TPU size, stopped at its first
    step: the true cloud's attributes, the cloud at each view's time, the
    cameras, the initial cloud, the trainee's ``HiddenConfig``, loss and
    pipeline configs, the learning rates and the first step's batch."""
    import jax

    from splatfields_torch.models import splats as tsplats
    from splatfields_tpu import train_lib as jtrain
    from splatfields_tpu.models import deform_model as jdeform
    from splatfields_tpu.models import splats as jsplats
    from splatfields_tpu.ops.raster import api as japi
    gate = _jax_script("quality_gate", monkeypatch)
    drawn, seen = [], {}

    def record(*args, **kw):
        drawn.append([np.asarray(a) for a in args[:7]] + [
            np.asarray(kw["colors_precomp"])])

        class Out:
            color = np.zeros((3, 1, 1), np.float32)
        return Out()

    class Deform:
        net, variables, opt_state = None, {}, None

        def __init__(self, hidden, **kw):
            seen["hidden"] = hidden

    def make_step(net, opt_cfg, pipe_cfg, *args, **kw):
        seen.update(opt=opt_cfg, pipe=pipe_cfg)

        def step(*a):
            seen.update(batch=a[5], lrs=a[6], field_lr=a[7])
            raise Reached
        return step

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(japi, "rasterize", record)
    monkeypatch.setattr(jsplats, "create_from_pcd", lambda pts0, *a, **k: (
        seen.setdefault("pts0", pts0), None))
    monkeypatch.setattr(jsplats, "adam_init", lambda *a, **k: None)
    monkeypatch.setattr(jdeform, "DeformModel", Deform)
    monkeypatch.setattr(jtrain, "make_train_step", make_step)
    monkeypatch.setattr(sys, "argv", ["quality_gate.py", "--variant",
                                      variant, "--num_views",
                                      str(num_views)])
    with pytest.raises(Reached) as exc:
        gate.main()
    want = _main_locals(exc.value)

    ours = []
    monkeypatch.setattr(quality_gate_torch, "render_plain", lambda *a, **k: (
        ours.append(a) or torch.zeros(3, 1, 1), None))
    g = quality_gate_torch.Gate(variant, 42, torch.device("cpu"),
                                num_views=num_views)
    assert g.n_frames == want["n_frames"]
    assert g.specs == want["cam_specs"]
    assert len(drawn) == len(ours) == len(g.cams) == len(g.specs)
    for cam, mine, (cloud, sc, rot, op, w2v, full, campos, col) in zip(
            g.cams, ours, drawn):
        np.testing.assert_array_equal(mine[0], cloud)
        for x, y in zip(mine[1:5], (sc, rot, op, col)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(cam.world_view_transform, w2v,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(cam.full_proj_transform, full,
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(cam.camera_center, campos, rtol=1e-6,
                                   atol=1e-6)
    assert all(len(v) == num_views for v in g.groups)
    assert all(len({g.specs[v][2] for v in views}) == 1
               for views in g.groups)
    assert sorted({v for views in g.groups for v in views}) == \
        want["train_v"]
    assert g.test_v == want["test_v"]
    np.testing.assert_array_equal(g.pts0, seen["pts0"])
    # the trainee's configs, field for field
    h = seen["hidden"]
    assert jcfg.HiddenConfig(**g.hidden()) == h
    assert dataclasses.asdict(g.opt) == dataclasses.asdict(seen["opt"])
    assert dataclasses.asdict(g.pipe) == dataclasses.asdict(seen["pipe"])
    lrs = tsplats.splat_lr_tree(*quality_gate_torch.SPLAT_LRS)
    assert tsplats.tree_items(lrs) == {
        k: float(getattr(seen["lrs"], k))
        for k in tsplats.tree_items(lrs)}
    assert np.float32(quality_gate_torch.FIELD_LR) == np.asarray(
        seen["field_lr"])
    # the first step's batch: the first group's views
    b, jb = g.batch(g.groups[0], torch.device("cpu")), seen["batch"]
    for k in ("viewmatrix", "projmatrix", "campos", "bg"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]), k)
    for k in ("tanfovx", "tanfovy"):
        np.testing.assert_array_equal(np.float32(b[k]), np.asarray(jb[k]))
    assert np.float32(b["fid"]) == np.asarray(jb["fid"])


@pytest.mark.parametrize("seed", [42, 3])
def test_gate_net_seed_matches_the_jax_gate(seed, monkeypatch):
    """Both gates draw the net at the same seed whatever the scene seed:
    the JAX gate's ``DeformModel`` keeps its default seed 0, and the
    port's is built at ``NET_SEED`` 0 (the scene and the initial cloud
    follow ``--seed`` / ``--seeds``)."""
    from splatfields_torch.models import deform_model as tdeform
    from splatfields_torch.models import splats as tsplats
    from splatfields_tpu.models import deform_model as jdeform
    from splatfields_tpu.ops.raster import api as japi
    gate = _jax_script("quality_gate", monkeypatch)
    seeds = {}

    def catch(package, cls):
        def build(*args, **kw):
            # the seed as the real constructor would take it, default and all
            bound = inspect.signature(cls).bind(*args, **kw)
            bound.apply_defaults()
            seeds[package] = bound.arguments["seed"]
            raise Reached
        return build

    class Out:
        color = np.zeros((3, 1, 1), np.float32)

    monkeypatch.setattr(japi, "rasterize", lambda *a, **k: Out())
    monkeypatch.setattr(jdeform, "DeformModel",
                        catch("jax", jdeform.DeformModel))
    monkeypatch.setattr(sys, "argv", ["quality_gate.py", "--seed",
                                      str(seed)])
    with pytest.raises(Reached):
        gate.main()
    monkeypatch.setattr(quality_gate_torch, "render_plain",
                        lambda *a, **k: (torch.zeros(3, 1, 1), None))
    monkeypatch.setattr(tsplats, "create_from_pcd", lambda *a, **k: (
        None, None))
    monkeypatch.setattr(tsplats, "adam_init", lambda *a, **k: None)
    monkeypatch.setattr(tdeform, "DeformModel",
                        catch("port", tdeform.DeformModel))
    with pytest.raises(Reached):
        quality_gate_torch.train_and_eval("field", seed, 1,
                                          torch.device("cpu"))
    assert seeds == {"jax": 0, "port": 0}
