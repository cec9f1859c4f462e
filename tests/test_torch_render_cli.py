"""The port's render and extract-geo CLIs against the JAX package's flag
surface and the protocol scripts, and the depth colour map.

- ``render.jet``: cv2's ``COLORMAP_JET`` on the value quantized as the
  JAX CLI quantizes it, ``(dvis * 255).astype(uint8)``; the table equals
  cv2's (in RGB order, as ``cv2.imwrite`` stores the BGR map) on all 256
  levels and on a seeded depth ramp. Skips where cv2 is absent.
- Every option string of the JAX render and extract-geo parsers
  (``config.build_parser`` plus the ``add_argument`` calls of their
  ``main``, read from the source) is accepted by the port's.
- The render lines of ``scripts/run_dtu.sh`` and ``scripts/run_blender.sh``
  parse with the port's render parser, their train lines with its train
  parser, with the JAX package's values.
"""
import ast
import os
import re
import shlex

import numpy as np
import pytest

from splatfields_torch import config as tcfg
from splatfields_torch import extract_geo as tgeo
from splatfields_torch import render as trender
from splatfields_torch import train as ttrain
from splatfields_tpu import config as jcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_jet_matches_cv2():
    cv2 = pytest.importorskip("cv2")
    levels = np.arange(256, dtype=np.uint8)[None]
    want = cv2.applyColorMap(levels, cv2.COLORMAP_JET)[0, :, ::-1]
    np.testing.assert_array_equal(trender.JET_LUT, want)
    rng = np.random.RandomState(0)
    dvis = np.clip(rng.rand(40, 50) * 1.2 - 0.1, 0, 1).astype(np.float32)
    dvis[0, :3] = (0.0, 1.0, 0.5)
    got = trender.jet(dvis)
    ref = cv2.applyColorMap((dvis * 255).astype(np.uint8),
                            cv2.COLORMAP_JET)[..., ::-1]
    assert got.dtype == np.uint8 and got.shape == (40, 50, 3)
    np.testing.assert_array_equal(got, ref)


def _main_flags(path):
    """Option strings of the ``add_argument`` calls in ``main`` of a
    module of the JAX package."""
    tree = ast.parse(open(path).read())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef)
                and f.name == "main")
    return {a.value for n in ast.walk(main) if isinstance(n, ast.Call)
            and getattr(n.func, "attr", "") == "add_argument"
            for a in n.args if isinstance(a, ast.Constant)}


def _options(parser):
    return set(parser._option_string_actions)


@pytest.mark.parametrize("cli,port_parser", [
    ("render", trender.build_render_parser),
    ("extract_geo", tgeo.build_parser)])
def test_parser_accepts_every_jax_flag(cli, port_parser):
    want = _options(jcfg.build_parser(sentinel=True)) | _main_flags(
        os.path.join(REPO, "splatfields_tpu", f"{cli}.py"))
    if cli == "render":
        assert {"--lpips_weights", "--render_batch"} <= want
    missing = want - _options(port_parser())
    assert not missing, missing


def _script_lines(script):
    """The script's ``$PY.<cli>`` command lines with its defaults
    substituted, the ablation loop's once per variant -> [(cli, argv)]."""
    text = open(os.path.join(REPO, "scripts", script)).read()
    env = dict(re.findall(r"^(\w+)=\$\{\w+:-([^}]*)\}", text, re.M))
    env.update(SCENE="scan114" if "dtu" in script else "lego")
    text = text.replace("\\\n", " ")
    loop = re.search(r"for VARIANT in (.*?); do", text, re.S)
    variants = re.findall(r'"([^"]*)"', loop.group(1)) if loop else []
    out = []
    for line in text.splitlines():
        line = line.strip()
        if not line.startswith("$PY."):
            continue
        expand = [dict(NAME=v.split()[0], FLAGS=v.split(None, 1)[1])
                  for v in variants] if "$FLAGS" in line else [{}]
        for extra in expand:
            cmd = line
            for k, v in sorted({**env, **extra}.items(),
                               key=lambda kv: -len(kv[0])):
                cmd = cmd.replace("${" + k + "}", v).replace("$" + k, v)
            cli, *argv = shlex.split(cmd)
            out.append((cli[len("$PY."):], argv))
    return out


@pytest.mark.parametrize("script", ["run_dtu.sh", "run_blender.sh"])
def test_protocol_lines_parse(script):
    lines = _script_lines(script)
    assert {cli for cli, _ in lines} == {"train", "render"}
    for cli, argv in lines:
        if cli == "render":
            args = trender.build_render_parser().parse_args(argv)
            assert args.lpips_weights is None and args.render_batch == 8
            want = jcfg.build_parser(sentinel=True).parse_known_args(argv)[0]
        else:
            args = ttrain.build_train_parser().parse_args(argv)
            want = jcfg.build_parser().parse_known_args(argv)[0]
        for k, v in vars(want).items():
            if v is not None:
                assert getattr(args, k) == v, (cli, k)
    trains = [argv for cli, argv in lines if cli == "train"]
    if script == "run_dtu.sh":
        model, _, hidden, opt = tcfg.extract_configs(
            ttrain.build_train_parser().parse_args(trains[1]))
        assert (model.resolution, hidden.deform_weight, opt.lambda_mask,
                hidden.W) == (2, 0.0, 0.1, 128)
