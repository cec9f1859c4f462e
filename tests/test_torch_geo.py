"""The port's ``extract_geo`` and ``ops/marching.py`` against the JAX
package's, on the CPU.

- ``marching_tetrahedra`` is the JAX package's NumPy code, copied: on a
  seeded field its vertices and triangles are equal and the mesh PLY
  bytes identical. ``extract_fields`` hands a torch query the same f32
  grid (an exact query gives the same field).
- ``morans_report`` and ``splat_density_query`` in static mode (300
  splats, SH degree 1, 20 invalid) and in field mode (the MLP-only net,
  ``--encoder_type none``; the JAX functions get the port net's outputs,
  so they compose the same attributes with their own code): Moran's I
  within 1e-6 relative, with an absolute 1e-7, since I is a mean of O(1)
  terms of either sign that can cancel to near 0; the density at 400
  points within 1e-5 of its largest value.
- The ``MoransI_iteration_N.yaml`` text: ``yaml_text`` equals
  ``yaml.safe_dump`` on the report and on awkward floats.
- ``python -m splatfields_torch.extract_geo`` end to end on a run the
  port's train CLI wrote (2 iterations of a 64x64 Blender scene with
  ``--lambda_corr 0.01 --corr_interval 2``: one KNN, at iteration 2): the
  yaml's values against the JAX package's ``morans_report`` of the same
  saved state (its own Scene), as in static mode above, and a mesh PLY
  with vertices and faces.
"""
import argparse
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from splatfields_torch import config as tcfg
from splatfields_torch import extract_geo as tgeo
from splatfields_torch import train as ttrain
from splatfields_torch.interop import splat_params_from_numpy
from splatfields_torch.models import splats as tsplats
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.ops import knn as tknn
from splatfields_torch.ops import marching as tmarch
from splatfields_tpu import config as jcfg
from splatfields_tpu import extract_geo as jgeo
from splatfields_tpu.models import splats as jsplats
from splatfields_tpu.ops import marching as jmarch
from splatfields_tpu.scene import Scene as JaxScene

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(res=24, seed=0):
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, res)] * 3, indexing="ij"),
                 -1)
    u = np.zeros((res,) * 3)
    for c in rng.uniform(-0.6, 0.6, (5, 3)):
        u += np.exp(-((g - c) ** 2).sum(-1) / 0.08)
    return (u + 0.01 * rng.randn(*u.shape)).astype(np.float32)


def test_marching_tetrahedra_and_mesh_bytes(tmp_path):
    u = _field()
    tv, tt = tmarch.marching_tetrahedra(u, 0.5)
    jv, jt = jmarch.marching_tetrahedra(u, 0.5)
    assert len(tt) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tt, jt)
    tmarch.write_mesh_ply(tmp_path / "t.ply", tv, tt)
    jmarch.write_mesh_ply(tmp_path / "j.ply", jv, jt)
    assert ((tmp_path / "t.ply").read_bytes()
            == (tmp_path / "j.ply").read_bytes())


def test_extract_fields_grid():
    lo, hi = np.array([-1.0, -0.5, 0.2]), np.array([0.7, 1.1, 1.3])
    got = tmarch.extract_fields(lo, hi, 17, lambda p: p[:, 0] * 2 + p[:, 1],
                                chunk=1000, device="cpu")
    want = jmarch.extract_fields(lo, hi, 17, lambda p: p[:, 0] * 2 + p[:, 1],
                                 chunk=1000)
    np.testing.assert_array_equal(got, want)


class _JaxNetShim:
    """Stands in for a JAX DeformModel in ``splatfields_tpu.extract_geo``:
    its ``net.apply`` returns the port net's outputs, so the JAX functions
    compose them (field means, scale added to the splats', rgb) with
    their own code. The nets themselves are held to each other by
    tests/test_torch_fields.py."""

    def __init__(self, net):
        self.variables, self.net = None, self
        self._port = net

    def apply(self, variables, xyz, t):
        with torch.no_grad():
            out = self._port(torch.as_tensor(np.array(xyz)))
        return {k: jnp.asarray(v.numpy()) for k, v in out.items()
                if isinstance(v, torch.Tensor)}


def _state(mode, n=300, n_invalid=20):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    j_params, j_stats = jsplats.create_from_pcd(pts, cols, 1)
    j_params = jsplats.SplatParams(**{
        k: jnp.asarray(np.asarray(getattr(j_params, k))
                       + rng.randn(*getattr(j_params, k).shape).astype(
                           np.float32) * 0.1)
        for k in ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity")})
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_invalid, replace=False)] = False
    j_stats = jsplats.SplatStats(jnp.asarray(valid), j_stats.max_radii2d,
                                 j_stats.xyz_gradient_accum, j_stats.denom)
    np_params = {k: np.asarray(getattr(j_params, k)) for k in (
        "xyz", "features_dc", "features_rest", "scaling", "rotation",
        "opacity")}
    t_params = splat_params_from_numpy(np_params, device="cpu")
    t_stats = tsplats.SplatStats(torch.as_tensor(valid),
                                 *[torch.zeros(n)] * 3)
    j_def = t_def = None
    if mode == "field":
        t_def = DeformModel(tcfg.HiddenConfig(encoder_type="none",
                                              composition_rank=0),
                            radius=1.0, seed=3, device="cpu")
        j_def = _JaxNetShim(t_def.net)
    return (j_params, j_stats, j_def), (t_params, t_stats, t_def)


@pytest.fixture(scope="module", params=["static", "field"])
def state(request):
    return request.param, _state(request.param)


def test_morans_report(state):
    mode, (j, t) = state
    got = tgeo.morans_report(*t, 0)
    want = jgeo.morans_report(*j, 0)
    assert set(got) == set(want) == {
        "moran_scale", "moran_rotation", "moran_opacity", "moran_rgb"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert tgeo.yaml_text(got) == yaml.safe_dump(got)


def test_splat_density_query(state):
    mode, (j, t) = state
    q = np.random.RandomState(5).uniform(-1, 1, (400, 3)).astype(np.float32)
    got = tgeo.splat_density_query(*t, 0)(torch.as_tensor(q)).numpy()
    want = jgeo.splat_density_query(*j, 0)(q)
    assert got.shape == want.shape == (400,)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("report", [
    {"moran_rgb": 1e-05, "moran_scale": 0.123456789, "moran_opacity": -0.5,
     "moran_rotation": 1e17},
    {"b": float("nan"), "a": float("inf"), "c": -float("inf"), "d": 0.0,
     "e": 3.0e-300, "f": 1.0},
    {}])
def test_yaml_text(report):
    assert tgeo.yaml_text(report) == yaml.safe_dump(report)


@pytest.fixture(scope="module")
def static_run(tmp_path_factory):
    """2 iterations of the Moran line (``--lambda_corr 0.01``), with
    ``--corr_interval 2``: the KNN runs at iteration 2 only."""
    base = tmp_path_factory.mktemp("geo")
    scene = chip_smoke.write_blender_scene(base, 64, 5, [0.3, 2.5],
                                           torch.device("cpu"))
    out = str(base / "run")
    knn = tknn.query_nn
    calls = []
    tknn.query_nn = lambda pts, *a, **k: calls.append(len(pts)) or knn(
        pts, *a, **k)
    try:
        ttrain.main(["-s", scene, "-m", out, "--white_background", "--eval",
                     "--is_static", "--n_views", "4", "--pts_samples",
                     "random", "--num_pts", "400", "--load_time_step", "0",
                     "--composition_rank", "0", "--iterations", "2",
                     "--tile_cap", "128", "--k_chunk", "32", "--quiet",
                     "--lambda_corr", "0.01", "--corr_interval", "2"],
                    device="cpu")
    finally:
        tknn.query_nn = knn
    return out, calls


def test_moran_loop_gate(static_run):
    assert static_run[1] == [400]


def test_cli_static(static_run):
    static_run = static_run[0]
    report = tgeo.main(["-m", static_run, "--mesh_resolution", "16",
                        "--mesh_threshold", "0.3"], device="cpu")
    with open(os.path.join(static_run, "MoransI_iteration_2.yaml")) as f:
        text = f.read()
    assert text == yaml.safe_dump(report)
    args = argparse.Namespace(**tcfg.load_cfg_args(static_run))
    model = jcfg.extract_configs(args)[0]
    scene = JaxScene(model, load_iteration=-1, shuffle=False)
    want = jgeo.morans_report(scene.splats, scene.splat_stats, None, 0)
    for k, v in yaml.safe_load(text).items():
        assert math.isclose(v, want[k], rel_tol=1e-6, abs_tol=1e-7), k
    mesh = os.path.join(static_run, "mesh_iteration_2.ply")
    with open(mesh, "rb") as f:
        head = f.read(300).split(b"end_header")[0].decode()
    n_v = int(head.split("element vertex ")[1].split()[0])
    n_f = int(head.split("element face ")[1].split()[0])
    assert n_v > 0 and n_f > 0
