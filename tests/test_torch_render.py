"""The slice end to end on the CPU: the JAX serving path
(``render_lib._render_jit`` in field mode) against the port's
``render_camera`` on the same carried weights and splats.

64x48 image, 256 splats, VarTriPlane noise 4x4, bench-style orbit camera.
Tolerances: the field outputs agree to ~1e-6 relative (test_torch_fields)
and the blends to ~1e-6 absolute (test_torch_raster); the images here
agree to ~4e-7 (depth, with z ~ 4, to ~2e-6), so colour and alpha get
2e-5 and depth 1e-4. Screen radii and the dropped-instance count are
integers and must be equal.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu import config as jax_config
from splatfields_tpu.data.cameras import MiniCam
from splatfields_tpu.models import splats as jax_splats
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_tpu.render_lib import _render_jit
from splatfields_torch import config
from splatfields_torch.interop import load_flax_variables, splat_params_from_numpy
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.models.splats import SplatStats
from splatfields_torch.render_lib import render_camera, render_cameras_batched
from splatfields_torch.utils import camera_math as cm

W, H, N = 64, 48, 256
ENC = {"noise_res": 4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera(view=1, fov=0.8):
    """One of bench.py's orbit cameras."""
    th = 0.25 * view
    c, s = math.cos(th), math.sin(th)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    w2v = cm.get_world2view(R, np.array([0.1 * view, 0, 4.0], np.float32)).T
    proj = cm.get_projection_matrix(0.01, 100.0, fov, fov).T
    return MiniCam(image_width=W, image_height=H, FoVy=fov, FoVx=fov,
                   znear=0.01, zfar=100.0, world_view_transform=w2v,
                   full_proj_transform=(w2v @ proj).astype(np.float32))


def test_render_camera_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    cols = rng.rand(N, 3).astype(np.float32)
    jax_params, jax_stats = jax_splats.create_from_pcd(pts, cols, 0,
                                                       capacity=N)
    ref_model = JaxDeformModel(jax_config.HiddenConfig(
        encoder_type="VarTriPlaneEncoder", composition_rank=0,
        encoder_args=ENC), radius=1.0)
    pipe = config.PipelineConfig(tile_cap=256, k_chunk=64)
    cam = _camera()
    bg = np.ones(3, np.float32)
    ref = _render_jit(
        jax_params, jax_stats.valid, ref_model.variables,
        jnp.asarray(cam.world_view_transform),
        jnp.asarray(cam.full_proj_transform), jnp.asarray(cam.camera_center),
        jnp.float32(cam.tanfovx), jnp.float32(cam.tanfovy), jnp.asarray(bg),
        jnp.float32(0.0), net=ref_model.net, width=W, height=H, sh_degree=0,
        field_mode=True, n_frames=0, tile_size=16, tile_cap=pipe.tile_cap,
        k_chunk=pipe.k_chunk, dup_factor=pipe.dup_factor)

    model = DeformModel(config.HiddenConfig(
        encoder_type="VarTriPlaneEncoder", composition_rank=0,
        encoder_args=ENC), radius=1.0, device="cpu")
    load_flax_variables(model.net, jax.tree.map(np.asarray,
                                                dict(ref_model.variables)))
    params = splat_params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                     device="cpu")
    valid = torch.tensor(np.asarray(jax_stats.valid))
    stats = SplatStats(valid=valid, max_radii2d=torch.zeros(N),
                       xyz_gradient_accum=torch.zeros(N), denom=torch.zeros(N))
    out = render_camera(cam, params, stats, model, pipe, bg)

    assert out["render"].shape == (3, H, W)
    np.testing.assert_array_equal(out["radii"].numpy(), np.asarray(ref.radii))
    assert int(out["n_dropped"]) == int(ref.n_dropped)
    for key, name, atol in (("render", "color", 2e-5), ("depth", "depth", 1e-4),
                            ("opacity", "alpha", 2e-5)):
        np.testing.assert_allclose(out[key].numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=key)
    # the scene is not blank: the comparison saw real coverage
    assert float(out["opacity"].mean()) > 0.1

    # the batched twin is the same per-frame path
    (frame,) = render_cameras_batched([cam], params, stats, model, pipe, bg)
    torch.testing.assert_close(frame["render"], out["render"], rtol=0, atol=0)
