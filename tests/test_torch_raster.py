"""The port's rasterizer modules against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:
- float outputs of the same f32 formulas: the two frameworks fuse and
  order the arithmetic differently, so values agree to a few f32 ulps
  (rtol 1e-5);
- blend outputs: the chunked transmittance product is associated in a
  different order (1e-5 absolute on colour and T; depth, which sums
  w * z with z ~ 4, 4e-5);
- integer outputs of binning (ranges, ids, counts, drops): exact, since
  both are fed the same float inputs.
"""
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu.ops.raster import blend_jax
from splatfields_tpu.ops.raster.api import rasterize as jax_rasterize
from splatfields_tpu.ops.raster.binning import bin_gaussians as jax_bin
from splatfields_tpu.ops.raster.blend_pallas import blend_sorted_pallas
from splatfields_tpu.ops.raster.oracle import rasterize_oracle
from splatfields_tpu.ops.raster.preprocess import preprocess as jax_preprocess
from splatfields_torch.ops.raster.api import rasterize
from splatfields_torch.ops.raster.binning import bin_gaussians
from splatfields_torch.ops.raster.blend_cuda import blend_fwd
from splatfields_torch.ops.raster.blend_torch import blend_sorted_plain
from splatfields_torch.ops.raster.preprocess import preprocess
from splatfields_torch.utils import camera_math as cm


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_scene(n=256, seed=0, width=64, height=48):
    """Random splats in [-1, 1]^3 seen from z = -4 (as in test_raster.py)."""
    rng = np.random.RandomState(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = (0.02 + 0.08 * rng.rand(n, 3)).astype(np.float32)
    rots = rng.randn(n, 4).astype(np.float32)
    ops = rng.uniform(0.2, 0.95, (n,)).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    w2v = cm.get_world2view(np.eye(3, dtype=np.float32),
                            np.array([0, 0, 4.0], np.float32)).T
    fovx, fovy = 0.8, 0.6
    proj = cm.get_projection_matrix(0.01, 100.0, fovx, fovy).T
    return dict(
        means3d=means, scales=scales, rotations=rots, opacities=ops,
        colors_precomp=colors, viewmatrix=w2v, projmatrix=w2v @ proj,
        campos=np.linalg.inv(w2v.T)[:3, 3].astype(np.float32),
        bg=np.array([1.0, 1.0, 1.0], np.float32),
        tanfovx=math.tan(fovx / 2), tanfovy=math.tan(fovy / 2),
        width=width, height=height)


def heavy_scene():
    """Big opaque splats: most pixels saturate (T < 1e-4) early."""
    s = make_scene(n=96, seed=3)
    s["scales"] = np.full_like(s["scales"], 0.5)
    s["opacities"] = np.full_like(s["opacities"], 0.95)
    return s


def tie_scene():
    """Pairs of splats at one position (equal depth) with other colours:
    the order within a tie (by id) decides the colour."""
    s = make_scene(n=64, seed=5)
    for k in ("means3d", "scales", "rotations", "opacities"):
        s[k] = np.concatenate([s[k], s[k]])
    s["colors_precomp"] = np.concatenate(
        [s["colors_precomp"], 1.0 - s["colors_precomp"]])
    return s


SCENES = {"random": make_scene, "heavy": heavy_scene, "ties": tie_scene}


def _pre_args(s, lib):
    conv = jnp.asarray if lib == "jax" else torch.as_tensor
    return ((conv(s["means3d"]), conv(s["scales"]), conv(s["rotations"]),
             conv(s["opacities"]), conv(s["viewmatrix"]),
             conv(s["projmatrix"]), s["width"], s["height"], s["tanfovx"],
             s["tanfovy"]))


def _t(x):
    """A torch copy of a JAX array."""
    return torch.tensor(np.asarray(x))


def _tiles(s):
    return -(-s["width"] // 16), -(-s["height"] // 16)


@pytest.mark.parametrize("color_src", ["precomp", "sh3"])
def test_preprocess_matches_jax(color_src):
    s = make_scene()
    kw_j, kw_t = {}, {}
    if color_src == "precomp":
        kw_j["colors_precomp"] = jnp.asarray(s["colors_precomp"])
        kw_t["colors_precomp"] = torch.as_tensor(s["colors_precomp"])
    else:
        shs = np.random.RandomState(1).randn(256, 16, 3).astype(np.float32)
        kw_j.update(shs=jnp.asarray(shs), sh_degree=3,
                    campos=jnp.asarray(s["campos"]))
        kw_t.update(shs=torch.as_tensor(shs), sh_degree=3,
                    campos=torch.as_tensor(s["campos"]))
    ref = jax_preprocess(*_pre_args(s, "jax"), **kw_j)
    out = preprocess(*_pre_args(s, "torch"), **kw_t)
    for name in ("means2d", "depths", "conics", "rgb", "opacity"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    np.testing.assert_array_equal(out.visible.numpy(), np.asarray(ref.visible))


BIN_CASES = {
    # (scene, tile_cap, dup_cap)
    "plain": ("random", 256, 4096),
    "dup_cap_overflow": ("random", 256, 300),
    "tile_cap_overflow": ("heavy", 16, 4096),
    "depth_ties": ("ties", 256, 4096),
}


def _jax_pre(s):
    return jax_preprocess(*_pre_args(s, "jax"),
                          colors_precomp=jnp.asarray(s["colors_precomp"]))


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_binning_matches_jax_exactly(case):
    scene, tile_cap, dup_cap = BIN_CASES[case]
    s = SCENES[scene]()
    tx, ty = _tiles(s)
    pre = _jax_pre(s)
    ref = jax_bin(pre.means2d, pre.depths, pre.radii, tx, ty, 16,
                  tile_cap=tile_cap, dup_cap=dup_cap)
    out = bin_gaussians(_t(pre.means2d), _t(pre.depths),
                        _t(pre.radii), tx, ty, 16, dup_cap=dup_cap)
    for name in ("tile_start", "sorted_id", "counts", "n_dropped"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(out.depth.numpy(), np.asarray(ref.depth))
    if case == "dup_cap_overflow":
        assert int(out.n_dropped) > 0
    if case == "tile_cap_overflow":
        assert int(out.counts.max()) > tile_cap


BLEND_CASES = {
    # (scene, tile_cap, k_chunk)
    "plain": ("random", 256, 64),
    "early_termination": ("heavy", 256, 64),
    "tile_cap_overflow": ("heavy", 32, 16),
    "depth_ties": ("ties", 256, 64),
}


@pytest.mark.parametrize("case", sorted(BLEND_CASES))
def test_plain_blend_matches_jax_and_pallas(case):
    scene, tile_cap, k_chunk = BLEND_CASES[case]
    s = SCENES[scene]()
    tx, ty = _tiles(s)
    pre = _jax_pre(s)
    b = jax_bin(pre.means2d, pre.depths, pre.radii, tx, ty, 16,
                tile_cap=tile_cap, dup_cap=4096)
    ref = blend_jax.blend_tiles(
        b.sorted_id, b.tile_start, b.counts, pre.means2d, pre.conics,
        pre.rgb, pre.opacity, pre.depths, tx, ty, 16, tile_cap=tile_cap,
        k_chunk=k_chunk)
    pack = blend_jax.pack_attributes(pre.means2d, pre.conics, pre.rgb,
                                     pre.opacity, pre.depths)
    sorted_pack = pack[jnp.maximum(b.sorted_id, 0)]
    pal = blend_sorted_pallas(sorted_pack, b.tile_start, b.counts, tx, ty, 16,
                              tile_cap, k_chunk, True)
    color, depth, final_t = blend_sorted_plain(
        _t(sorted_pack), _t(b.tile_start), _t(b.counts), tx, ty, 16,
        tile_cap, k_chunk)
    ref_color = np.transpose(np.asarray(ref.color), (0, 2, 1))
    for other in ((ref_color, ref.depth, ref.final_t), pal):
        np.testing.assert_allclose(color.numpy(), np.asarray(other[0]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(depth.numpy(), np.asarray(other[1]),
                                   atol=4e-5, rtol=0)
        np.testing.assert_allclose(final_t.numpy(), np.asarray(other[2]),
                                   atol=1e-5, rtol=0)
    if scene == "heavy":
        assert float(final_t.min()) < 1e-3   # some pixels did saturate
    if case == "tile_cap_overflow":
        assert int(np.asarray(b.counts).max()) > tile_cap


def _torch_scene(s):
    return [torch.as_tensor(s[k]) for k in (
        "means3d", "scales", "rotations", "opacities", "viewmatrix",
        "projmatrix", "campos", "bg")]


@pytest.mark.parametrize("scene", ["random", "heavy"])
def test_rasterize_matches_jax_and_oracle(scene):
    s = SCENES[scene]()
    args = (s["tanfovx"], s["tanfovy"], s["width"], s["height"])
    ref = jax_rasterize(*[jnp.asarray(x) for x in (
        s["means3d"], s["scales"], s["rotations"], s["opacities"],
        s["viewmatrix"], s["projmatrix"], s["campos"], s["bg"])], *args,
        colors_precomp=jnp.asarray(s["colors_precomp"]), tile_cap=256,
        k_chunk=64, dup_cap=4096, blend_impl="jax")
    oracle = rasterize_oracle(
        s["means3d"], s["scales"], s["rotations"], s["opacities"],
        s["viewmatrix"], s["projmatrix"], s["campos"], s["bg"], *args,
        colors_precomp=s["colors_precomp"])
    launches = blend_fwd.launches
    out = rasterize(*_torch_scene(s), *args,
                    colors_precomp=torch.as_tensor(s["colors_precomp"]),
                    tile_cap=256, k_chunk=64, dup_cap=4096)
    # CPU tensors take the plain blend: no kernel launch is counted
    assert blend_fwd.launches == launches
    assert out.color.shape == (3, s["height"], s["width"])
    np.testing.assert_array_equal(out.radii.numpy(), np.asarray(ref.radii))
    assert int(out.n_dropped) == int(ref.n_dropped) == 0
    for name, atol in (("color", 1e-4), ("depth", 4e-4), ("alpha", 1e-4)):
        got = getattr(out, name).numpy()
        np.testing.assert_allclose(got, np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=name)
        # the oracle is a sequential numpy blend in another order of
        # operations, as far from the JAX blend as from this one
        np.testing.assert_allclose(got, oracle[name], atol=10 * atol, rtol=0,
                                   err_msg=f"{name} vs oracle")
