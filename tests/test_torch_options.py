"""The JAX package's off-by-default field options in the port, against
the JAX package on the CPU, each set in both packages by monkeypatch.

- The quad sampler (``ops/grid_sample.py``): the quad table, its edge
  weights, the forward and the plane's gradient through each of the
  table VJP's three routes: the scatter (default), the sorted segment sum
  (``SPLATFIELDS_PLANE_GRAD_PALLAS``; JAX's Pallas kernel runs in
  interpret mode, as tests/test_segsum_pallas.py runs it) and the
  scatter-free prefix sums (``SPLATFIELDS_SORTED_PLANE_GRAD``, at N =
  1,200 as JAX's own test); per plane and all planes in one table
  (``SPLATFIELDS_QUAD_MULTI``), with the table in bf16
  (``SPLATFIELDS_PLANE_BF16``). Both gradient options on raise
  ``ValueError`` in both packages.
- The encoders' routing of those options (``PlaneOptions``) and their
  sampling on given planes, against JAX ``_sample_planes_stacked``.
- The decoder: grouped ``TimeConv`` (per-frame deltas included) at f32
  and under ``SPLATFIELDS_CNN_BF16``, the packed ``SpatialAttention``,
  the packed ``Tensorial2D`` (``SPLATFIELDS_PACKED_CNN``) equal to three
  unpacked ones at ``strategy`` none and per_frame and to JAX's packed
  decoder, and a packed ``deform.msgpack`` across both packages.
- ``fuse_heads`` (static and 4-D) equal to the unfused heads and to JAX's.
- ``SPLATFIELDS_NGP_SORTED_GRAD=off``: the plain gather's table gradient.
- The static 3DGS path at ``sh_degree`` 3 (``train_lib.static_attributes``)
  against the NumPy oracle ``rasterize_oracle``.

Weights are the port's, carried to flax with ``interop.module_to_flax``.
Tolerances: f32 routes within 1e-5 of the largest value (gradients: of
the largest gradient), plus rtol 1e-5. ``PLANE_BF16`` rounds the same
table in both packages, so it is held as tightly. Under ``CNN_BF16`` the
conv's output is rounded to bf16 (a step of 2^-8 relative) after f32
sums that the two packages add in other orders: a value near a rounding
boundary may round to the neighbouring bf16 value, so outputs agree
within one step, 2^-8 of the largest output; the gradients' bf16
cotangents and operands likewise, within two steps, 2^-7 of the largest
gradient.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_tpu.models import decoder as jdec
from splatfields_tpu.models import encoders as jenc
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_tpu.models.splatfields import SplatFields as JaxSplatFields
from splatfields_tpu.ops import grid_sample as jgs
from splatfields_tpu.ops.raster.oracle import rasterize_oracle
from splatfields_torch import config, train_lib
from splatfields_torch.interop import (
    flax_to_state_dict,
    load_flax_variables,
    module_to_flax,
)
from splatfields_torch.models import decoder as pdec
from splatfields_torch.models import encoders as penc
from splatfields_torch.models import splats
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.models.splatfields import SplatFields
from splatfields_torch.ops import grid_sample as pgs
from tests.test_torch_encoders import _close

OPTION_ENVS = ("SPLATFIELDS_QUAD_SAMPLE", "SPLATFIELDS_PLANE_BF16",
               "SPLATFIELDS_QUAD_MULTI", "SPLATFIELDS_PLANE_GRAD_PALLAS",
               "SPLATFIELDS_SORTED_PLANE_GRAD", "SPLATFIELDS_PACKED_CNN",
               "SPLATFIELDS_CNN_BF16", "SPLATFIELDS_NGP_SORTED_GRAD")
ROUTE_ENV = {"scatter": None, "segsum": "SPLATFIELDS_PLANE_GRAD_PALLAS",
             "cumsum": "SPLATFIELDS_SORTED_PLANE_GRAD"}
BF16_STEP = 2.0 ** -8
HEADS = dict(deform_w=16, deform_d=2, deform_skips=(1,), rgb_w=16,
             rgb_d=2, rgb_skips=(1,), scale_w=16, scale_d=2,
             scale_skips=(1,), opacity_w=16, opacity_d=2, opacity_skips=(1,),
             rotation_w=16, rotation_d=2, flow_w=16, flow_d=2,
             flow_skips=(1,))
# a 2x2-noise decoder: 16x16 planes
GEN = dict(noise_res=2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_options(monkeypatch):
    """Every option unset unless a test sets it."""
    for name in OPTION_ENVS:
        monkeypatch.delenv(name, raising=False)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _coords(n, seed):
    """Points over [-1.2, 1.2]^2, a hot spot (many points into few table
    rows) and every edge case of the quad weights: floors at -1, 0,
    size - 1 and outside the plane."""
    rng = np.random.RandomState(seed)
    hot = np.float32([0.31, -0.47]) + rng.randn(n // 4, 2).astype(
        np.float32) * 1e-3
    edge = np.float32([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [0.999, -0.999],
                       [-1.06, 0.2], [0.2, 1.06], [-1.4, 0.0], [0.0, 1.4]])
    rest = rng.uniform(-1.2, 1.2, (n - n // 4 - len(edge), 2))
    return np.concatenate([hot, edge, rest.astype(np.float32)])


def test_quad_table_and_weights_equal_jax():
    rng = np.random.RandomState(0)
    plane = rng.randn(3, 7, 5).astype(np.float32)
    coords = _coords(200, 1)
    np.testing.assert_array_equal(
        pgs.pack_quad_rows(torch.as_tensor(plane)).numpy(),
        np.asarray(jax.jit(jgs.pack_quad_rows)(jnp.asarray(plane))))
    idx, w4 = pgs.quad_idx_w(torch.as_tensor(coords), 7, 5)
    jidx, jw4 = jax.jit(jgs._quad_idx_w, static_argnums=(1, 2))(
        jnp.asarray(coords), 7, 5)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # weights in [0, 1]; XLA may fuse their products into other roundings
    np.testing.assert_allclose(w4.numpy(), np.asarray(jw4), rtol=0,
                               atol=1e-6)
    g = rng.randn(35, 12).astype(np.float32)
    np.testing.assert_array_equal(
        pgs.quad_rows_grad_to_plane(torch.as_tensor(g), 7, 5).numpy(),
        np.asarray(jax.jit(jgs.quad_rows_grad_to_plane, static_argnums=(
            1, 2))(jnp.asarray(g), 7, 5)))


def test_quad_sample_is_grid_sample():
    """The quad route computes the function F.grid_sample computes."""
    rng = np.random.RandomState(2)
    planes = torch.as_tensor(rng.randn(3, 4, 9, 11).astype(np.float32))
    coords = torch.as_tensor(np.stack([_coords(300, s) for s in (3, 4, 5)]))
    want = pgs.grid_sample_planes(planes, coords)
    got = torch.stack([pgs.grid_sample_2d_quad(planes[i], coords[i])
                       for i in range(3)], dim=1)
    _close(got, want.numpy(), "quad vs grid_sample", tol=1e-6)
    _close(pgs.grid_sample_2d_quad_multi(planes, list(coords)), want.numpy(),
           "quad multi vs grid_sample", tol=1e-6)


def _plane_grads(monkeypatch, route, multi, bf16, n, seed):
    """The port's and JAX's (output, plane gradient) of sum(out * cot)."""
    rng = np.random.RandomState(seed)
    planes = rng.randn(3, 4, 16, 16).astype(np.float32)
    coords = np.stack([_coords(n, seed + i) for i in range(3)])
    if ROUTE_ENV[route]:
        monkeypatch.setenv(ROUTE_ENV[route], "on")
    dtype = jnp.bfloat16 if bf16 else None

    def jfn(p):
        if multi:
            return jgs.grid_sample_2d_quad_multi(
                p, [jnp.asarray(c) for c in coords], dtype)
        return jnp.stack([jgs._quad_sample(jgs.pack_quad_rows(p[i]),
                                           jnp.asarray(coords[i]), (16, 16),
                                           dtype) for i in range(3)], axis=1)

    cot = rng.randn(n, 3, 4).astype(np.float32)

    @jax.jit
    def fwd_bwd(p, c):
        out, vjp = jax.vjp(jfn, p)
        return out, vjp(c)[0]

    jout, jgrad = fwd_bwd(jnp.asarray(planes), jnp.asarray(cot))
    x = torch.tensor(planes, requires_grad=True)
    tdtype = torch.bfloat16 if bf16 else None
    if multi:
        out = pgs.grid_sample_2d_quad_multi(x, list(torch.as_tensor(coords)),
                                            tdtype, route)
    else:
        out = torch.stack([pgs.grid_sample_2d_quad(
            x[i], torch.as_tensor(coords[i]), tdtype, route)
            for i in range(3)], dim=1)
    (grad,) = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), x)
    return (out, grad), (np.asarray(jout), np.asarray(jgrad))


@pytest.mark.parametrize("route", ["scatter", "segsum", "cumsum"])
@pytest.mark.parametrize("multi", [False, True], ids=["per_plane", "multi"])
def test_quad_sample_and_plane_grad_match_jax(monkeypatch, route, multi):
    (out, grad), (jout, jgrad) = _plane_grads(monkeypatch, route, multi,
                                              False, 1200, 7)
    _close(out, jout, "output")
    _close(grad, jgrad, f"plane gradient, {route}")
    assert np.abs(jgrad).max() > 0


def test_plane_bf16_matches_jax(monkeypatch):
    """Both packages round the same table to bf16 and sum in f32; the
    plane gradient stays f32 (equal to the f32 route's)."""
    (out, grad), (jout, jgrad) = _plane_grads(monkeypatch, "scatter", True,
                                              True, 600, 9)
    _close(out, jout, "bf16 output")
    _close(grad, jgrad, "bf16 plane gradient")
    (out32, grad32), _ = _plane_grads(monkeypatch, "scatter", True, False,
                                      600, 9)
    _close(grad, grad32.numpy(), "bf16 vs f32 plane gradient")
    assert float((out32 - out).detach().abs().max()) > 1e-4 * float(
        out32.detach().abs().max())


def test_both_plane_grad_options_raise(monkeypatch):
    monkeypatch.setenv("SPLATFIELDS_PLANE_GRAD_PALLAS", "on")
    monkeypatch.setenv("SPLATFIELDS_SORTED_PLANE_GRAD", "on")
    plane = jnp.ones((2, 4, 4))
    coords = jnp.zeros((3, 2))
    for build in (lambda: jax.jit(jax.grad(lambda p: jnp.sum(
            jgs.grid_sample_2d_quad(p, coords))))(plane),
                  pgs.plane_grad_route, penc.PlaneOptions.read,
                  lambda: penc.VarTriPlaneEncoder(**GEN, generator=_gen())):
        with pytest.raises(ValueError) as err:
            build()
        assert ("SPLATFIELDS_SORTED_PLANE_GRAD" in str(err.value)
                and "SPLATFIELDS_PLANE_GRAD_PALLAS" in str(err.value))
    # QUAD_SAMPLE=off never reaches the table's VJP, in either package
    monkeypatch.setenv("SPLATFIELDS_QUAD_SAMPLE", "off")
    assert not penc.PlaneOptions.read().quad


@pytest.mark.parametrize("env,want", [
    ({}, dict(quad=False)),
    ({"SPLATFIELDS_QUAD_SAMPLE": "on"}, dict(quad=True)),
    ({"SPLATFIELDS_QUAD_SAMPLE": "garbage"}, dict(quad=True)),
    ({"SPLATFIELDS_QUAD_SAMPLE": "off", "SPLATFIELDS_QUAD_MULTI": "on",
      "SPLATFIELDS_PLANE_BF16": "on"}, dict(quad=False)),
    ({"SPLATFIELDS_PLANE_BF16": "on"},
     dict(quad=True, gather_dtype=torch.bfloat16)),
    ({"SPLATFIELDS_QUAD_MULTI": "on"}, dict(quad=True, multi=True)),
    ({"SPLATFIELDS_QUAD_MULTI": "on", "SPLATFIELDS_QUAD_SAMPLE": "garbage"},
     dict(quad=True, multi=False)),
    ({"SPLATFIELDS_PLANE_GRAD_PALLAS": "on"}, dict(quad=True, grad="segsum")),
    ({"SPLATFIELDS_SORTED_PLANE_GRAD": "on"}, dict(quad=True, grad="cumsum")),
    ({"SPLATFIELDS_PACKED_CNN": "on"}, dict(quad=False, packed=True)),
])
def test_plane_option_rules(monkeypatch, env, want):
    """JAX's names and values; unset with no sub-option on keeps
    F.grid_sample (the port's kept difference)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = penc.PlaneOptions.read()
    for k, v in want.items():
        assert getattr(got, k) == v, (k, got)


@functools.cache
def _jax_stacked(axes, env):
    """JAX ``_sample_planes_stacked``'s (output, plane gradient) under the
    options ``env``, jitted (the options are read when it traces)."""
    def loss(planes, pts, cot):
        out = jenc._sample_planes_stacked(planes, pts, axes)
        return jnp.sum(out * cot), out
    return jax.jit(jax.grad(loss, has_aux=True))


@pytest.mark.parametrize("env", [
    ("SPLATFIELDS_QUAD_SAMPLE",), ("SPLATFIELDS_QUAD_MULTI",),
    ("SPLATFIELDS_QUAD_MULTI", "SPLATFIELDS_PLANE_GRAD_PALLAS"),
    ("SPLATFIELDS_PLANE_BF16", "SPLATFIELDS_SORTED_PLANE_GRAD")],
    ids=["quad", "multi", "multi_segsum", "bf16_cumsum"])
def test_encoder_sampling_matches_jax(monkeypatch, env):
    """VarTriPlane's planes through ``PlaneOptions.sample`` against JAX's
    ``_sample_planes_stacked`` with the same options."""
    for name in env:
        monkeypatch.setenv(name, "on")
    rng = np.random.RandomState(5)
    planes = rng.randn(3, 4, 16, 16).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (300, 3)).astype(np.float32)
    cot = rng.randn(300, 3, 4).astype(np.float32)
    axes = penc._SPACE_AXES
    jgrad, jout = _jax_stacked(axes, env)(planes, pts, cot)
    enc = penc.VarTriPlaneEncoder(**GEN, generator=_gen())
    assert enc.options.quad
    x = torch.tensor(planes, requires_grad=True)
    out = enc.options.sample(x, torch.as_tensor(pts), axes)
    (grad,) = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), x)
    _close(out, jout, "output")
    _close(grad, jgrad, "plane gradient")


@functools.cache
def _jax_grad(jmod, frame):
    """Jitted (param gradients, output) of sum(jmod(x, frame) * cot)."""
    def loss(params, variables, x, cot):
        out = jmod.apply(dict(variables, params=params), x,
                         **({} if frame is None else {"frame_id": frame}))
        return jnp.sum(out * cot), out
    return jax.jit(jax.grad(loss, has_aux=True))


def _module_pair(pm, jm, x, frame=None, tol=1e-5, grad_tol=1e-5):
    """A port decoder module ``pm`` and the flax one ``jm`` with the port's
    weights on the NHWC input ``x``: outputs within ``tol`` of the largest
    output, every parameter's gradient of sum(out * cot) within
    ``grad_tol`` of the largest gradient. The port's side gets ``x`` as
    contiguous NCHW, as its decoders hand it on (this CPU build's GroupNorm
    backward crashes on a channels-last strided input). Returns the port's
    output, NHWC."""
    kw = {} if frame is None else {"frame_id": frame}
    out = pm(torch.as_tensor(x).permute(0, 3, 1, 2).contiguous(),
             **kw).permute(0, 2, 3, 1)
    cot = np.random.RandomState(3).randn(*out.shape).astype(np.float32)
    names, wrt = zip(*pm.named_parameters())
    grads = torch.autograd.grad((out * torch.as_tensor(cot)).sum(), wrt)
    variables = module_to_flax(pm)
    jgrads, jout = _jax_grad(jm, frame)(variables["params"], variables, x,
                                        cot)
    _close(out, jout, "output", tol=tol)
    want = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, jgrads)).items()}
    assert set(want) == set(names)
    scale = max(np.abs(w).max() for w in want.values())
    for k, g in zip(names, grads):
        _close(g, want[k], f"gradient {k}", scale, grad_tol)
    return out.detach()


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "cnn_bf16"])
def test_grouped_time_conv_matches_jax(monkeypatch, bf16):
    """A grouped 3x3 conv (3 groups) with per-frame deltas at frame 1."""
    def conv():
        return pdec.TimeConv(12, 9, 3, n_frames=3, strategy="per_frame",
                             groups=3, generator=_gen())

    if bf16:
        monkeypatch.setenv("SPLATFIELDS_CNN_BF16", "on")
    pm = conv()
    with torch.no_grad():   # a nonzero bias, as training makes it
        pm.bias.uniform_(-0.5, 0.5, generator=_gen(1))
    assert pm.bf16 is bf16
    x = np.random.RandomState(2).randn(1, 6, 6, 12).astype(np.float32)
    out = _module_pair(pm, jdec.TimeConv(9, 3, 3, "per_frame", groups=3), x,
                       1, *((BF16_STEP, 2 * BF16_STEP) if bf16 else ()))
    if bf16:   # the option took effect
        monkeypatch.setenv("SPLATFIELDS_CNN_BF16", "off")
        f32 = conv()
        f32.load_state_dict(pm.state_dict())
        with torch.no_grad():
            ref = f32(torch.as_tensor(x).permute(0, 3, 1, 2), 1).permute(
                0, 2, 3, 1)
        assert float((ref - out).abs().max()) > 1e-4 * float(
            ref.abs().max())


def test_packed_attention_matches_jax():
    pm = pdec.SpatialAttention(12, 6, n_packs=3, generator=_gen())
    with torch.no_grad():   # to_out starts at zero: give it weights
        pm.to_out_kernel.normal_(0, 0.3, generator=_gen(1))
        pm.to_out_bias.normal_(0, 0.3, generator=_gen(2))
    assert pm.to_q_kernel.shape == (3, 4, 4) and pm.to_q_bias.shape == (3, 4)
    x = np.random.RandomState(4).randn(1, 5, 5, 12).astype(np.float32)
    _module_pair(pm, jdec.SpatialAttention(12, 6, n_packs=3), x)


@pytest.mark.parametrize("strategy", ["none", "per_frame"])
def test_packed_decoder_equals_three(strategy):
    """Three decoders as one channel-packed net, pack-major (their weights
    copied in by ``chip_smoke.pack_tensorial``): the same planes; and its
    leaves are JAX's packed tree (the JAX packed decoder gives the same
    planes)."""
    kw = dict(GEN, n_frames=3, strategy=strategy)
    subs = [pdec.Tensorial2D(**kw, generator=_gen(i)) for i in range(3)]
    packed = pdec.Tensorial2D(**kw, n_packs=3, generator=_gen(5))
    chip_smoke.pack_tensorial(subs, packed)
    frame = 1 if strategy == "per_frame" else None
    with torch.no_grad():
        want = torch.cat([s(frame) for s in subs], dim=1)
        got = packed(frame)
    _close(got, want.numpy(), "packed vs three")
    variables = module_to_flax(packed)
    jm = jdec.Tensorial2D(**kw, n_packs=3)
    jout = jax.jit(lambda v, f: jm.apply(v, f))(variables, frame)
    _close(got, np.asarray(jout).transpose(0, 3, 1, 2), "packed vs JAX")


PACKED_NET = dict(encoder_type="VarTriPlaneEncoder",
                  encoder_args={"noise_res": 2}, composition_rank=0,
                  n_frames=0, **HEADS)


def _jax_net(kw, **extra):
    kw = dict(kw, **extra)
    kw["encoder_args"] = tuple(sorted(kw["encoder_args"].items()))
    return JaxSplatFields(**kw)


class _Narrow(DeformModel):
    """The port's DeformModel around a given net (its IO methods only)."""

    def __init__(self, net):
        self.net = net


def test_packed_msgpack_crosses_both_ways(monkeypatch, tmp_path):
    """Under ``SPLATFIELDS_PACKED_CNN=on``: a deform.msgpack the JAX
    package writes loads into the port, and both render the same
    attributes; the port's file loads back into JAX's tree."""
    monkeypatch.setenv("SPLATFIELDS_PACKED_CNN", "on")
    pnet = SplatFields(**PACKED_NET, generator=_gen(0))
    keys = set(pnet.state_dict())
    assert "encoder.subs_packed.net.mid_attn.to_q_kernel" in keys
    assert not any(k.startswith("encoder.subs_0") for k in keys)
    tree = module_to_flax(pnet)
    JaxDeformModel.save_weights(types.SimpleNamespace(variables=tree),
                                str(tmp_path), 3)
    port = _Narrow(SplatFields(**PACKED_NET, generator=_gen(5)))
    assert port.load_weights(str(tmp_path)) == 3
    for k, v in pnet.state_dict().items():
        assert torch.equal(port.net.state_dict()[k], v), k
    xyz = np.random.RandomState(6).uniform(-0.9, 0.9, (200, 3)).astype(
        np.float32)
    with torch.no_grad():
        got = port.net(torch.as_tensor(xyz))
    want = jax.jit(lambda v, x: _jax_net(PACKED_NET).apply(v, x))(
        tree, jnp.asarray(xyz))
    for k in ("scales", "opacity", "rotations", "rgb", "means3D"):
        _close(got[k], want[k], k)
    port.save_weights(str(tmp_path / "again"), 4)
    jax_side = types.SimpleNamespace(variables=jax.tree.map(
        np.zeros_like, tree))
    JaxDeformModel.load_weights(jax_side, str(tmp_path / "again"), 4)
    for path, v in jax.tree_util.tree_leaves_with_path(jax_side.variables):
        want = functools.reduce(lambda t, p: t[p.key], path, tree)
        np.testing.assert_array_equal(np.asarray(v), want)


# no deform head: the batched heads are the others
FOUR_D = dict(encoder_type="", composition_rank=0, n_frames=3,
              flow_model="offset", deform_weight=0.0, **HEADS)
STATIC = dict(encoder_type="", composition_rank=0, n_frames=0,
              deform_weight=0.0, **HEADS)


@pytest.mark.parametrize("kw", [STATIC, FOUR_D], ids=["static", "4d"])
def test_fuse_heads_match(kw):
    """``fuse_heads`` on equals off (same weights) and JAX's
    ``fuse_heads=True``, outputs and every parameter's gradient."""
    net = SplatFields(**kw, fuse_heads=True, generator=_gen(0))
    plain = SplatFields(**kw, generator=_gen(0))
    assert net.fuse_heads and not plain.fuse_heads
    rng = np.random.RandomState(8)
    xyz = rng.uniform(-0.9, 0.9, (150, 3)).astype(np.float32)
    tkw = {}
    if kw["n_frames"]:
        t = np.full((150, 1), 0.5, np.float32)
        tkw = dict(t=torch.as_tensor(t), frame_id=1)
    keys = ("scales", "opacity", "rotations", "rgb", "means3D") + (
        ("flow",) if kw["n_frames"] else ())
    cots = {k: rng.randn(150, {"opacity": 1, "rotations": 4}.get(k, 3))
            .astype(np.float32) for k in keys}
    names, leaves = zip(*net.named_parameters())
    grads = {}
    for which, m in (("fused", net), ("plain", plain)):
        out = m(torch.as_tensor(xyz), **tkw)
        total = sum((out[k] * torch.as_tensor(cots[k])).sum() for k in keys)
        grads[which] = (out, torch.autograd.grad(
            total, [p for _, p in m.named_parameters()]))
    variables = module_to_flax(net)
    jnet = JaxSplatFields(**kw, fuse_heads=True, encoder_args=())

    def loss(params):
        args = (xyz,) if not kw["n_frames"] else (xyz, t)
        out = jnet.apply(dict(variables, params=params), *args)
        return sum(jnp.sum(out[k] * cots[k]) for k in keys), out

    g, jout = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    want = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, g)).items()}
    scale = max(np.abs(w).max() for w in want.values())
    out, got = grads["fused"]
    for k in keys:
        _close(out[k], grads["plain"][0][k].detach().numpy(), f"{k} vs off")
        _close(out[k], jout[k], f"{k} vs JAX")
    for name, a, b in zip(names, got, grads["plain"][1]):
        _close(a, b.numpy(), f"gradient {name} vs off", scale)
        _close(a, want[name], f"gradient {name} vs JAX", scale)


def test_fuse_heads_ignore_mlp_bf16(monkeypatch):
    """The batched heads run in f32 under ``SPLATFIELDS_MLP_BF16=on``,
    the other heads in bf16 (JAX's trap, kept)."""
    monkeypatch.setenv("SPLATFIELDS_MLP_BF16", "on")
    # no deform head: the geometry heads read the points themselves
    net = SplatFields(**STATIC, fuse_heads=True, generator=_gen(0))
    xyz = torch.as_tensor(np.random.RandomState(9).uniform(
        -0.9, 0.9, (100, 3)).astype(np.float32))
    with torch.no_grad():
        fused = net(xyz)
        net.fuse_heads = False
        plain = net(xyz)
        monkeypatch.setenv("SPLATFIELDS_MLP_BF16", "off")
        f32 = net(xyz)
    for k in ("scales", "opacity", "rotations"):
        _close(fused[k], f32[k].numpy(), f"{k}: f32 under fuse_heads")
        assert not torch.equal(plain[k], f32[k]), k
    assert torch.equal(fused["rgb"], plain["rgb"])


@pytest.mark.parametrize("env", ["off", "on"])
def test_ngp_sorted_grad_off_gives_the_same_table_grad(monkeypatch, env):
    """``SPLATFIELDS_NGP_SORTED_GRAD``: ``off`` takes the plain gather
    (autograd's scatter), ``on`` the sorted segment sum; the table
    gradient equals JAX's under the same value."""
    monkeypatch.setenv("SPLATFIELDS_NGP_SORTED_GRAD", env)
    enc = jenc.HashGridEncoder(n_levels=4, log2_hashmap_size=12)
    port = penc.HashGridEncoder(n_levels=4, log2_hashmap_size=12,
                                generator=_gen())
    assert penc.ngp_sorted_grad(port.sorted_grad, port.table) is (env == "on")
    table = np.random.RandomState(4).randn(4, 2 ** 12, 2).astype(np.float32)
    load_flax_variables(port, {"params": {"table": table}})
    pts = np.random.RandomState(5).uniform(0, 1, (256, 3)).astype(np.float32)
    w = np.random.RandomState(6).randn(256, 8).astype(np.float32)
    calls = []
    segsum = penc.sorted_segment_sum
    monkeypatch.setattr(penc, "sorted_segment_sum",
                        lambda *a: calls.append(a) or segsum(*a))

    def loss(t):
        return jnp.sum(jnp.tanh(enc.apply({"params": {"table": t}},
                                          jnp.asarray(pts))) * w)

    want = np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(table)))
    out = (torch.tanh(port(torch.as_tensor(pts))) * torch.as_tensor(w)).sum()
    (got,) = torch.autograd.grad(out, port.table)
    assert len(calls) == (env == "on")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("env,cuda,want", [
    ("auto", False, False), ("auto", True, True), ("on", False, True),
    ("off", True, False), ("garbage", True, True)])
def test_ngp_sorted_grad_rule(env, cuda, want):
    assert penc.ngp_sorted_grad(env, types.SimpleNamespace(is_cuda=cuda)) \
        is want


def test_static_sh3_path_matches_oracle():
    """The static 3DGS path at sh_degree 3: ``static_attributes`` of
    splats with every SH band nonzero, rendered by ``render_view``,
    against the NumPy oracle (tests/test_torch_raster.py's bound)."""
    rng = np.random.RandomState(3)
    n, res = 300, 48
    pts = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
    p, st = splats.create_from_pcd(pts, rng.rand(n, 3).astype(np.float32),
                                   3, device="cpu")
    p = splats.SplatParams(**{**p.__dict__, "features_rest": torch.as_tensor(
        rng.randn(n, 15, 3).astype(np.float32) * 0.3),
        "opacity": torch.as_tensor(rng.uniform(-2, 1, (n, 1)).astype(
            np.float32))})
    attrs = train_lib.static_attributes(p, st.valid)
    assert attrs["shs"].shape == (n, 16, 3)
    cam = chip_smoke.make_views(2, res)[1]

    def f32(x):
        return np.asarray(x, np.float32)

    view = {"viewmatrix": torch.as_tensor(f32(cam.world_view_transform)),
            "projmatrix": torch.as_tensor(f32(cam.full_proj_transform)),
            "campos": torch.as_tensor(f32(cam.camera_center)),
            "tanfovx": cam.tanfovx, "tanfovy": cam.tanfovy}
    bg = np.float32([0.2, 0.5, 0.8])
    out = train_lib.render_view(attrs, view, torch.as_tensor(bg), res, res,
                                3, config.PipelineConfig())
    oracle = rasterize_oracle(
        *[a.detach().numpy() for a in (attrs["means3d"], attrs["scales"],
                                       attrs["rotations"], attrs["opacity"])],
        f32(cam.world_view_transform), f32(cam.full_proj_transform),
        f32(cam.camera_center), bg, cam.tanfovx, cam.tanfovy, res, res,
        shs=attrs["shs"].detach().numpy(), sh_degree=3)
    assert float(out.alpha.max()) > 0.5
    for name, atol in (("color", 1e-3), ("depth", 4e-3), ("alpha", 1e-3)):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   oracle[name], atol=atol, rtol=0,
                                   err_msg=name)
    # the higher bands reach the colours: without them the image moves
    flat = dict(attrs, shs=attrs["shs"][:, :1])
    out0 = train_lib.render_view(flat, view, torch.as_tensor(bg), res, res,
                                 0, config.PipelineConfig())
    assert float((out0.color - out.color).abs().max()) > 1e-2
