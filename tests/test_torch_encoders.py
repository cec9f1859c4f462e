"""The port's encoders, plane / line / grid generators and
``grid_sample_3d`` against the JAX package on the CPU, module by module.

Each module is built by the port from a torch seed, its weights carried to
flax with ``interop.module_to_flax``, and both packages run on the same
numpy inputs: the outputs agree within 1e-5 of their largest value, and
the gradients of sum(out * cot) for a seeded cotangent, with respect to
every parameter (converted back with ``interop.flax_to_state_dict``) or
to the given planes, within 1e-5 of the largest gradient, both plus rtol
1e-5. (A leaf's own largest gradient is no scale: a conv bias before a
per-channel GroupNorm has a gradient that is zero but for the padding's
border terms, rounding noise against a gradient 1e5 times larger.)

Sizes are small: planes of resolution 16, grids of 8^3, generated planes
from 2x2 noise (16x16 planes), 3 frames. The fuse modes and time axes of
the generated encoders are held on given planes, and their decoders one
at a time (Tensorial2D), gradients included, and six at once in the
forward (``planes``): a JAX compile costs ~3 s a decoder. The frame is a
traced argument, so a case's frames share one compile.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_tpu.models import decoder as jdec
from splatfields_tpu.models import encoders as jenc
from splatfields_tpu.ops import grid_sample as jgs
from splatfields_torch.interop import flax_to_state_dict, module_to_flax
from splatfields_torch.models import decoder as pdec
from splatfields_torch.models import encoders as penc
from splatfields_torch.ops.grid_sample import grid_sample_3d

N = 64
FRAMES = 3
GEN = dict(noise_res=2, n_frames=FRAMES, strategy="per_frame")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _pts(dim=3, seed=3, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, (N, dim)).astype(
        np.float32)


def _close(got, want, label, scale=None, tol=1e-5):
    """Within ``tol`` of ``scale`` (default: the largest |want|) plus rtol
    ``tol``."""
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if scale is None:
        scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=label)


@functools.cache
def _jax_grad(jmod, jfn, wrt_planes):
    """Jitted (gradients, output) of sum(jfn(jmod, variables, *args) * cot)
    with respect to the params, or to ``args[0]`` (the planes)."""
    def loss(x, variables, args, cot):
        if wrt_planes:
            out = jfn(jmod, variables, x, *args)
        else:
            out = jfn(jmod, dict(variables, params=x), *args)
        return jnp.sum(out * cot), out
    return jax.jit(jax.grad(loss, has_aux=True))


def _pair(pmod, pfn, jmod, jfn, *args, planes=None, seed=11):
    """``pfn(pmod, *args)`` and ``jfn(jmod, variables, *args)`` (the JAX
    output in the port's layout; ``args`` numpy arrays or ints, traced on
    the JAX side) with the port's weights in both; with ``planes``, both
    functions take the planes first and the gradient is theirs."""
    variables = module_to_flax(pmod)
    t_args = [torch.tensor(a) if isinstance(a, np.ndarray) else a
              for a in args]
    if planes is not None:
        x = torch.tensor(planes, requires_grad=True)
        out = pfn(pmod, x, *t_args)
        names, wrt = ["planes"], [x]
    else:
        out = pfn(pmod, *t_args)
        names, wrt = zip(*pmod.named_parameters())
    cot = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(), wrt,
                                allow_unused=True)
    fn = _jax_grad(jmod, jfn, planes is not None)
    jgrads, jout = fn(variables["params"] if planes is None else planes,
                      variables, args, cot)
    _close(out, jout, "output")
    if planes is not None:
        want = {"planes": np.asarray(jgrads)}
    else:
        want = {k: v.numpy() for k, v in flax_to_state_dict(
            jax.tree.map(np.asarray, jgrads)).items()}
        assert set(want) == set(names)
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for k, g in zip(names, grads):
        _close(torch.zeros(want[k].shape) if g is None else g, want[k],
               f"gradient {k}", scale)
    return out


def _apply(m, v, *args, **kw):
    return m.apply(v, *args, **kw)


def _apply_time(m, v, pts, t):
    return m.apply(v, pts, input_time=t)


def _apply_planes(m, v, planes, pts):
    return m.apply(v, pts, planes=planes)


def _apply_planes_time(m, v, planes, pts, t):
    return m.apply(v, pts, input_time=t, planes=planes)


# --- grid_sample_3d ---------------------------------------------------------

@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_grid_sample_3d(padding):
    rng = np.random.RandomState(0)
    grid = rng.randn(3, 5, 6, 7).astype(np.float32)
    # a third of the points outside [-1, 1] in some coordinate
    coords = rng.uniform(-1.3, 1.3, (200, 3)).astype(np.float32)
    cot = rng.randn(200, 3).astype(np.float32)
    g = torch.tensor(grid, requires_grad=True)
    out = grid_sample_3d(g, torch.tensor(coords), padding_mode=padding)
    (dgrid,) = torch.autograd.grad((out * torch.tensor(cot)).sum(), g)

    def loss(gr):
        o = jgs.grid_sample_3d(gr, coords, padding_mode=padding)
        return jnp.sum(o * cot), o

    jd, jout = jax.grad(loss, has_aux=True)(jnp.asarray(grid))
    _close(out, jout, "output")
    _close(dgrid, jd, "grid gradient")


# --- learned planes and grids -------------------------------------------------

@pytest.mark.parametrize("fuse", ["cat", "add", "mean"])
def test_triplane(fuse):
    pm = penc.TriPlaneEncoder(16, 4, fuse, generator=_gen())
    out = _pair(pm, lambda m, p: m(p), jenc.TriPlaneEncoder(16, 4, fuse),
                _apply, _pts())
    assert out.shape == (N, pm.out_dim) and pm.width == pm.out_dim


@pytest.mark.parametrize("fuse", ["cat", "space_cat"])
def test_hexplane(fuse):
    pm = penc.HexPlaneEncoder(16, 4, fuse, generator=_gen())
    with torch.no_grad():   # time planes start at ones: make them vary
        pm.time_planes.add_(0.3 * torch.randn(pm.time_planes.shape,
                                              generator=_gen(1)))
    out = _pair(pm, lambda m, p, t: m(p, t), jenc.HexPlaneEncoder(16, 4, fuse),
                _apply_time, _pts(), np.full((N, 1), 0.6, np.float32))
    assert out.shape == (N, pm.out_dim)


def test_hexplane_time_planes_start_at_one_and_need_time():
    pm = penc.HexPlaneEncoder(16, 4, generator=_gen())
    assert bool((pm.time_planes == 1).all())
    with pytest.raises(ValueError, match="space-time"):
        pm(torch.zeros(5, 3))
    # 4-D points need no input_time
    assert pm(torch.zeros(5, 4)).shape == (5, 24)


def test_grid():
    pm = penc.GridEncoder(8, 24, generator=_gen())
    out = _pair(pm, lambda m, p: m(p), jenc.GridEncoder(8, 24), _apply,
                _pts(lo=-1.1, hi=1.1))
    assert out.shape == (N, 24)


def test_var_grid():
    """VarGridEncoder, and with it Tensorial3D and Conv3DStack (8 -> 128
    -> ... -> 16 channels, 2^3 -> 16^3)."""
    pm = penc.VarGridEncoder(noise_res=2, generator=_gen())
    out = _pair(pm, lambda m, p: m(p), jenc.VarGridEncoder(noise_res=2),
                _apply, _pts())
    assert out.shape == (N, 16)
    assert pm.net.noise.shape == (1, 8, 2, 2, 2)
    assert pm.net().shape == (1, 16, 16, 16, 16)


# --- generated planes ----------------------------------------------------------

def _planes(n, seed=5):
    return np.random.RandomState(seed).randn(n, 4, 16, 16).astype(np.float32)


@pytest.mark.parametrize("n_planes,fuse,dim", [
    (6, "space_cat", 4), (4, "add", 4),
    # 3-D points: the time axes read z, as JAX clamps index 3
    (6, "cat", 3)])
def test_var_triplane_fuse_and_time_axes(n_planes, fuse, dim):
    kw = dict(out_ch=4, noise_res=1, fuse_mode=fuse, n_planes=n_planes)
    pm = penc.VarTriPlaneEncoder(**kw, generator=_gen())
    out = _pair(pm, lambda m, pl, p: m(p, planes=pl),
                jenc.VarTriPlaneEncoder(**kw), _apply_planes, _pts(dim),
                planes=_planes(n_planes))
    assert out.shape == (N, pm.width)
    assert pm.out_dim == (n_planes * 4 if fuse == "cat" else 4)


def test_var_hexplane_on_planes():
    kw = dict(out_ch=4, noise_res=1)
    pm = penc.VarHexPlaneEncoder(**kw, generator=_gen())
    out = _pair(pm, lambda m, pl, p, t: m(p, t, planes=pl),
                jenc.VarHexPlaneEncoder(**kw), _apply_planes_time, _pts(),
                np.full((N, 1), 0.25, np.float32), planes=_planes(6))
    assert out.shape == (N, pm.out_dim) == (N, 24)
    with pytest.raises(ValueError, match="space-time"):
        pm(torch.zeros(5, 3), planes=torch.tensor(_planes(6)))


def test_planes_at_a_frame():
    """VarHexPlane's six ``planes(frame_id)`` (the generators both
    generated encoders share) against JAX, different at another frame,
    and the encoder on them equal to the encoder generating its own. The
    per-frame decoders' gradients are test_tensorial2d_per_frame's."""
    pm = penc.VarHexPlaneEncoder(**GEN, generator=_gen())
    want = jax.jit(lambda v, f: jenc.VarHexPlaneEncoder(**GEN).apply(
        v, method=lambda mod: mod.planes(f)))(module_to_flax(pm), 1)
    got = pm.planes(1)
    _close(got, want, "planes")
    assert not torch.equal(got, pm.planes(2))
    pts, t = torch.tensor(_pts()), torch.full((N, 1), 0.5)
    assert torch.equal(pm(pts, t, 1, planes=got), pm(pts, t, 1))


# --- decoders and generators -----------------------------------------------------

def _time_conv(m, v, x, frame):
    return jnp.transpose(m.apply(v, jnp.transpose(x, (0, 2, 3, 1)), frame),
                         (0, 3, 1, 2))


@pytest.mark.parametrize("frame", [0, 2])
def test_time_conv_per_frame(frame):
    pm = pdec.TimeConv(6, 5, 3, n_frames=FRAMES, strategy="per_frame",
                       generator=_gen())
    assert pm.frame_weights.shape == (FRAMES, 5, 6, 3, 3)
    x = np.random.RandomState(4).randn(1, 6, 7, 7).astype(np.float32)
    _pair(pm, lambda m, x_, f: m(x_, f),
          jdec.TimeConv(5, 3, FRAMES, "per_frame"), _time_conv, x, frame)


def test_time_conv_frame_weights_init():
    """Normal at 0.01 x the kaiming std, zeros where the kernel starts at
    zero; no deltas without the strategy or with one frame."""
    pm = pdec.TimeConv(32, 64, 3, n_frames=50, strategy="per_frame",
                       generator=_gen())
    std = 0.01 * np.sqrt(2.0 / (3 * 3 * 64))
    assert abs(float(pm.frame_weights.detach().std()) / std - 1) < 0.02
    zero = pdec.TimeConv(8, 8, 3, zero_init=True, n_frames=4,
                         strategy="per_frame", generator=_gen())
    assert float(zero.frame_weights.detach().abs().max()) == 0
    for kw in (dict(n_frames=4), dict(n_frames=1, strategy="per_frame")):
        assert pdec.TimeConv(8, 8, 3, generator=_gen(), **kw
                             ).frame_weights is None


def _tensorial2d(m, v, frame):
    return jnp.transpose(m.apply(v, frame), (0, 3, 1, 2))


@pytest.mark.parametrize("frame", [1, 2])
def test_tensorial2d_per_frame(frame):
    pm = pdec.Tensorial2D(**GEN, generator=_gen())
    _pair(pm, lambda m, f: m(f), jdec.Tensorial2D(**GEN), _tensorial2d, frame)


def _nchw(m, v, z):
    return jnp.transpose(m.apply(v, jnp.transpose(z, (0, 2, 3, 1)), 1),
                         (0, 3, 1, 2))


def test_vae_decoder():
    """VAEDecoder (one block, so no upsampling) ignores the frame it is
    given."""
    pm = pdec.VAEDecoder(block_out_channels=(32,), generator=_gen())
    z = np.random.RandomState(5).randn(1, 8, 3, 3).astype(np.float32)
    out = _pair(pm, lambda m, z_: m(z_, 1),
                jdec.VAEDecoder(block_out_channels=(32,)), _nchw, z)
    assert out.shape == (1, 16, 3, 3)


def _ncl(m, v):
    return jnp.transpose(m.apply(v), (0, 2, 1))


def test_tensorial1d():
    pm = pdec.Tensorial1D(noise_res=4, generator=_gen())
    out = _pair(pm, lambda m: m(), jdec.Tensorial1D(noise_res=4), _ncl)
    assert out.shape == (1, 16, 64)


def _ncl_in(m, v, x):
    return jnp.transpose(m.apply(v, jnp.transpose(x, (0, 2, 1))), (0, 2, 1))


def test_conv1d_stack_resize():
    """Conv1DStack at uneven resizes (5 -> 7 -> 3 -> 11): the spelt-out
    linear interpolation, ends clipped."""
    kw = dict(in_channels=4, out_channels=3, upsample_resolutions=(7, 3, 11),
              block_channels=(16, 16, 32, 16))
    pm = pdec.Conv1DStack(**kw, generator=_gen())
    x = np.random.RandomState(6).randn(2, 4, 5).astype(np.float32)
    out = _pair(pm, lambda m, x_: m(x_), jdec.Conv1DStack(**kw), _ncl_in, x)
    assert out.shape == (2, 3, 11)


def test_kaiming3d_init():
    """The 3-D stack's kernels: normal, std sqrt(2 / (27 out))."""
    pm = pdec.Conv3DStack(generator=_gen())
    k = pm.conv_1_kernel
    assert k.shape == (128, 128, 3, 3, 3)
    assert abs(float(k.detach().std()) / np.sqrt(2.0 / (27 * 128)) - 1) < 0.02
