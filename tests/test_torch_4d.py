"""The 4-D field against the JAX package on the CPU: a small 4-D
``SplatFields`` (``chip_smoke.SMALL_4D``: VarTriPlane at noise 4x4,
4 frames, ResField rank 2 on every head, the offset flow head, 16-wide
heads), its outputs at two time steps; the same net without its encoder
(``STEP_NET``: the time embedding is then its only feature), its outputs
and gradients at two time steps and one and three training steps at
``num_views`` 2 against ``splatfields_tpu.train_lib.make_train_step``;
and a ``deform.msgpack`` written by the JAX package's
``DeformModel.save_weights`` read by the port.

The weights are drawn by the port and carried to JAX with
``interop.module_to_flax``: flax's own init of the plane decoder takes
20-30 s on the CPU. The msgpack test carries them the other way. The
gradients and steps leave the encoder out because the JAX compile of the
plane decoder's backward costs ~10 s a program; the decoder's gradient
does not depend on the frame (strategy 'none') and is held in field mode
by tests/test_torch_train.py, and the 4-D VarTriPlane step on the card
against the CPU by ``chip_smoke.py`` phase 24.

The steps are test_torch_train's harness with two views a step and a
time step per step (fids 1/3, 2/3, 1: frames 1, 2, 3): 2,000 splats
from ``create_from_pcd`` (numpy seed 0) at 64x64, below the 0.99 alpha
clamp (asserted), non-zero Adam states (count 10) on both trees. The
losses agree within 1e-6 relative; parameters, moments, screen-space
gradients and statistics as test_torch_train holds them (1e-5 of a
leaf's largest value for the moments, rtol 1e-6 plus 1e-4 of the
learning rate per step for the parameters). The net's outputs agree
within rtol 1e-6 plus 1e-6 of the largest output (1e-5 for the
rotations: normalising a vector scales its rounding by the inverse of its
length, ~50 for the 16-wide rotation head without features), its
gradients within rtol 1e-6 plus 1e-6 of the largest gradient (1e-5 and
1e-5 for the rotation head's parameters, for the same reason).
"""
import functools
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from splatfields_tpu import config as jax_config
from splatfields_tpu import train_lib as jax_train_lib
from splatfields_tpu.models import splats as jax_splats
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_tpu.models.splatfields import SplatFields as JaxSplatFields
from splatfields_torch import config, train_lib
from splatfields_torch.interop import (
    adam_state_from_numpy,
    flax_to_state_dict,
    module_to_flax,
    splat_params_from_numpy,
)
from splatfields_torch.models import splats
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.models.splatfields import SplatFields, frame_id_of
from tests.test_torch_train import (
    FIELD_LR,
    SPLAT_LRS,
    _moments,
    _np,
    check_adam_states,
    check_loss_and_aux,
    check_parameters,
    check_screen_grad_radii_and_stats,
)

RES, N, VIEWS = 64, 2000, 2
FIDS = (1 / 3, 2 / 3, 1.0)
STEPS = (1, 3)
N_FRAMES = chip_smoke.SMALL_4D["n_frames"]
STEP_NET = dict(chip_smoke.SMALL_4D, encoder_type="", encoder_args={})
OUT_KEYS = ("scales", "opacity", "rotations", "rgb", "flow", "means3D")
NQ = 300


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them, slowing these runs by an order of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_net(kw):
    kw = dict(kw)
    kw["encoder_args"] = tuple(sorted(kw["encoder_args"].items()))
    return JaxSplatFields(**kw)


@pytest.fixture(scope="module")
def nets():
    """(JAX net, the numpy variables, the port's net holding them)."""
    pnet = chip_smoke.small_4d_net("cpu")
    return _jax_net(chip_smoke.SMALL_4D), module_to_flax(pnet), pnet


@pytest.fixture(scope="module")
def step_nets():
    """``nets`` for ``STEP_NET``."""
    pnet = SplatFields(**STEP_NET, generator=torch.Generator().manual_seed(0))
    return _jax_net(STEP_NET), module_to_flax(pnet), pnet


@functools.partial(jax.jit, static_argnums=0)
def _jax_fwd(jnet, variables, xyz, t):
    """Outputs; t traced, so one compile serves every time step."""
    return jnet.apply(variables, xyz, t)


@functools.partial(jax.jit, static_argnums=0)
def _jax_fwd_grads(jnet, variables, xyz, t, cots):
    """(gradients of sum(out * cot), outputs); t traced, so one compile
    serves every time step."""
    def loss(p):
        out = jnet.apply(dict(variables, params=p), xyz, t)
        return sum(jnp.sum(out[k] * cots[k]) for k in OUT_KEYS), out
    return jax.grad(loss, has_aux=True)(variables["params"])


def _queries(fid, seed=7):
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-0.9, 0.9, (NQ, 3)).astype(np.float32)
    cots = {k: rng.randn(NQ, {"opacity": 1, "rotations": 4}.get(k, 3))
            .astype(np.float32) for k in OUT_KEYS}
    return xyz, np.full((NQ, 1), np.float32(fid), np.float32), cots


def _check_outputs(got, want):
    scale = max(np.abs(np.asarray(want[k])).max() for k in OUT_KEYS)
    for k in OUT_KEYS:
        # normalize(x) scales x's rounding by 1 / |x|: STEP_NET's rotation
        # head ends in vectors ~0.02 long
        atol = (1e-5 if k == "rotations" else 1e-6) * scale
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-6,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("fid", [1 / 3, 1.0])
def test_vartriplane_outputs(nets, fid):
    jnet, variables, pnet = nets
    xyz, t, _ = _queries(fid)
    got = pnet(torch.tensor(xyz), torch.tensor(t),
               frame_id=frame_id_of(fid, N_FRAMES))
    _check_outputs(got, _jax_fwd(jnet, variables, xyz, t))


@pytest.mark.parametrize("fid", [1 / 3, 1.0])
def test_outputs_and_gradients(step_nets, fid):
    jnet, variables, pnet = step_nets
    xyz, t, cots = _queries(fid)
    g, want_out = _jax_fwd_grads(jnet, variables, xyz, t, cots)
    fid_host = frame_id_of(fid, N_FRAMES)
    assert fid_host == int(jnp.round(jnp.float32(fid) * (N_FRAMES - 1)))
    got = pnet(torch.tensor(xyz), torch.tensor(t), frame_id=fid_host)
    _check_outputs(got, want_out)
    total = sum((got[k] * torch.tensor(cots[k])).sum() for k in OUT_KEYS)
    names, leaves = zip(*pnet.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, leaves,
                                                allow_unused=True)))
    want = {k: v.numpy() for k, v in flax_to_state_dict(_np(g)).items()}
    assert set(want) == set(names)
    scale = max(np.abs(v).max() for v in want.values())
    frame = frame_id_of(fid, N_FRAMES)
    for k, w in want.items():
        gk = grads[k]
        gk = np.zeros_like(w) if gk is None else gk.numpy()
        # the rotation head's gradients pass normalize's 1 / |x| too
        tol = 1e-5 if k.startswith("mlp_rotation.") else 1e-6
        np.testing.assert_allclose(gk, w, rtol=tol, atol=tol * scale,
                                   err_msg=k)
        if k.endswith("weights_t"):
            # only the frame's coefficient row gets a gradient
            assert np.abs(np.delete(gk, frame, 0)).max() == 0, k
            assert np.abs(gk[frame]).max() > 0, k


def _batches(rng):
    cams = chip_smoke.make_views(VIEWS * len(FIDS) + 1, RES)[1:]
    out = []
    for i, fid in enumerate(FIDS):
        views = cams[VIEWS * i: VIEWS * (i + 1)]
        out.append({
            "viewmatrix": np.stack([c.world_view_transform for c in views]),
            "projmatrix": np.stack([c.full_proj_transform for c in views]),
            "campos": np.stack([c.camera_center for c in views]),
            "tanfovx": np.array([c.tanfovx for c in views], np.float32),
            "tanfovy": np.array([c.tanfovy for c in views], np.float32),
            "fid": np.float32(fid),
            "image": rng.rand(VIEWS, 3, RES, RES).astype(np.float32),
            "mask": np.zeros((VIEWS, 1, 1, 1), np.float32),
            "depth": np.zeros((VIEWS, 1, 1), np.float32),
            "bg": np.ones(3, np.float32),
        })
    return out


@pytest.fixture(scope="module")
def runs(step_nets):
    """Both packages through three 4-D steps of ``STEP_NET``; snapshots
    after 1 and 3."""
    jnet, variables, pnet = step_nets
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (N, 3)).astype(np.float32)
    cols = rng.rand(N, 3).astype(np.float32)
    j_params, j_stats = jax_splats.create_from_pcd(pts, cols, 0, capacity=N)
    mu, nu = _moments(_np(j_params), 1)
    j_sopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    mu, nu = _moments(variables["params"], 2)
    j_fopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    j_vars = variables
    opt_kw = dict(lambda_mask=0.0, lambda_norm=0.01)
    j_step = jax_train_lib.make_train_step(
        jnet, jax_config.OptimizationConfig(**opt_kw),
        jax_config.PipelineConfig(tile_cap=256, k_chunk=64), RES, RES, VIEWS,
        True, N_FRAMES, 0)

    p_params = splat_params_from_numpy(_np(j_params), device="cpu")
    p_stats = splats.SplatStats(*[torch.tensor(np.asarray(x)) for x in (
        j_stats.valid, j_stats.max_radii2d, j_stats.xyz_gradient_accum,
        j_stats.denom)])
    p_sopt = adam_state_from_numpy(_np(j_sopt), device="cpu")
    p_fopt = adam_state_from_numpy(_np(j_fopt), device="cpu")
    p_fparams = {k: p.detach().clone() for k, p in pnet.named_parameters()}
    p_step = train_lib.make_train_step(
        pnet, config.OptimizationConfig(**opt_kw),
        config.PipelineConfig(tile_cap=256, k_chunk=64), RES, RES, VIEWS,
        True, N_FRAMES, 0)
    j_lrs = jax_splats.splat_lr_tree(*SPLAT_LRS)
    p_lrs = splats.splat_lr_tree(*SPLAT_LRS)

    snaps = {}
    for step, b in enumerate(_batches(np.random.RandomState(1)), start=1):
        with torch.no_grad():
            attrs = train_lib.field_attributes(
                pnet, p_params.xyz, splats.get_scaling(p_params),
                p_stats.valid, float(b["fid"]), N_FRAMES, params=p_fparams)
        assert float(attrs["opacity"].max()) < 0.99
        assert "flow" in attrs
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        j_params, j_stats, j_sopt, j_fp, j_fopt, j_out, _ = j_step(
            j_params, j_stats, j_sopt, j_vars, j_fopt, jb, j_lrs,
            jnp.asarray(FIELD_LR, jnp.float32), jax.random.PRNGKey(0))
        j_vars = dict(j_vars, params=j_fp)
        pb = {k: torch.as_tensor(v) for k, v in b.items()}
        pb["fid"] = float(b["fid"])
        p_params, p_stats, p_sopt, p_fparams, p_fopt, p_out = p_step(
            p_params, p_stats, p_sopt, p_fparams, p_fopt, pb, p_lrs,
            FIELD_LR)
        if step in STEPS:
            snaps[step] = dict(
                jax=dict(params=_np(j_params), stats=_np(j_stats),
                         sopt=_np(j_sopt), fparams=_np(j_fp),
                         fopt=_np(j_fopt), out=_np(j_out)),
                port=dict(params=p_params, stats=p_stats, sopt=p_sopt,
                          fparams=p_fparams, fopt=p_fopt, out=p_out))
    return snaps


@pytest.mark.parametrize("after", STEPS)
def test_step_loss(runs, after):
    j, p = runs[after]["jax"]["out"], runs[after]["port"]["out"]
    np.testing.assert_allclose(float(p.loss), float(j.loss), rtol=1e-6)
    check_loss_and_aux(runs, after)


@pytest.mark.parametrize("after", STEPS)
def test_step_screen_grad_radii_and_stats(runs, after):
    check_screen_grad_radii_and_stats(runs, after)


@pytest.mark.parametrize("after", STEPS)
@pytest.mark.parametrize("tree", ["params", "fparams"])
def test_step_parameters(runs, after, tree):
    check_parameters("field", runs, after, tree)


@pytest.mark.parametrize("after", STEPS)
@pytest.mark.parametrize("tree", ["sopt_mu", "sopt_nu", "fopt_mu", "fopt_nu"])
def test_step_adam_states(runs, after, tree):
    check_adam_states(runs, after, tree)


class _Narrow(DeformModel):
    """The port's DeformModel around a given net (its IO methods only)."""

    def __init__(self, net):
        self.net = net


def test_jax_msgpack_read_by_the_port(nets, tmp_path):
    jnet, variables, pnet = nets
    # the JAX package's writer, on the small net's variables
    JaxDeformModel.save_weights(types.SimpleNamespace(variables=variables),
                                str(tmp_path), 7)
    other = chip_smoke.small_4d_net("cpu", seed=5)
    loaded = _Narrow(other)
    assert loaded.load_weights(str(tmp_path)) == 7
    for k, v in pnet.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    xyz, t, _ = _queries(2 / 3, seed=8)
    want = _jax_fwd(jnet, variables, xyz, t)
    got = other(torch.tensor(xyz), torch.tensor(t),
                frame_id=frame_id_of(2 / 3, N_FRAMES))
    _check_outputs(got, want)
    # and the port writes what it read
    loaded.save_weights(str(tmp_path / "again"), 7)
    again = _Narrow(chip_smoke.small_4d_net("cpu", seed=6))
    again.load_weights(str(tmp_path / "again"), 7)
    for k, v in pnet.state_dict().items():
        assert torch.equal(again.net.state_dict()[k], v), k


def test_port_net_needs_its_frame():
    net = chip_smoke.small_4d_net("cpu")
    with pytest.raises(ValueError, match="frame_id"):
        net(torch.zeros(4, 3), torch.zeros(4, 1))
    assert isinstance(net, SplatFields)
