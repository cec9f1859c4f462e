"""The train CLI's field options through the port's ``SplatFields`` and
training step, against the JAX package on the CPU.

- ``use_view_dep_rgb`` (with a TriPlane encoder) and
  ``geo_model_disable_pts`` (with a Grid encoder) through ``SplatFields``:
  outputs and gradients of every parameter; ``rgb_from_viewdir``;
- the fused heads (``fused_pallas="on"``, f32 on the CPU) equal to the
  unfused chain on the plans the new encoders and the view-dependent head
  give (feature width 24; an ``mlp_rgb`` of 128 outputs);
- one static field step with ``n_splats`` (a subset of 150 of 256
  splats), the view-dependent head and the TriPlane encoder, against
  ``splatfields_tpu.train_lib.make_train_step``. Both packages get the
  same subset: ``_subsample_idx`` is replaced in both for the step
  (monkeypatch);
- one 4-D step of the port with ``VarHexPlaneEncoder`` and
  ``layer_strategy per_frame`` (3 frames, 2 views, Adam from zero
  moments): finite, and of every conv's per-frame deltas only the step's
  frame moves. (The JAX step of six plane decoders takes ~60 s to trace
  and compile on the CPU; the encoder's planes at a frame, its decoders'
  per-frame gradients and its sampling are held against JAX in
  tests/test_torch_encoders.py, and the 4-D VarHexPlane step on the card
  against the CPU by ``chip_smoke.py`` phase 31);
- a ``deform.msgpack`` the JAX package writes for TriPlane, Grid and a
  per-frame VarHexPlane net, read by the port; the port's train state
  round trip of the new leaves; the flags through the CLI's parser and
  ``cfg_args``; HexPlane on a static field raises, as the JAX assert does.

The weights are the port's, carried to flax with ``interop.
module_to_flax``. Heads are 16 wide. Tolerances: outputs within 1e-5 of
their largest value and gradients within 1e-5 of the largest gradient
(tests/test_torch_encoders.py), plus rtol 1e-5; the steps as
tests/test_torch_train.py holds them.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_tpu import config as jax_config
from splatfields_tpu import train_lib as jax_train_lib
from splatfields_tpu.models import splats as jax_splats
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_tpu.models.splatfields import SplatFields as JaxSplatFields
from splatfields_torch import checkpointing, config, train, train_lib
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

HEADS = dict(deform_w=16, deform_d=3, deform_skips=(1,), rgb_w=16, rgb_d=3,
             rgb_skips=(1,), scale_w=16, scale_d=2, scale_skips=(1,),
             opacity_w=16, opacity_d=2, opacity_skips=(1,), rotation_w=16,
             rotation_d=2, flow_w=16, flow_d=3, flow_skips=(1,))
TRI = dict(encoder_type="TriPlaneEncoder",
           encoder_args={"resolution": 16, "channels": 4})
GRID = dict(encoder_type="GridEncoder", encoder_args={"resolution": 8})
NETS = {
    "view_dep_rgb": dict(TRI, use_view_dep_rgb=True, **HEADS),
    "geo_model_disable_pts": dict(GRID, geo_model_disable_pts=True,
                                  **HEADS),
}
STEP_NET = dict(TRI, use_view_dep_rgb=True, **HEADS)
HEX_NET = dict(encoder_type="VarHexPlaneEncoder",
               encoder_args={"noise_res": 2}, layer_strategy="per_frame",
               n_frames=3, composition_rank=0, flow_model="offset", **HEADS)
RES, N, N_SPLATS = 64, 256, 150
NQ = 200


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the CPU's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_net(kw, seed=0):
    return SplatFields(**kw, generator=torch.Generator().manual_seed(seed))


def _jax_net(kw):
    kw = dict(kw)
    kw["encoder_args"] = tuple(sorted(kw["encoder_args"].items()))
    return JaxSplatFields(**kw)


def _close(got, want, label, scale=None, tol=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if scale is None:
        scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=label)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_grads(jnet, keys, variables, xyz, cots):
    def loss(p):
        out = jnet.apply(dict(variables, params=p), xyz)
        return sum(jnp.sum(out[k] * cots[k]) for k in keys), out
    return jax.grad(loss, has_aux=True)(variables["params"])


@pytest.mark.parametrize("name", list(NETS))
def test_outputs_and_gradients(name):
    kw = NETS[name]
    pnet, jnet = _port_net(kw), _jax_net(kw)
    variables = module_to_flax(pnet)
    rng = np.random.RandomState(1)
    xyz = rng.uniform(-0.9, 0.9, (NQ, 3)).astype(np.float32)
    out = pnet(torch.tensor(xyz))
    keys = tuple(k for k in ("scales", "opacity", "rotations", "rgb",
                             "rgb_feat", "means3D") if k in out)
    assert ("rgb_feat" in keys) == (name == "view_dep_rgb")
    cots = {k: rng.randn(*out[k].shape).astype(np.float32) for k in keys}
    g, want = _jax_grads(jnet, keys, variables, xyz, cots)
    for k in keys:
        _close(out[k], want[k], k)
    names, leaves = zip(*pnet.named_parameters())
    total = sum((out[k] * torch.tensor(cots[k])).sum() for k in keys)
    grads = dict(zip(names, torch.autograd.grad(total, leaves,
                                                allow_unused=True)))
    want_g = {k: v.numpy() for k, v in flax_to_state_dict(_np(g)).items()}
    # rgb_viewdep is called only through rgb_from_viewdir
    assert set(want_g) == set(names)
    scale = max(np.abs(v).max() for v in want_g.values())
    for k, w in want_g.items():
        got = grads[k]
        _close(torch.zeros(w.shape) if got is None else got, w, k, scale)
    if name == "geo_model_disable_pts":
        # the geometry heads read the features alone, unembedded
        assert pnet.mlp_scale.multires == 0
        assert pnet.mlp_scale.net_0.weight.shape[1] == pnet.feat_dim


def test_rgb_from_viewdir():
    kw = NETS["view_dep_rgb"]
    pnet, jnet = _port_net(kw), _jax_net(kw)
    rng = np.random.RandomState(2)
    feat = rng.randn(NQ, 16).astype(np.float32)
    dirs = rng.randn(NQ, 3).astype(np.float32)
    want = jnet.apply(module_to_flax(pnet), feat, dirs,
                      method=JaxSplatFields.rgb_from_viewdir)
    got = pnet.rgb_from_viewdir(torch.tensor(feat), torch.tensor(dirs))
    _close(got, want, "rgb")
    params = {k: v * 2 for k, v in pnet.named_parameters()}
    with torch.no_grad():
        pnet.rgb_viewdep.weight.mul_(2)
        pnet.rgb_viewdep.bias.mul_(2)
    assert torch.equal(pnet.rgb_from_viewdir(torch.tensor(feat),
                                             torch.tensor(dirs)),
                       pnet.rgb_from_viewdir(torch.tensor(feat),
                                             torch.tensor(dirs), params))


TRI16 = dict(encoder_type="TriPlaneEncoder", encoder_args={"resolution": 16})


@pytest.mark.parametrize("kw", [
    dict(GRID), dict(TRI16), dict(TRI16, use_view_dep_rgb=True)],
    ids=["grid_F24", "triplane_F48", "view_dep_rgb128"])
def test_fused_heads_match_the_chain(kw):
    """The published head widths on the new plans (f32 on the CPU)."""
    net = _port_net(kw)
    xyz = torch.tensor(np.random.RandomState(3).uniform(
        -0.9, 0.9, (NQ, 3)).astype(np.float32))
    net.fused_pallas = "off"
    want = net(xyz)
    net.fused_pallas = "on"
    got = net(xyz)
    assert set(got) == set(want)
    for k, w in want.items():
        if w is not None:
            _close(got[k], w.detach().numpy(), k)
    rgb_out = net.mlp_rgb.net_7.weight.shape[0]
    assert rgb_out == (128 if kw.get("use_view_dep_rgb") else 3)


def test_hexplane_needs_time():
    net = _port_net(dict(encoder_type="HexPlaneEncoder",
                         encoder_args={"resolution": 8}, **HEADS))
    with pytest.raises(ValueError, match="space-time"):
        net(torch.zeros(4, 3))


# --- steps ----------------------------------------------------------------------

def _scene(n):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    return jax_splats.create_from_pcd(pts, cols, 0, capacity=n)


def _batch(cams, fid, rng):
    return {
        "viewmatrix": np.stack([c.world_view_transform for c in cams]),
        "projmatrix": np.stack([c.full_proj_transform for c in cams]),
        "campos": np.stack([c.camera_center for c in cams]),
        "tanfovx": np.array([c.tanfovx for c in cams], np.float32),
        "tanfovy": np.array([c.tanfovy for c in cams], np.float32),
        "fid": np.float32(fid),
        "image": rng.rand(len(cams), 3, RES, RES).astype(np.float32),
        "mask": np.zeros((len(cams), 1, 1, 1), np.float32),
        "depth": np.zeros((len(cams), 1, 1), np.float32),
        "bg": np.ones(3, np.float32)}


def _one_step(kw, views, fid, n_frames, n_splats=-1):
    """Both packages through one step of the net ``kw`` from the same
    splats, weights and non-zero Adam states -> test_torch_train's
    snapshot dict."""
    pnet = _port_net(kw)
    variables = module_to_flax(pnet)
    j_params, j_stats = _scene(N)
    mu, nu = _moments(_np(j_params), 1)
    j_sopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    mu, nu = _moments(variables["params"], 2)
    j_fopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    opt_kw = dict(lambda_mask=0.0, lambda_norm=0.01)
    j_step = jax_train_lib.make_train_step(
        _jax_net(kw), jax_config.OptimizationConfig(**opt_kw),
        jax_config.PipelineConfig(tile_cap=256, k_chunk=64), RES, RES,
        views, True, n_frames, 0, n_splats=n_splats)
    p_params = splat_params_from_numpy(_np(j_params), device="cpu")
    p_stats = splats.SplatStats(*[torch.tensor(np.asarray(x)) for x in (
        j_stats.valid, j_stats.max_radii2d, j_stats.xyz_gradient_accum,
        j_stats.denom)])
    p_sopt = adam_state_from_numpy(_np(j_sopt), device="cpu")
    p_fopt = adam_state_from_numpy(_np(j_fopt), device="cpu")
    p_fparams = {k: p.detach().clone() for k, p in pnet.named_parameters()}
    p_step = train_lib.make_train_step(
        pnet, config.OptimizationConfig(**opt_kw),
        config.PipelineConfig(tile_cap=256, k_chunk=64), RES, RES, views,
        True, n_frames, 0, n_splats=n_splats, generator=torch.Generator())
    cams = chip_smoke.make_views(views + 1, RES)[1:]
    b = _batch(cams, fid, np.random.RandomState(1))
    with torch.no_grad():
        attrs = train_lib.field_attributes(
            pnet, p_params.xyz, splats.get_scaling(p_params), p_stats.valid,
            float(b["fid"]), n_frames, params=p_fparams)
    assert float(attrs["opacity"].max()) < 0.99
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    j_out = j_step(j_params, j_stats, j_sopt, variables, j_fopt, jb,
                   jax_splats.splat_lr_tree(*SPLAT_LRS),
                   jnp.asarray(FIELD_LR, jnp.float32), jax.random.PRNGKey(0))
    pb = {k: torch.as_tensor(v) for k, v in b.items()}
    pb["fid"] = float(b["fid"])
    p_out = p_step(p_params, p_stats, p_sopt, p_fparams, p_fopt, pb,
                   splats.splat_lr_tree(*SPLAT_LRS), FIELD_LR)
    names = ("params", "stats", "sopt", "fparams", "fopt", "out")
    return {1: dict(jax={k: _np(v) for k, v in zip(names, j_out)},
                    port=dict(zip(names, p_out)))}


SUBSET = np.random.RandomState(4).permutation(N)[:N_SPLATS]


@pytest.fixture(scope="module")
def static_step():
    """One static step of ``STEP_NET`` (TriPlane, view-dependent colour)
    with ``n_splats``: the JAX and the port's subsample both give
    ``SUBSET``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_train_lib, "_subsample_idx",
                   lambda rng, valid, n: jnp.asarray(SUBSET[:n]))
        mp.setattr(train_lib, "_subsample_idx",
                   lambda gen, valid, n: torch.tensor(SUBSET[:n]))
        return _one_step(STEP_NET, 1, 0.0, 0, n_splats=N_SPLATS)


def test_step_loss_screen_grad_and_stats(static_step):
    check_loss_and_aux(static_step, 1)
    check_screen_grad_radii_and_stats(static_step, 1)
    # the subset's rows only
    out = static_step[1]["port"]["out"]
    assert out.radii.shape == (N_SPLATS,)
    denom = static_step[1]["port"]["stats"].denom
    rest = np.setdiff1d(np.arange(N), SUBSET)
    assert float(denom[rest].abs().max()) == 0
    assert float(denom[SUBSET].max()) == 1


@pytest.mark.parametrize("tree", ["params", "fparams"])
def test_step_parameters(static_step, tree):
    check_parameters("field", static_step, 1, tree)


@pytest.mark.parametrize("tree", ["sopt_mu", "sopt_nu", "fopt_mu", "fopt_nu"])
def test_step_adam_states(static_step, tree):
    check_adam_states(static_step, 1, tree)


def test_hex_step_moves_only_its_frame():
    """One 4-D step of ``HEX_NET`` at fid 1/2 (frame 1), 2 views, from
    zero Adam moments: a row without gradient stays put, so of every
    conv's per-frame deltas only row 1 moves (in the convs the gradient
    reaches: not in a conv1 before its zero-initialised conv2)."""
    pnet = _port_net(HEX_NET)
    n_frames = HEX_NET["n_frames"]
    p, st = splats.create_from_pcd(*[a.astype(np.float32) for a in (
        np.random.RandomState(0).uniform(-0.9, 0.9, (N, 3)),
        np.random.RandomState(1).rand(N, 3))], 0, device="cpu")
    fp = {k: v.detach().clone() for k, v in pnet.named_parameters()}
    step = train_lib.make_train_step(
        pnet, config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01),
        config.PipelineConfig(tile_cap=256, k_chunk=64), RES, RES, 2, True,
        n_frames, 0)
    b = _batch(chip_smoke.make_views(3, RES)[1:], 0.5,
               np.random.RandomState(1))
    pb = {k: torch.as_tensor(v) for k, v in b.items()}
    pb["fid"] = 0.5
    _, _, _, new_fp, _, out = step(p, st, splats.adam_init(p), fp,
                                   splats.adam_init(fp), pb,
                                   splats.splat_lr_tree(*SPLAT_LRS), FIELD_LR)
    assert bool(torch.isfinite(out.loss))
    frame = frame_id_of(0.5, n_frames)
    keys = [k for k in fp if k.endswith("frame_weights")]
    assert sum(k.endswith("conv_in.weight") for k in fp) == 6
    assert len(keys) == 6 * 25
    moved = 0
    for k in keys:
        rows = (new_fp[k] != fp[k]).flatten(1).any(dim=1)
        assert not bool(rows[[f for f in range(n_frames) if f != frame]]
                        .any()), k
        moved += int(rows[frame])
    assert moved >= len(keys) // 2


def test_subsample_idx_takes_valid_rows():
    valid = torch.zeros(1000, dtype=torch.bool)
    valid[::3] = True
    idx = train_lib._subsample_idx(torch.Generator().manual_seed(0), valid,
                                   300)
    assert bool(valid[idx].all()) and len(set(idx.tolist())) == 300


# --- weights, train state and flags ------------------------------------------

def _same_state(got, want):
    got, want = got.state_dict(), want.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


class _Narrow(DeformModel):
    """The port's DeformModel around a given net (its IO methods only)."""

    def __init__(self, net):
        self.net = net


@pytest.mark.parametrize("kw", [TRI, GRID, HEX_NET],
                         ids=["triplane", "grid", "varhex_per_frame"])
def test_jax_msgpack_read_by_the_port(kw, tmp_path):
    pnet = _port_net(kw)
    JaxDeformModel.save_weights(
        types.SimpleNamespace(variables=module_to_flax(pnet)),
        str(tmp_path), 3)
    other = _Narrow(_port_net(kw, seed=5))
    assert other.load_weights(str(tmp_path)) == 3
    _same_state(other.net, pnet)
    other.save_weights(str(tmp_path / "again"), 3)
    again = _Narrow(_port_net(kw, seed=6))
    again.load_weights(str(tmp_path / "again"), 3)
    _same_state(again.net, pnet)


def test_train_state_round_trip(tmp_path):
    """The per-frame deltas, noise buffers and Adam moments of a VarHex
    net through ``save_train_state`` / ``load_train_state``."""
    pnet = _port_net(HEX_NET)
    fp = {k: v.detach() for k, v in pnet.named_parameters()}
    fopt = splats.AdamState(count=3, mu={k: v + 1 for k, v in fp.items()},
                            nu={k: v * 2 for k, v in fp.items()})
    p, st = splats.create_from_pcd(np.zeros((4, 3), np.float32),
                                   np.zeros((4, 3), np.float32), 0,
                                   device="cpu")
    checkpointing.save_train_state(str(tmp_path), 7, p, st,
                                   splats.adam_init(p), pnet.state_dict(),
                                   fopt, torch.Generator())
    state, meta = checkpointing.load_train_state(str(tmp_path), "cpu")
    other = _port_net(HEX_NET, seed=9)
    other.load_state_dict(state["field_state"])
    _same_state(other, pnet)
    assert any(k.endswith("frame_weights") for k in state["field_opt"].mu)
    for k in fp:
        assert torch.equal(state["field_opt"].mu[k], fopt.mu[k])


def test_flags_reach_the_net_and_cfg_args(tmp_path):
    argv = ["-s", "x", "-m", str(tmp_path), "--encoder_type",
            "VarHexPlaneEncoder", "--layer_strategy", "per_frame",
            "--use_view_dep_rgb", "--geo_model_disable_pts", "--n_splats",
            "5000", "--load_time_step", "3"]
    args = train.build_train_parser().parse_args(argv)
    config.save_cfg_args(str(tmp_path), args)
    stored = config.load_cfg_args(str(tmp_path))
    for k, v in (("encoder_type", "VarHexPlaneEncoder"),
                 ("layer_strategy", "per_frame"), ("use_view_dep_rgb", True),
                 ("geo_model_disable_pts", True), ("n_splats", 5000)):
        assert stored[k] == v, k
    # the render CLI's flag groups (render.build_render_parser's, whose
    # module imports scipy)
    rargs = config.get_combined_args(
        config.build_parser("render", sentinel=True), ["-m", str(tmp_path)])
    _, _, hidden, _ = config.extract_configs(rargs)
    hidden = config.HiddenConfig(**{**vars(hidden), "n_frames": 3,
                                    "encoder_args": {"noise_res": 1}})
    net = DeformModel(hidden, radius=1.0, device="cpu").net
    assert net.use_view_dep_rgb and net.geo_model_disable_pts
    assert net.encoder.subs_0.net.conv_in.frame_weights.shape[0] == 3
