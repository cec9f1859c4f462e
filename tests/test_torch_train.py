"""The port's training step against ``splatfields_tpu.train_lib.
make_train_step`` on the CPU, after 1 and after 3 steps.

The harness of tests/test_loss_paths.py at the size of test_torch_render:
64x48, 256 splats from ``create_from_pcd`` (numpy seed 0), bench.py's
loss (``lambda_mask`` 0, ``lambda_norm`` 0.01, D-SSIM 0.2) and splat
learning rates, one view per step from a different orbit camera, a random
target image. Field mode uses the VarTriPlane net (noise 4x4) with the
JAX weights carried across; static mode renders SH degree 0 splats. Both
packages start from the same splats and the same non-zero Adam states
(count 10, moments from a numpy seed), so every update is a smooth
function of the gradient (no zero-state sign(g) steps).

The JAX step on the CPU differentiates its XLA blend by autodiff, which
gives 0 at the 0.99 alpha clamp, while the port uses the closed-form VJP
of the Pallas/CUDA kernels (1 at the clamp); the scene stays below the
clamp (max opacity < 0.99, asserted), where the two agree.

Tolerances (tests/conftest.py pins the JAX MLP to f32): the forward
values agree to ~1e-6 relative (test_torch_render), so the loss gets rtol
1e-5. Gradients are sums over pixels taken in another order, with the
closed-form blend VJP on one side and autodiff on the other; they agree
to ~1e-6 of each leaf's largest value, so the screen-space gradient and
the moments (mu ~ g, nu ~ g^2) are compared at 1e-5 of their leaf's
largest value, and the parameters at rtol 1e-6 (their own rounding) plus
1e-4 of the leaf's learning rate per step (a step moves a parameter by
about lr). Radii, the visibility counts and the valid mask are integers
and must be equal.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu import config as jax_config
from splatfields_tpu import train_lib as jax_train_lib
from splatfields_tpu.models import splats as jax_splats
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_torch import config, train_lib
from splatfields_torch.interop import (
    adam_state_from_numpy,
    flax_to_state_dict,
    load_flax_variables,
    splat_params_from_numpy,
)
from splatfields_torch.models import splats
from splatfields_torch.models.deform_model import DeformModel
from tests.test_torch_render import _camera

W, H, N = 64, 48, 256
ENC = {"noise_res": 4}
STEPS = (1, 3)
SPLAT_LRS = (1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)   # bench.py
FIELD_LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moments(tree, seed):
    """Non-zero Adam moments shaped like a numpy tree."""
    rng = np.random.RandomState(seed)

    def leaf(a):
        return (rng.randn(*a.shape).astype(np.float32) * 1e-3,
                rng.uniform(0.5, 1.5, a.shape).astype(np.float32) * 1e-6)

    pairs = jax.tree.map(leaf, tree)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    return (jax.tree.map(lambda p: p[0], pairs, is_leaf=is_pair),
            jax.tree.map(lambda p: p[1], pairs, is_leaf=is_pair))


def _batches(seed=0, n_steps=max(STEPS)):
    rng = np.random.RandomState(seed)
    out = []
    for step in range(n_steps):
        cam = _camera(view=step + 1)
        out.append({
            "viewmatrix": cam.world_view_transform[None],
            "projmatrix": cam.full_proj_transform[None],
            "campos": cam.camera_center[None],
            "tanfovx": np.full((1,), cam.tanfovx, np.float32),
            "tanfovy": np.full((1,), cam.tanfovy, np.float32),
            "fid": np.zeros((), np.float32),
            "image": rng.rand(1, 3, H, W).astype(np.float32),
            "mask": np.zeros((1, 1, 1, 1), np.float32),
            "depth": np.zeros((1, 1, 1), np.float32),
            "bg": np.ones(3, np.float32),
        })
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _run(mode, hidden=None, n=N, steps=STEPS):
    """Both packages through max(steps) steps; numpy snapshots after each
    step in ``steps``. Static mode has no net; the field modes take the
    ``hidden`` config (default: the VarTriPlane net at noise 4x4) and
    ``n`` splats."""
    field = mode != "static"
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    cols = rng.rand(n, 3).astype(np.float32)
    j_params, j_stats = jax_splats.create_from_pcd(pts, cols, 0, capacity=n)
    opt = jax_config.OptimizationConfig(lambda_mask=0.0, lambda_norm=0.01)
    pipe = jax_config.PipelineConfig(tile_cap=256, k_chunk=64)
    mu, nu = _moments(_np(j_params), 1)
    # separate count buffers: the JAX step donates both states
    j_sopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    hidden = hidden or dict(encoder_type="VarTriPlaneEncoder",
                            composition_rank=0, encoder_args=ENC)
    if field:
        ref = JaxDeformModel(jax_config.HiddenConfig(**hidden), radius=1.0)
        j_vars, net = ref.variables, ref.net
        mu, nu = _moments(_np(j_vars["params"]), 2)
    else:
        j_vars, net, mu, nu = {"params": {}}, None, {}, {}
    j_fopt = jax_splats.AdamState(count=jnp.asarray(10, jnp.int32), mu=mu,
                                  nu=nu)
    j_step = jax_train_lib.make_train_step(net, opt, pipe, W, H, 1, field, 0,
                                           0)

    p_params = splat_params_from_numpy(_np(j_params), device="cpu")
    p_stats = splats.SplatStats(*[torch.tensor(np.asarray(x)) for x in (
        j_stats.valid, j_stats.max_radii2d, j_stats.xyz_gradient_accum,
        j_stats.denom)])
    p_sopt = adam_state_from_numpy(_np(j_sopt), device="cpu")
    p_fopt = adam_state_from_numpy(_np(j_fopt), device="cpu")
    model = None
    p_fparams = {}
    if field:
        model = DeformModel(config.HiddenConfig(**hidden), radius=1.0,
                            seed=1, device="cpu")
        load_flax_variables(model.net, _np(dict(j_vars)))
        p_fparams = model.params
    p_step = train_lib.make_train_step(
        model.net if field else None, config.OptimizationConfig(
            lambda_mask=0.0, lambda_norm=0.01),
        config.PipelineConfig(tile_cap=256, k_chunk=64), W, H, 1, field, 0, 0)
    j_lrs = jax_splats.splat_lr_tree(*SPLAT_LRS)
    p_lrs = splats.splat_lr_tree(*SPLAT_LRS)

    snaps = {}
    for step, b in enumerate(_batches(n_steps=max(steps)), start=1):
        # below the 0.99 alpha clamp: applied alpha <= opacity < 0.99
        with torch.no_grad():
            attrs = (train_lib.field_attributes(
                model.net, p_params.xyz, splats.get_scaling(p_params),
                p_stats.valid, 0.0, 0, params=p_fparams) if field
                else train_lib.static_attributes(p_params, p_stats.valid))
        assert float(attrs["opacity"].max()) < 0.99
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        j_params, j_stats, j_sopt, j_fp, j_fopt, j_out, _ = j_step(
            j_params, j_stats, j_sopt, j_vars, j_fopt, jb, j_lrs,
            jnp.asarray(FIELD_LR, jnp.float32), jax.random.PRNGKey(0))
        j_vars = dict(j_vars, params=j_fp)
        pb = {k: torch.as_tensor(v) for k, v in b.items()}
        p_params, p_stats, p_sopt, p_fparams, p_fopt, p_out = p_step(
            p_params, p_stats, p_sopt, p_fparams, p_fopt, pb, p_lrs,
            FIELD_LR)
        if step in steps:
            snaps[step] = dict(
                jax=dict(params=_np(j_params), stats=_np(j_stats),
                         sopt=_np(j_sopt), fparams=_np(j_fp),
                         fopt=_np(j_fopt), out=_np(j_out)),
                port=dict(params=p_params, stats=p_stats, sopt=p_sopt,
                          fparams=p_fparams, fopt=p_fopt, out=p_out))
    return snaps


@pytest.fixture(scope="module", params=["field", "static"])
def runs(request):
    return request.param, _run(request.param)


def _splat_dict(tree):
    return {f: np.asarray(getattr(tree, f)) for f in
            ("xyz", "features_dc", "features_rest", "scaling", "rotation",
             "opacity")}


def _field_dict(tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(tree).items()}


def _trees(snap, key):
    """(port leaves, JAX leaves) of one tree, both {name: numpy}."""
    j, p = snap["jax"], snap["port"]
    if key in ("params", "sopt_mu", "sopt_nu"):
        jt = j["params"] if key == "params" else getattr(j["sopt"], key[5:])
        pt = p["params"] if key == "params" else getattr(p["sopt"], key[5:])
        return ({k: v.detach().numpy() for k, v in
                 splats.tree_items(pt).items()}, _splat_dict(jt))
    jt = j["fparams"] if key == "fparams" else getattr(j["fopt"], key[5:])
    pt = p["fparams"] if key == "fparams" else getattr(p["fopt"], key[5:])
    return ({k: v.detach().numpy() for k, v in pt.items()}, _field_dict(jt))


def check_loss_and_aux(snaps, after):
    j, p = snaps[after]["jax"]["out"], snaps[after]["port"]["out"]
    np.testing.assert_allclose(float(p.loss), float(j.loss), rtol=1e-5)
    assert set(p.loss_dict) == set(j.loss_dict)
    for k in j.loss_dict:
        np.testing.assert_allclose(p.loss_dict[k].numpy(),
                                   np.asarray(j.loss_dict[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(p.means3d.numpy(), np.asarray(j.means3d),
                               rtol=1e-5, atol=1e-5)


def check_screen_grad_radii_and_stats(snaps, after):
    j, p = snaps[after]["jax"], snaps[after]["port"]
    np.testing.assert_array_equal(p["out"].radii.numpy(),
                                  np.asarray(j["out"].radii))
    sg_ref = np.asarray(j["out"].screen_grad)
    scale = np.abs(sg_ref).max()
    assert scale > 0
    np.testing.assert_allclose(p["out"].screen_grad.numpy() / scale,
                               sg_ref / scale, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(p["stats"].valid.numpy(),
                                  np.asarray(j["stats"].valid))
    np.testing.assert_array_equal(p["stats"].max_radii2d.numpy(),
                                  np.asarray(j["stats"].max_radii2d))
    np.testing.assert_array_equal(p["stats"].denom.numpy(),
                                  np.asarray(j["stats"].denom))
    acc_ref = np.asarray(j["stats"].xyz_gradient_accum)
    np.testing.assert_allclose(p["stats"].xyz_gradient_accum.numpy() / scale,
                               acc_ref / scale, atol=1e-5 * after, rtol=0)
    assert float(p["stats"].denom.max()) == after   # visible every step


def _param_lr(tree, name):
    if tree == "fparams":
        return FIELD_LR
    return getattr(splats.splat_lr_tree(*SPLAT_LRS), name)


def check_parameters(mode, snaps, after, tree):
    got, want = _trees(snaps[after], tree)
    assert set(got) == set(want)
    if mode == "static" and tree == "fparams":
        assert not got
    for k in want:
        tol = 1e-4 * _param_lr(tree, k) * after
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=tol,
                                   err_msg=k)


def check_adam_states(snaps, after, tree):
    got, want = _trees(snaps[after], tree)
    assert set(got) == set(want)
    s = snaps[after]
    assert (s["port"]["sopt"].count == int(s["jax"]["sopt"].count)
            == 10 + after)
    for k in want:
        scale = np.abs(want[k]).max() if want[k].size else 1.0
        np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                   atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("after", STEPS)
def test_loss_and_aux_match(runs, after):
    check_loss_and_aux(runs[1], after)


@pytest.mark.parametrize("after", STEPS)
def test_screen_grad_radii_and_stats_match(runs, after):
    check_screen_grad_radii_and_stats(runs[1], after)


@pytest.mark.parametrize("after", STEPS)
@pytest.mark.parametrize("tree", ["params", "fparams"])
def test_parameters_match(runs, after, tree):
    check_parameters(*runs, after, tree)


@pytest.mark.parametrize("after", STEPS)
@pytest.mark.parametrize("tree", ["sopt_mu", "sopt_nu", "fopt_mu", "fopt_nu"])
def test_adam_states_match(runs, after, tree):
    check_adam_states(runs[1], after, tree)
