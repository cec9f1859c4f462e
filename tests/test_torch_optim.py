"""The training slice's small modules against the JAX package on the CPU:
SSIM, the learning-rate schedule, Adam and the splat learning rates, the
densification statistics, densify-and-prune with the split noise passed
in, reset_opacity, the field optimizer's schedule, the losses and the
Adam-state carrier.

Inputs come from numpy seeds. Tolerances: the same f32 formulas evaluated
in another framework agree to a few ulps (rtol 1e-6 on elementwise
updates, 1e-5 on reductions such as SSIM and the losses, whose sums run
in another order); gradients are compared over the largest magnitude
(1e-5); integer and boolean outputs (masks, counts, gather order) must be
equal.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu import config as jax_config
from splatfields_tpu import train_lib as jax_train_lib
from splatfields_tpu.models import splats as jax_splats
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_tpu.ops import ssim as jax_ssim
from splatfields_tpu.ops.raster.api import RenderOut as JaxRenderOut
from splatfields_tpu.utils import schedules as jax_schedules
from splatfields_torch import config, train_lib
from splatfields_torch.interop import (
    adam_state_from_numpy,
    flax_to_state_dict,
    load_flax_variables,
    splat_params_from_numpy,
)
from splatfields_torch.models import splats
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.ops.raster.api import RenderOut
from splatfields_torch.ops.ssim import ssim
from splatfields_torch.utils.schedules import expon_lr_func

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-6, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --- SSIM and the schedule ---------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 48, 64), (1, 40, 30), (30, 20)])
def test_ssim_value_and_grad_match_jax(shape):
    rng = np.random.RandomState(0)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    want = jax_ssim.ssim(jnp.asarray(a), jnp.asarray(b))
    g_want = np.asarray(jax.grad(lambda x: jax_ssim.ssim(x, jnp.asarray(b)))(
        jnp.asarray(a)))
    x = torch.tensor(a, requires_grad=True)
    got = ssim(x, torch.as_tensor(b))
    (g_got,) = torch.autograd.grad(got, x)
    _close(float(got), float(want), rtol=1e-5)
    scale = np.abs(g_want).max()
    _close(g_got.numpy() / scale, g_want / scale, rtol=0, atol=1e-5)
    if len(shape) == 3:
        _close(ssim(x, torch.as_tensor(b), size_average=False).detach(),
               jax_ssim.ssim(jnp.asarray(a), jnp.asarray(b),
                             size_average=False), rtol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(lr_init=8e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=40_000),
    dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=500, lr_delay_mult=0.1,
         max_steps=3000),
    dict(lr_init=0.0, lr_final=0.0)])
def test_expon_lr_func_matches_jax(kw):
    got, want = expon_lr_func(**kw), jax_schedules.expon_lr_func(**kw)
    for step in (-1, 0, 1, 250, 500, 2999, 3000, 20_000, 40_000, 50_000):
        assert got(step) == want(step), step


def test_deform_model_optimizer_matches_jax():
    hidden = dict(encoder_type="VarTriPlaneEncoder", composition_rank=0,
                  encoder_args={"noise_res": 4})
    ref = JaxDeformModel(jax_config.HiddenConfig(**hidden), radius=1.0)
    port = DeformModel(config.HiddenConfig(**hidden), radius=1.0,
                       device="cpu")
    load_flax_variables(port.net, _np(dict(ref.variables)))
    opt = jax_config.OptimizationConfig()
    ref.train_setting(opt)
    port.train_setting(config.OptimizationConfig())
    for it in (0, 1, 1000, 39_999, 40_000):
        assert port.learning_rate(it) == ref.learning_rate(it)
    want = flax_to_state_dict(_np(ref.params))
    assert set(port.params) == set(want) == set(port.opt_state.mu)
    assert port.opt_state.count == 0
    for k, v in want.items():
        torch.testing.assert_close(port.params[k], v, rtol=0, atol=0)
        assert not port.opt_state.mu[k].any() and not port.opt_state.nu[k].any()
    # the setter writes a tree into the net
    port.params = {k: v + 1.0 for k, v in want.items()}
    for k, p in port.net.named_parameters():
        torch.testing.assert_close(p.detach(), want[k] + 1.0)


# --- Adam ----------------------------------------------------------------------

def _splat_tree(rng, n=64, k_rest=3):
    shapes = dict(xyz=(n, 3), features_dc=(n, 1, 3),
                  features_rest=(n, k_rest, 3), scaling=(n, 3),
                  rotation=(n, 4), opacity=(n, 1))
    return {f: rng.randn(*s).astype(np.float32) for f, s in shapes.items()}


@pytest.mark.parametrize("kind", ["splats", "dict"])
def test_adam_update_matches_jax(kind):
    rng = np.random.RandomState(0)
    p0 = _splat_tree(rng)
    if kind == "splats":
        j_p = jax_splats.SplatParams(**{k: jnp.asarray(v)
                                        for k, v in p0.items()})
        t_p = splat_params_from_numpy(p0, device="cpu")
        j_lr = jax_splats.splat_lr_tree(1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)
        t_lr = splats.splat_lr_tree(1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)
        for f in FIELDS:
            assert getattr(t_lr, f) == getattr(j_lr, f)
    else:
        j_p = {k: jnp.asarray(v) for k, v in p0.items()}
        t_p = {k: torch.tensor(v) for k, v in p0.items()}
        j_lr = t_lr = 1e-3
    j_s, t_s = jax_splats.adam_init(j_p), splats.adam_init(t_p)
    for step in range(3):
        g = _splat_tree(np.random.RandomState(step + 1))
        if step == 1:
            g["opacity"][:] = 0.0     # zero gradients: m / (sqrt(v) + eps)
        j_g = (jax_splats.SplatParams(**{k: jnp.asarray(v)
                                         for k, v in g.items()})
               if kind == "splats" else {k: jnp.asarray(v)
                                         for k, v in g.items()})
        t_g = splats.tree_like(t_p, {k: torch.tensor(v)
                                     for k, v in g.items()})
        j_p, j_s = jax_splats.adam_update(j_p, j_g, j_s, j_lr)
        t_p, t_s = splats.adam_update(t_p, t_g, t_s, t_lr)
    assert t_s.count == int(j_s.count) == 3
    for name, got, want in (("params", t_p, j_p), ("mu", t_s.mu, j_s.mu),
                            ("nu", t_s.nu, j_s.nu)):
        got = splats.tree_items(got)
        want = (want if isinstance(want, dict)
                else {f: getattr(want, f) for f in FIELDS})
        for k in FIELDS:
            _close(got[k], want[k], rtol=1e-6, atol=1e-7, msg=f"{name} {k}")


def test_adam_state_carrier():
    rng = np.random.RandomState(0)
    tree = _splat_tree(rng)
    j = jax_splats.AdamState(
        count=jnp.asarray(7, jnp.int32),
        mu=jax_splats.SplatParams(**{k: jnp.asarray(v) for k, v in tree.items()}),
        nu=jax_splats.SplatParams(**{k: jnp.asarray(v ** 2)
                                     for k, v in tree.items()}))
    t = adam_state_from_numpy(_np(j), device="cpu")
    assert t.count == 7 and isinstance(t.mu, splats.SplatParams)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t.nu, f).numpy(), tree[f] ** 2)
    # a flax-shaped tree goes through the parameter layouts
    flax = {"params": {"head": {"kernel": rng.randn(4, 6).astype(np.float32),
                                "bias": rng.randn(6).astype(np.float32)},
                       "conv": {"kernel": rng.randn(3, 3, 2, 5).astype(
                           np.float32)}}}
    f = adam_state_from_numpy(jax_splats.AdamState(
        count=np.int32(2), mu=flax["params"], nu=flax["params"]),
        device="cpu")
    assert set(f.mu) == {"head.weight", "head.bias", "conv.weight"}
    np.testing.assert_array_equal(f.mu["head.weight"].numpy(),
                                  flax["params"]["head"]["kernel"].T)
    np.testing.assert_array_equal(
        f.nu["conv.weight"].numpy(),
        flax["params"]["conv"]["kernel"].transpose(3, 2, 0, 1))


# --- densification -------------------------------------------------------------

def _stats_inputs(seed, n=96):
    rng = np.random.RandomState(seed)
    valid = rng.rand(n) > 0.2
    return dict(
        valid=valid,
        max_radii2d=(rng.rand(n) * 5).astype(np.float32),
        accum=(rng.rand(n) * 1e-3).astype(np.float32),
        denom=rng.randint(0, 4, n).astype(np.float32),
        screen_grad=(rng.randn(n, 2) * 1e-3).astype(np.float32),
        radii=(rng.randint(0, 3, n) * rng.randint(0, 9, n)).astype(np.int32))


def _both_stats(d):
    j = jax_splats.SplatStats(valid=jnp.asarray(d["valid"]),
                              max_radii2d=jnp.asarray(d["max_radii2d"]),
                              xyz_gradient_accum=jnp.asarray(d["accum"]),
                              denom=jnp.asarray(d["denom"]))
    t = splats.SplatStats(valid=torch.tensor(d["valid"]),
                          max_radii2d=torch.tensor(d["max_radii2d"]),
                          xyz_gradient_accum=torch.tensor(d["accum"]),
                          denom=torch.tensor(d["denom"]))
    return j, t


def _assert_stats(got, want):
    for f in ("valid", "max_radii2d", "xyz_gradient_accum", "denom"):
        _close(getattr(got, f), getattr(want, f), rtol=1e-6, msg=f)


@pytest.mark.parametrize("subsample", [False, True])
def test_stats_updates_match_jax(subsample):
    d = _stats_inputs(0)
    j, t = _both_stats(d)
    m = 48 if subsample else 96
    idx = np.random.RandomState(1).permutation(96)[:m].astype(np.int32)
    sg, radii = d["screen_grad"][:m], d["radii"][:m]
    j_idx = jnp.asarray(idx) if subsample else None
    t_idx = torch.tensor(idx) if subsample else None
    j = jax_splats.update_max_radii(j, jnp.asarray(radii), idx=j_idx)
    j = jax_splats.add_densification_stats(j, jnp.asarray(sg),
                                           jnp.asarray(radii), idx=j_idx)
    t = splats.update_max_radii(t, torch.tensor(radii), idx=t_idx)
    t = splats.add_densification_stats(t, torch.tensor(sg),
                                       torch.tensor(radii), idx=t_idx)
    _assert_stats(t, j)
    assert (t.denom.numpy() != d["denom"]).any()


def _densify_inputs(n, seed):
    rng = np.random.RandomState(seed)
    p = _splat_tree(rng, n=n, k_rest=0)
    # a spread of sizes and opacities: clones, splits and prunes all occur
    p["scaling"] = np.log(rng.uniform(0.001, 0.3, (n, 3))).astype(np.float32)
    p["opacity"] = rng.uniform(-6, 3, (n, 1)).astype(np.float32)
    d = _stats_inputs(seed, n)
    d["accum"] = (rng.rand(n) * 2e-3).astype(np.float32)
    return p, d


@pytest.mark.parametrize("case", ["grow", "overflow", "screen_size"])
def test_densify_and_prune_matches_jax(case):
    n = 96
    n_valid = {"grow": 40, "overflow": 90, "screen_size": 60}[case]
    p, d = _densify_inputs(n, 3)
    d["valid"] = np.arange(n) < n_valid
    max_screen = 20.0 if case == "screen_size" else 0.0
    j_p = jax_splats.SplatParams(**{k: jnp.asarray(v) for k, v in p.items()})
    t_p = splat_params_from_numpy(p, device="cpu")
    j_stats, t_stats = _both_stats(d)
    mu, nu = _splat_tree(np.random.RandomState(4), n=n, k_rest=0), \
        _splat_tree(np.random.RandomState(5), n=n, k_rest=0)
    j_opt = jax_splats.AdamState(
        count=jnp.asarray(5, jnp.int32),
        mu=jax_splats.SplatParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jax_splats.SplatParams(**{k: jnp.asarray(v) for k, v in nu.items()}))
    t_opt = adam_state_from_numpy(_np(j_opt), device="cpu")
    key = jax.random.PRNGKey(7)
    noise = jax.random.normal(key, (n, 2, 3), jnp.float32)  # the JAX draw
    args = (2e-4, 0.005, 2.0, max_screen)
    j_out = jax_splats.densify_and_prune(j_p, j_stats, j_opt, key, *args)
    t_out = splats.densify_and_prune(t_p, t_stats, t_opt,
                                     torch.tensor(np.asarray(noise)), *args)
    assert int(t_out[3]) == int(j_out[3])
    if case == "overflow":
        assert int(t_out[3]) > 0
    np.testing.assert_array_equal(t_out[1].valid.numpy(),
                                  np.asarray(j_out[1].valid))
    n_new = int(t_out[1].valid.sum())
    assert n_new != n_valid      # the round changed the population
    _assert_stats(t_out[1], j_out[1])
    for f in FIELDS:
        _close(getattr(t_out[0], f), getattr(j_out[0], f), rtol=1e-6,
               atol=1e-6, msg=f)
        for m in ("mu", "nu"):
            _close(getattr(getattr(t_out[2], m), f),
                   getattr(getattr(j_out[2], m), f), rtol=0, atol=0,
                   msg=f"{m} {f}")
    assert t_out[2].count == 5


def test_reset_opacity_matches_jax():
    p = _splat_tree(np.random.RandomState(0))
    j_p = jax_splats.SplatParams(**{k: jnp.asarray(v) for k, v in p.items()})
    t_p = splat_params_from_numpy(p, device="cpu")
    j_opt = jax_splats.adam_init(j_p)
    j_opt = dataclasses.replace(j_opt, mu=j_p, nu=j_p)
    t_opt = splats.AdamState(count=0, mu=t_p, nu=t_p)
    j_new, j_o = jax_splats.reset_opacity(j_p, j_opt)
    t_new, t_o = splats.reset_opacity(t_p, t_opt)
    _close(t_new.opacity, j_new.opacity, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t_new.xyz.numpy(), p["xyz"])
    assert not t_o.mu.opacity.any() and not t_o.nu.opacity.any()
    np.testing.assert_array_equal(t_o.mu.xyz.numpy(), p["xyz"])


# --- losses ----------------------------------------------------------------------

LOSS_CASES = {
    "main_path": dict(lambda_mask=0.0, lambda_norm=0.01),
    "all_terms": dict(lambda_mask=0.1, lambda_norm=0.01, lambda_norm_mean=0.02,
                      lambda_depth=0.1, lambda_depthl1=0.05,
                      lambda_opacity=0.03, lambda_gradient=0.5),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_compute_losses_match_jax(case):
    rng = np.random.RandomState(0)
    v, h, w, n = 2, 24, 32, 50
    color = rng.rand(v, 3, h, w).astype(np.float32)
    alpha = rng.rand(v, 1, h, w).astype(np.float32)
    depth = (rng.rand(v, 1, h, w) * 4).astype(np.float32)
    batch = {"image": rng.rand(v, 3, h, w).astype(np.float32),
             "mask": (rng.rand(v, 1, h, w) > 0.5).astype(np.float32),
             "depth": (rng.rand(v, h, w) * 4 - 0.5).astype(np.float32)}
    attrs = {"means3d": rng.randn(n, 3).astype(np.float32),
             "opacity": rng.rand(n).astype(np.float32),
             "gradient_error": np.float32(0.25)}
    valid = rng.rand(n) > 0.3
    radii = np.zeros(n, np.int32)
    opt_kw = LOSS_CASES[case]

    def jax_loss(c):
        outs = [JaxRenderOut(c[i], jnp.asarray(depth[i]), jnp.asarray(alpha[i]),
                             jnp.asarray(radii), jnp.asarray(0))
                for i in range(v)]
        return jax_train_lib.compute_losses(
            outs, {k: jnp.asarray(x) for k, x in batch.items()},
            {k: jnp.asarray(x) for k, x in attrs.items()},
            jax_config.OptimizationConfig(**opt_kw), jnp.asarray(valid))

    (j_loss, j_aux), j_grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(color))
    c = torch.tensor(color, requires_grad=True)
    outs = [RenderOut(c[i], torch.tensor(depth[i]), torch.tensor(alpha[i]),
                      torch.tensor(radii), torch.tensor(0)) for i in range(v)]
    t_loss, t_aux = train_lib.compute_losses(
        outs, {k: torch.tensor(x) for k, x in batch.items()},
        {k: torch.as_tensor(x) for k, x in attrs.items()},
        config.OptimizationConfig(**opt_kw), torch.tensor(valid))
    (t_grad,) = torch.autograd.grad(t_loss, c)
    _close(float(t_loss), float(j_loss), rtol=1e-5)
    assert set(t_aux) == set(j_aux)
    for k in j_aux:
        _close(float(t_aux[k]), float(j_aux[k]), rtol=1e-5, msg=k)
    scale = np.abs(np.asarray(j_grad)).max()
    _close(t_grad.numpy() / scale, np.asarray(j_grad) / scale, rtol=0,
           atol=1e-5)


def test_unported_loss_terms_raise():
    # the n_splats subsample is ported (tests/test_torch_field_options.py
    # holds it) and draws its keys from the generator the loop passes in
    with pytest.raises(ValueError, match="n_splats"):
        train_lib.make_train_step(None, config.OptimizationConfig(),
                                  config.PipelineConfig(), 8, 8, 1, True, 0,
                                  0, n_splats=10)
    assert callable(train_lib.make_train_step(
        None, config.OptimizationConfig(), config.PipelineConfig(), 8, 8, 1,
        True, 0, 0, n_splats=10, generator=torch.Generator()))
    # 4-D steps are ported (tests/test_torch_4d.py holds them)
    assert callable(train_lib.make_train_step(
        None, config.OptimizationConfig(), config.PipelineConfig(), 8, 8, 1,
        True, 5, 0))


def test_optimization_config_matches_jax():
    assert (dataclasses.asdict(config.OptimizationConfig())
            == dataclasses.asdict(jax_config.OptimizationConfig()))
