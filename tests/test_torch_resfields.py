"""The 4-D field's building blocks against the JAX package on the CPU:
``ResFieldLinear`` with active ranks (compression 'vm', mode 'lookup',
fuse 'add', the member the 4-D field trains with; the rest of the zoo is
tests/test_torch_resfield_zoo.py), the density transfer functions,
``GeneralMLP`` with ResField ranks, every ``FlowHead``
model, ``SirenMLP`` and ``exp_se3``.

The JAX parameters are drawn by flax, then replaced by numpy draws from a
seed (so zero-initialised branches, such as the DCT heads' coefficients,
carry gradients too) and carried across with ``interop``. Outputs and the
gradients of a fixed random cotangent agree within 1e-6 relative (rtol
1e-6) plus 1e-6 of the largest JAX value of their tree (the outputs, or
all the gradients): both packages sum in f32 in their own order, and a
bias gradient, a sum over rows with cancellation, can lose more than
1e-6 of itself.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu.models import flow as jax_flow
from splatfields_tpu.models import mlp as jax_mlp
from splatfields_tpu.models import resfields as jax_resfields
from splatfields_tpu.utils import transforms as jax_transforms
from splatfields_torch.interop import (
    flax_to_state_dict,
    load_flax_variables,
    module_to_flax,
)
from splatfields_torch.models import flow, mlp, resfields
from splatfields_torch.utils import transforms

GEN = torch.Generator().manual_seed(0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what="", scale=None):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    if scale is None:
        scale = float(np.abs(want).max()) if want.size else 1.0
    assert scale > 0, what
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale,
                               err_msg=what)


def _randomize(params, seed):
    """Every leaf replaced by N(0, 0.3) numpy draws, except a SIREN's (its
    sin(30 x) needs its own small init); ``seed`` None keeps them all."""
    if seed is None:
        return params
    rng = np.random.RandomState(seed)
    return {k: v if k == "basis_net" else jax.tree.map(
        lambda a: np.asarray(0.3 * rng.randn(*np.shape(a)), np.float32), v)
        for k, v in params.items()}


def _outs(module, params, args, kwargs):
    o = module.apply({"params": params}, *args, **kwargs)
    return o if isinstance(o, tuple) else (o,)


@functools.partial(jax.jit, static_argnums=0)
def _jax_run(module, params, args, kwargs, cots):
    """(outputs, (gradients of sum(out * cot) w.r.t. the params and every
    arg)) in one compile per module, shared by the frames."""
    def loss(p, a):
        o = _outs(module, p, a, kwargs)
        return sum(jnp.sum(x * c) for x, c in zip(o, cots)), o
    grads, outs = jax.grad(loss, argnums=(0, 1), has_aux=True)(params, args)
    return outs, grads


def _parity(jax_module, port_module, args, port_kwargs=None, jax_kwargs=None,
            seed=0, inputs=()):
    """Outputs and gradients (parameters, and the ``inputs`` positions of
    ``args``) of JAX ``apply`` against the port module, for sum(out * c)
    with a seeded cotangent c per output."""
    jax_kwargs = jax_kwargs or {}
    port_kwargs = port_kwargs or {}
    params = jax_module.init(jax.random.PRNGKey(0), *args,
                             **jax_kwargs)["params"]
    params = _randomize(params, seed)
    load_flax_variables(port_module, {"params": params})
    shapes = jax.eval_shape(functools.partial(_outs, jax_module), params,
                            args, jax_kwargs)
    rng = np.random.RandomState(1 if seed is None else seed + 1)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in shapes]
    want, (g_params, g_args) = _jax_run(jax_module, params, args, jax_kwargs,
                                        cots)
    want = [np.asarray(o) for o in want]

    port_in = [torch.tensor(a).requires_grad_(i in inputs)
               for i, a in enumerate(args)]
    got = port_module(*port_in, **port_kwargs)
    got = got if isinstance(got, tuple) else (got,)
    out_scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        _close(g, w, "output", out_scale)
    total = sum((g * torch.tensor(c)).sum() for g, c in zip(got, cots))
    names = [k for k, _ in port_module.named_parameters()]
    leaves = [p for _, p in port_module.named_parameters()]
    grads = torch.autograd.grad(total, leaves + [port_in[i] for i in inputs])
    want_g = flax_to_state_dict(jax.tree.map(np.asarray, g_params))
    assert set(names) == set(want_g)
    want_in = [np.asarray(g_args[i]) for i in inputs]
    g_scale = max(float(np.abs(w).max())
                  for w in [v.numpy() for v in want_g.values()] + want_in)
    for k, g in zip(names, grads):
        _close(g, want_g[k].numpy(), k, g_scale)
    for g, w in zip(grads[len(leaves):], want_in):
        _close(g, w, "input", g_scale)


@pytest.mark.parametrize("frame_id", [0, 3, 6])
def test_resfield_linear(frame_id):
    x = np.random.RandomState(2).randn(11, 5).astype(np.float32)
    jm = jax_resfields.ResFieldLinear(in_features=5, out_features=4, rank=3,
                                      capacity=7)
    pm = resfields.ResFieldLinear(5, 4, 3, 7, generator=GEN)
    assert pm.matrix_t.shape == (3, 4 * 5) and pm.weights_t.shape == (7, 3)
    _parity(jm, pm, (x,), {"frame_id": frame_id},
            {"frame_id": jnp.int32(frame_id)}, seed=frame_id, inputs=(0,))


def test_resfield_linear_delta_order():
    """``matrix_t`` is flattened in (out, in) order in both packages: the
    port's effective weight is W + (weights_t[f] @ matrix_t).view(out, in)
    with no transpose."""
    pm = resfields.ResFieldLinear(3, 2, 1, 2, generator=GEN)
    with torch.no_grad():
        pm.weight.zero_()
        pm.bias.zero_()
        pm.weights_t.fill_(1.0)
        pm.matrix_t.copy_(torch.arange(6.0)[None])
    y = pm(torch.eye(3), frame_id=1)        # row j: column j of W
    assert torch.equal(y, torch.arange(6.0).view(2, 3).T)


def test_resfield_refuses_the_rest_of_the_zoo():
    """The rest of the zoo builds (its parity with JAX is
    tests/test_torch_resfield_zoo.py): ``cp`` holds its factors and the
    interpolation mode reads time; only a name outside the zoo is refused
    at construction."""
    cp = resfields.ResFieldLinear(3, 2, 1, 2, compression="cp",
                                  generator=GEN)
    assert sorted(k for k, _ in cp.named_parameters()) == [
        "bias", "lin_f1", "lin_f2", "lin_f3", "lin_w", "weight"]
    interp = resfields.ResFieldLinear(3, 2, 1, 2, mode="interpolation",
                                      generator=GEN)
    y = interp(torch.ones(4, 3), input_time=torch.zeros(4, 1))
    assert y.shape == (4, 2) and torch.isfinite(y).all()
    with pytest.raises(NotImplementedError, match="not a member"):
        resfields.ResFieldLinear(3, 2, 1, 2, compression="dense",
                                 generator=GEN)


@pytest.mark.parametrize("frame_id", [0, 2, 4])
def test_general_mlp_with_ranks(frame_id):
    """composition_rank 4, n_frames 5: ranks on net_2 .. net_H only."""
    rng = np.random.RandomState(3)
    xyz = rng.uniform(-1, 1, (13, 3)).astype(np.float32)
    feat = rng.randn(13, 6).astype(np.float32)
    cfg = dict(in_features=9, out_features=3, hidden_features=16,
               num_hidden_layers=3, skips=(1,), multires=2,
               out_activation="sigmoid", act="leaky_relu",
               composition_rank=4, n_frames=5)
    jm = jax_mlp.GeneralMLP(**cfg)
    pm = mlp.GeneralMLP(**cfg, generator=GEN)
    ranked = sorted(k for k, _ in pm.named_parameters() if "_t" in k)
    assert ranked == [f"net_{i}.{p}" for i in (2, 3)
                      for p in ("matrix_t", "weights_t")]
    _parity(jm, pm, (xyz, feat), {"frame_id": frame_id},
            {"frame_id": jnp.int32(frame_id)}, seed=10 + frame_id,
            inputs=(0, 1))


@pytest.mark.parametrize("flow_model", flow.FLOW_MODELS)
def test_flow_head(flow_model):
    rng = np.random.RandomState(4)
    hidden = rng.randn(17, 8).astype(np.float32)
    pts = rng.uniform(-1, 1, (17, 3)).astype(np.float32)
    time_step = np.float32(0.4)
    jm = jax_flow.FlowHead(width=8, flow_model=flow_model, num_basis=3,
                           n_frames=5)
    pm = flow.FlowHead(8, flow_model, 3, 5, generator=GEN)
    _parity(jm, pm, (hidden, pts),
            {"time_step": torch.tensor(time_step), "frame_id": 3},
            {"time_step": jnp.asarray(time_step), "frame_id": jnp.int32(3)},
            seed=20, inputs=(0, 1))


def test_init_dct_basis_and_flow_names():
    np.testing.assert_array_equal(flow.init_dct_basis(4, 10),
                                  jax_flow.init_dct_basis(4, 10))
    names = {fm: sorted(k.split(".")[0] for k, _ in flow.FlowHead(
        8, fm, 3, 5, generator=GEN).named_parameters())
        for fm in flow.FLOW_MODELS}
    assert set(names["offset"]) == {"gaussian_warp"}
    assert set(names["se3Scaled"]) == {"branch_w", "branch_v",
                                       "branch_scale", "branch_offset"}
    assert set(names["dct"]) == {"branch_coeff", "trajectory_basis"}
    assert set(names["dct_siren"]) == {"branch_coeff", "basis_net"}


def test_siren_mlp():
    t = np.random.RandomState(5).uniform(-1, 1, (7, 1)).astype(np.float32)
    jm = jax_resfields.SirenMLP(out_features=4, hidden_features=16,
                                num_hidden_layers=2)
    pm = resfields.SirenMLP(1, 4, 16, 2, generator=GEN)
    _parity(jm, pm, (t,), seed=None, inputs=(0,))


def test_exp_se3():
    rng = np.random.RandomState(6)
    S = rng.randn(9, 6).astype(np.float32)
    theta = rng.uniform(0.1, 2.0, (9, 1)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (9, 1)).astype(np.float32)
    cot = rng.randn(9, 4, 4).astype(np.float32)
    for jf, pf, extra in ((jax_transforms.exp_se3, transforms.exp_se3, ()),
                          (jax_transforms.scaled_exp_se3,
                           transforms.scaled_exp_se3, (scale,))):
        want, (gS, gth) = jax.jit(lambda s, t: (
            jf(s, t, *extra), jax.grad(lambda s_, t_: jnp.sum(
                jf(s_, t_, *extra) * cot), argnums=(0, 1))(s, t)))(S, theta)
        s_t = torch.tensor(S, requires_grad=True)
        t_t = torch.tensor(theta, requires_grad=True)
        got = pf(s_t, t_t, *[torch.tensor(e) for e in extra])
        _close(got, want, "exp_se3")
        got_s, got_t = torch.autograd.grad((got * torch.tensor(cot)).sum(),
                                           (s_t, t_t))
        _close(got_s, gS, "d/dS")
        _close(got_t, gth, "d/dtheta")
    h = rng.randn(5, 3).astype(np.float32)
    _close(transforms.from_homogeneous(transforms.to_homogeneous(
        torch.tensor(h))), h)
    _close(transforms.exp_so3(torch.tensor(S[:, :3]), torch.tensor(theta)),
           jax_transforms.exp_so3(S[:, :3], theta))


@pytest.mark.parametrize("which", ["LaplaceDensity", "BellDensity"])
def test_density(which):
    """``models/density.py`` against the JAX modules: values, ``inv_s``
    and the gradients of the scalars and the SDF, the scalars drawn from
    a seed (tolerance as above)."""
    from splatfields_tpu.models import density as jax_density
    from splatfields_torch.models import density
    sdf = np.random.RandomState(7).randn(23).astype(np.float32) * 0.3
    sdf[0] = 0.0
    jm = getattr(jax_density, which)()
    pm = getattr(density, which)()
    _parity(jm, pm, (sdf,), seed=8, inputs=(0,))
    params = module_to_flax(pm)["params"]
    assert set(params) == ({"beta"} if which == "LaplaceDensity"
                           else {"lamb", "gamma"})
    np.testing.assert_allclose(pm.inv_s().detach().numpy(), jm.apply(
        {"params": params}, method=jm.inv_s), rtol=1e-6)
