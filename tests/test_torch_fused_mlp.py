"""The port's fused MLP heads (``splatfields_torch/ops/fused_mlp.py``, the
plain version on the CPU) against the JAX package's
(``splatfields_tpu/ops/fused_mlp.py``, its Pallas kernels in interpret
mode), on the CPU:

- the plans of the published-width VarTriPlane and NGP nets;
- ``pack_params`` of the port's modules against the JAX packing of the
  same weights (the port's, as a flax tree that ``load_flax_variables``
  takes back bit for bit);
- ``fused_heads`` forward and every gradient at f32 and bf16, with and
  without features (tests/test_fused_mlp.py's plan, N = 100);
- ``SplatFields(fused_pallas="on")`` outputs and parameter gradients for
  three encoders at tests/test_fused_mlp.py's small widths;
- one training step of an encoder-free field with
  ``SPLATFIELDS_FUSED_MLP=on`` in both packages (tests/test_torch_train.py's
  harness).

The SplatFields and training checks assert that the port's fused path
ran: two fused calls per forward and no ``GeneralMLP.forward``.

Tolerances. f32: tests/test_fused_mlp.py's (forward 1e-5; gradients rtol
and atol 1e-4; SplatFields outputs 2e-5, gradients rtol 2e-4, atol 2e-5):
the same products summed in another order. bf16: both sides round the same
operands at the same places and sum exact bf16 products in f32, so they
differ by the summation order alone, as long as no sum lands on the other
side of a bf16 rounding boundary (that would move the activation by 2^-8
relative). Measured at N = 100: forward 1.4e-7 of the output's max,
gradients 1.9e-7 of each tensor's max; the bound is 1e-4 of the max.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import splatfields_torch.models.splatfields as port_splatfields
import tests.test_torch_train as train_parity
from splatfields_torch.interop import (
    _convert,
    flax_to_state_dict,
    load_flax_variables,
)
from splatfields_torch.models.mlp import GeneralMLP
from splatfields_torch.models.splatfields import SplatFields
from splatfields_torch.ops import fused_mlp as fm
from splatfields_tpu.models.splatfields import SplatFields as JaxSplatFields
from splatfields_tpu.ops import fused_mlp as jfm

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tests/test_fused_mlp.py's SplatFields at small widths
SMALL = dict(n_frames=0, radius=1.0, composition_rank=0, deform_w=32,
             deform_d=3, rgb_w=32, rgb_d=3, scale_w=16, scale_d=2,
             opacity_w=16, opacity_d=2, rotation_w=16, rotation_d=2,
             fused_block=64, deform_skips=(1,), rgb_skips=(1,),
             scale_skips=(1,), opacity_skips=(1,), rotation_skips=(20,))
ENCODERS = {"": {},
            "VarTriPlaneEncoder": dict(encoder_args=(("noise_res", 4),)),
            "NGPMLP": dict(n_levels=4, log2_hashmap_size=12)}
KEYS = ("means3D", "rgb", "scales", "opacity", "rotations")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(x):
    return jax.tree.map(np.asarray, x)


class _PathSpy:
    """Counts the port's fused calls and GeneralMLP forwards."""

    def __init__(self, monkeypatch):
        self.fused = self.mlp = 0
        fused, forward = port_splatfields.fused_heads, GeneralMLP.forward

        def fused_spy(*args):
            self.fused += 1
            return fused(*args)

        def forward_spy(mlp, *args, **kwargs):
            self.mlp += 1
            return forward(mlp, *args, **kwargs)

        monkeypatch.setattr(port_splatfields, "fused_heads", fused_spy)
        monkeypatch.setattr(GeneralMLP, "forward", forward_spy)


@pytest.mark.parametrize("mode", ["deform", "downstream"])
@pytest.mark.parametrize("encoder", ["VarTriPlaneEncoder", "NGPMLP"])
def test_plans_match_jax(encoder, mode):
    """Published widths: every LayerSpec, n_rows and n_bias."""
    ref = JaxSplatFields(n_frames=0, radius=1.0, encoder_type=encoder,
                         composition_rank=0).bind({})
    port = SplatFields(radius=1.0, encoder_type=encoder,
                       log2_hashmap_size=12,   # the table's size is no input
                       generator=torch.Generator())
    want = jfm.plan_from_module(ref, mode)
    got = fm.plan_from_module(port, mode)
    assert tuple(got) == tuple(want)
    assert got.n_rows == want.n_rows and got.n_bias == want.n_bias
    assert got.feat_dim == {"VarTriPlaneEncoder": 48, "NGPMLP": 16}[encoder]


def _head_tree(plan, seed=0):
    rng = np.random.RandomState(seed)
    return {h.name: {f"net_{i}": {
        "weight": rng.randn(L.fin, L.fout).astype(np.float32) * 0.3,
        "bias": rng.randn(L.fout).astype(np.float32) * 0.1}
        for i, L in enumerate(h.layers)} for h in plan.heads}


@pytest.mark.parametrize("feat_dim", [6, 0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fused_heads_match_jax(dtype, feat_dim):
    """Forward and the gradients of emb, feat, w and b against the JAX
    custom VJP (Pallas interpret mode) on the same packed weights."""
    jdt, tdt = DTYPES[dtype]
    cfgs = [dict(name="a", emb_cols=15, hidden=16, depth=3, skips=(1,),
                 out=3),
            dict(name="b", emb_cols=9, hidden=8, depth=2, skips=(20,), out=4)]
    jplan = jfm.build_plan(cfgs, emb_dim=15, feat_dim=feat_dim)
    plan = fm.build_plan(cfgs, emb_dim=15, feat_dim=feat_dim)
    assert tuple(plan) == tuple(jplan)
    w, b = _tree(jfm.pack_params(_head_tree(jplan), jplan))
    rng = np.random.RandomState(3)
    n = 100
    emb = rng.randn(n, 15).astype(np.float32)
    feat = rng.randn(n, feat_dim).astype(np.float32)
    gs = [rng.randn(n, h.out_dim).astype(np.float32) for h in plan.heads]

    want, vjp = jax.vjp(
        lambda *a: jfm.fused_heads(jplan, 32, jdt, True, *a),
        *map(jnp.asarray, (emb, feat, w, b)))
    want_g = vjp(tuple(map(jnp.asarray, gs)))

    xs = [torch.tensor(x, requires_grad=True) for x in (emb, feat, w, b)]
    got = fm.fused_heads(plan, *xs, tdt)
    got_g = torch.autograd.grad(got, xs, [torch.as_tensor(g) for g in gs],
                                allow_unused=True)
    f32 = dtype == "float32"
    for o, r in zip(got, want):
        np.testing.assert_allclose(
            o.detach().numpy(), np.asarray(r), rtol=0,
            atol=1e-5 if f32 else 1e-4 * float(np.abs(r).max()))
    for name, g, r in zip(("emb", "feat", "w", "b"), got_g, want_g):
        r = np.asarray(r)
        if not r.size:
            continue
        g = np.zeros_like(r) if g is None else g.numpy()
        if f32:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * float(
                np.abs(r).max()), err_msg=name)


def _flax_variables(port, shapes):
    """The port's weights as a flax variable tree shaped like ``shapes``
    (``jax.eval_shape`` of the init, which skips compiling it): interop's
    key mapping, its layouts inverted. load_flax_variables takes the tree
    back, bit for bit."""
    state = port.state_dict()

    def leaf(collection, path, like):
        names = tuple(k.key for k in path)
        key, _ = _convert(names, np.zeros(like.shape), collection)
        v = state[key].numpy()
        if v.ndim == 2 and names[-1] in ("kernel", "weight"):
            v = v.T
        elif v.ndim == 4:
            v = v.transpose((0, 2, 3, 1) if collection == "buffers"
                            else (2, 3, 1, 0))
        assert v.shape == like.shape, names
        return jnp.asarray(v)

    return {c: jax.tree_util.tree_map_with_path(
        lambda path, like, c=c: leaf(c, path, like), tree)
        for c, tree in shapes.items()}


@pytest.fixture(scope="module", params=list(ENCODERS))
def small_nets(request):
    """One small SplatFields of each package per encoder holding the same
    weights (the port's init), fused "on" in both."""
    encoder = request.param
    kw = dict(SMALL, encoder_type=encoder, **ENCODERS[encoder])
    ref = JaxSplatFields(**kw, fused_pallas="on")
    xyz = np.random.RandomState(0).uniform(-0.8, 0.8, (150, 3)).astype(
        np.float32)
    port = SplatFields(**kw, fused_pallas="on",
                       generator=torch.Generator().manual_seed(1))
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(1),
                            jnp.asarray(xyz))
    variables = _flax_variables(port, shapes)
    back = SplatFields(**kw, fused_pallas="on", generator=torch.Generator())
    load_flax_variables(back, _tree(variables))
    assert all(torch.equal(v, port.state_dict()[k])
               for k, v in back.state_dict().items())
    return ref, variables, port, xyz


@pytest.mark.parametrize("mode", ["deform", "downstream"])
def test_pack_params_match_jax(small_nets, mode):
    ref, variables, port, _ = small_nets
    bound = ref.bind(variables)
    jplan = jfm.plan_from_module(bound, mode)
    plan = fm.plan_from_module(port, mode)
    assert tuple(plan) == tuple(jplan)
    want = _tree(jfm.pack_params(variables["params"], jplan))
    got = fm.pack_params(port, plan)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.detach().numpy(), w)
    # unpack_grads takes the packing back to the port's layout
    back = fm.unpack_grads(*got, plan)
    params = dict(port.named_parameters())
    assert back and all(torch.equal(v, params[k]) for k, v in back.items())


def test_splatfields_fused_matches_jax(small_nets, monkeypatch):
    """Outputs and every parameter's gradient of a weighting of all
    outputs, both packages on their fused path."""
    monkeypatch.delenv("SPLATFIELDS_FUSED_MLP", raising=False)
    ref, variables, port, xyz = small_nets
    spy = _PathSpy(monkeypatch)
    got = port(torch.as_tensor(xyz))
    assert (spy.fused, spy.mlp) == (2, 0)
    w = {k: np.random.RandomState(i).randn(*got[k].shape).astype(np.float32)
         for i, k in enumerate(KEYS)}

    def jax_loss(p):
        o = ref.apply(dict(variables, params=p), jnp.asarray(xyz))
        return sum(jnp.sum(o[k] * w[k]) for k in KEYS), o

    (_, want), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        variables["params"])
    want_g = flax_to_state_dict(_tree(want_g))
    for k in KEYS:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=2e-5,
                                   err_msg=k)
    names, leaves = zip(*port.named_parameters())
    loss = sum((got[k] * torch.as_tensor(w[k])).sum() for k in KEYS)
    got_g = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert set(got_g) == set(want_g)
    for k, g in want_g.items():
        np.testing.assert_allclose(got_g[k].numpy(), g.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


# --- one and three training steps, both packages fused -------------------

@pytest.fixture(scope="module")
def runs():
    """tests/test_torch_train.py's harness (64x48, 256 splats, bench.py's
    loss and learning rates, below the 0.99 alpha clamp) with
    SPLATFIELDS_FUSED_MLP=on in both packages, one step. The net has no
    encoder (F = 0), which halves the JAX step's compile time; the
    encoders' fused paths are held by test_splatfields_fused_matches_jax."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPLATFIELDS_FUSED_MLP", "on")
        spy = _PathSpy(mp)
        snaps = train_parity._run(
            "field", hidden=dict(encoder_type="", composition_rank=0),
            steps=(1,))
    assert spy.mlp == 0 and spy.fused > 0
    return "field", snaps


def test_train_loss_and_aux_match(runs):
    train_parity.check_loss_and_aux(runs[1], 1)


def test_train_screen_grad_radii_and_stats_match(runs):
    train_parity.check_screen_grad_radii_and_stats(runs[1], 1)


@pytest.mark.parametrize("tree", ["params", "fparams"])
def test_train_parameters_match(runs, tree):
    train_parity.check_parameters(*runs, 1, tree)


@pytest.mark.parametrize("tree", ["sopt_mu", "sopt_nu", "fopt_mu", "fopt_nu"])
def test_train_adam_states_match(runs, tree):
    train_parity.check_adam_states(runs[1], 1, tree)
