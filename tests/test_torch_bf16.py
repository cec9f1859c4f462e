"""The JAX package's two bf16 defaults in the port, on the CPU:
``SPLATFIELDS_MLP_BF16`` (bf16 activations between the MLP layers) and
``SPLATFIELDS_NGP_BF16_TABLE`` (the hash grid gathers from a bf16 copy of
its table). tests/conftest.py pins the MLP option off for the suite;
these tests set both options in both packages themselves.

The MLP, ``on``: a small static SplatFields (every head, skips included)
with the port's weights carried to JAX (``interop.module_to_flax``),
outputs and every parameter's gradient of sum(out * cot). Both packages
round at the same points (the input once, each layer's f32 activation to
bf16, the weight to bf16, the last output back to f32), and each product
of two bf16 values is exact in f32, so only the order of the f32 sums
differs (~1e-7 relative). Where a sum lies that close to a bf16 rounding
boundary the two round to neighbouring values, one bf16 step (2^-8
relative) apart, and the step carries into that point's later layers.
The bound is therefore two bf16 steps of each tensor's scale,
2^-7 * max|JAX value|, for every element of the outputs and of the
gradients. A flip is rare, and it moves only its own point's outputs, so
at least 99% of the output elements also agree within 1e-5 of the
scale; a parameter's gradient sums every point's cotangent, so one flip
anywhere moves all of it by ~2^-8 / N, and the gradients are held to the
bound alone. The bf16 outputs must also differ from the port's f32 ones
by more than 1e-4 of the scale: the option took effect.

The table, ``on``: a 4-level hash grid whose table holds N(0, 1) values
(so that bf16 rounding, 2^-9 relative, shows), the features against
JAX's sorted-gather path (``SPLATFIELDS_NGP_SORTED_GRAD=on``, the path
that reads the bf16 copy): both gather the same bf16 values, so they
agree within 1e-6. The table gradient stays f32: it is the f32 gather's
transpose (the sorted segment sum that tests/test_torch_ngp.py holds
against both JAX VJPs) applied to the same cotangent, within its rtol
1e-5, atol 1e-6.

``auto``: the MLP rule is JAX's (bf16 for ``n_frames == 0``, f32 for
4-D), and the table rule is on for CUDA tensors, off for CPU ones.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatfields_torch.interop import (
    flax_to_state_dict,
    load_flax_variables,
    module_to_flax,
)
from splatfields_torch.models import encoders
from splatfields_torch.models.mlp import mlp_bf16
from splatfields_torch.models.splatfields import SplatFields
from splatfields_tpu.models import encoders as jax_encoders
from splatfields_tpu.models.splatfields import SplatFields as JaxSplatFields

STATIC_NET = dict(
    n_frames=0, encoder_type="", composition_rank=0, deform_w=16,
    deform_d=3, deform_skips=(1,), rgb_w=16, rgb_d=3, rgb_skips=(1,),
    scale_w=16, scale_d=2, scale_skips=(1,), opacity_w=16, opacity_d=2,
    opacity_skips=(1,), rotation_w=16, rotation_d=2)
OUT_KEYS = ("scales", "opacity", "rotations", "rgb", "means3D")
NQ = 300
BF16_STEPS = 2.0 ** -7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_bf16(got: np.ndarray, want: np.ndarray, what: str,
                per_point: bool = True):
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert err.max() <= BF16_STEPS * scale, (what, err.max(), scale)
    if per_point:
        assert np.mean(err <= 1e-5 * scale) >= 0.99, (what, np.mean(
            err <= 1e-5 * scale))


def test_mlp_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("SPLATFIELDS_MLP_BF16", "on")
    pnet = SplatFields(**STATIC_NET,
                       generator=torch.Generator().manual_seed(0))
    jnet = JaxSplatFields(**STATIC_NET, encoder_args=())
    variables = module_to_flax(pnet)
    rng = np.random.RandomState(7)
    xyz = rng.uniform(-0.9, 0.9, (NQ, 3)).astype(np.float32)
    cots = {k: rng.randn(NQ, {"opacity": 1, "rotations": 4}.get(k, 3))
            .astype(np.float32) for k in OUT_KEYS}

    @jax.jit
    def fwd_grads(params):
        def loss(p):
            out = jnet.apply(dict(variables, params=p), xyz)
            return sum(jnp.sum(out[k] * cots[k]) for k in OUT_KEYS), out
        return jax.grad(loss, has_aux=True)(params)

    g, want_out = fwd_grads(variables["params"])
    got = pnet(torch.as_tensor(xyz))
    for k in OUT_KEYS:
        _check_bf16(got[k].detach().numpy(), np.asarray(want_out[k]), k)
    total = sum((got[k] * torch.as_tensor(cots[k])).sum() for k in OUT_KEYS)
    names, leaves = zip(*pnet.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(total, leaves,
                                                allow_unused=True)))
    want = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, g)).items()}
    assert set(want) == set(names)
    for k, w in want.items():
        _check_bf16(grads[k].numpy(), w, k, per_point=False)
    # the option took effect: f32 moves the outputs
    monkeypatch.setenv("SPLATFIELDS_MLP_BF16", "off")
    with torch.no_grad():
        f32 = pnet(torch.as_tensor(xyz))
    scale = max(float(f32[k].abs().max()) for k in OUT_KEYS)
    assert max(float((f32[k] - got[k].detach()).abs().max())
               for k in OUT_KEYS) > 1e-4 * scale


@pytest.mark.parametrize("env,n_frames,want", [
    ("auto", 0, True), ("auto", 4, False), ("on", 4, True),
    ("off", 0, False), ("garbage", 0, True), (None, 4, False)])
def test_mlp_bf16_rule(monkeypatch, env, n_frames, want):
    """JAX ``models/mlp.py``'s rule: on/off, and anything else is auto."""
    if env is None:
        monkeypatch.delenv("SPLATFIELDS_MLP_BF16", raising=False)
    else:
        monkeypatch.setenv("SPLATFIELDS_MLP_BF16", env)
    assert mlp_bf16(n_frames) is want


@pytest.mark.parametrize("env,cuda,want", [
    ("auto", False, False), ("auto", True, True), ("on", False, True),
    ("off", True, False), (None, True, True)])
def test_table_bf16_rule(monkeypatch, env, cuda, want):
    if env is None:
        monkeypatch.delenv("SPLATFIELDS_NGP_BF16_TABLE", raising=False)
    else:
        monkeypatch.setenv("SPLATFIELDS_NGP_BF16_TABLE", env)
    assert encoders.ngp_bf16_table(types.SimpleNamespace(is_cuda=cuda)) \
        is want


def test_table_bf16_matches_jax(monkeypatch):
    monkeypatch.setenv("SPLATFIELDS_NGP_BF16_TABLE", "on")
    monkeypatch.setenv("SPLATFIELDS_NGP_SORTED_GRAD", "on")
    enc = jax_encoders.HashGridEncoder(n_levels=4, log2_hashmap_size=12)
    port = encoders.HashGridEncoder(n_levels=4, log2_hashmap_size=12,
                                    generator=torch.Generator())
    table = np.random.RandomState(4).randn(4, 2 ** 12, 2).astype(np.float32)
    load_flax_variables(port, {"params": {"table": table}})
    pts = np.random.RandomState(5).uniform(0, 1, (256, 3)).astype(np.float32)
    w = np.random.RandomState(6).randn(256, 8).astype(np.float32)

    want = jax.jit(lambda t, p: enc.apply({"params": {"table": t}}, p))(
        jnp.asarray(table), jnp.asarray(pts))
    feats = port(torch.as_tensor(pts))
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    out = (torch.tanh(feats) * torch.as_tensor(w)).sum()
    g_feats, got = torch.autograd.grad(out, [feats, port.table])
    assert got.dtype == torch.float32
    monkeypatch.setenv("SPLATFIELDS_NGP_BF16_TABLE", "off")
    f32 = port(torch.as_tensor(pts))
    (want_grad,) = torch.autograd.grad(f32, port.table, g_feats)
    np.testing.assert_allclose(got.numpy(), want_grad.numpy(), rtol=1e-5,
                               atol=1e-6)
    # the bf16 source took effect: the f32 gather moves the features
    with torch.no_grad():
        f32 = port(torch.as_tensor(pts))
    assert float((f32 - feats.detach()).abs().max()) > 1e-4
