"""The port's NGP variant (hash grid, NGPMLP, SplatFields with
``encoder_type="NGPMLP"``, the training step) against the JAX package on
the CPU, with the JAX weights carried across by ``load_flax_variables``.

Sizes: 4 levels; 2^14 rows per level where the hash ids are compared
(levels 0-1 dense, 2-3 hashed), 2^12 elsewhere (all hashed, and the
interpret-mode Pallas grid stays short). Everything runs in f32.

The table gradient: the JAX package on the CPU takes autograd's scatter
(``SPLATFIELDS_NGP_SORTED_GRAD`` auto), or with the knob on the sort +
Pallas segment sum in interpret mode; the port, with the knob on, sorts
the ids with the gradient rows and sums them with
``ops/segsum.sorted_segment_sum`` (its plain version on CPU tensors), and
under ``auto`` takes the scatter on the CPU as JAX does. All three add the same terms per row in
other orders: rtol 1e-5, atol 1e-6 (tests/test_fields.py's tolerance for
the two JAX VJPs). The net's outputs and other gradients agree like the
VarTriPlane net's (tests/test_torch_fields.py): 1e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.test_torch_train as train_parity
from splatfields_torch import config
from splatfields_torch.interop import flax_to_state_dict, load_flax_variables
from splatfields_torch.models import encoders
from splatfields_torch.models.deform_model import DeformModel
from splatfields_tpu import config as jax_config
from splatfields_tpu.models import encoders as jax_encoders
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel

N = 256
SMALL = dict(encoder_type="NGPMLP", composition_rank=0, n_levels=4,
             log2_hashmap_size=12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(seed, n=N, lo=0.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _tree(variables):
    return jax.tree.map(np.asarray, dict(variables))


def _hash_pair(log2_size, seed=0):
    enc = jax_encoders.HashGridEncoder(n_levels=4,
                                       log2_hashmap_size=log2_size)
    v = enc.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)))
    port = encoders.HashGridEncoder(n_levels=4, log2_hashmap_size=log2_size,
                                    generator=torch.Generator())
    load_flax_variables(port, _tree(v))
    return enc, v, port


def test_hash_ids_match_jax(monkeypatch):
    """The corner ids of every level, dense and hashed, equal the JAX ids
    (taken from the sorted-gather path, which receives them)."""
    enc, v, port = _hash_pair(14)
    assert port.dense.tolist() == [True, True, False, False]
    pts = _points(1)
    pts[:2] = [[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]   # the box's corners
    captured = []
    make_gather = jax_encoders._leveled_sorted_gather

    def spy(*args):
        gather = make_gather(*args)

        def call(table, idx):
            captured.append(np.asarray(idx))
            return gather(table, idx)
        return call

    monkeypatch.setenv("SPLATFIELDS_NGP_SORTED_GRAD", "on")
    monkeypatch.setattr(jax_encoders, "_leveled_sorted_gather", spy)
    enc.apply(v, jnp.asarray(pts))
    ids, _ = port.corner_ids(torch.as_tensor(pts))
    assert ids.dtype == torch.int32 and ids.shape == (4, N, 8)
    np.testing.assert_array_equal(ids.reshape(4, -1).numpy(), captured[0])
    assert int(ids.max()) < 2 ** 14


@pytest.mark.parametrize("log2_size", [12, 14])
def test_hash_features_match_jax(log2_size):
    enc, v, port = _hash_pair(log2_size, seed=2)
    pts = _points(3)
    want = np.asarray(enc.apply(v, jnp.asarray(pts)))
    with torch.no_grad():
        got = port(torch.as_tensor(pts)).numpy()
    assert got.shape == want.shape == (N, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("jax_vjp", ["scatter", "pallas"])
def test_table_grad_matches_jax(monkeypatch, jax_vjp):
    """d sum(tanh(enc(pts)) * w) / d table against the JAX VJP: the
    scatter (knob off) or the Pallas segment sum in interpret mode (knob
    on); and the port's gradient goes through one segment sum (the port
    reads ``SPLATFIELDS_NGP_SORTED_GRAD`` when the encoder is built: on,
    its sorted route; ``auto`` would take the scatter on the CPU, as JAX
    does)."""
    monkeypatch.setenv("SPLATFIELDS_NGP_SORTED_GRAD", "on")
    enc, v, port = _hash_pair(12, seed=4)
    pts = _points(5)
    w = np.random.RandomState(6).randn(N, 8).astype(np.float32)
    monkeypatch.setenv("SPLATFIELDS_NGP_SORTED_GRAD",
                       "off" if jax_vjp == "scatter" else "on")

    def loss(params):
        return jnp.sum(jnp.tanh(enc.apply({"params": params},
                                          jnp.asarray(pts))) * w)

    want = np.asarray(jax.grad(loss)(v["params"])["table"])
    calls = []
    segsum = encoders.sorted_segment_sum

    def spy(sidx, vals, n_rows):
        calls.append((sidx, n_rows))
        return segsum(sidx, vals, n_rows)

    monkeypatch.setattr(encoders, "sorted_segment_sum", spy)
    out = (torch.tanh(port(torch.as_tensor(pts))) * torch.as_tensor(w)).sum()
    (got,) = torch.autograd.grad(out, port.table)
    (sidx, n_rows), = calls
    assert n_rows == 4 * 2 ** 12 and sidx.shape == (4 * N * 8,)
    assert bool((sidx[1:] >= sidx[:-1]).all())
    assert got.shape == want.shape == (4, 2 ** 12, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.count_nonzero(want) > 0


@pytest.mark.parametrize("contract", [False, True])
def test_ngp_mlp_matches_jax(contract):
    """NGPMLP with points inside and outside the radius: outputs and every
    parameter's gradient."""
    m = jax_encoders.NGPMLP(out_features=16, n_levels=4, log2_hashmap_size=12,
                            radius=1.0, contract=contract)
    pts = _points(7, lo=-1.6, hi=1.6)
    assert (np.linalg.norm(pts, axis=1) > 1.0).any()
    v = m.init(jax.random.PRNGKey(7), jnp.asarray(pts))
    port = encoders.NGPMLP(out_features=16, n_levels=4, log2_hashmap_size=12,
                           radius=1.0, contract=contract,
                           generator=torch.Generator())
    load_flax_variables(port, _tree(v))
    w = np.random.RandomState(8).randn(N, 16).astype(np.float32)

    def loss(params):
        return jnp.sum(m.apply({"params": params}, jnp.asarray(pts)) * w)

    want_out = np.asarray(m.apply(v, jnp.asarray(pts)))
    want = flax_to_state_dict(_tree(jax.grad(loss)(v["params"])))
    out = port(torch.as_tensor(pts))
    np.testing.assert_allclose(out.detach().numpy(), want_out, rtol=1e-5,
                               atol=1e-5)
    names, leaves = zip(*port.named_parameters())
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), leaves)
    assert set(names) == set(want) == {
        "encoding.table", "hidden_0.weight", "hidden_0.bias", "out.weight",
        "out.bias"}
    for k, g in zip(names, grads):
        scale = float(want[k].abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(g.numpy() / scale, want[k].numpy() / scale,
                                   rtol=0, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def models():
    ref = JaxDeformModel(jax_config.HiddenConfig(**SMALL), radius=1.0, seed=0)
    tree = _tree(ref.variables)
    port = DeformModel(config.HiddenConfig(**SMALL), radius=1.0, seed=1,
                       device="cpu")
    load_flax_variables(port.net, tree)
    return ref, port, tree


def test_splatfields_ngp_builds(models):
    _, port, tree = models
    net = port.net
    assert isinstance(net.encoder, encoders.NGPMLP)
    assert net.feat_dim == 16 and net.refine0.weight.shape == (16, 16)
    assert port.params["encoder.encoding.table"].shape == (4, 2 ** 12, 2)
    assert "table" in tree["params"]["encoder"]["encoding"]


def test_splatfields_ngp_outputs_match(models):
    ref, port, _ = models
    x = _points(9, lo=-0.9, hi=0.9)
    want = ref.net.apply(ref.variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.net(torch.as_tensor(x))
    for key in ("means3D", "scales", "opacity", "rotations", "rgb"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def test_splatfields_ngp_param_grads_match(models):
    """Every parameter's gradient of a random weighting of all heads'
    outputs against ``jax.grad`` (the scatter VJP for the table). The
    weights are the init plus noise (0.05, far above the table's 1e-4
    init), so that the hash features reach the heads."""
    ref, _, tree = models
    rng = np.random.RandomState(10)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        tree["params"])
    variables = dict(ref.variables, params=jax.tree.map(jnp.asarray, params))
    port = DeformModel(config.HiddenConfig(**SMALL), radius=1.0,
                       device="cpu")
    load_flax_variables(port.net, dict(tree, params=params))
    x = _points(11, lo=-0.9, hi=0.9)
    keys = ("means3D", "scales", "opacity", "rotations", "rgb")
    with torch.no_grad():
        dims = {k: v.shape[1] for k, v in port.net(torch.as_tensor(x)).items()
                if k in keys}
    w = {k: rng.randn(N, d).astype(np.float32) for k, d in dims.items()}

    def jax_loss(p):
        out = ref.net.apply(dict(variables, params=p), jnp.asarray(x))
        return sum(jnp.sum(out[k] * w[k]) for k in keys)

    want = flax_to_state_dict(_tree(jax.grad(jax_loss)(variables["params"])))
    names, leaves = zip(*port.net.named_parameters())
    out = port.net(torch.as_tensor(x))
    loss = sum((out[k] * torch.as_tensor(w[k])).sum() for k in keys)
    got = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert set(got) == set(want)
    for k, g in want.items():
        scale = float(g.abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy() / scale, g.numpy() / scale,
                                   rtol=0, atol=1e-5, err_msg=k)


# --- the training step: 1 and 3 steps of both packages' make_train_step ---

@pytest.fixture(scope="module")
def runs():
    """tests/test_torch_train.py's harness (64x48, bench.py's loss and
    learning rates, non-zero Adam states, scenes below the 0.99 alpha
    clamp) with the small NGP net and 2,000 splats."""
    return "ngp", train_parity._run("ngp", hidden=SMALL, n=2000)


@pytest.mark.parametrize("after", train_parity.STEPS)
def test_train_loss_and_aux_match(runs, after):
    train_parity.check_loss_and_aux(runs[1], after)


@pytest.mark.parametrize("after", train_parity.STEPS)
def test_train_screen_grad_radii_and_stats_match(runs, after):
    train_parity.check_screen_grad_radii_and_stats(runs[1], after)


@pytest.mark.parametrize("after", train_parity.STEPS)
@pytest.mark.parametrize("tree", ["params", "fparams"])
def test_train_parameters_match(runs, after, tree):
    train_parity.check_parameters(*runs, after, tree)


@pytest.mark.parametrize("after", train_parity.STEPS)
@pytest.mark.parametrize("tree", ["sopt_mu", "sopt_nu", "fopt_mu", "fopt_nu"])
def test_train_adam_states_match(runs, after, tree):
    train_parity.check_adam_states(runs[1], after, tree)
