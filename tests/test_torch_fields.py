"""The port's field stack against the JAX package on the CPU, with the JAX
weights carried across by ``interop.load_flax_variables``.

Small size: VarTriPlane noise 8x4x4 -> planes 16x32x32, default head
widths, N = 256 points made with numpy from a seed. Everything runs in
f32 (tests/conftest.py pins the JAX MLP to f32); the two frameworks order
their convolution, GroupNorm and matmul sums differently, so outputs agree
to ~1e-6 relative; the tolerances (1e-5 relative, 1e-5 to 1e-4 absolute
through the 20-layer CNN) leave room for that and no more.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splatfields_tpu import config as jax_config
from splatfields_tpu.models import splats as jax_splats
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel
from splatfields_torch import config
from splatfields_torch.interop import flax_to_state_dict, load_flax_variables
from splatfields_torch.models import splats
from splatfields_torch.models.deform_model import DeformModel

N = 256
ENC = {"noise_res": 4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: the suite runs several workers
    on the CPU's cores, and a full torch thread pool in each worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jax_hidden = jax_config.HiddenConfig(
        encoder_type="VarTriPlaneEncoder", composition_rank=0,
        encoder_args=ENC)
    ref = JaxDeformModel(jax_hidden, radius=1.0, seed=0)
    tree = jax.tree.map(np.asarray, dict(ref.variables))
    hidden = config.HiddenConfig(encoder_type="VarTriPlaneEncoder",
                                 composition_rank=0, encoder_args=ENC)
    port = DeformModel(hidden, radius=1.0, seed=1, device="cpu")
    load_flax_variables(port.net, tree)
    return ref, port, tree


def _points(seed=0):
    return np.random.RandomState(seed).uniform(-0.9, 0.9, (N, 3)).astype(
        np.float32)


def test_planes_match(models):
    ref, port, _ = models
    want = ref.net.apply(ref.variables, method=type(ref.net).generate_planes)
    with torch.no_grad():
        got = port.net.generate_planes()
    assert got.shape == (3, 16, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_encoder_features_match(models):
    ref, port, _ = models
    x = _points(1)
    want = ref.net.apply(ref.variables, jnp.asarray(x), None,
                         method=type(ref.net).extract_features)
    with torch.no_grad():
        got = port.net.extract_features(torch.as_tensor(x))
    assert got.shape == (N, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_splatfields_outputs_match(models):
    ref, port, _ = models
    x = _points(2)
    want = ref.net.apply(ref.variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.net(torch.as_tensor(x))
    for key in ("means3D", "scales", "opacity", "rotations", "rgb"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


def _drop(tree, path):
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
    node = out
    for k in path[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    del node[path[-1]]
    return out


@pytest.mark.parametrize("fault", ["missing", "unused", "shape"])
def test_load_is_strict(models, fault):
    _, port, tree = models
    if fault == "missing":
        bad = _drop(tree, ("params", "refine0", "bias"))
        err = KeyError
    elif fault == "unused":
        bad = dict(tree, params=dict(tree["params"],
                                     extra={"bias": np.zeros(3, np.float32)}))
        err = KeyError
    else:
        bad = dict(tree, params=dict(tree["params"], refine1=dict(
            tree["params"]["refine1"], bias=np.zeros(7, np.float32))))
        err = ValueError
    with pytest.raises(err):
        load_flax_variables(port.net, bad)


def test_create_from_pcd_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-0.9, 0.9, (300, 3)).astype(np.float32)
    cols = rng.rand(300, 3).astype(np.float32)
    want, want_stats = jax_splats.create_from_pcd(pts, cols, 1, capacity=320)
    got, stats = splats.create_from_pcd(pts, cols, 1, capacity=320,
                                        device="cpu")
    for name in ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity"):
        # scaling = log sqrt of a KNN distance from a matmul expansion:
        # ulp-level differences, 1e-5 absolute in log space
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(stats.valid.numpy(),
                                  np.asarray(want_stats.valid))


def test_param_grads_match_jax(models):
    """Every parameter's gradient of one scalar loss over all heads (a
    fixed random weighting of the outputs, planes generated inside the
    call as the train step does) against ``jax.grad``. The weights are
    the init plus noise, so that the zero-initialised layers (each
    resnet's conv2, the attention's output) pass gradients on. Per leaf,
    over the leaf's largest gradient: 1e-4 (the backward sums over 256
    points and the CNN's pixels in another order). Some biases have a zero
    gradient up to rounding in both packages: a conv bias before a
    GroupNorm of one channel per group is subtracted again, and the
    attention's key bias adds one logit to every key of a query, which
    the softmax ignores. So a bias is held against the larger of its own
    and its layer's weight gradient."""
    ref, _, tree = models
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.randn(*a.shape)).astype(np.float32),
        tree["params"])
    variables = dict(ref.variables, params=jax.tree.map(jnp.asarray, params))
    port = DeformModel(config.HiddenConfig(
        encoder_type="VarTriPlaneEncoder", composition_rank=0,
        encoder_args=ENC), radius=1.0, device="cpu")
    load_flax_variables(port.net, dict(tree, params=params))
    x = _points(3)
    keys = ("means3D", "scales", "opacity", "rotations", "rgb")
    with torch.no_grad():
        dims = {k: v.shape[1] for k, v in port.net(torch.as_tensor(x)).items()
                if k in keys}
    w = {k: rng.randn(N, d).astype(np.float32) for k, d in dims.items()}

    def jax_loss(p):
        out = ref.net.apply(dict(variables, params=p), jnp.asarray(x))
        return sum(jnp.sum(out[k] * w[k]) for k in keys)

    want = flax_to_state_dict(jax.tree.map(
        np.asarray, jax.jit(jax.grad(jax_loss))(variables["params"])))
    names, leaves = zip(*port.net.named_parameters())
    out = port.net(torch.as_tensor(x))
    loss = sum((out[k] * torch.as_tensor(w[k])).sum() for k in keys)
    got = dict(zip(names, torch.autograd.grad(loss, leaves)))
    assert set(got) == set(want)
    for k, g in want.items():
        scale = float(g.abs().max())
        if k.endswith(".bias"):
            scale = max(scale, float(want[k[:-4] + "weight"].abs().max()))
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy() / scale, g.numpy() / scale,
                                   rtol=0, atol=1e-4, err_msg=k)
