"""Checkpoints of the port, on the CPU.

- ``utils/msgpack.py`` against flax: on a small ``DeformModel``'s
  variables (the MLP-only field, encoder ``""``) and on trees of mixed
  dtypes, the reader against ``flax.serialization.msgpack_restore``, the
  writer's bytes equal to ``flax.serialization.to_bytes`` and read back
  by ``from_bytes``;
- ``deform.msgpack`` across: a JAX-written file loaded into the port
  gives the JAX field's outputs on seeded points, and the reverse, to
  the f32 forward agreement of tests/test_torch_fields.py (1e-5);
- ``interop.module_to_flax`` inverts ``load_flax_variables`` on the
  VarTriPlane net (convs, GroupNorm, the noise buffers);
- ``--resume``: a run saved at iteration 3 and resumed gives iterations
  4-6 (losses, the final PLY and train state) bit for bit as the run
  that never stopped, in field mode (the MLP-only net: the checkpoint
  does not depend on the encoder, and the VarTriPlane decoder's convs
  on the CPU cost most of the run) with densification at 2, 4 and 6.
"""
import random

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from splatfields_torch import config as tcfg
from splatfields_torch import interop
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.train import training
from splatfields_torch.utils import msgpack as mp
from splatfields_tpu import config as jcfg
from splatfields_tpu.models.deform_model import DeformModel as JaxDeformModel

MLP_ONLY = dict(encoder_type="", composition_rank=0)
TOL_FIELD = 1e-5


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
def jax_deform():
    return JaxDeformModel(jcfg.HiddenConfig(**MLP_ONLY), radius=1.0)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_equal(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _tree_equal(a[k], b[k])
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def _mixed_tree():
    rng = np.random.RandomState(0)
    return {"a": {"f32": rng.randn(3, 4).astype(np.float32),
                  "f64": rng.randn(2).astype(np.float64),
                  "f16": rng.randn(5, 1).astype(np.float16)},
            "ints": {"i8": np.array([-3, 4], np.int8),
                     "u8": np.arange(300).astype(np.uint8),
                     "i64": np.array(2**40, np.int64)},
            "bool": np.array([True, False]),
            "scalar": np.float32(1.5), "big": np.zeros((70, 300), np.int32),
            "empty": np.zeros((0, 3), np.float32)}


@pytest.mark.parametrize("which", ["deform", "mixed"])
def test_msgpack_against_flax(jax_deform, which):
    tree = (_numpy_tree(jax_deform.variables) if which == "deform"
            else _mixed_tree())
    flax_bytes = flax.serialization.to_bytes(tree)
    _tree_equal(mp.flax_from_bytes(flax_bytes),
                flax.serialization.msgpack_restore(flax_bytes))
    ours = mp.flax_to_bytes(tree)
    assert ours == flax_bytes
    _tree_equal(flax.serialization.from_bytes(tree, ours), tree)
    assert mp.unpackb(mp.packb({"k": [1, -2, 3.5, "s", b"b", None, True]})) \
        == {"k": [1, -2, 3.5, "s", b"b", None, True]}


def _field_outputs_close(jax_vars, jax_net, port_net):
    pts = np.random.RandomState(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    want = jax_net.apply(jax_vars, jnp.asarray(pts))
    with torch.no_grad():
        got = port_net(torch.from_numpy(pts))
    for k in ("means3D", "rgb", "opacity", "scales", "rotations"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=TOL_FIELD, atol=TOL_FIELD,
                                   err_msg=k)


def test_deform_msgpack_across(jax_deform, tmp_path):
    path = str(tmp_path)
    jax_deform.save_weights(path, 7)
    port = DeformModel(tcfg.HiddenConfig(**MLP_ONLY), radius=1.0, seed=5,
                       device="cpu")
    assert port.load_weights(path) == 7
    _field_outputs_close(jax_deform.variables, jax_deform.net, port.net)

    other = DeformModel(tcfg.HiddenConfig(**MLP_ONLY), radius=1.0, seed=9,
                        device="cpu")
    other.save_weights(path, 11)
    jax_deform.load_weights(path, 11)
    _field_outputs_close(jax_deform.variables, jax_deform.net, other.net)


def test_module_to_flax_inverts_the_loader():
    hidden = tcfg.HiddenConfig(encoder_type="VarTriPlaneEncoder",
                               composition_rank=0,
                               encoder_args={"noise_res": 4})
    a = DeformModel(hidden, radius=1.0, seed=0, device="cpu")
    b = DeformModel(hidden, radius=1.0, seed=1, device="cpu")
    tree = mp.flax_from_bytes(mp.flax_to_bytes(interop.module_to_flax(a.net)))
    assert "buffers" in tree and "encoder" in tree["params"]
    interop.load_flax_variables(b.net, tree)
    sa, sb = a.net.state_dict(), b.net.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    return chip_smoke.write_blender_scene(
        tmp_path_factory.mktemp("data"), 32, 5, [0.3], torch.device("cpu"))


def _run(scene_dir, model_path, iterations, resume=False):
    argv = ["-s", scene_dir, "-m", model_path, "--white_background",
            "--eval", "--n_views", "4", "--pts_samples", "random",
            "--num_pts", "200", "--load_time_step", "0",
            "--composition_rank", "0", "--encoder_type", "",
            "--lambda_norm", "0.01",
            "--tile_cap", "128", "--k_chunk", "32",
            "--iterations", str(iterations), "--densify_from_iter", "1",
            "--densification_interval", "2", "--densify_grad_threshold",
            "0"]
    args = tcfg.build_parser().parse_args(argv)
    model, pipe, hidden, opt = tcfg.extract_configs(args)
    losses = {}
    res = training(model, hidden, opt, pipe, [], [3, 6], quiet=True,
                   resume=resume, rng=random.Random(0), device="cpu",
                   progress_callback=lambda it, loss, p, s: losses.setdefault(
                       it, loss))
    return losses, res


def test_resume_continues_bit_for_bit(scene_dir, tmp_path):
    whole, res = _run(scene_dir, str(tmp_path / "whole"), 6)
    first, _ = _run(scene_dir, str(tmp_path / "split"), 3)
    rest, resumed = _run(scene_dir, str(tmp_path / "split"), 6, resume=True)
    assert sorted(first) == [1, 2, 3] and sorted(rest) == [4, 5, 6]
    assert {**first, **rest} == whole
    assert (res.start_iteration, resumed.start_iteration) == (1, 4)
    assert [d[0] for d in res.densified] == [2, 4, 6]
    assert [d[0] for d in resumed.densified] == [4, 6]
    for rel in ("point_cloud/iteration_6/point_cloud.ply",
                "deform/iteration_6/deform.msgpack",
                "train_state/iteration_6/meta.json"):
        with open(tmp_path / "whole" / rel, "rb") as f1, \
                open(tmp_path / "split" / rel, "rb") as f2:
            assert f1.read() == f2.read(), rel
    state = torch.load(tmp_path / "split" / "train_state" / "iteration_6" /
                       "state.pt", weights_only=True)
    assert state["splat_params"]["xyz"].shape[0] > 200  # capacity grew
    assert state["field_opt"]["count"] == 6
