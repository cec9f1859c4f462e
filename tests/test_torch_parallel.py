"""The port's multi-device step (``splatfields_torch/parallel``) on the CPU:
one gloo world of 4 processes against the single-device step.

The cases are the JAX package's sharded-step tests
(``tests/test_metrics_and_render.py::TestShardedStep``) on 4 ranks in
place of 8 devices: field mode over ``data x model`` 1x4 (loss,
parameters and the densification statistics) and 2x2 (loss and
parameters: with two data rows the statistics average each row's last
view, the documented deviation), 4-D with ``n_frames=4`` (2x2), the
``--corr_interval`` gate, static SH degree 1, the ring exchange in field
and static mode (1x4), and the on-mesh densify. The inputs are the JAX
tests': 128 splats from ``create_from_pcd``, 32x32, two views with
different cameras and images, ``lambda_mask`` 0.1, ``lambda_norm`` 0.01,
``tile_cap`` 64. The world runs once for the module (``world``): it
meets through a ``FileStore`` under the test's temporary directory (no
ports to race for between xdist workers), pins each rank to one thread,
and is killed if it has not ended in ``WORLD_TIMEOUT_S``. Rank 0 gathers
every case's whole state; the single-device steps are shared out over
the ranks, and each writes one npz a case, sharded and single-device.

Tolerances are the JAX tests': loss within 1e-4, parameters within 2e-5
absolute and 1e-4 relative, ``max_radii2d`` exact, the densify within
1e-6. The sharded step sums its gradients over the ranks in another
order than the single-device step, so only these tolerances, not bits,
hold. Both Adam states start from tests/test_torch_train.py's non-zero
moments (count 10): from zero moments the first update is
lr g / (|g| + 1e-15), which turns a gradient at the rounding noise into
an update of up to lr (the 4-D case's flow head has 139 of 89,088
gradients under 1e-12, where the two summation orders differ by up to
1e-12), so the zero-state step holds no tolerance in any order.

The 2x2 field case is also held against the JAX package's single-device
step on the same numpy inputs and weights (the port's net carried across
with ``interop.module_to_flax``), at the same tolerances: the parity of
the slice as a whole. That step runs in the test's own process while the
world runs. JAX's own sharded step is not run here.

The train CLI on the mesh: inside the world every rank calls
``train.main`` with ``--mesh_model 4`` (the world's process group, no
spawn) on a 32x32 Blender scene, 300 random points, 4 iterations with
densify at 2 and 4, then ``--resume`` to 6; rank 0 runs the same two
command lines without a mesh. Every iteration's loss agrees within 1e-5
relative (the repo's criterion for two runs of one loop), the densify
rounds at 2 and 4 keep as many splats, and rank 0 alone wrote the run.
The round at 6 compares each splat's summed screen gradient with a
threshold, and the two runs sum it in other orders: it may differ by a
splat near the threshold (2 of 724 here), within 1%. A run from
301 points holds a capacity rounded up to 304 (a rounded capacity draws
other densify noise, so it is not held to the run without a mesh).

The mesh flags of the train CLI: its refusals (``--n_splats`` on a mesh,
a one-view batch over two data rows), and too few local GPUs for a
spawned mesh.
"""
import copy
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from splatfields_torch import config, train_lib
from splatfields_torch.models import splats
from splatfields_torch.models.deform_model import DeformModel
from splatfields_torch.utils import camera_math as cm

W = H = 32
V = 2
N = 128
WORLD = 4
WORLD_TIMEOUT_S = 240
SPLAT_LRS = (1.6e-4, 2.5e-3, 0.05, 1e-3, 1e-3)
FIELD_LR = 1e-3
# name: (field mode, SH degree, n_frames, data rows, ring, corr gate)
CASES = {
    "field_4d": (True, 0, 4, 2, False, False),
    "field_model": (True, 0, 0, 1, False, False),
    "corr_gate": (False, 0, 0, 1, False, True),
    "field_data_model": (True, 0, 0, 2, False, False),
    "static_sh1": (False, 1, 0, 1, False, False),
    "ring_field": (True, 0, 0, 1, True, False),
    "ring_static": (False, 1, 0, 1, True, False),
}
# the cases whose statistics must equal the single-device step's (one
# data row)
STATS_CASES = ("field_model", "static_sh1", "ring_field")


def scene_inputs():
    """The JAX tests' numpy inputs: the tiny scene's 128 means, two
    cameras at z 4.0 and 4.3, two random images and masks."""
    means = np.random.RandomState(0).uniform(-0.8, 0.8, (N, 3)).astype(
        np.float32)
    rng = np.random.RandomState(7)
    cams = []
    for dz in (4.0, 4.3):
        w2v = cm.get_world2view(np.eye(3, dtype=np.float32),
                                np.array([0.1, -0.05, dz], np.float32)).T
        proj = cm.get_projection_matrix(0.01, 100.0, 0.8, 0.8).T
        cams.append((w2v, (w2v @ proj).astype(np.float32),
                     np.linalg.inv(w2v.T)[:3, 3].astype(np.float32)))
    tanfov = np.float32(np.tan(0.4))
    return {
        "means": means,
        "viewmatrix": np.stack([c[0] for c in cams]),
        "projmatrix": np.stack([c[1] for c in cams]),
        "campos": np.stack([c[2] for c in cams]),
        "tanfovx": np.full((V,), tanfov, np.float32),
        "tanfovy": np.full((V,), tanfov, np.float32),
        "image": rng.rand(V, 3, H, W).astype(np.float32),
        "mask": (rng.rand(V, 1, H, W) > 0.5).astype(np.float32),
    }


def hidden_cfg(n_frames=0):
    return config.HiddenConfig(encoder_type="none",
                               composition_rank=4 if n_frames else 0,
                               n_frames=n_frames, flow_model="offset")


def moments(tree, seed) -> splats.AdamState:
    """An Adam state at count 10 with seeded non-zero moments (those of
    tests/test_torch_train.py) for a tree of tensors."""
    rng = np.random.RandomState(seed)
    mu, nu = {}, {}
    for k, v in splats.tree_items(tree).items():
        mu[k] = torch.as_tensor(rng.randn(*v.shape).astype(np.float32)
                                * 1e-3)
        nu[k] = torch.as_tensor(rng.uniform(0.5, 1.5, v.shape).astype(
            np.float32) * 1e-6)
    return splats.AdamState(count=10, mu=splats.tree_like(tree, mu),
                            nu=splats.tree_like(tree, nu))


def setup(inputs, field, sh_degree=0, n_frames=0, corr=False):
    """(params, stats, splat Adam, DeformModel or None, opt, pipe, batch)
    on the CPU, as the JAX tests' ``_setup``; the Adam states carry
    ``moments``."""
    m = inputs["means"]
    params, stats = splats.create_from_pcd(m, np.abs(m), sh_degree,
                                           capacity=N, device="cpu")
    deform = None
    if field:
        deform = DeformModel(hidden_cfg(n_frames), radius=1.0, seed=0,
                             device="cpu")
        deform.opt_state = moments(deform.params, 2)
    opt = config.OptimizationConfig(lambda_mask=0.1, lambda_norm=0.01)
    if corr:
        opt = config.OptimizationConfig(lambda_mask=0.1, lambda_norm=0.01,
                                        lambda_corr=0.01, corr_interval=2)
    batch = {k: torch.as_tensor(inputs[k]) for k in
             ("viewmatrix", "projmatrix", "campos", "image", "mask")}
    batch.update(tanfovx=inputs["tanfovx"], tanfovy=inputs["tanfovy"],
                 fid=0.4 if n_frames else 0.0, bg=torch.ones(3),
                 depth=torch.zeros(V, 1, 1))
    if corr:
        batch["corr_gate"] = True
    return (params, stats, moments(params, 1), deform, opt,
            config.PipelineConfig(tile_cap=64, k_chunk=32), batch)


def densify_inputs(params, stats):
    """The JAX densify test's statistics (clones, splits and prunes all
    fire) and a seeded split noise."""
    import dataclasses
    rng = np.random.RandomState(3)
    stats = dataclasses.replace(
        stats,
        xyz_gradient_accum=torch.as_tensor(
            rng.rand(N).astype(np.float32) * 6e-4),
        denom=torch.ones(N), valid=torch.as_tensor(rng.rand(N) > 0.1))
    noise = torch.randn(N, 2, 3, generator=torch.Generator().manual_seed(5))
    return stats, noise


def _flat(prefix, tree) -> dict:
    return {f"{prefix}.{k}": np.asarray(v.detach().cpu().numpy())
            for k, v in splats.tree_items(tree).items()}


def run_case(name, inputs, mesh=None):
    """One step of case ``name``: the sharded step on ``mesh`` (the whole
    state gathered back), or the single-device step (``mesh`` None).
    Returns {name: numpy}."""
    from splatfields_torch.parallel import step as pstep
    field, sh, n_frames, data, ring, corr = CASES[name]
    params, stats, sopt, deform, opt, pipe, batch = setup(
        inputs, field, sh, n_frames, corr)
    net = deform.net if deform else None
    fp = deform.params if deform else {}
    fo = deform.opt_state if deform else splats.adam_init({})
    lrs = splats.splat_lr_tree(*SPLAT_LRS)
    if mesh is None:
        step = train_lib.make_train_step(net, opt, pipe, W, H, V, field,
                                         n_frames, sh)
    else:
        step = pstep.make_sharded_train_step(
            net, opt, pipe, W, H, V // mesh.n_data, field, n_frames, mesh,
            sh, ring=ring)
        params, stats, sopt = pstep.shard_train_state(params, stats, sopt,
                                                      mesh)
        fp = pstep.replicate(fp)
    params, stats, sopt, fp, fo, out = step(params, stats, sopt, fp, fo,
                                            batch, lrs, FIELD_LR)
    if mesh is not None:
        params, stats, sopt = pstep.unshard_train_state(params, stats, sopt,
                                                        mesh)
    res = {"loss": np.float32(out.loss)}
    res.update(_flat("sp", params))
    res.update(_flat("st", stats))
    res.update({f"fp.{k}": v.detach().numpy() for k, v in fp.items()})
    return res


def run_densify(inputs, mesh=None):
    from splatfields_torch.parallel import step as pstep
    params, stats, sopt, *_ = setup(inputs, False)
    stats, noise = densify_inputs(params, stats)
    if mesh is None:
        out = splats.densify_and_prune(params, stats, sopt, noise, 2e-4,
                                       0.005, 1.5, 0.0, percent_dense=0.01)
    else:
        dens = pstep.make_sharded_densify(mesh, 0.0, 0.01)
        p, s, o, dropped = dens(*pstep.shard_train_state(params, stats, sopt,
                                                         mesh),
                                noise, 2e-4, 0.005, 1.5)
        out = (*pstep.unshard_train_state(p, s, o, mesh), dropped)
    p, s, o, dropped = out
    res = {"dropped": np.int64(dropped)}
    res.update(_flat("sp", p))
    res.update(_flat("st", s))
    res.update(_flat("mu", o.mu))
    return res


LOOP_ARGV = ["--white_background", "--eval", "--is_static", "--n_views",
             "4", "--pts_samples", "random", "--num_pts", "300",
             "--load_time_step", "0", "--composition_rank", "0",
             "--tile_cap", "128", "--k_chunk", "32", "--quiet",
             "--densify_from_iter", "1", "--densification_interval", "2",
             "--test_iterations", "4", "--save_iterations", "4"]


def run_loop(scene, out, mesh_flags):
    """The CLI for 4 iterations, then ``--resume`` to 6 -> (every
    iteration's loss, the densify rounds, the final valid count)."""
    from splatfields_torch import train as ttrain
    losses, training = [], ttrain.training

    def spy(*args, **kw):
        kw["progress_callback"] = lambda it, loss, *_: losses.append(loss)
        return training(*args, **kw)

    ttrain.training = spy
    try:
        argv = ["-s", scene, "-m", out] + LOOP_ARGV + mesh_flags
        first = ttrain.main(argv + ["--iterations", "4"], device="cpu")
        last = ttrain.main(argv + ["--iterations", "6", "--resume"],
                           device="cpu")
    finally:
        ttrain.training = training
    return (np.array(losses), np.array(first.densified + last.densified),
            int(last.stats.valid.sum()))


def world_rank(rank, world, store_path, out_dir, inputs, scene):
    """One rank of the test world: every case on its mesh, then the
    single-device step of every ``world``-th case from its rank, written
    with the sharded results rank 0 gathered: ``<case>.npz`` holds
    ``mesh/`` and ``single/`` entries."""
    import torch.distributed as dist

    from splatfields_torch.parallel import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.initialize_distributed(None, world, rank, backend="gloo",
                                    init_method=f"file://{store_path}",
                                    timeout_s=WORLD_TIMEOUT_S)
    meshes = {d: mesh_lib.make_mesh(world, data=d) for d in (1, 2)}
    results = {}
    for name, case in CASES.items():
        results[name] = run_case(name, inputs, meshes[case[3]])
    results["densify"] = run_densify(inputs, meshes[1])
    loop = run_loop(scene, os.path.join(out_dir, "loop_mesh"),
                    ["--mesh_model", str(world)])
    from splatfields_torch import train as ttrain
    odd = ttrain.main(["-s", scene, "-m", os.path.join(out_dir, "loop_odd")]
                      + LOOP_ARGV + ["--num_pts", "301", "--iterations", "1",
                                     "--mesh_model", str(world)],
                      device="cpu")
    loop = loop + (odd.params.capacity, int(odd.stats.valid.sum()))
    names = list(results)
    mine = names[rank::world]
    # rank 0 sends each rank the sharded results of its cases
    box = [results if rank == 0 else None]
    dist.broadcast_object_list(box, src=0)
    dist.destroy_process_group()
    for name in mine:
        single = (run_densify(inputs) if name == "densify"
                  else run_case(name, inputs))
        np.savez(os.path.join(out_dir, f"{name}.npz"),
                 **{f"mesh/{k}": v for k, v in box[0][name].items()},
                 **{f"single/{k}": v for k, v in single.items()})
    if rank == 0:
        single = run_loop(scene, os.path.join(out_dir, "loop_single"), [])
        np.savez(os.path.join(out_dir, "loop.npz"),
                 **{f"{side}/{k}": v for side, res in (("mesh", loop),
                                                        ("single", single))
                    for k, v in zip(("losses", "densified", "valid",
                                     "odd_capacity", "odd_valid"), res)})


@pytest.fixture(scope="module")
def inputs():
    return scene_inputs()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, inputs):
    """Every case's npz from one 4-rank gloo world (killed past its
    timeout), and the JAX single-device step of the 2x2 field case,
    computed here while the world runs."""
    import chip_smoke
    base = tmp_path_factory.mktemp("parallel")
    scene = chip_smoke.write_blender_scene(base, 32, 5, [0.3],
                                           torch.device("cpu"), n_splats=20)
    ctx = mp.start_processes(
        world_rank, args=(WORLD, str(base / "store"), str(base), inputs,
                          scene),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.time() + WORLD_TIMEOUT_S
    try:
        jax_step = jax_single_step(inputs)
        while not ctx.join(timeout=max(deadline - time.time(), 0.0)):
            if time.time() >= deadline:
                raise TimeoutError(f"the {WORLD}-rank world did not end "
                                   f"in {WORLD_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    res = {name: dict(np.load(base / f"{name}.npz"))
           for name in (*CASES, "densify", "loop")}
    res["jax"] = jax_step
    res["base"] = base
    return res


def _pairs(res, prefix):
    keys = sorted(k[len("mesh/"):] for k in res
                  if k.startswith(f"mesh/{prefix}."))
    assert keys
    return [(k, res[f"mesh/{k}"], res[f"single/{k}"]) for k in keys]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single(world, name):
    res = world[name]
    assert abs(float(res["mesh/loss"]) - float(res["single/loss"])) < 1e-4
    prefixes = ("sp", "fp") if CASES[name][0] else ("sp",)
    for prefix in prefixes:
        for k, got, want in _pairs(res, prefix):
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4,
                                       err_msg=f"{name} {k}")
    if name in STATS_CASES:
        for k, atol in (("st.xyz_gradient_accum", 1e-5), ("st.denom", 1e-6),
                        ("st.max_radii2d", 0.0)):
            np.testing.assert_allclose(res[f"mesh/{k}"], res[f"single/{k}"],
                                       atol=atol, err_msg=f"{name} {k}")


def test_sharded_densify_matches_host(world):
    res = world["densify"]
    assert int(res["mesh/dropped"]) == int(res["single/dropped"])
    for prefix in ("sp", "st", "mu"):
        for k, got, want in _pairs(res, prefix):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4,
                                       err_msg=k)


def jax_single_step(inputs):
    """The JAX package's single-device step of the 2x2 field case on the
    same numpy state and the port's weights -> (loss, {name: numpy})."""
    import jax
    import jax.numpy as jnp

    from splatfields_torch.interop import flax_to_state_dict, module_to_flax
    from splatfields_tpu import config as jcfg
    from splatfields_tpu import train_lib as jtrain
    from splatfields_tpu.models import splats as jsplats
    from splatfields_tpu.models.deform_model import build_splatfields

    params, stats, sopt, deform, opt, pipe, batch = setup(inputs, True)
    jparams = jsplats.SplatParams(**{k: jnp.asarray(v.numpy()) for k, v in
                                     splats.tree_items(params).items()})
    jstats = jsplats.SplatStats(**{k: jnp.asarray(v.numpy()) for k, v in
                                   splats.tree_items(stats).items()})
    jnet = build_splatfields(jcfg.HiddenConfig(
        encoder_type="none", composition_rank=0, n_frames=0,
        flow_model="offset"), radius=1.0)
    variables = jax.tree.map(jnp.asarray, module_to_flax(deform.net))
    step = jtrain.make_train_step(
        jnet, jcfg.OptimizationConfig(lambda_mask=0.1,
                                             lambda_norm=0.01),
        jcfg.PipelineConfig(tile_cap=64, k_chunk=32), W, H, num_views=V,
        field_mode=True, n_frames=0, sh_degree=0)
    jb = {k: jnp.asarray(inputs[k]) for k in
          ("viewmatrix", "projmatrix", "campos", "tanfovx", "tanfovy",
           "image", "mask")}
    jb.update(fid=jnp.asarray(0.0, jnp.float32), bg=jnp.ones(3, jnp.float32))
    def jtree(tree):
        """A port tree of tensors as the JAX tree: splat leaves as they
        are, field leaves through a copy of the net (the flax layout)."""
        if isinstance(tree, splats.SplatParams):
            return jsplats.SplatParams(**{
                k: jnp.asarray(v.numpy())
                for k, v in splats.tree_items(tree).items()})
        net = copy.deepcopy(deform.net)
        with torch.no_grad():
            for k, p in net.named_parameters():
                p.copy_(tree[k])
        return jax.tree.map(jnp.asarray, module_to_flax(net)["params"])

    def jadam(state):
        return jsplats.AdamState(count=jnp.asarray(state.count, jnp.int32),
                                 mu=jtree(state.mu), nu=jtree(state.nu))

    jp, _, _, jfp, _, jout, _ = step(
        jparams, jstats, jadam(sopt), variables, jadam(deform.opt_state),
        jb,
        jsplats.splat_lr_tree(*SPLAT_LRS), jnp.asarray(FIELD_LR, jnp.float32),
        jax.random.PRNGKey(0))
    want = {f"fp.{k}": v.numpy() for k, v in flax_to_state_dict(
        jax.tree.map(np.asarray, jfp)).items()}
    want.update({f"sp.{k}": np.asarray(getattr(jp, k)) for k in
                 splats.tree_items(params)})
    return float(jout.loss), want


def test_field_data_model_matches_jax_single_step(world):
    """The 2x2 field case against the JAX package's single-device step."""
    res = world["field_data_model"]
    loss, want = world["jax"]
    assert abs(float(res["mesh/loss"]) - loss) < 1e-4
    for k, v in want.items():
        np.testing.assert_allclose(res[f"mesh/{k}"], v, atol=2e-5, rtol=1e-4,
                                   err_msg=k)


def test_train_cli_on_the_mesh(world):
    """``train.main`` on a 1x4 mesh against no mesh: the loop's losses,
    densify rounds and splats, and rank 0 alone writing."""
    res = world["loop"]
    got, want = res["mesh/losses"], res["single/losses"]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(res["mesh/densified"][:, 0],
                                  res["single/densified"][:, 0])
    assert list(res["mesh/densified"][:, 0]) == [2, 4, 6]
    # (iteration, valid before, valid after, dropped)
    np.testing.assert_array_equal(res["mesh/densified"][:2],
                                  res["single/densified"][:2])
    np.testing.assert_allclose(res["mesh/densified"][2, 1:3],
                               res["single/densified"][2, 1:3], rtol=0.01)
    assert abs(int(res["mesh/valid"]) - int(res["single/valid"])) \
        <= 0.01 * int(res["single/valid"])
    assert (int(res["mesh/odd_capacity"]), int(res["mesh/odd_valid"])) \
        == (304, 301)
    run = world["base"] / "loop_mesh"
    assert (run / "point_cloud" / "iteration_6" / "point_cloud.ply").exists()
    assert (run / "train_state" / "iteration_4").exists()
    assert len(list(run.glob("metrics*"))) == 1





@pytest.mark.parametrize("flags,match", [
    (["--mesh_model", "2", "--n_splats", "100"], "n_splats"),
    (["--mesh_model", "1", "--mesh_data", "2"], "data axis"),
])
def test_mesh_refusals(flags, match):
    """The JAX CLI's refusals, before any rank starts."""
    from splatfields_torch import train as ttrain
    with pytest.raises(ValueError, match=match):
        ttrain.main(["-s", "nowhere", "-m", "nowhere"] + flags)


def test_spawn_needs_a_gpu_a_rank(monkeypatch):
    from splatfields_torch import train as ttrain
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 local GPUs"):
        ttrain.main(["-s", "nowhere", "-m", "nowhere", "--mesh_model", "2"])
