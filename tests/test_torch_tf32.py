"""The port's CLIs keep their math in f32 on the card: ``train.main``,
``render.main`` and ``extract_geo.main`` turn off TF32 for cuDNN
convolutions (torch's default lets cuDNN use it) and for CUDA matmuls
before any work (``device.full_f32_math``). The flags are process-wide
and read the same on the CPU, so each main runs here on a tiny run (a
32x32 Blender scene of 20 ground-truth splats, 5 train views, 300
random points, 2 iterations) with both flags set to True beforehand, and
both must be False after it.
"""
import pytest
import torch

import chip_smoke
from splatfields_torch import extract_geo, render, train


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the model path, the flags after train.main)."""
    saved = _tf32_flags(), torch.get_num_threads()
    torch.set_num_threads(1)
    base = tmp_path_factory.mktemp("tf32")
    try:
        scene = chip_smoke.write_blender_scene(
            base, 32, 5, [0.3], torch.device("cpu"), n_splats=20)
        out = str(base / "run")
        _tf32_on()
        train.main(["-s", scene, "-m", out, "--white_background", "--eval",
                    "--is_static", "--n_views", "4", "--pts_samples",
                    "random", "--num_pts", "300", "--load_time_step", "0",
                    "--composition_rank", "0", "--iterations", "2",
                    "--tile_cap", "128", "--k_chunk", "32", "--quiet",
                    "--test_iterations", "2"], device="cpu")
        yield out, _tf32_flags()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved[0]
        torch.set_num_threads(saved[1])


def test_train_main_turns_tf32_off(run):
    assert run[1] == (False, False)


@pytest.mark.parametrize("cli", ["render", "extract_geo"])
def test_cli_turns_tf32_off(run, cli):
    _tf32_on()
    if cli == "render":
        render.main(["-m", run[0], "--skip_train"], device="cpu")
    else:
        extract_geo.main(["-m", run[0], "--mesh_resolution", "8",
                          "--mesh_threshold", "0.3"], device="cpu")
    assert _tf32_flags() == (False, False)
