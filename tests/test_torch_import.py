"""The port stands alone: it imports neither JAX, flax nor the JAX
package, and its entry points refuse to drop to the CPU on their own."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "splatfields_tpu")


MODULES = ("splatfields_torch", "splatfields_torch.render_lib",
           "splatfields_torch.train_lib", "splatfields_torch.interop",
           "splatfields_torch.config", "splatfields_torch.ops.ssim",
           "splatfields_torch.utils.schedules",
           "splatfields_torch.models.deform_model",
           "splatfields_torch.ops.raster.blend_cuda",
           "splatfields_torch.ops.cuda_build", "splatfields_torch.ops.segsum",
           "splatfields_torch.models.encoders",
           "splatfields_torch.ops.fused_mlp", "chip_smoke")


def test_import_pulls_in_no_jax():
    code = (f"import sys, {', '.join(MODULES)}; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    files = sorted((ROOT / "splatfields_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_need_a_gpu_unless_told():
    from splatfields_torch import config
    from splatfields_torch.models import splats
    from splatfields_torch.models.deform_model import DeformModel
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is valid")
    hidden = config.HiddenConfig(encoder_type="VarTriPlaneEncoder",
                                 composition_rank=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeformModel(hidden, radius=1.0)
    pts = torch.zeros(8, 3).numpy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        splats.create_from_pcd(pts, pts, 0)
