"""LPIPS with the VGG16 backbone, from a local weight file (counterpart of
``splatfields_tpu/ops/lpips.py``; the reference calls ``lpips.LPIPS(net=
'vgg')`` on images scaled to [-1, 1], ``render.py:174-180``).

No weights ship and none are downloaded. The ``.npz`` layout is the JAX
package's, in torch tensor layouts: ``features.{i}.weight`` [out, in, 3,
3] and ``features.{i}.bias`` for the 13 convs of ``torchvision.models.
vgg16().features`` (i in 0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28;
3x3, padding 1, a 2x2 max-pool between blocks), and ``lins.{k}.weight``
[1, C_k, 1, 1] for the five taps (relu1_2 ... relu5_3).

The metric (``lpips.LPIPS.forward``, normalize=False): the ScalingLayer
``(x - shift) / scale``, the VGG taps, each unit-normalised over its
channels (``x / (||x|| + 1e-10)``), the squared difference weighted by
``lins.k`` summed over channels, the spatial mean, summed over the taps.
It runs as ``F.conv2d`` on the images' device in float32 (cuDNN's TF32
off for the call).

Weights are looked up in order: the path given, ``$SPLATFIELDS_LPIPS``,
``<repo>/weights/lpips_vgg.npz``. ``load_lpips`` returns None when none
is found, and the caller reports ``lpips: null``.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from splatfields_torch.device import resolve_device

# LPIPS ScalingLayer constants (RGB order)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# torchvision vgg16.features conv indices by block; LPIPS taps each
# block's last ReLU
BLOCKS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))


def find_weights(path: str | None = None) -> str | None:
    if path and os.path.isfile(path):
        return path
    env = os.environ.get("SPLATFIELDS_LPIPS", "")
    if env and os.path.isfile(env):
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    default = os.path.join(repo, "weights", "lpips_vgg.npz")
    return default if os.path.isfile(default) else None


def lpips_distance(weights: dict, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """a, b: [N, 3, H, W] float32 in [-1, 1] (RGB) -> [N]."""
    shift = a.new_tensor(_SHIFT)[None, :, None, None]
    scale = a.new_tensor(_SCALE)[None, :, None, None]

    def taps(x):
        h = (x - shift) / scale
        outs = []
        for bi, blk in enumerate(BLOCKS):
            if bi > 0:
                h = F.max_pool2d(h, 2, 2)
            for i in blk:
                h = F.relu(F.conv2d(h, weights[f"conv{i}_w"],
                                    weights[f"conv{i}_b"], padding=1))
            outs.append(h)
        return outs

    total = 0.0
    for k, (fa, fb) in enumerate(zip(taps(a), taps(b))):
        na = fa / (torch.linalg.vector_norm(fa, dim=1, keepdim=True) + 1e-10)
        nb = fb / (torch.linalg.vector_norm(fb, dim=1, keepdim=True) + 1e-10)
        d = (na - nb) ** 2
        lin = weights[f"lin{k}"][None, :, None, None]
        total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
    return total


class TorchLPIPS:
    """``fn(a, b) -> float`` for a, b [H, W, 3] float32 NumPy in [0, 1]:
    ``metrics.eval_imgs``'s contract."""

    def __init__(self, weights: dict, device: torch.device):
        self.weights, self.device = weights, device

    def __call__(self, a: np.ndarray, b: np.ndarray) -> float:
        def prep(x):
            t = torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                                device=self.device)
            return t.permute(2, 0, 1)[None] * 2.0 - 1.0

        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            return float(lpips_distance(self.weights, prep(a), prep(b))[0])


def load_lpips(path: str | None = None, device=None) -> TorchLPIPS | None:
    """The LPIPS callable on ``device`` (None: the GPU) from a local npz,
    or None when no weight file is found or it is unusable."""
    found = find_weights(path)
    if found is None:
        return None
    dev = resolve_device(device)
    try:
        with np.load(found) as raw:
            w = {}
            for blk in BLOCKS:
                for i in blk:
                    for kind, key in (("w", "weight"), ("b", "bias")):
                        w[f"conv{i}_{kind}"] = torch.as_tensor(np.asarray(
                            raw[f"features.{i}.{key}"], np.float32),
                            device=dev)
            for k in range(len(BLOCKS)):
                w[f"lin{k}"] = torch.as_tensor(np.asarray(
                    raw[f"lins.{k}.weight"], np.float32).reshape(-1),
                    device=dev)
    except Exception as e:  # a malformed file: the same null fallback
        print(f"lpips weights at {found} unusable ({e}); reporting null")
        return None
    return TorchLPIPS(w, dev)
