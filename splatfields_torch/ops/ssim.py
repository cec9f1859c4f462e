"""Training SSIM (counterpart of ``splatfields_tpu/ops/ssim.py::ssim``).

11x11 Gaussian window (sigma 1.5), zero padding, C1 = 0.01^2,
C2 = 0.03^2, biased variances, as the reference ``utils/loss_utils.py``.
The separable window runs as two depthwise 1-D convolutions over all
five filtered maps at once. ``masked_ssim`` comes with the metrics.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    xs = np.arange(window_size)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_same(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Separable zero-padded 'same' filter over [B, H, W] maps."""
    pad = k1d.shape[0] // 2
    x = x[:, None]
    x = F.conv2d(x, k1d.reshape(1, 1, -1, 1), padding=(pad, 0))
    x = F.conv2d(x, k1d.reshape(1, 1, 1, -1), padding=(0, pad))
    return x[:, 0]


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         size_average: bool = True) -> torch.Tensor:
    """SSIM of [C, H, W] (or [H, W]) images in [0, 1]: the mean of the
    SSIM map, or its per-channel means if not ``size_average``."""
    if img1.ndim == 2:
        img1 = img1[None]
    if img2.ndim == 2:
        img2 = img2[None]
    c = img1.shape[0]
    k = torch.as_tensor(_gaussian_kernel(window_size, 1.5),
                        device=img1.device)
    # one filter pass over mu1, mu2, E[x1^2], E[x2^2], E[x1 x2]
    maps = _filter2d_same(torch.cat([img1, img2, img1 * img1, img2 * img2,
                                     img1 * img2]), k)
    mu1, mu2, e11, e22, e12 = maps.split(c)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2))


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR over all pixels (reference ``utils/image_utils.py:15-21``)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))
