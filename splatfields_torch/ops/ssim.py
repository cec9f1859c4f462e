"""Training SSIM (counterpart of ``splatfields_tpu/ops/ssim.py::ssim``).

11x11 Gaussian window (sigma 1.5), zero padding, C1 = 0.01^2,
C2 = 0.03^2, biased variances, as the reference ``utils/loss_utils.py``.
The separable window runs as two depthwise 1-D convolutions over all
five filtered maps at once. ``masked_ssim`` is the multinerf
partial-convolution SSIM over a validity mask (JAX ``masked_ssim``).
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
                        device=img1.device, dtype=img1.dtype)
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


def masked_ssim(img0: torch.Tensor, img1: torch.Tensor, mask: torch.Tensor,
                filter_size: int = 11) -> torch.Tensor:
    """Mean SSIM of [H, W, C] images over an [H, W, 1] mask (reference
    ``render.py:45-160``): every Gaussian-filtered map (sigma 1.5) is
    filtered over the valid pixels only and renormalised by the filtered
    mask (a partial convolution), pixels whose filtered mask is ~0 are
    dropped, and the SSIM map is summed with the mask as weights over the
    mask's sum: the sum of the channels' masked means, as the JAX
    function returns it (3 for identical RGB images)."""
    k = torch.as_tensor(_gaussian_kernel(filter_size, 1.5),
                        device=img0.device, dtype=img0.dtype)
    mask = mask.to(img0.dtype)
    m_filt = _filter2d_same(mask.permute(2, 0, 1), k).permute(1, 2, 0)
    valid = (m_filt > 1e-5).to(img0.dtype)
    denom = torch.clamp(m_filt, min=1e-10)

    def convolve2d(z):
        zm = _filter2d_same((z * mask).permute(2, 0, 1), k).permute(1, 2, 0)
        return zm / denom * valid

    mu0, mu1 = convolve2d(img0), convolve2d(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = torch.clamp(convolve2d(img0 * img0) - mu00, min=0.0)
    sigma11 = torch.clamp(convolve2d(img1 * img1) - mu11, min=0.0)
    sigma01 = convolve2d(img0 * img1) - mu01
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), torch.abs(sigma01))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    den = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    w = valid * mask
    return torch.sum(numer / den * w) / torch.clamp(torch.sum(w), min=1e-10)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """PSNR over all pixels (reference ``utils/image_utils.py:15-21``)."""
    mse = torch.mean((img1 - img2) ** 2)
    return 20 * torch.log10(1.0 / torch.sqrt(mse))
