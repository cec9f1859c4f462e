"""Evaluation metrics on the host, in NumPy (counterpart of
``splatfields_tpu/metrics.py``).

``compute_psnr``; ``compute_ssim``, the multinerf SSIM with valid-mode
separable Gaussian filtering and the box-count renormalisation of the
mask (the reference's quirk: the mask is renormalised with a box filter
while the image uses the Gaussian); ``eval_all``, which writes PSNR,
SSIM * 100 and LPIPS * 100 over a render directory into
``results.yaml``.

PNGs and JPEGs (``*.png`` and ``*.jpg``, as the JAX package globs) are
read by ``data/images.py`` in RGB order, where the JAX package reads BGR
through cv2; PSNR and SSIM are per-channel sums and means, so
the order does not change them (tests/test_torch_train_loop.py shows
it). LPIPS does depend on it, and the reference and the JAX package feed
it cv2's BGR images, so ``eval_imgs`` hands it the channels reversed.
LPIPS needs a local VGG weight file (``ops/lpips.py``); without one
``lpips`` is null, as in the JAX package.
"""
from __future__ import annotations

import collections
import glob
import math
import os

import numpy as np
from scipy import signal

from splatfields_torch.data import images
from splatfields_torch.ops.lpips import load_lpips

LPIPS_NOTE = ("lpips unavailable: no local VGG-LPIPS weight file found "
              "(pass --lpips_weights, set $SPLATFIELDS_LPIPS or place "
              "weights/lpips_vgg.npz; see ops/lpips.py for the format)")


def compute_psnr(img0: np.ndarray, img1: np.ndarray) -> float:
    mse = np.mean((img0 - img1) ** 2)
    return float(-10.0 / math.log(10) * math.log(mse + 1e-20))


def compute_ssim(img0: np.ndarray, img1: np.ndarray,
                 mask: np.ndarray | None = None, max_val: float = 1.0,
                 filter_size: int = 11, filter_sigma: float = 1.5,
                 k1: float = 0.01, k2: float = 0.03) -> float:
    """Multinerf masked SSIM, valid-mode convolution; [H, W, C] images."""
    if mask is None:
        mask = np.ones_like(img0[..., :1])
    mask = mask[..., 0]
    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def convolve2d(z, m, f):
        z_ = np.stack([signal.convolve2d(z[..., i] * m, f, mode="valid")
                       for i in range(z.shape[-1])], axis=-1)
        m_ = signal.convolve2d(m, np.ones_like(f), mode="valid")
        out = np.where(m_[..., None] != 0,
                       z_ * np.sum(np.ones_like(f)) / m_[..., None], 0.0)
        return out, (m_ != 0).astype(z.dtype)

    def filt_fn(z, m):
        z1, m1 = convolve2d(z, m, filt[None, :])
        return convolve2d(z1, m1, filt[:, None])

    mu0 = filt_fn(img0, mask)[0]
    mu1 = filt_fn(img1, mask)[0]
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = np.maximum(0.0, filt_fn(img0**2, mask)[0] - mu00)
    sigma11 = np.maximum(0.0, filt_fn(img1**2, mask)[0] - mu11)
    sigma01 = filt_fn(img0 * img1, mask)[0] - mu01
    sigma01 = np.sign(sigma01) * np.minimum(
        np.sqrt(sigma00 * sigma11), np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    return float(np.mean(numer / denom))


def eval_imgs(pred: np.ndarray, gt: np.ndarray, lpips_fn=None,
              scale_ssim: float = 100.0, scale_lpips: float = 100.0) -> dict:
    """uint8 [H, W, 3] RGB prediction and ground truth -> psnr, ssim and,
    given ``lpips_fn`` (``ops/lpips.load_lpips``), lpips of the BGR
    images."""
    p = pred.astype(np.float32) / 255.0
    g = gt.astype(np.float32) / 255.0
    out = {"psnr": compute_psnr(p, g),
           "ssim": compute_ssim(p, g) * scale_ssim}
    if lpips_fn is not None:
        out["lpips"] = lpips_fn(p[..., ::-1], g[..., ::-1]) * scale_lpips
    return out


def _images(d: str) -> list[str]:
    return sorted(glob.glob(os.path.join(d, "*.png"))
                  + glob.glob(os.path.join(d, "*.jpg")))


def eval_all(src_dir: str, scale_ssim: float = 100.0,
             scale_lpips: float = 100.0,
             lpips_weights_path: str | None = None, device=None) -> dict:
    """Mean metrics of ``renders/*.{png,jpg}`` against ``gt/`` -> the
    summary dict, also written to ``src_dir/results.yaml``. LPIPS runs on
    ``device`` (None: the GPU) when a weight file is found."""
    gt_paths = _images(os.path.join(src_dir, "gt"))
    pred_paths = _images(os.path.join(src_dir, "renders"))
    if [os.path.basename(p) for p in gt_paths] != [
            os.path.basename(p) for p in pred_paths]:
        raise ValueError(f"gt and renders differ in {src_dir}: "
                         f"{len(gt_paths)} vs {len(pred_paths)} files")
    lpips_fn = load_lpips(lpips_weights_path, device)
    results = collections.defaultdict(list)
    for gp, pp in zip(gt_paths, pred_paths):
        ev = eval_imgs(images.read_color(pp), images.read_color(gp),
                       lpips_fn, scale_ssim, scale_lpips)
        for k, v in ev.items():
            results[k].append(v)
    summary = {k: float(np.mean(v)) for k, v in results.items()}
    dst = os.path.join(src_dir, "results.yaml")
    with open(dst, "w") as f:
        f.write(f"ssim: {summary.get('ssim')}\n")
        f.write(f"psnr: {summary.get('psnr')}\n")
        if "lpips" in summary:
            f.write(f"lpips: {summary['lpips']}\n")
        else:
            f.write(f"lpips: null  # {LPIPS_NOTE}\n")
    print("Saved results to", dst)
    for k, v in summary.items():
        print(k, "=", v)
    return summary


def read_results(path: str) -> dict:
    """``results.yaml`` as this module and the JAX package write it (one
    ``key: value`` a line, ``null`` -> None) -> dict, without yaml."""
    out = {}
    with open(path) as f:
        for line in f:
            key, _, value = line.split("#", 1)[0].partition(":")
            value = value.strip()
            if key.strip():
                out[key.strip()] = None if value == "null" else float(value)
    return out
