"""Image metrics: PSNR and SSIM, and the per-frame bundle of the eval loop.

Counterpart of ``r2l_tpu/metrics.py`` (``img2mse`` :19, ``mse2psnr`` :23,
``psnr`` :27, ``_gaussian_window`` :36, ``_depthwise_conv2d`` :44, ``ssim``
:84, ``frame_metrics`` :96). Images are [H, W, C] or [N, H, W, C] in [0, 1];
the convolutions run on the images' device in NCHW.

A metric must not depend on the device. The JAX package asks for
``Precision.HIGHEST`` because bf16 passes moved SSIM by 0.09 on a real
render; on the card, cuDNN runs f32 convolutions in TF32 by default, so
every metric convolution here runs under ``full_f32`` (TF32 off, the flags
restored after).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mse2psnr(img2mse(x, y))


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block;
    the caller's flags come back after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.array([math.exp(-(i - size // 2) ** 2 / (2.0 * sigma ** 2))
                  for i in range(size)])
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_conv2d(img: torch.Tensor, kernel: torch.Tensor
                      ) -> torch.Tensor:
    """img [N, C, H, W], kernel [k, k] (k odd) applied to each channel with
    zero SAME padding."""
    C, k = img.shape[1], kernel.shape[0]
    w = kernel.to(img.device, torch.float32).expand(C, 1, k, k)
    return F.conv2d(img, w, padding=k // 2, groups=C)


def _ssim_impl(img1: torch.Tensor, img2: torch.Tensor,
               window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """SSIM under the caller's precision flags (``ssim`` turns TF32 off)."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    img1 = img1.float().permute(0, 3, 1, 2)
    img2 = img2.float().permute(0, 3, 1, 2)
    w = torch.from_numpy(_gaussian_window(window_size, sigma))
    mu1 = _depthwise_conv2d(img1, w)
    mu2 = _depthwise_conv2d(img2, w)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _depthwise_conv2d(img1 * img1, w) - mu1_sq
    s2 = _depthwise_conv2d(img2 * img2, w) - mu2_sq
    s12 = _depthwise_conv2d(img1 * img2, w) - mu12
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(ssim_map)


@torch.no_grad()
def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM (11x11 Gaussian window, sigma 1.5) of two [H, W, C] or
    [N, H, W, C] images in [0, 1], a scalar on their device."""
    with full_f32():
        return _ssim_impl(img1, img2, window_size, sigma)


@torch.no_grad()
def frame_metrics(img: torch.Tensor, gt: torch.Tensor
                  ) -> dict[str, torch.Tensor]:
    """{mse, psnr, ssim} of one frame against its ground truth, as scalars
    on the frame's device: the eval loop reads them back once a frame."""
    mse = img2mse(img.float(), gt.float())
    return {"mse": mse, "psnr": mse2psnr(mse), "ssim": ssim(img, gt)}
