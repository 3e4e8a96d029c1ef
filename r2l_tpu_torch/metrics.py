"""Image metrics: PSNR.

Counterpart of ``r2l_tpu/metrics.py:19-33``.
"""
from __future__ import annotations

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def psnr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mse2psnr(img2mse(x, y))
