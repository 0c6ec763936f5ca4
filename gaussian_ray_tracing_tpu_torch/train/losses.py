"""Image losses for gaussian fitting (counterpart of
gaussian_ray_tracing_tpu/train/losses.py).

Includes the standard 3DGS training loss (Kerbl et al.):
0.8 * L1 + 0.2 * (1 - SSIM), with SSIM computed by an 11x11 separable
gaussian window (sigma 1.5), VALID borders, as the JAX package does.

SSIM's variances cancel: sigma = blur(x^2) - mu^2 is ~1e-4 on smooth
renders against mu^2 ~1e-1, and at bf16 the JAX loss went negative and
diverged. On an H100 the same hazard is TF32, which cuDNN convolutions
use by default. The blur here is therefore written as explicit float32
multiply-adds of shifted slices, with no convolution and no matmul, so no
backend setting can lower its precision.
"""

from __future__ import annotations

import numpy as np
import torch


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Differentiable -PSNR (dB) surrogate."""
    mse = torch.clamp(l2_loss(pred, target), min=1e-12)
    return 10.0 * torch.log10(mse)


def _ssim_window(size: int, sigma: float) -> list[float]:
    """Normalized 1-D gaussian taps, computed in float32 as the JAX package
    computes them."""
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    w = np.exp(-0.5 * (x / sigma) ** 2)
    return [float(v) for v in (w / np.sum(w)).astype(np.float32)]


def _blur(img: torch.Tensor, win: list[float]) -> torch.Tensor:
    """Separable gaussian blur of an (H, W, C) image, VALID borders: rows
    first, then columns, each a sum of shifted float32 slices."""
    size = len(win)
    H, W = img.shape[0] - size + 1, img.shape[1] - size + 1
    rows = win[0] * img[0:H]
    for k in range(1, size):
        rows = rows + win[k] * img[k : k + H]
    out = win[0] * rows[:, 0:W]
    for k in range(1, size):
        out = out + win[k] * rows[:, k : k + W]
    return out


def ssim(pred: torch.Tensor, target: torch.Tensor, size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM over an (H, W, 3) pair in [0, 1] (differentiable)."""
    win = _ssim_window(size, sigma)
    x = pred.to(torch.float32)
    y = target.to(torch.float32)
    mx, my = _blur(x, win), _blur(y, win)
    mxx, myy, mxy = mx * mx, my * my, mx * my
    sx = _blur(x * x, win) - mxx
    sy = _blur(y * y, win) - myy
    sxy = _blur(x * y, win) - mxy
    c1, c2 = 0.01**2, 0.03**2
    s = ((2.0 * mxy + c1) * (2.0 * sxy + c2)) / ((mxx + myy + c1) * (sx + sy + c2))
    return torch.mean(s)


def dssim_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                  lambda_dssim: float = 0.2) -> torch.Tensor:
    """The 3DGS training objective: (1-λ)·L1 + λ·(1-SSIM)."""
    return (1.0 - lambda_dssim) * l1_loss(pred, target) + lambda_dssim * (
        1.0 - ssim(pred, target)
    )
