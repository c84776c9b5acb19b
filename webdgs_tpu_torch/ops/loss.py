"""Loss pixel-gradients and image metrics (counterpart of
webdgs_tpu/ops/loss.py:28-136).

The reference never forms a scalar loss: its loss pass writes dL/dpixel
directly,

    grad = lambda_l1 * sign(pred - targ)
         + lambda_l2 * (pred - targ)
         + lambda_dssim * ((1 - ssim_map)/2) * (pred - targ)

with ``ssim_map`` a per-pixel 5x5 uniform-window SSIM over edge-replicated
samples.  That "DSSIM gradient" is the reference's simplification, not a
derivative; it is reproduced exactly.  This module is the oracle of the
tile-loss kernel (``ops/tile_loss.py``) and the image-space branch of
``train_step`` for frames under 5x5.

All windows are explicit shifted sums in float32 (no convolution, so no
TF32 on the card).  Images are (H, W, C).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The reference's loss weights and SSIM constants."""

    lambda_l1: float = 0.8
    lambda_l2: float = 0.0
    lambda_dssim: float = 0.2
    c1: float = 1e-4
    c2: float = 9e-4


def _edge_pad(x: torch.Tensor, half: int) -> torch.Tensor:
    """(H, W, C) -> (H + 2 half, W + 2 half, C), edge-replicated."""
    h, w = x.shape[0], x.shape[1]
    rows = torch.clamp(torch.arange(-half, h + half, device=x.device),
                       0, h - 1)
    cols = torch.clamp(torch.arange(-half, w + half, device=x.device),
                       0, w - 1)
    return x[rows][:, cols]


def _window_mean(x: torch.Tensor, half: int = 2) -> torch.Tensor:
    """5x5 uniform window mean with edge-replicated sampling."""
    xp = _edge_pad(x, half)
    win = 2 * half + 1
    h, w = x.shape[0], x.shape[1]
    r = xp[:, 0:w]
    for d in range(1, win):
        r = r + xp[:, d:w + d]
    s = r[0:h]
    for d in range(1, win):
        s = s + r[d:h + d]
    return s / (win * win)


def ssim_map(pred: torch.Tensor, target: torch.Tensor,
             c1: float = 1e-4, c2: float = 9e-4) -> torch.Tensor:
    """Per-pixel 5x5-window SSIM, per channel."""
    mu_x = _window_mean(pred)
    mu_y = _window_mean(target)
    sigma_x2 = _window_mean(pred * pred) - mu_x * mu_x
    sigma_y2 = _window_mean(target * target) - mu_y * mu_y
    sigma_xy = _window_mean(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x2 + sigma_y2 + c2)
    return num / den


def pixel_loss_gradient(pred: torch.Tensor, target: torch.Tensor,
                        cfg: LossConfig) -> torch.Tensor:
    """dL/dpixel, (H, W, 3), with the reference's exact formulas."""
    diff = pred - target
    grad = cfg.lambda_l1 * torch.sign(diff) + cfg.lambda_l2 * diff
    if cfg.lambda_dssim > 0.0:
        dssim = (1.0 - ssim_map(pred, target, cfg.c1, cfg.c2)) * 0.5
        grad = grad + cfg.lambda_dssim * dssim * diff
    return grad


def loss_metrics(pred: torch.Tensor, target: torch.Tensor,
                 cfg: LossConfig) -> dict[str, torch.Tensor]:
    diff = pred - target
    l1 = torch.mean(torch.abs(diff))
    l2 = torch.mean(diff * diff)
    dssim = torch.mean((1.0 - ssim_map(pred, target, cfg.c1, cfg.c2)) * 0.5)
    total = cfg.lambda_l1 * l1 + cfg.lambda_l2 * l2 + cfg.lambda_dssim * dssim
    return {"l1": l1, "l2": l2, "dssim": dssim, "loss": total,
            "psnr": psnr(pred, target)}


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = torch.mean(torch.square(pred - target))
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def ssim(pred: torch.Tensor, target: torch.Tensor, window: int = 11,
         sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Standard Gaussian-window SSIM (Wang et al.) for quality reporting,
    edge-replicated; the separable blur is written as explicit weighted
    sums in float32."""
    half = window // 2
    x = torch.arange(window, dtype=torch.float32, device=pred.device) - half
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = (g / torch.sum(g)).tolist()

    def blur(img):
        h, w = img.shape[0], img.shape[1]
        v = _edge_pad(img, half)
        r = g[0] * v[0:h]
        for d in range(1, window):
            r = r + g[d] * v[d:h + d]
        s = g[0] * r[:, 0:w]
        for d in range(1, window):
            s = s + g[d] * r[:, d:w + d]
        return s

    mu_x = blur(pred)
    mu_y = blur(target)
    sigma_x2 = blur(pred * pred) - mu_x * mu_x
    sigma_y2 = blur(target * target) - mu_y * mu_y
    sigma_xy = blur(pred * target) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x2 + sigma_y2 + c2)
    return torch.mean(num / den)
