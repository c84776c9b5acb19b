"""Tile-space loss: the reference's loss pass on the rasterizer's tile
buffer (counterpart of webdgs_tpu/ops/tile_loss.py:61-357).

``tile_loss_gradient`` is the wrapper of CUDA kernel ``csrc/tile_loss.cu``
(one CTA per tile, the composited prediction and the target staged over
the tile plus a 2-pixel halo in shared memory, the 5x5 window sums
separable: row sums, then sums of five row sums, four pixels of a column
per thread).  It turns the planar (T, NUM_OUT, P) forward tiles and the
(H, W, 3) target into the backward rasterizer's pixel cotangent
(T, NUM_OUT, P) -- channels 0-2 dL/drgb, channel OUT_T = sum_c bg_c *
dL/dc (the background chain rule), the rest 0 -- and per-tile metric
partial sums ``[sum |d|, sum d^2, sum dssim, valid px]`` (T, 4).  Any tile
of at most 1,024 pixels.  On a CPU tensor it runs
:func:`tile_loss_gradient_plain`, the same arithmetic in plain torch over
the whole padded frame; on a CUDA tensor it launches the kernel or raises.

The 5x5 window samples are edge-replicated (``clamp`` to the frame), so
pixels of the tile-grid padding never feed a window; they get zero
gradient and count nowhere.
"""

from __future__ import annotations

import torch

from webdgs_tpu_torch import _build
from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.ops.loss import LossConfig
from webdgs_tpu_torch.ops.rasterize import NUM_OUT, OUT_T

HALF = 2  # 5x5 window
WIN = 2 * HALF + 1
NUM_SUMS = 4  # per-tile partials: |d|, d^2, dssim, valid pixels
MAX_TILE_PX = 1024  # the largest tile the kernel takes (any tile_w, tile_h)


def supports_tile_loss(img_w: int, img_h: int,
                       settings: RenderSettings) -> bool:
    """Frames smaller than the 5x5 window take the image-space path."""
    return img_w >= WIN and img_h >= WIN


def metrics_from_sums(tot: torch.Tensor, cfg: LossConfig) -> dict:
    """Scalar metrics (the ``loss_metrics`` keys) from the summed per-tile
    partials ``[sum|diff|, sum diff^2, sum dssim, valid px]``."""
    n = torch.clamp(tot[3] * 3.0, min=1.0)
    l1 = tot[0] / n
    l2 = tot[1] / n
    dssim = tot[2] / n
    return {"l1": l1, "l2": l2, "dssim": dssim,
            "loss": (cfg.lambda_l1 * l1 + cfg.lambda_l2 * l2
                     + cfg.lambda_dssim * dssim),
            "psnr": -10.0 * torch.log10(torch.clamp(l2, min=1e-12))}


def _check_inputs(out, target, img_w, img_h, ntx, nty, settings):
    if out.dim() != 3 or tuple(out.shape) != (ntx * nty, NUM_OUT,
                                              settings.tile_px):
        raise ValueError(f"out must be ({ntx * nty}, {NUM_OUT}, "
                         f"{settings.tile_px}), got {tuple(out.shape)}")
    if tuple(target.shape) != (img_h, img_w, 3):
        raise ValueError(f"target must be ({img_h}, {img_w}, 3), got "
                         f"{tuple(target.shape)}")
    for name, t in (("out", out), ("target", target)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.device != target.device:
        raise ValueError("out and target are on different devices")
    if ntx * settings.tile_w < img_w or nty * settings.tile_h < img_h:
        raise ValueError("the tile grid does not cover the frame")
    if not supports_tile_loss(img_w, img_h, settings):
        raise ValueError(f"a {img_w}x{img_h} frame is smaller than the "
                         f"{WIN}x{WIN} window")
    if not 0 < settings.tile_px <= MAX_TILE_PX:
        raise ValueError(f"tile of {settings.tile_px} pixels: the kernel "
                         f"takes tiles of 1 to {MAX_TILE_PX} pixels")


def _box(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """5x5 box sum of an (h+4, w+4, ...) halo array: row shifts first,
    then column shifts, each in window order."""
    r = x[:, 0:w]
    for d in range(1, WIN):
        r = r + x[:, d:w + d]
    s = r[0:h]
    for d in range(1, WIN):
        s = s + r[d:h + d]
    return s


def tile_loss_gradient_plain(out: torch.Tensor, target: torch.Tensor,
                             img_w: int, img_h: int, ntx: int, nty: int,
                             cfg: LossConfig, settings: RenderSettings):
    """Plain torch version of the kernel: (dpix (T, NUM_OUT, P), per-tile
    sums (T, NUM_SUMS))."""
    th, tw = settings.tile_h, settings.tile_w
    hp, wp = nty * th, ntx * tw
    dev = out.device
    bg = torch.tensor(settings.background, dtype=torch.float32, device=dev)
    # planar tiles -> padded (hp, wp, c) image of the channels used
    img = out.reshape(nty, ntx, NUM_OUT, th, tw).permute(0, 3, 1, 4, 2)
    img = img.reshape(hp, wp, NUM_OUT)
    pred_img = img[..., 0:3] + bg * img[..., OUT_T:OUT_T + 1]

    # (hp+4, wp+4) halo of every pixel of the grid: edge-clamped samples
    gy = torch.clamp(torch.arange(-HALF, hp + HALF, device=dev), 0,
                     img_h - 1)
    gx = torch.clamp(torch.arange(-HALF, wp + HALF, device=dev), 0,
                     img_w - 1)
    p = pred_img[gy][:, gx]
    q = target[gy][:, gx]
    inv = 1.0 / (WIN * WIN)
    mu_x = _box(p, hp, wp) * inv
    mu_y = _box(q, hp, wp) * inv
    sigma_x2 = _box(p * p, hp, wp) * inv - mu_x * mu_x
    sigma_y2 = _box(q * q, hp, wp) * inv - mu_y * mu_y
    sigma_xy = _box(p * q, hp, wp) * inv - mu_x * mu_y
    num = (2 * mu_x * mu_y + cfg.c1) * (2 * sigma_xy + cfg.c2)
    den = ((mu_x * mu_x + mu_y * mu_y + cfg.c1)
           * (sigma_x2 + sigma_y2 + cfg.c2))
    dssim = (1.0 - num / den) * 0.5

    own = (slice(HALF, HALF + hp), slice(HALF, HALF + wp))
    diff = p[own] - q[own]
    grad = cfg.lambda_l1 * torch.sign(diff) + cfg.lambda_l2 * diff
    grad = grad + cfg.lambda_dssim * dssim * diff
    valid = ((torch.arange(hp, device=dev) < img_h)[:, None]
             & (torch.arange(wp, device=dev) < img_w)[None, :])
    valid = valid.to(torch.float32)[..., None]  # (hp, wp, 1)
    grad = grad * valid

    d_t = (grad * bg).sum(dim=-1, keepdim=True)
    zeros = torch.zeros_like(d_t)
    planes = torch.cat([grad, zeros, d_t, zeros.expand(hp, wp, 3)], dim=-1)
    dpix = planes.reshape(nty, th, ntx, tw, NUM_OUT).permute(0, 2, 4, 1, 3)
    dpix = dpix.reshape(ntx * nty, NUM_OUT, th * tw).contiguous()

    per_px = torch.cat([
        (diff.abs() * valid).sum(dim=-1, keepdim=True),
        (diff * diff * valid).sum(dim=-1, keepdim=True),
        (dssim * valid).sum(dim=-1, keepdim=True),
        valid], dim=-1)  # (hp, wp, 4)
    sums = per_px.reshape(nty, th, ntx, tw, NUM_SUMS).permute(0, 2, 1, 3, 4)
    sums = sums.reshape(ntx * nty, th * tw, NUM_SUMS).sum(dim=1)
    return dpix, sums


def _tile_loss_cuda(out, target, img_w, img_h, ntx, nty, cfg, settings):
    lib = _build.library()
    n_tiles = ntx * nty
    dpix = torch.empty_like(out)
    sums = torch.empty((n_tiles, NUM_SUMS), dtype=torch.float32,
                       device=out.device)
    bg = settings.background
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.webdgs_tile_loss(
            out.data_ptr(), target.data_ptr(), n_tiles, ntx,
            settings.tile_w, settings.tile_h, img_w, img_h, cfg.lambda_l1,
            cfg.lambda_l2, cfg.lambda_dssim, cfg.c1, cfg.c2, bg[0], bg[1],
            bg[2], dpix.data_ptr(), sums.data_ptr(), stream)
    _build.check(err, "tile_loss_gradient")
    tile_loss_tiles.kernel_launches += 1
    return dpix, sums


def tile_loss_tiles(out: torch.Tensor, target: torch.Tensor, img_w: int,
                    img_h: int, ntx: int, nty: int, cfg: LossConfig,
                    settings: RenderSettings):
    """The kernel's function: (dpix (T, NUM_OUT, P), per-tile sums
    (T, NUM_SUMS)).  ``tile_loss_tiles.kernel_launches`` counts the CUDA
    kernel's launches."""
    _check_inputs(out, target, img_w, img_h, ntx, nty, settings)
    if out.device.type == "cpu":
        return tile_loss_gradient_plain(out, target, img_w, img_h, ntx, nty,
                                        cfg, settings)
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    return _tile_loss_cuda(out, target, img_w, img_h, ntx, nty, cfg,
                           settings)


tile_loss_tiles.kernel_launches = 0


def tile_loss_gradient(out: torch.Tensor, target: torch.Tensor, img_w: int,
                       img_h: int, ntx: int, nty: int, cfg: LossConfig,
                       settings: RenderSettings):
    """Pixel cotangent for the rasterizer's tile buffer + scalar metrics
    (the keys of ``loss_metrics``).  out: (T, NUM_OUT, P) planar forward
    tiles; target: (H, W, 3)."""
    dpix, sums = tile_loss_tiles(out, target, img_w, img_h, ntx, nty, cfg,
                                 settings)
    return dpix, metrics_from_sums(sums.sum(dim=0), cfg)
