"""Tiled alpha-compositing rasterizer, forward only (counterpart of
webdgs_tpu/ops/rasterize.py:63-86, 686-757, 890-950).

``rasterize_tiles`` is the wrapper of CUDA kernel ``csrc/rasterize_fwd.cu``
(one CTA per tile, one thread per pixel, entries staged through shared
memory).  On a CPU tensor it runs :func:`rasterize_tiles_plain`, the same
compositing in plain torch, blocked like the TPU kernel: all tiles in
parallel, chunks of ``settings.chunk`` entries, the exclusive
log-transmittance carried across chunks, and a tile dropping out once all
its pixels have saturated.  On a CUDA tensor it launches the kernel or
raises.

Alpha semantics (the reference's): alpha = min(alpha_max, op *
exp(-0.5 * conic quad form)); pixels outside the splat's SnugBox extents
are skipped; alpha < alpha_min contributes nothing; a splat counts only
while the exclusive transmittance is >= t_threshold; n_contrib is the
1-based index of the last contributing splat in the tile's range.
"""

from __future__ import annotations

import math

import torch

from webdgs_tpu_torch import _build
from webdgs_tpu_torch.config import RenderSettings

# attribute-row layout of the packed per-entry splat array (16, E)
ROW_CX, ROW_CY = 0, 1
ROW_CA, ROW_CB, ROW_CC = 2, 3, 4
ROW_R, ROW_G, ROW_B = 5, 6, 7
ROW_OP = 8
ROW_EX, ROW_EY = 9, 10
NUM_ROWS = 16

# output-channel layout of the per-tile pixel buffer (T, NUM_OUT, P),
# channel-planar: pixels on the minor axis
OUT_R, OUT_G, OUT_B = 0, 1, 2
OUT_ACC_ALPHA = 3
OUT_T = 4
OUT_NCONTRIB = 5
NUM_OUT = 8

# the kernel stages ROW_CX..ROW_EY of each chunk in dynamic shared memory,
# which a launch may size up to 48 KB without an opt-in attribute
_USED_ROWS = ROW_EY + 1
_MAX_CHUNK = 48 * 1024 // (4 * _USED_ROWS)


def _check_inputs(attrs16, tile_offsets, ntx, nty, settings):
    if attrs16.dim() != 2 or attrs16.shape[0] != NUM_ROWS:
        raise ValueError(f"attrs16 must be ({NUM_ROWS}, E), got "
                         f"{tuple(attrs16.shape)}")
    if attrs16.dtype != torch.float32:
        raise TypeError(f"attrs16 must be float32, got {attrs16.dtype}")
    if tile_offsets.dtype != torch.int32:
        raise TypeError(f"tile_offsets must be int32, got "
                        f"{tile_offsets.dtype}")
    if tile_offsets.shape != (ntx * nty + 1,):
        raise ValueError(f"tile_offsets must be ({ntx * nty + 1},), got "
                         f"{tuple(tile_offsets.shape)}")
    for name, t in (("attrs16", attrs16), ("tile_offsets", tile_offsets)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if attrs16.device != tile_offsets.device:
        raise ValueError("attrs16 and tile_offsets are on different devices")
    if not 0 < settings.tile_px <= 1024:
        raise ValueError(f"tile of {settings.tile_px} pixels: one CUDA "
                         "block holds 1 to 1024")
    if not 0 < settings.chunk <= _MAX_CHUNK:
        raise ValueError(f"chunk must be in [1, {_MAX_CHUNK}]")
    # the kernel reads attrs16 through these offsets: keep them in bounds
    lo, hi = torch.stack(torch.aminmax(tile_offsets)).tolist()
    if lo < 0 or hi > attrs16.shape[1]:
        raise ValueError(f"tile_offsets span [{lo}, {hi}], outside the "
                         f"{attrs16.shape[1]} entries of attrs16")


def _pixel_coords(ntx: int, n_tiles: int, settings: RenderSettings,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates of every tile, (T, P, 1) each."""
    t = torch.arange(n_tiles, dtype=torch.int32, device=device)[:, None]
    pix = torch.arange(settings.tile_px, dtype=torch.int32,
                       device=device)[None, :]
    pxf = ((t % ntx) * settings.tile_w + pix % settings.tile_w).to(
        torch.float32) + 0.5
    pyf = ((t // ntx) * settings.tile_h + pix // settings.tile_w).to(
        torch.float32) + 0.5
    return pxf[..., None], pyf[..., None]


def rasterize_tiles_plain(attrs16: torch.Tensor, tile_offsets: torch.Tensor,
                          num_tiles_x: int, num_tiles_y: int,
                          settings: RenderSettings,
                          track_ncontrib: bool = True) -> torch.Tensor:
    """Plain torch version of the kernel, (T, NUM_OUT, P) float32."""
    dev = attrs16.device
    n_tiles = num_tiles_x * num_tiles_y
    p, k = settings.tile_px, settings.chunk
    log_t_min = math.log(settings.t_threshold)
    e_len = attrs16.shape[1]

    uo = tile_offsets[:-1].to(torch.int64)
    cnt = tile_offsets[1:].to(torch.int64) - uo
    nch = (cnt + k - 1) // k
    pxf, pyf = _pixel_coords(num_tiles_x, n_tiles, settings, dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)

    log_t_un = torch.zeros((n_tiles, p, 1), dtype=torch.float32, device=dev)
    log_t_gated = torch.zeros_like(log_t_un)
    nmax = torch.zeros_like(log_t_un)
    acc = torch.zeros((n_tiles, 4, p), dtype=torch.float32, device=dev)

    n_chunks = int(nch.max()) if n_tiles else 0
    for c in range(n_chunks):
        # tiles with a chunk left and an unsaturated pixel (the TPU
        # kernel's while-loop test, rasterize.py:318-320)
        live = (c < nch) & (log_t_un.amax(dim=(1, 2)) >= log_t_min)
        tl = torch.nonzero(live).squeeze(1)
        if tl.numel() == 0:
            break
        sl = uo[tl, None] + c * k + lane  # (t, K) entry slots
        in_range = sl < (uo + cnt)[tl, None]
        sub = attrs16[:, torch.clamp(sl, max=e_len - 1)]  # (16, t, K)
        sub = sub.permute(1, 0, 2)[:, :, None, :]  # (t, 16, 1, K)

        def row(i):
            return sub[:, i]  # (t, 1, K)

        dx = pxf[tl] - row(ROW_CX)  # (t, P, K)
        dy = pyf[tl] - row(ROW_CY)
        u1 = row(ROW_CA) * dx + row(ROW_CB) * dy
        u2 = row(ROW_CB) * dx + row(ROW_CC) * dy
        power = dx * u1 + dy * u2
        alpha = torch.clamp(row(ROW_OP) * torch.exp(-0.5 * power),
                            max=settings.alpha_max)
        keep = ((dx.abs() <= row(ROW_EX)) & (dy.abs() <= row(ROW_EY))
                & (alpha >= settings.alpha_min) & in_range[:, None, :])
        alpha = torch.where(keep, alpha, 0.0)

        lt = log_t_un[tl]
        alog = torch.log1p(-alpha)
        alog_incl = torch.cumsum(alog, dim=2)
        t_excl = torch.exp(alog_incl - alog + lt)
        incl = (t_excl >= settings.t_threshold).to(torch.float32)
        w = alpha * t_excl * incl  # (t, P, K)

        c4 = torch.cat([sub[:, ROW_R:ROW_B + 1, 0, :],
                        torch.ones_like(sub[:, 0:1, 0, :])], dim=1)
        acc[tl] += torch.einsum("tck,tpk->tcp", c4, w)
        log_t_un[tl] = lt + alog_incl[:, :, k - 1:k]
        log_t_gated[tl] += (alog * incl).sum(dim=2, keepdim=True)
        if track_ncontrib:
            pos = (c * k + lane + 1).to(torch.float32)
            contrib = (alpha > 0.0) & (incl > 0.0)
            cand = torch.where(contrib, pos, 0.0).amax(dim=2, keepdim=True)
            nmax[tl] = torch.maximum(nmax[tl], cand)

    out = torch.zeros((n_tiles, NUM_OUT, p), dtype=torch.float32, device=dev)
    out[:, 0:4] = acc
    out[:, OUT_T] = torch.exp(log_t_gated[..., 0])
    out[:, OUT_NCONTRIB] = nmax[..., 0]
    return out


def _rasterize_tiles_cuda(attrs16, tile_offsets, ntx, nty, settings,
                          track_ncontrib):
    lib = _build.library()
    dev = attrs16.device
    n_tiles = ntx * nty
    out = torch.empty((n_tiles, NUM_OUT, settings.tile_px),
                      dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.webdgs_rasterize_fwd(
            attrs16.data_ptr(), attrs16.shape[1], tile_offsets.data_ptr(),
            n_tiles, ntx, settings.tile_w, settings.tile_h, settings.chunk,
            settings.alpha_min, settings.alpha_max, settings.t_threshold,
            math.log(settings.t_threshold), int(track_ncontrib),
            out.data_ptr(), stream)
    _build.check(err, "rasterize_tiles")
    rasterize_tiles.kernel_launches += 1
    return out


def rasterize_tiles(attrs16: torch.Tensor, tile_offsets: torch.Tensor,
                    num_tiles_x: int, num_tiles_y: int,
                    settings: RenderSettings,
                    track_ncontrib: bool = True) -> torch.Tensor:
    """attrs16: (16, E) f32 packed per-entry attributes in sorted
    tile/depth order; tile_offsets: (T+1,) i32 entry ranges (a plain cumsum
    of per-tile counts, ending at most at E).

    Returns (T, NUM_OUT, P) channel-planar per-tile pixels
    [r, g, b, acc_alpha, T_final, n_contrib, 0, 0] without background;
    channel 5 reads 0 unless ``track_ncontrib``.
    ``rasterize_tiles.kernel_launches`` counts the CUDA kernel's launches.
    """
    _check_inputs(attrs16, tile_offsets, num_tiles_x, num_tiles_y, settings)
    if attrs16.device.type == "cpu":
        return rasterize_tiles_plain(attrs16, tile_offsets, num_tiles_x,
                                     num_tiles_y, settings, track_ncontrib)
    if attrs16.device.type != "cuda":
        raise ValueError(f"unsupported device {attrs16.device}")
    return _rasterize_tiles_cuda(attrs16, tile_offsets, num_tiles_x,
                                 num_tiles_y, settings, track_ncontrib)


rasterize_tiles.kernel_launches = 0


def _pack_per_gauss(attrs) -> torch.Tensor:
    n = attrs.opacity.shape[0]
    return torch.cat([
        attrs.center_px,  # 2
        attrs.conic,  # 3
        attrs.color,  # 3
        attrs.opacity[:, None],  # 1
        attrs.extents,  # 2
        torch.zeros((n, NUM_ROWS - 11), dtype=torch.float32,
                    device=attrs.opacity.device),
    ], dim=1)  # (N, 16); column order matches ROW_*


def pack_entry_attrs(attrs, entry_gauss: torch.Tensor,
                     entry_valid: torch.Tensor) -> torch.Tensor:
    """Gather per-Gaussian SplatAttrs into depth-sorted per-entry rows
    (16, E), contiguous.  Invalid slots are zeroed everywhere: opacity 0
    makes them exact no-ops in the compositor."""
    per_gauss = _pack_per_gauss(attrs)
    gathered = torch.where(entry_valid[:, None],
                           per_gauss[entry_gauss.to(torch.int64)], 0.0)
    return gathered.T.contiguous()


def composite_background(tiles: torch.Tensor,
                         settings: RenderSettings) -> torch.Tensor:
    """accum + background * T_final; tiles: (..., NUM_OUT) image-space
    pixel channels (after :func:`tiles_to_image`) -> (..., 3)."""
    bg = torch.tensor(settings.background, dtype=torch.float32,
                      device=tiles.device)
    return tiles[..., 0:3] + bg * tiles[..., OUT_T:OUT_T + 1]


def tiles_to_image(out: torch.Tensor, num_tiles_x: int, num_tiles_y: int,
                   img_w: int, img_h: int,
                   settings: RenderSettings) -> torch.Tensor:
    """(T, C, P) channel-planar per-tile pixels -> (H, W, C) image crop."""
    c = out.shape[1]
    img = out.reshape(num_tiles_y, num_tiles_x, c, settings.tile_h,
                      settings.tile_w)
    img = img.permute(0, 3, 1, 4, 2).reshape(
        num_tiles_y * settings.tile_h, num_tiles_x * settings.tile_w, c)
    return img[:img_h, :img_w]


def image_to_tiles(img: torch.Tensor, num_tiles_x: int, num_tiles_y: int,
                   settings: RenderSettings) -> torch.Tensor:
    """(H, W, C) -> channel-minor (T, P, C), zero-padding to the tile grid
    (the per-pixel layout the importance replay consumes)."""
    h, w, c = img.shape
    ph = num_tiles_y * settings.tile_h - h
    pw = num_tiles_x * settings.tile_w - w
    img = torch.nn.functional.pad(img, (0, 0, 0, pw, 0, ph))
    img = img.reshape(num_tiles_y, settings.tile_h, num_tiles_x,
                      settings.tile_w, c)
    return img.permute(0, 2, 1, 3, 4).reshape(
        num_tiles_y * num_tiles_x, settings.tile_px, c)
