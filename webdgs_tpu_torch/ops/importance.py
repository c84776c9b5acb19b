"""Densification importance counts (counterpart of
webdgs_tpu/ops/importance.py).

Per view, at the metric resolution:
  1. render the scene, keeping the per-tile n_contrib map;
  2. flag map: mean |pred - target| per pixel, min/max-normalised,
     thresholded (:func:`metric_flag_map`);
  3. per sorted entry, the number of flagged pixels of its tile to which it
     contributes -- 1-based position <= the pixel's n_contrib and
     alpha >= alpha_min (:func:`entry_counts`, the wrapper of CUDA kernel
     ``csrc/importance.cu``);
  4. per-Gaussian sums of those counts by the segment sum
     (``ops/segsum.py``, one row), averaged over the views.

Every view renders with its own camera.  On a CPU tensor
:func:`entry_counts` runs :func:`entry_counts_plain`, which splits the
work as the kernel does where that is cheap: each tile's range clamped to
[0, E], and only its flagged pixels with n_contrib >= 1 walked, each
through the first min(n_contrib, range) entries, with the alpha test of
``rasterize_tiles_plain`` (``_chunk_alpha``).  On a CUDA tensor it
launches the kernel or raises; neither reads anything back to the host.
Counts are integers <= tile_px, so every sum is exact in float32.
"""

from __future__ import annotations

import torch

from webdgs_tpu_torch import _build
from webdgs_tpu_torch.config import RenderSettings
from webdgs_tpu_torch.core.camera import Camera
from webdgs_tpu_torch.ops import binning as binning_ops
from webdgs_tpu_torch.ops import rasterize as raster_ops
from webdgs_tpu_torch.ops.projection import project_gaussians
from webdgs_tpu_torch.ops.segsum import segment_reduce_entries

# the kernel's tile limit: its record list takes 24 bytes of shared memory
# per pixel and its scan of the pixels' vote groups one warp (32 groups)
_MAX_TILE_PX = 1024
# (pixel, entry) pairs per batch of the plain version (its memory bound)
_PLAIN_PAIRS = 1 << 22


def metric_flag_map(pred: torch.Tensor, target: torch.Tensor,
                    threshold: float) -> torch.Tensor:
    """Binary (H, W) float32 importance mask: the per-pixel mean absolute
    error, min/max-normalised, above ``threshold``."""
    err = torch.mean(torch.abs(pred - target), dim=-1)
    lo, hi = torch.min(err), torch.max(err)
    norm = torch.where(hi > lo, (err - lo) / torch.clamp(hi - lo, min=1e-12),
                       0.0)
    return (norm > threshold).to(torch.float32)


def _check_inputs(attrs16, tile_offsets, pix_tiles, ntx, nty, settings):
    n_tiles = ntx * nty
    if attrs16.dim() != 2 or attrs16.shape[0] != raster_ops.NUM_ROWS or \
            attrs16.dtype != torch.float32:
        raise ValueError(f"attrs16 must be ({raster_ops.NUM_ROWS}, E) "
                         f"float32, got {tuple(attrs16.shape)} "
                         f"{attrs16.dtype}")
    if tile_offsets.dtype != torch.int32 or \
            tile_offsets.shape != (n_tiles + 1,):
        raise ValueError(f"tile_offsets must be ({n_tiles + 1},) int32")
    if pix_tiles.dtype != torch.float32 or \
            tuple(pix_tiles.shape) != (n_tiles, settings.tile_px, 2):
        raise ValueError(f"pix_tiles must be ({n_tiles}, "
                         f"{settings.tile_px}, 2) float32, got "
                         f"{tuple(pix_tiles.shape)} {pix_tiles.dtype}")
    for name, t in (("attrs16", attrs16), ("tile_offsets", tile_offsets),
                    ("pix_tiles", pix_tiles)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != attrs16.device:
            raise ValueError(f"{name} is on {t.device}, attrs16 on "
                             f"{attrs16.device}")
    if settings.tile_px % 32:
        raise ValueError(f"tile of {settings.tile_px} pixels: the kernel "
                         "votes in whole warps, so it takes a multiple of 32")
    if not 0 < settings.tile_px <= _MAX_TILE_PX:
        raise ValueError(f"tile of {settings.tile_px} pixels: the kernel's "
                         "record list and warp scan take at most "
                         f"{_MAX_TILE_PX}")
    if settings.chunk <= 0:
        raise ValueError(f"chunk {settings.chunk} must be positive")


def entry_counts_plain(attrs16: torch.Tensor, tile_offsets: torch.Tensor,
                       pix_tiles: torch.Tensor, num_tiles_x: int,
                       num_tiles_y: int,
                       settings: RenderSettings) -> torch.Tensor:
    """Plain torch version of the kernel, (E,) float32.  Each tile's range
    is clamped to 0 <= uo <= end <= E, as the kernel clamps it; only the
    pixels that can count (flagged, n_contrib >= 1: the kernel's records)
    are walked, ``settings.chunk`` entries at a time."""
    dev = attrs16.device
    k = settings.chunk
    e_len = attrs16.shape[1]
    out = torch.zeros((e_len,), dtype=torch.float32, device=dev)

    off = tile_offsets.to(torch.int64)
    uo = off[:-1].clamp(0, e_len)
    cnt = torch.maximum(off[1:], uo).clamp(max=e_len) - uo
    nc = pix_tiles[..., 1]
    tile, p = torch.nonzero((pix_tiles[..., 0] > 0.0) & (nc >= 1.0),
                            as_tuple=True)
    # each pixel's entries: positions 1 .. min(n_contrib, range)
    walk = torch.minimum(nc[tile, p].clamp(max=float(e_len)).to(torch.int64),
                         cnt[tile])
    if walk.numel() == 0:
        return out
    start = uo[tile]
    tw = settings.tile_w
    pxf = ((tile % num_tiles_x) * tw + p % tw).to(torch.float32) + 0.5
    pyf = ((tile // num_tiles_x) * settings.tile_h + p // tw).to(
        torch.float32) + 0.5
    rows = attrs16[:raster_ops.ROW_EY + 1]  # the rows the alpha test reads
    lane = torch.arange(k, dtype=torch.int64, device=dev)
    batch = max(1, _PLAIN_PAIRS // k)
    for c in range(-(-int(walk.max()) // k)):
        sel = torch.nonzero(walk > c * k).squeeze(1)
        for b in range(0, sel.shape[0], batch):
            s = sel[b:b + batch]
            slots = start[s, None] + c * k + lane  # (f, K)
            sub = rows[:, slots.clamp(max=e_len - 1)]  # (11, f, K)
            sub = sub.permute(1, 0, 2)[:, :, None, :]  # (f, 11, 1, K)
            keep = raster_ops._chunk_alpha(sub, pxf[s, None, None],
                                           pyf[s, None, None], settings)[4]
            hit = keep[:, 0] & (c * k + lane < walk[s, None])
            idx = slots[hit]
            out.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32,
                                              device=dev))
    return out


def _entry_counts_cuda(attrs16, tile_offsets, pix_tiles, ntx, nty,
                       settings):
    lib = _build.library()
    dev = attrs16.device
    n_tiles = ntx * nty
    out = torch.zeros((attrs16.shape[1],), dtype=torch.float32, device=dev)
    if n_tiles == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.webdgs_importance(
            attrs16.data_ptr(), attrs16.shape[1], tile_offsets.data_ptr(),
            pix_tiles.data_ptr(), n_tiles, ntx, settings.tile_w,
            settings.tile_h, settings.alpha_min, settings.alpha_max,
            out.data_ptr(), stream)
    _build.check(err, "entry_counts")
    entry_counts.kernel_launches += 1
    return out


def entry_counts(attrs16: torch.Tensor, tile_offsets: torch.Tensor,
                 pix_tiles: torch.Tensor, num_tiles_x: int,
                 num_tiles_y: int, settings: RenderSettings) -> torch.Tensor:
    """Per sorted entry slot, the number of flagged pixels of its tile to
    which it contributes, (E,) float32; zero outside every tile's range.

    attrs16: (16, E) packed entry rows and tile_offsets (T+1,) i32, as the
    forward rasterizer took them; pix_tiles: (T, P, 2) float32 per-pixel
    (flag, n_contrib) in the :func:`image_to_tiles` layout.
    ``entry_counts.kernel_launches`` counts the CUDA kernel's launches."""
    _check_inputs(attrs16, tile_offsets, pix_tiles, num_tiles_x,
                  num_tiles_y, settings)
    if attrs16.device.type == "cpu":
        return entry_counts_plain(attrs16, tile_offsets, pix_tiles,
                                  num_tiles_x, num_tiles_y, settings)
    if attrs16.device.type != "cuda":
        raise ValueError(f"unsupported device {attrs16.device}")
    return _entry_counts_cuda(attrs16, tile_offsets, pix_tiles, num_tiles_x,
                              num_tiles_y, settings)


entry_counts.kernel_launches = 0


@torch.no_grad()
def view_importance_counts(scene_params: dict[str, torch.Tensor],
                           alive: torch.Tensor, sh_deg: int, camera: Camera,
                           target: torch.Tensor, img_w: int, img_h: int,
                           threshold: float,
                           settings: RenderSettings) -> torch.Tensor:
    """Per-Gaussian importance counts (N,) float32 for one view; ``target``
    is the (img_h, img_w, 3) ground truth at the metric resolution."""
    attrs, aux = project_gaussians(scene_params, alive, camera, img_w, img_h,
                                   sh_deg, settings)
    ntx, nty = binning_ops.tile_grid(img_w, img_h, settings)
    # the heuristic entry capacity, as the reference; attrs enables the
    # exact tile cull, whose culled pairs never contribute anywhere
    bins = binning_ops.bin_splats(aux, img_w, img_h, settings, attrs=attrs,
                                  with_source=True)
    attrs16 = raster_ops.pack_entry_attrs(attrs, bins.entry_gauss,
                                          bins.entry_valid)
    out = raster_ops.rasterize_tiles(attrs16, bins.tile_offsets, ntx, nty,
                                     settings)
    tiles = raster_ops.tiles_to_image(out, ntx, nty, img_w, img_h, settings)
    pred = raster_ops.composite_background(tiles, settings)

    flag = metric_flag_map(pred, target, threshold)
    pix = torch.stack([flag, tiles[..., raster_ops.OUT_NCONTRIB]], dim=-1)
    pix_tiles = raster_ops.image_to_tiles(pix, ntx, nty,
                                          settings).contiguous()
    counts = entry_counts(attrs16, bins.tile_offsets, pix_tiles, ntx, nty,
                          settings)
    return segment_reduce_entries(counts[:, None], bins.entry_valid,
                                  bins.entry_source, bins.gauss_counts)[:, 0]


def multiview_importance_counts(scene_params: dict[str, torch.Tensor],
                                alive: torch.Tensor, sh_deg: int,
                                cameras: list[Camera],
                                targets: torch.Tensor, img_w: int,
                                img_h: int, threshold: float,
                                settings: RenderSettings) -> torch.Tensor:
    """Counts averaged over views: ``cameras[i]`` sees ``targets[i]``
    ((V, img_h, img_w, 3))."""
    total = torch.zeros(alive.shape, dtype=torch.float32,
                        device=alive.device)
    for cam, target in zip(cameras, targets):
        total = total + view_importance_counts(
            scene_params, alive, sh_deg, cam, target, img_w, img_h,
            threshold, settings)
    return total / targets.shape[0]
