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
:func:`entry_counts` runs :func:`entry_counts_plain`, blocked like the
kernel: all tiles in parallel, chunks of ``settings.chunk`` entries, the
alpha test of ``rasterize_tiles_plain`` (``_chunk_alpha``), tiles with no
flagged pixel skipped and chunks past the largest flagged n_contrib never
evaluated.  On a CUDA tensor it launches the kernel or raises.  Counts are
integers <= tile_px, so every sum is exact in float32.
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

# rows the kernel stages per chunk (cx, cy, conic, op, extents) and the
# shared memory a launch may use without an opt-in attribute
_STAGE_ROWS = 8
_SMEM_BYTES = 48 * 1024


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
    if not 0 < settings.tile_px <= 1024 or settings.tile_px % 32:
        raise ValueError(f"tile of {settings.tile_px} pixels: the kernel "
                         "takes a multiple of 32, at most 1024")
    smem = 4 * (_STAGE_ROWS + settings.tile_px // 32) * settings.chunk
    if not 0 < settings.chunk or smem > _SMEM_BYTES:
        raise ValueError(f"chunk {settings.chunk} needs {smem} bytes of "
                         f"shared memory, more than {_SMEM_BYTES}")
    # the kernel reads attrs16 through these offsets: keep them in bounds
    lo, hi = torch.stack(torch.aminmax(tile_offsets)).tolist()
    if lo < 0 or hi > attrs16.shape[1]:
        raise ValueError(f"tile_offsets span [{lo}, {hi}], outside the "
                         f"{attrs16.shape[1]} entries of attrs16")


def entry_counts_plain(attrs16: torch.Tensor, tile_offsets: torch.Tensor,
                       pix_tiles: torch.Tensor, num_tiles_x: int,
                       num_tiles_y: int,
                       settings: RenderSettings) -> torch.Tensor:
    """Plain torch version of the kernel, (E,) float32."""
    dev = attrs16.device
    n_tiles = num_tiles_x * num_tiles_y
    k = settings.chunk
    e_len = attrs16.shape[1]

    flagged = pix_tiles[..., 0:1] > 0.0  # (T, P, 1)
    n_contrib = pix_tiles[..., 1:2]
    # entries past every flagged pixel's last contributor never count; a
    # tile with no flagged pixel has nothing to count
    max_nc = torch.where(flagged, n_contrib, 0.0).amax(dim=(1, 2)).to(
        torch.int64)
    uo = tile_offsets[:-1].to(torch.int64)
    live = torch.minimum(tile_offsets[1:].to(torch.int64) - uo, max_nc)
    nch = (live + k - 1) // k
    pxf, pyf = raster_ops._pixel_coords(num_tiles_x, n_tiles, settings, dev)
    lane = torch.arange(k, dtype=torch.int64, device=dev)

    out = torch.zeros((e_len,), dtype=torch.float32, device=dev)
    n_chunks = int(nch.max()) if n_tiles else 0
    for c in range(n_chunks):
        tl = torch.nonzero(c < nch).squeeze(1)
        sl = uo[tl, None] + c * k + lane  # (t, K) entry slots
        in_range = c * k + lane < live[tl, None]
        sub = attrs16[:, torch.clamp(sl, max=e_len - 1)]  # (16, t, K)
        sub = sub.permute(1, 0, 2)[:, :, None, :]  # (t, 16, 1, K)
        _, _, _, _, keep = raster_ops._chunk_alpha(sub, pxf[tl], pyf[tl],
                                                   settings)
        pos = (c * k + lane + 1).to(torch.float32)  # 1-based in the range
        mask = keep & (pos <= n_contrib[tl]) & flagged[tl]
        counts = mask.sum(dim=1).to(torch.float32)  # (t, K)
        out[sl[in_range]] = counts[in_range]
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
            settings.tile_h, settings.chunk, settings.alpha_min,
            settings.alpha_max, out.data_ptr(), stream)
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
